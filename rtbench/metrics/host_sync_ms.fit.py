"""host_sync_ms.fit: host time blocked in reads of device values
(aten::_local_scalar_dense on the timing thread) in the traced window, in
milliseconds per fit step."""


def read(run):
    s = run.summary
    if s is None or run.kind != "fit":
        return None
    return s.sync_us / s.items / 1e3
