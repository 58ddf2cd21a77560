"""device_idle_pct.frame: the share of the traced window (first item's
start to last item's end) in which no operation ran on the device, in
percent: 100 less the union of the device's operation intervals."""


def read(run):
    s = run.summary
    if s is None or run.kind != "orbit" or s.window_us <= 0:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)
