"""walk_ms.frame: device time of the walk kernels (names holding
walk_kernel, subwalk_kernel, prepick_kernel or mxu_walk_kernel) in the
traced window, in milliseconds per frame."""

from rtbench import trace


def read(run):
    s = run.summary
    if s is None or run.kind != "orbit":
        return None
    ms = s.kernel_ms_per_item(trace.WALK_KERNELS)
    return ms if ms > 0 else None
