"""walk_roofline.frame: the walk kernels' share of their roofline, in
percent, over the first frames of the orbit rendered again once the traced
window has closed: the least time of their walk calls (rtbench/roofline.py)
over the device time of their walk kernels (torch.profiler).  Not read for
instanced scenes, whose per-instance calls are not counted."""

import torch

from rtbench import roofline, trace

FRAMES = 2


def read(run):
    mix = run.mix
    if (run.kind != "orbit" or mix is None or mix.instanced
            or mix.render is None or not torch.cuda.is_available()):
        return None
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with roofline.recorded_walks() as calls:
        with profile(activities=acts) as prof:
            for i in range(FRAMES):
                with torch.profiler.record_function(trace.ITEM):
                    mix.render(mix.first + i)
            torch.cuda.synchronize()
    s = trace.summarize(prof)
    if s is None or not calls:
        return None
    measured = s.kernel_ms_per_item(trace.WALK_KERNELS) * s.items
    if measured <= 0:
        return None
    return 100.0 * roofline.bound_ms(calls) / measured
