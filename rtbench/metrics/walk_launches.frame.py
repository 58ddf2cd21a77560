"""walk_launches.frame: walk kernel launches per frame over the window,
from the program's counter (raytpu_torch/kernels/fused.py::LAUNCHES)."""


def read(run):
    if run.kind != "orbit" or not run.items or run.launches is None:
        return None
    return run.launches / run.items
