"""setup_s: process start to the first timed item (host clock), in
seconds: imports, the scene, the program's bake, the kernels' build or
load, and the warm-up frames or checked fit steps."""


def read(run):
    return run.setup_s
