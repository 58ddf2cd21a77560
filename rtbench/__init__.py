"""The benchmark of ``raytpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: ``python3 -m rtbench.run`` (run.py) runs one cell of
``BENCHMARK.json`` once.

Data, found by name: ``configs/`` (scenes), ``traffic/`` (traffic mixes),
``limits/`` (the correctness check's limits per cell), ``metrics/`` (one
reader per metric).  Code: ``workload.py`` (the traffic generator and the
timed loop), ``scene.py`` (scene generation), ``reference.py`` (the plain
reference the outputs are compared with), ``trace.py`` (the profiler's
window), ``roofline.py`` (the walks' least time), ``calibrate.py`` (the
readings the limits are set from, with the control).  It imports nothing
of JAX or of the JAX package.
"""
