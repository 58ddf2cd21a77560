"""The benchmark of ``raytpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: ``python3 -m rtbench.run`` (run.py) runs one cell of
``BENCHMARK.json`` once.

Found by name: ``configs/`` (scenes), ``traffic/`` (traffic mixes),
``limits/`` (the correctness check's limits per cell), ``metrics/`` (one
reader per metric), ``scenes/`` (a scene a configuration names: its
arrays, the program's bake, the reference's scene) and ``mixes/`` (a mix a
traffic file names: its class).  Code: ``workload.py`` (the traffic
generator and the timed loop), ``scene.py`` (the height field),
``reference.py`` (the plain reference the outputs are compared with) and
``reference_textured.py`` (its texture sampling and textured fit),
``trace.py`` (the profiler's window), ``roofline.py`` (the walks' least
time), ``calibrate.py`` (the readings the limits are set from, with the
control).  It imports nothing of JAX or of the JAX package.
"""
