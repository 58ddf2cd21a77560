"""raytpu_torch — the PyTorch/CUDA port of raytpu, grown beside it.

The JAX package ``raytpu`` is the reference; this package mirrors its module
paths and names and imports nothing of it.  It covers the forward
(non-differentiable) render path so far: the host-side scene bake, camera
rays, one nearest-hit query per level, spot/directional shading with
shadow queries, reflections and the image, and the two-level instanced
render with refraction (``render/instanced.py``).  The cluster walks that
these paths run are CUDA kernels (``kernels/csrc/walk.cu``); every tensor
that lies on the CPU goes through their plain PyTorch version instead.

Entry points put their tensors on the card unless the caller names another
device (``device.py``).
"""

from raytpu_torch.config import (  # noqa: F401
    Intersector,
    Quantize,
    RenderConfig,
    RenderMode,
    TextureFiltering,
    UVAddressMode,
)
