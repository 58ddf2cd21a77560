"""raytpu_torch — the PyTorch/CUDA port of raytpu, grown beside it.

The JAX package ``raytpu`` is the reference; this package mirrors its module
paths and names.  It covers the forward (non-differentiable) render path so
far: the host-side scene bake, camera rays, one nearest-hit query per level,
spot/directional shading with any-hit shadow queries, reflections and the
image.  The two cluster walks that the path runs are CUDA kernels
(``kernels/csrc/walk.cu``); every tensor that lies on the CPU goes through
their plain PyTorch version instead.

``raytpu.config`` imports only the standard library, so the render
configuration is shared with the reference as it is.  Nothing here imports
JAX or flax.
"""

from raytpu.config import (  # noqa: F401
    Intersector,
    Quantize,
    RenderConfig,
    RenderMode,
    TextureFiltering,
    UVAddressMode,
)
