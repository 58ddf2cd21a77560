"""Image read/write (``raytpu/io/image.py``).

``write_image`` is the RenderTarget2D.SaveAsPng analog (Game1.cs:156-161);
``read_image`` replaces RayTracerTexture's GDI+ bitmap load
(RayTracerTexture.cs:24-33), returning (H, W, 3) uint8 top-down rows, the
layout the texture lookup indexes.  Both go through PIL (Pillow), imported
at use.
"""

from __future__ import annotations

import numpy as np
import torch


def pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("image files are read and written with Pillow "
                          "(the PIL package), which is not installed") from e
    return Image


def to_uint8(image) -> np.ndarray:
    """(H, W, 3) float [0, 1] or uint8 image — a tensor on any device or an
    array — as a uint8 array, rounded as the JAX package rounds."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return arr


def write_image(path: str, image) -> None:
    """Write an (H, W, 3) float [0, 1] or uint8 image (a tensor on any
    device, or an array) to PNG/BMP/JPEG by suffix."""
    pil_image().fromarray(to_uint8(image)).save(path)


def read_image(path: str) -> np.ndarray:
    """Read an image file to (H, W, 3) uint8."""
    with pil_image().open(path) as im:
        return np.asarray(im.convert("RGB"))
