"""Texture addressing and sampling on tensors, faithful to Material.cs.

- Address modes Clamp/Wrap/Mirror exactly as Material.cs:102-143, including
  the Mirror quirk that an in-range coordinate is flipped (``1 - uv``) when
  ``(int)(orig - folded) % 2 == 0``, which is true for the 0 case.
- Point filtering (Material.cs:145-160): ``x = (int)(u * (W-1))``
  truncation, raw byte channels scaled by 1/255.
- Bilinear filtering (Material.cs:162-232) with its quirks: texel snapping
  via ``Math.IEEERemainder`` (round-half-even remainder), truncating index
  math, and the ``+0.5`` in the blend weights (Material.cs:221-222).

Textures are stored as float32 raw byte values (0..255); sampling multiplies
by 1/255 at the end like the reference's BYTE_RECIPROCAL.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.config import TextureFiltering, UVAddressMode

BYTE_RECIPROCAL = float(np.float32(1.0 / 255.0))


def _wrap1(x):
    # Material.WrapUV (Material.cs:125-136): C# % is fmod (sign of dividend).
    x = torch.where(x > 1.0, torch.fmod(x, 1.0), x)
    x = torch.where(x < 0.0, 1.0 + torch.fmod(x, 1.0), x)
    return x


def address_uv(uv, mode: UVAddressMode):
    """Apply an address mode to (..., 2) UVs (Material.LookupUV dispatch)."""
    if mode == UVAddressMode.CLAMP:
        return uv.clamp(0.0, 1.0)
    if mode == UVAddressMode.WRAP:
        return _wrap1(uv)
    if mode == UVAddressMode.MIRROR:
        folded = _wrap1(uv)
        # (int)(original - folded) % 2 == 0 → flip (Material.cs:115-122);
        # only evenness matters, which C#'s and Python's % agree on.
        diff = torch.trunc(uv - folded).to(torch.int32)
        flip = diff % 2 == 0
        return torch.where(flip, 1.0 - folded, folded)
    raise ValueError(mode)


def _clip(i, hi):
    return torch.minimum(torch.clamp(i, min=0), hi)


def _fetch(images, fetch):
    if fetch is None:
        return lambda t, y, x: images[t, y, x]  # noqa: E731
    return fetch


def sample_point(images, tex_id, height, width, uv, fetch=None):
    """Point filtering (Material.cs:145-160).

    ``images``: (T, H_pad, W_pad, 3) raw byte values; ``tex_id``: (...,)
    per-sample texture index; ``height/width``: (...,) true sizes;
    ``uv``: (..., 2) addressed UVs.

    ``fetch(tex_id, y, x) -> (..., 3)`` raw bytes (optional): the texel
    backend, for instance the ring-sharded atlas of
    dist/bigscene.py::make_texel_fetch_ring; ``images`` may then be
    None."""
    wf = (width - 1).to(torch.float32)
    hf = (height - 1).to(torch.float32)
    x = _clip(torch.trunc(uv[..., 0] * wf).to(torch.int32), width - 1)
    y = _clip(torch.trunc(uv[..., 1] * hf).to(torch.int32), height - 1)
    return _fetch(images, fetch)(tex_id, y, x) * BYTE_RECIPROCAL


def _ieee_remainder(x, y):
    """.NET Math.IEEERemainder: x - y * round(x / y), round-half-to-even."""
    return x - y * torch.round(x / y)


def sample_bilinear(images, tex_id, height, width, uv, fetch=None):
    """Bilinear filtering with the reference's quirks (Material.cs:162-232).

    ``fetch``: the texel backend (see sample_point)."""
    wf = width.to(torch.float32)
    hf = height.to(torch.float32)
    texel_w = 1.0 / wf  # texelDensity (Material.cs:67)
    texel_h = 1.0 / hf
    rem_x = _ieee_remainder(uv[..., 0], texel_w)
    rem_y = _ieee_remainder(uv[..., 1], texel_h)
    u = uv[..., 0] - rem_x
    v = uv[..., 1] - rem_y
    x = _clip(torch.trunc(u * (wf - 1.0)).to(torch.int32), width - 1)
    y = _clip(torch.trunc(v * (hf - 1.0)).to(torch.int32), height - 1)
    x2 = _clip(torch.trunc((u + texel_w) * (wf - 1.0)).to(torch.int32),
               width - 1)
    y2 = _clip(torch.trunc((v + texel_h) * (hf - 1.0)).to(torch.int32),
               height - 1)
    fetch = _fetch(images, fetch)
    c_base = fetch(tex_id, y, x)
    c_x = fetch(tex_id, y, x2)
    c_y = fetch(tex_id, y2, x)
    c_xy = fetch(tex_id, y2, x2)
    # The reference's +0.5 weights (Material.cs:221-224), replicated.
    dx = (rem_x * wf + 0.5)[..., None]
    dy = (rem_y * hf + 0.5)[..., None]
    inv_dx = 1.0 - dx
    inv_dy = 1.0 - dy
    return (
        c_base * inv_dx * inv_dy
        + c_y * inv_dx * dy
        + c_x * dx * inv_dy
        + c_xy * dx * dy
    ) * BYTE_RECIPROCAL


def lookup_uv(images, tex_id, height, width, uv, address_mode: UVAddressMode,
              filtering: TextureFiltering, fetch=None):
    """Material.LookupUV (Material.cs:71-100).  ``fetch``: the texel
    backend (see sample_point)."""
    uv = address_uv(uv, address_mode)
    if filtering == TextureFiltering.POINT:
        return sample_point(images, tex_id, height, width, uv, fetch=fetch)
    if filtering == TextureFiltering.BILINEAR:
        return sample_bilinear(images, tex_id, height, width, uv,
                               fetch=fetch)
    raise ValueError(filtering)
