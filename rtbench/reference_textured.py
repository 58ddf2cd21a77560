"""The plain reference of a textured scene's fit, in plain PyTorch.

It adds to reference.py (whose search, light and camera it uses) what a
texture brings, written from the reference engine's semantics
(``RayTracer.CastRay``'s surface colour, ``Material.LookupUV`` with
``WrapUV`` addressing and bilinear filtering, Material.cs:71-232 as
SURVEY.md describes it), and imports nothing of the program:

- the surface colour of a hit on a textured material is the atlas sampled
  at the hit's UV, the corners' UVs interpolated by its barycentrics, and
  not the diffuse colour (RayTracer.cs:568-581);
- wrap addressing: a coordinate above 1 becomes its remainder (C#'s ``%``,
  the sign of the dividend), one below 0 one plus its remainder;
- bilinear filtering: the coordinate is snapped to the texel grid by its
  IEEE remainder against the texel size 1/n (``Math.IEEERemainder``:
  quotient rounded half to even), the texel index is the snapped
  coordinate times n - 1, truncated, and its neighbour's the snapped
  coordinate plus one texel size, likewise, both held to [0, n - 1]; the
  neighbour's weight is the remainder times n plus 0.5 (the engine's own
  ``+ 0.5``, Material.cs:221-222); texels are raw byte values, the blend
  scaled by 1/255 at the end.

Departures, each from the engine and shared with the program as the
configuration states it: the arithmetic is float32 (the engine's
remainder is taken in float64); the atlas holds one texture, so a hit's
texture is that one.  Texel gradients come from autograd through plain
indexing of the atlas.
"""

from __future__ import annotations

import torch

from rtbench import reference
from rtbench.reference import F32, Geometry

BYTE = float(torch.tensor(1.0 / 255.0, dtype=F32))  # 1/255 in float32
FIELDS = ("tri_v1", "tri_e1", "tri_e2", "textures")


class TexturedScene(reference.RefScene):
    """A mesh placed once, its corners' UVs and its atlas (H, W, 3) of raw
    byte values in float32."""

    def __init__(self, arrays, device):
        super().__init__(arrays, device)
        self.uvs = torch.as_tensor(arrays.uvs, device=device)
        self.atlas = torch.as_tensor(arrays.texture, device=device).to(F32)


def wrap(c):
    """``WrapUV`` of one coordinate."""
    c = torch.where(c > 1.0, torch.fmod(c, 1.0), c)
    return torch.where(c < 0.0, 1.0 + torch.fmod(c, 1.0), c)


def _axis(c, n):
    """Bilinear filtering along one axis of n texels: (texel, neighbour,
    neighbour's weight)."""
    size = torch.tensor(float(n), dtype=c.dtype, device=c.device)
    step = 1.0 / size
    rem = c - step * torch.round(c / step)
    snap = c - rem
    lo = torch.trunc(snap * (size - 1.0)).long().clamp(0, n - 1)
    hi = torch.trunc((snap + step) * (size - 1.0)).long().clamp(0, n - 1)
    return lo, hi, rem * size + 0.5


def bilinear(atlas, uv):
    """The atlas (H, W, 3) sampled at wrapped UVs (..., 2): colours in
    [0, 1] scale, (..., 3)."""
    x0, x1, wx = _axis(uv[..., 0], atlas.shape[1])
    y0, y1, wy = _axis(uv[..., 1], atlas.shape[0])
    wx, wy = wx[..., None], wy[..., None]
    return (atlas[y0, x0] * (1.0 - wx) * (1.0 - wy)
            + atlas[y1, x0] * (1.0 - wx) * wy
            + atlas[y0, x1] * wx * (1.0 - wy)
            + atlas[y1, x1] * wx * wy) * BYTE


def surface(scene, atlas, tri, u, v):
    """The texture's colour at hits (u, v) on triangles ``tri``."""
    uv = scene.uvs[tri].to(u.dtype)
    at = (uv[:, 0] + (uv[:, 1] - uv[:, 0]) * u[:, None]
          + (uv[:, 2] - uv[:, 0]) * v[:, None])
    return bilinear(atlas, wrap(at))


def fit_steps(scene: TexturedScene, start, position, target, width, height,
              lr, steps, dtype=F32, half_batch=False, drop_grads=()):
    """reference.fit_steps with the atlas among the fitted fields: pixel
    MSE of the textured render (hits searched on the scene's own geometry;
    barycentrics, fragments, normals and texture samples recomputed from
    the fitted geometry and atlas) against the scene's own byte-quantised
    frame, Adam at ``lr``.

    ``start``: the fields' first values (``textures`` shaped (1, H, W, 3)
    as the program holds it).  ``half_batch``: the mean over the first half
    of the pixels alone; ``drop_grads``: fields whose gradient is zeroed
    before each update (faults, for the control tests)."""
    o, d = reference.camera_rays(position, target, width, height,
                                 scene.corners.device)
    with torch.no_grad():
        _, tri = reference.search(scene.boxes, scene.geo, o, d, cull=True,
                                  dtype=F32)
        hit = tri >= 0
        g = tri[hit]
        frag, normal, u, v = reference.object_hits_uv(scene, o[hit], d[hit],
                                                      g, F32)
        light = reference._light(scene, frag, normal, g, F32)
        want = torch.zeros((o.shape[0], 3), dtype=F32, device=o.device)
        want[hit] = reference.to_bytes(
            surface(scene, scene.atlas, g, u, v) * light).float() / 255.0
    params = {k: start[k].detach().to(dtype).clone().requires_grad_()
              for k in FIELDS}
    opt = torch.optim.Adam([params[k] for k in sorted(params)], lr=lr)
    losses, grads = [], {}
    rows = torch.arange(o.shape[0], device=o.device)
    use = rows < (o.shape[0] // 2) if half_batch else torch.ones_like(hit)
    idx = hit.nonzero().squeeze(1)
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        geo = Geometry(params["tri_v1"], params["tri_e1"], params["tri_e2"])
        frag, normal, u, v = reference.object_hits_uv(scene, o[hit], d[hit],
                                                      g, dtype, geo)
        light = reference._light(scene, frag, normal, g, dtype)
        color = torch.zeros((o.shape[0], 3), dtype=dtype, device=o.device)
        color = color.index_put(
            (idx,), surface(scene, params["textures"][0], g, u, v) * light)
        loss = ((color - want.to(dtype)) ** 2)[use].mean()
        loss.backward()
        for k in drop_grads:
            params[k].grad = torch.zeros_like(params[k])
        losses.append(float(loss.detach()))
        if step == 0:
            grads = {k: float(params[k].grad.double().norm()) for k in FIELDS}
        opt.step()
    change = {k: float((params[k].detach().double()
                        - start[k].double()).norm()) for k in FIELDS}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}
