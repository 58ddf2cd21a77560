"""The plain Whitted reference: frames of a scene of several materials,
with transparency, refraction and a texture, in plain PyTorch.

It adds to reference.py (whose camera, ray-triangle test, spot light and
byte rounding it uses) the rest of ``RayTracer.CastRay``
(RayTracer.cs:506-737), written from the reference engine's semantics, and
imports nothing of the program:

- nearest hit: the least t >= 0 over the triangles a ray crosses facing
  it (Moller-Trumbore, det < 0), t below the ray's bound, its parent's
  triangle left out and, for a reflection off a convex mesh, that whole
  mesh (convexGeometry, RayTracer.cs:554-559); on equal t the lower
  triangle id.  Every ray is tested against every triangle;
- the normal: the corners' normals interpolated by the barycentrics, or
  the face normal ``normalize(cross(e2, e1))`` where the material does
  not interpolate (RayTracer.cs:520-531);
- the spot light (reference.spot) with a shadow ray from the fragment
  toward the light: its nearest occluder short of the light blocks it
  whole, or lets ``1 - alpha`` through where the occluder's material is
  transparent (IsLightPathObstructed, RayTracer.cs:465-502);
- the surface colour: the material's diffuse colour, or its texture at
  the hit's UV, point-sampled with wrap addressing (``x = (int)(u * (W -
  1))`` after ``WrapUV``, Material.cs:125-160), texels scaled by 1/255;
- the colour ``lerp(reflection, surface, 1 - reflectiveness) * light``,
  and on a transparent material that times alpha plus ``1 - alpha`` times
  the refraction (RayTracer.cs:584, :699); at the reflection limit
  ``surface * light`` alone (RayTracer.cs:708-727); a miss is black;
- the reflection ``d - 2 (d . n) n``, normalised, from the hit point;
- the refraction by XNA's vector Snell law (RayTracer.cs:656-699): the
  engine's indices are ``n1 = 1, n2 = ior`` when the ray's medium index
  equals the material's, else ``n1 = ior, n2 = 1`` (so a ray that leaves
  air takes the ratio ior/1 and travels on in index 1); total internal
  reflection ends the branch (the engine's square root of a negative,
  NaN, never hits);
- the frame's bytes: ``round(clamp(c, 0, 1) * 255)``, half to even.

How it traces: a level's live rays only, compacted after every level,
each carrying its pixel and the weight its colour has there; a hit adds
weight times its own term to its pixel and hands weight times b and c to
its children.  Nothing of the program's slot layout is shared.

Departures, each from the engine and shared with the program as the
configuration states it: the arithmetic is float32 throughout (the
engine's is float32 too, but its bounce colours are bytes: the program's
default rounds once, at the end, and so does this); one spot light; the
atlas holds one texture, that of every textured material.

Faults, for the calibration of the limits (keyword arguments of
``render_frame``): ``refraction=False`` drops the refraction child,
``bounces=-1`` traces one bounce fewer, ``texture=False`` shades textured
materials with their diffuse colour, ``transparent_shadows=False`` makes
every occluder opaque.  ``dtype=torch.bfloat16`` computes every ray,
triangle and colour in bfloat16: the control.
"""

from __future__ import annotations

import torch

from rtbench import reference
from rtbench.reference import F32, cross, dot, normalize

BYTE = float(torch.tensor(1.0 / 255.0, dtype=F32))  # 1/255 in float32
# (ray, triangle) pairs tested at once.
PAIRS = 1 << 24


class WhittedScene:
    """Triangles, their meshes' materials, the atlas and the spot light.

    The light's fields carry the names reference.spot reads."""

    def __init__(self, arrays, device):
        v = torch.as_tensor(arrays.vertices, device=device)
        self.corners = v
        self.v0 = v[:, 0]
        self.e1, self.e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        self.normals = normalize(torch.as_tensor(arrays.normals,
                                                 device=device))
        self.face = normalize(cross(self.e2, self.e1))
        self.uvs = torch.as_tensor(arrays.uvs, device=device)
        self.mesh = torch.as_tensor(arrays.mesh, device=device).long()
        mats = arrays.materials

        def col(key, dtype):
            return torch.tensor([m[key] for m in mats], dtype=dtype,
                                device=device)

        self.color = col("diffuse_color", F32)             # (M, 4)
        self.reflect = col("reflectiveness", F32)
        self.transparent = col("transparent", torch.bool)
        self.ior = col("refraction_index", F32)
        self.interp = col("interpolate_normals", torch.bool)
        self.textured = col("use_texture", torch.bool)
        self.convex = col("convex", torch.bool)
        self.atlas = torch.as_tensor(arrays.texture, device=device).to(F32)
        lt = arrays.light
        self.light_pos = torch.tensor(lt["position"], dtype=F32, device=device)
        self.light_dir = torch.tensor(lt["direction"], dtype=F32,
                                      device=device)
        self.light_color = torch.ones(3, dtype=F32, device=device)
        self.intensity = 1.0
        self.decay = 1.3
        # cos(pi/4), float32 like the program's packed light table.
        self.cos_half = float(torch.tensor(0.7071067811865476, dtype=F32))


def nearest(scene, o, d, tmax=None, ignore_tri=None, ignore_mesh=None,
            dtype=F32):
    """The nearest hit of each ray (module docstring): ``(t, tri)``, t inf
    and tri -1 where none; ``tmax``: only t < tmax counts."""
    r, dev = o.shape[0], o.device
    none = torch.full((r,), -1, dtype=torch.int64, device=dev)
    tmax = torch.full((r,), float("inf"), device=dev) if tmax is None \
        else tmax
    ignore_tri = none if ignore_tri is None else ignore_tri
    ignore_mesh = none if ignore_mesh is None else ignore_mesh
    v0, e1, e2 = (x.to(dtype) for x in (scene.v0, scene.e1, scene.e2))
    ids = torch.arange(v0.shape[0], device=dev)
    t_out = torch.full((r,), float("inf"), dtype=F32, device=dev)
    id_out = none.clone()
    step = max(1, PAIRS // v0.shape[0])
    for s in range(0, r, step):
        sl = slice(s, s + step)
        det, u, v, t = reference.moller_trumbore(
            o[sl, None].to(dtype), d[sl, None].to(dtype), v0, e1, e2)
        t = t.to(F32)
        ok = ((det < 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
              & (t < tmax[sl, None]) & (ids != ignore_tri[sl, None])
              & (scene.mesh != ignore_mesh[sl, None]))
        t = torch.where(ok, t, float("inf"))
        best = t.amin(1)
        first = (t == best[:, None]).to(torch.uint8).argmax(1)
        found = torch.isfinite(best)
        t_out[sl] = best
        id_out[sl] = torch.where(found, first, -1)
    return t_out, id_out


def _barycentrics(scene, o, d, tri, dtype):
    """(u, v) of rays on their hit triangles."""
    v0, e1, e2 = (x[tri].to(dtype) for x in (scene.v0, scene.e1, scene.e2))
    _, u, v, _ = reference.moller_trumbore(o.to(dtype), d.to(dtype), v0, e1,
                                           e2)
    return u, v


def _texel(scene, tri, u, v):
    """The atlas point-sampled, wrap addressing, at the hits' UVs."""
    uv = scene.uvs[tri].to(u.dtype)
    at = (uv[:, 0] + (uv[:, 1] - uv[:, 0]) * u[:, None]
          + (uv[:, 2] - uv[:, 0]) * v[:, None])
    at = torch.where(at > 1.0, torch.fmod(at, 1.0), at)
    at = torch.where(at < 0.0, 1.0 + torch.fmod(at, 1.0), at)
    h, w = scene.atlas.shape[:2]
    x = torch.trunc(at[:, 0] * (w - 1)).long().clamp(0, w - 1)
    y = torch.trunc(at[:, 1] * (h - 1)).long().clamp(0, h - 1)
    return scene.atlas[y, x].to(u.dtype) * BYTE


def _light(scene, frag, normal, tri, dtype, transparent_shadows):
    """The spot light at the hits, shadowed (module docstring)."""
    contrib, to_light, dist = reference.spot(scene, frag, normal)
    lit = (contrib != 0.0).any(-1).nonzero().squeeze(1)
    amount = torch.zeros(frag.shape[0], dtype=dtype, device=frag.device)
    if lit.numel():
        _, occ = nearest(scene, frag[lit].to(F32), to_light[lit].to(F32),
                         dist[lit].to(F32), tri[lit], dtype=dtype)
        m = scene.mesh[occ.clamp(min=0)]
        see_through = scene.transparent[m] & transparent_shadows
        block = torch.where(see_through, scene.color[m, 3], 1.0).to(dtype)
        amount[lit] = torch.where(occ >= 0, block, 0.0)
    return contrib * (1.0 - amount)[:, None]


def trace(scene: WhittedScene, o, d, max_reflections, dtype=F32,
          refraction=True, bounces=0, texture=True, transparent_shadows=True):
    """Colours (R, 3) of primary rays (module docstring); ``refraction``,
    ``bounces``, ``texture``, ``transparent_shadows``: the faults."""
    r, dev = o.shape[0], o.device
    depth = max_reflections + bounces
    color = torch.zeros((r, 3), dtype=dtype, device=dev)
    pixel = torch.arange(r, device=dev)
    weight = torch.ones((r, 3), dtype=dtype, device=dev)
    medium = torch.ones(r, dtype=F32, device=dev)
    ignore_tri = ignore_mesh = None
    for level in range(depth + 1):
        last = level == depth
        _, tri = nearest(scene, o, d, None, ignore_tri, ignore_mesh, dtype)
        hit = (tri >= 0).nonzero().squeeze(1)
        if hit.numel() == 0:
            break
        o, d, tri = o[hit], d[hit], tri[hit]
        pixel, weight, medium = pixel[hit], weight[hit], medium[hit]
        m = scene.mesh[tri]
        u, v = _barycentrics(scene, o, d, tri, dtype)
        frag = (scene.v0[tri].to(dtype) + scene.e1[tri].to(dtype) * u[:, None]
                + scene.e2[tri].to(dtype) * v[:, None])
        n = scene.normals[tri].to(dtype)
        lerped = normalize(n[:, 0] + (n[:, 1] - n[:, 0]) * u[:, None]
                           + (n[:, 2] - n[:, 0]) * v[:, None])
        normal = torch.where(scene.interp[m][:, None], lerped,
                             scene.face[tri].to(dtype))
        light = _light(scene, frag, normal, tri, dtype, transparent_shadows)
        surface = scene.color[m, :3].to(dtype)
        if texture:
            surface = torch.where(scene.textured[m][:, None],
                                  _texel(scene, tri, u, v), surface)
        if last:
            color.index_add_(0, pixel, weight * surface * light)
            break
        refl = scene.reflect[m].to(dtype)[:, None]
        alpha = scene.color[m, 3].to(dtype)
        clear = scene.transparent[m]
        keep = torch.where(clear, alpha, 1.0)[:, None]
        a = keep * (1.0 - refl) * surface * light
        b = keep * refl * light
        c = torch.where(clear, 1.0 - alpha, 0.0)
        color.index_add_(0, pixel, weight * a)
        frag32, dd = frag.to(F32), d.to(dtype)
        # The children: reflections where b carries light, refractions of
        # transparent hits.
        go = (b != 0.0).any(-1).nonzero().squeeze(1)
        rd = normalize(dd - 2.0 * dot(dd, normal)[:, None] * normal)
        kids = [(frag32[go], rd[go].to(F32), pixel[go], weight[go] * b[go],
                 medium[go], tri[go],
                 torch.where(scene.convex[m[go]], m[go], -1))]
        if refraction:
            go = (c != 0.0).nonzero().squeeze(1)
            ior = scene.ior[m[go]]
            inside = medium[go] == ior
            n1 = torch.where(inside, 1.0, ior).to(dtype)
            n2 = torch.where(inside, medium[go], 1.0)
            ratio = n1 / n2.to(dtype)
            dg, ng = dd[go], normal[go]
            cos1 = dot(ng, -dg)
            k = 1.0 - ratio * ratio * (1.0 - cos1 * cos1)
            ok = k >= 0.0           # else total internal reflection
            term = (ratio * cos1 - torch.sqrt(k.clamp(min=0.0)))[:, None]
            base = ratio[:, None] * dg
            td = normalize(torch.where((cos1 >= 0.0)[:, None],
                                       base + term * ng, base - term * ng))
            go, td, n2 = go[ok], td[ok], n2[ok]
            kids.append((frag32[go], td.to(F32), pixel[go],
                         weight[go] * c[go, None], n2, tri[go],
                         torch.full_like(go, -1)))
        o, d, pixel, weight, medium, ignore_tri, ignore_mesh = (
            torch.cat(x) for x in zip(*kids))
        if o.shape[0] == 0:
            break
    return color


def render_frame(scene: WhittedScene, position, target, width, height,
                 max_reflections, dtype=F32, rows_per_chunk=1 << 18,
                 **faults):
    """A frame's byte colours (height, width, 3) uint8 on the scene's
    device, traced in chunks of rows of pixels; ``faults``: ``trace``'s."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    o, d = reference.camera_rays(position, target, width, height,
                                 scene.corners.device)
    out = torch.empty((o.shape[0], 3), dtype=torch.uint8, device=o.device)
    for s in range(0, o.shape[0], rows_per_chunk):
        sl = slice(s, s + rows_per_chunk)
        out[sl] = reference.to_bytes(trace(scene, o[sl], d[sl],
                                           max_reflections, dtype, **faults))
    return out.reshape(height, width, 3)
