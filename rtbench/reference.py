"""The plain reference: the benchmark's frames and fit steps in plain PyTorch.

It imports nothing of the program (``raytpu_torch``), of JAX or of the JAX
package, and takes nothing the program made: it is handed the scene arrays
the benchmark generated (scene.py) and works out the rest itself, from the
semantics the program implements (the reference engine's
``RayTracer.CastRay`` with XNA's camera):

- primary rays through the integer pixel coordinates, from the near plane
  of a look-at camera (fov pi/4, near 1);
- the nearest hit of a ray: the least t >= 0 over the triangles it crosses
  in Moller-Trumbore form, with back faces culled (det = e1 . (d x e2) < 0
  accepted), the hit's own triangle ignored on secondary rays; on equal t
  the lower triangle id;
- shading: the interpolated vertex normal, one spot light (cone, decay,
  the surfaceDot^12 term) times the diffuse color, shadowed when another
  triangle crosses the segment to the light; with reflections, the colour
  ``(1 - r) S L + r L C(reflected ray)``, the last level ``S L``;
- the frame's byte colours: ``round(clamp(c, 0, 1) * 255)``.

The search is exact and brute force in effect: triangles are grouped into
boxes (Morton order of their centroids, a fixed three-level hierarchy
built here from the triangles alone), a ray visits every box its segment
enters, and every triangle of a visited box is tested.  ``dtype`` sets the
precision of every ray and triangle computation: float32, as the
configuration states, or bfloat16 for the control (rtbench/calibrate.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

F32 = torch.float32
_TINY = 1e-30


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


# ---- cameras ---------------------------------------------------------------

def _look_at(position, target):
    """XNA ``Matrix.CreateLookAt`` (row vectors, right-handed), float32."""
    f32 = dict(dtype=F32)
    pos, tgt = torch.tensor(position, **f32), torch.tensor(target, **f32)
    z = normalize(pos - tgt)
    x = normalize(cross(torch.tensor((0.0, 1.0, 0.0), **f32), z))
    y = cross(z, x)
    m = torch.zeros((4, 4), **f32)
    m[0:3, 0], m[0:3, 1], m[0:3, 2] = x, y, z
    m[3, 0], m[3, 1], m[3, 2] = -dot(x, pos), -dot(y, pos), -dot(z, pos)
    m[3, 3] = 1.0
    return m


def _perspective(fov, aspect, near, far):
    """XNA ``Matrix.CreatePerspectiveFieldOfView``, float32."""
    y_scale = 1.0 / torch.tan(torch.tensor(fov, dtype=F32) * 0.5)
    m = torch.zeros((4, 4), dtype=F32)
    m[0, 0], m[1, 1] = y_scale / aspect, y_scale
    m[2, 2] = float(torch.tensor(far / (near - far), dtype=F32))
    m[2, 3] = -1.0
    m[3, 2] = float(torch.tensor(near * far / (near - far), dtype=F32))
    return m


def camera_rays(position, target, width, height, device, fov=math.pi / 4,
                near=1.0, far=1000.0):
    """Raster-ordered primary rays (index y * width + x) through the pixel
    corners: XNA's ``Viewport.Unproject`` of each pixel at depths 0 and 1
    through the inverse of view x projection, in float32, the direction
    combined in homogeneous form (origins on the near plane)."""
    inv = torch.linalg.inv(_look_at(position, target)
                           @ _perspective(fov, width / height, near, far))
    inv = inv.to(device)
    py, px = torch.meshgrid(torch.arange(height, dtype=F32, device=device),
                            torch.arange(width, dtype=F32, device=device),
                            indexing="ij")
    w, h = (torch.tensor(float(v), device=device) for v in (width, height))
    sx = px.reshape(-1) / w * 2.0 - 1.0
    sy = -(py.reshape(-1) / h * 2.0 - 1.0)

    def unproject(z):
        xyz = (sx[:, None] * inv[0, 0:3] + sy[:, None] * inv[1, 0:3]
               + z * inv[2, 0:3] + inv[3, 0:3])
        a = sx * inv[0, 3] + sy * inv[1, 3] + z * inv[2, 3] + inv[3, 3]
        return xyz, a

    n_xyz, n_a = unproject(0.0)
    f_xyz, f_a = unproject(1.0)
    return (n_xyz / n_a[:, None],
            normalize(f_xyz * n_a[:, None] - n_xyz * f_a[:, None]))


# ---- the scene -------------------------------------------------------------

class Geometry(NamedTuple):
    v0: torch.Tensor  # (T, 3)
    e1: torch.Tensor  # (T, 3)
    e2: torch.Tensor  # (T, 3)


def _morton(cells):
    v = cells.to(torch.int64) & 0x3FF
    out = torch.zeros_like(v[:, 0])
    for k in range(3):
        x = v[:, k]
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        out = out | (x << (2 - k))
    return out


class Boxes:
    """Triangles in Morton order of their centroids, grouped into leaves of
    ``fan[-1]`` triangles and those into levels of ``fan[i]`` children, each
    group's box padded so that its float32 slab test is conservative."""

    def __init__(self, corners, fan=(16, 16, 32)):
        lo, hi = corners.amin(1), corners.amax(1)
        smin, smax = lo.amin(0), hi.amax(0)
        extent = float((smax - smin).amax())
        cells = ((lo + hi) * 0.5 - smin) / max(extent, 1e-30) * 1023.0
        order = torch.argsort(_morton(cells.clamp(0, 1023)), stable=True)
        group = math.prod(fan)
        n = corners.shape[0]
        pad = (-n) % group
        fill = torch.full((pad,), -1, dtype=torch.int64, device=lo.device)
        self.order = torch.cat([order, fill])
        self.fan = fan
        big = float("inf")
        eps = 1e-4 * extent + 1e-6
        safe = self.order.clamp(min=0)
        real = (self.order >= 0)[:, None]
        box_lo = torch.where(real, lo[safe], big)
        box_hi = torch.where(real, hi[safe], -big)
        self.levels = []  # coarsest first: (lo, hi), each (groups, 3)
        for f in reversed(fan):
            box_lo = box_lo.reshape(-1, f, 3).amin(1)
            box_hi = box_hi.reshape(-1, f, 3).amax(1)
            self.levels.insert(0, (box_lo - eps, box_hi + eps))


def _slab(o, inv, lo, hi):
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    en = torch.minimum(t1, t2).amax(-1)
    ex = torch.maximum(t1, t2).amin(-1)
    return en, ex


def _candidates(boxes, o, inv, tmax, budget=1 << 24):
    """(ray, leaf) pairs whose padded leaf box the ray's segment
    [0, tmax] enters, level by level."""
    top_lo, top_hi = boxes.levels[0]
    en, ex = _slab(o[:, None], inv[:, None], top_lo, top_hi)
    keep = (en <= ex) & (ex >= 0.0) & (en <= tmax[:, None])
    ray, box = keep.nonzero(as_tuple=True)
    for level, f in zip(boxes.levels[1:], boxes.fan[:-1]):
        lo, hi = level
        out_r, out_b = [], []
        step = max(1, budget // f)
        for s in range(0, ray.shape[0], step):
            r, b = ray[s:s + step], box[s:s + step]
            kids = b[:, None] * f + torch.arange(f, device=b.device)
            en, ex = _slab(o[r, None], inv[r, None], lo[kids], hi[kids])
            keep = (en <= ex) & (ex >= 0.0) & (en <= tmax[r, None])
            i, j = keep.nonzero(as_tuple=True)
            out_r.append(r[i])
            out_b.append(kids[i, j])
        ray = torch.cat(out_r) if out_r else ray[:0]
        box = torch.cat(out_b) if out_b else box[:0]
    return ray, box


def moller_trumbore(o, d, v0, e1, e2):
    """(det, u, v, t) of rays against triangles, broadcast over (..., 3)."""
    p = cross(d, e2)
    det = dot(e1, p)
    tv = o - v0
    q = cross(tv, e1)
    return det, dot(tv, p) / det, dot(d, q) / det, dot(e2, q) / det


def search(boxes, geo: Geometry, o, d, tmax=None, ignore=None, cull=True,
           dtype=F32, budget=1 << 24):
    """Nearest accepted hit of each ray: ``(t, tri)``, t = inf and tri = -1
    where none.  ``tmax``: only hits with t < tmax count (None: any);
    ``ignore``: a triangle id per ray left out (-1: none); ``cull``: True
    accepts det < 0 (faces toward the ray), "reverse" det > 0."""
    r, dev = o.shape[0], o.device
    t_out = torch.full((r,), float("inf"), dtype=F32, device=dev)
    id_out = torch.full((r,), -1, dtype=torch.int64, device=dev)
    if tmax is None:
        tmax = torch.full((r,), float("inf"), dtype=F32, device=dev)
    if ignore is None:
        ignore = torch.full((r,), -1, dtype=torch.int64, device=dev)
    live = (torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
            & (tmax > 0)).nonzero().squeeze(1)
    ntop = boxes.levels[0][0].shape[0]
    chunk = max(1, budget // (ntop * 4))
    leaf = boxes.fan[-1]
    lanes = torch.arange(leaf, device=dev)
    for s in range(0, live.shape[0], chunk):
        idx = live[s:s + chunk]
        oc, dc, tc = o[idx], d[idx], tmax[idx]
        inv = 1.0 / torch.where(dc == 0.0, _TINY, dc)
        ray, lf = _candidates(boxes, oc, inv, tc, budget)
        best_t = torch.full((idx.shape[0],), float("inf"), dtype=F32,
                            device=dev)
        hits_r, hits_t, hits_id = [], [], []
        step = max(1, budget // (leaf * 8))
        for p in range(0, ray.shape[0], step):
            rr, ll = ray[p:p + step], lf[p:p + step]
            tid = boxes.order[ll[:, None] * leaf + lanes]
            g = tid.clamp(min=0)
            det, u, v, t = moller_trumbore(
                oc[rr, None].to(dtype), dc[rr, None].to(dtype),
                geo.v0[g].to(dtype), geo.e1[g].to(dtype),
                geo.e2[g].to(dtype))
            side = det > 0 if cull == "reverse" else det < 0
            ok = (side & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
                  & (t.to(F32) < tc[rr, None]) & (tid >= 0)
                  & (tid != ignore[idx][rr, None]))
            i, j = ok.nonzero(as_tuple=True)
            hits_r.append(rr[i])
            hits_t.append(t[i, j].to(F32))
            hits_id.append(tid[i, j])
        if not hits_r:
            continue
        hr, ht, hid = torch.cat(hits_r), torch.cat(hits_t), torch.cat(hits_id)
        best_t.scatter_reduce_(0, hr, ht, "amin")
        win = ht == best_t[hr]
        best_id = torch.full_like(best_t, 2**62, dtype=torch.int64)
        best_id.scatter_reduce_(0, hr[win], hid[win], "amin")
        found = torch.isfinite(best_t)
        t_out[idx] = best_t
        id_out[idx] = torch.where(found, best_id, -1)
    return t_out, id_out


# ---- the scene the reference renders ----------------------------------------

def transform_points(p, m):
    """``[p, 1] @ m`` for (..., 3) points and a (4, 4) row-vector matrix."""
    return (p[..., 0, None] * m[0, :3] + p[..., 1, None] * m[1, :3]
            + p[..., 2, None] * m[2, :3]) + m[3, :3]


def transform_vectors(v, m):
    """``v @ m`` for (..., 3) vectors and a (3, 3) matrix."""
    return (v[..., 0, None] * m[0] + v[..., 1, None] * m[1]
            + v[..., 2, None] * m[2])


class Placement(NamedTuple):
    world: torch.Tensor     # (4, 4) float32, row vectors
    inverse: torch.Tensor   # (4, 4)
    normals: torch.Tensor   # (3, 3): the inverse's transpose


class RefScene:
    """A scene's triangles, vertex normals, material and light, and the
    search boxes.  A mesh placed once is searched in world space; placed
    several times (instances), each ray is moved into each placement's
    object space by the reference engine's two-point method (origin and
    origin + direction as points, re-subtracted and normalised), searched
    there and the hits compared by world distance
    (OctreeSpatialManager.cs:312-482)."""

    def __init__(self, arrays, device, world_matrix=None):
        v = torch.as_tensor(arrays.vertices, device=device)
        self.corners = v
        self.geo = Geometry(v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        self.normals = torch.as_tensor(arrays.normals, device=device)
        self.placements = []
        for x, z, k in arrays.instances or ():
            w = torch.as_tensor(world_matrix(x, z, k))
            inv = torch.linalg.inv(w)
            self.placements.append(Placement(
                w.to(F32).to(device), inv.to(F32).to(device),
                inv.T[:3, :3].to(F32).to(device)))
        self.color = torch.tensor(arrays.color[:3], dtype=F32, device=device)
        self.reflect = float(arrays.reflectiveness)
        lt = arrays.light
        self.light_pos = torch.tensor(lt["position"], dtype=F32, device=device)
        self.light_dir = torch.tensor(lt["direction"], dtype=F32,
                                      device=device)
        self.light_color = torch.tensor(lt.get("color", (1.0, 1.0, 1.0)),
                                        dtype=F32, device=device)
        self.intensity = float(lt.get("intensity", 1.0))
        self.decay = float(lt.get("decay_exponent", 1.3))
        # float32 like the program's packed light table.
        self.cos_half = float(torch.tensor(
            math.cos(lt.get("spot_angle", math.pi / 2) * 0.5), dtype=F32))
        self.boxes = Boxes(v)


class Hits(NamedTuple):
    found: torch.Tensor    # (R,) bool
    t: torch.Tensor        # (R,) world distance, inf where none
    key: torch.Tensor      # (R,) int64 placement * triangles + triangle
    frag: torch.Tensor     # (R, 3) world hit point
    normal: torch.Tensor   # (R, 3) world interpolated normal


def _object_hits(scene, o, d, tri, dtype, geo=None):
    """Barycentrics, hit point and interpolated normal on triangles
    ``tri`` (>= 0), recomputed from ``geo`` (default the scene's), with the
    program's determinant guard."""
    geo = geo or scene.geo
    v0, e1, e2 = (x[tri].to(dtype) for x in geo)
    o, d = o.to(dtype), d.to(dtype)
    p = cross(d, e2)
    det = dot(e1, p)
    det = torch.where(det.abs() < 1e-20, 1.0, det)
    tv = o - v0
    q = cross(tv, e1)
    u = dot(tv, p) / det
    v = dot(d, q) / det
    n = scene.normals[tri].to(dtype)
    normal = normalize(n[:, 0] + (n[:, 1] - n[:, 0]) * u[:, None]
                       + (n[:, 2] - n[:, 0]) * v[:, None])
    return v0 + e1 * u[:, None] + e2 * v[:, None], normal


def hits(scene: RefScene, o, d, tmax=None, ignore=None, cull=True,
         dtype=F32) -> Hits:
    """The nearest hit of each ray in the world; ``ignore``: a key per ray
    left out (-1: none)."""
    r, dev = o.shape[0], o.device
    n = scene.geo.v0.shape[0]
    if ignore is None:
        ignore = torch.full((r,), -1, dtype=torch.int64, device=dev)
    if not scene.placements:
        t, tri = search(scene.boxes, scene.geo, o, d, tmax, ignore, cull,
                        dtype)
        found = tri >= 0
        frag = torch.zeros((r, 3), dtype=dtype, device=dev)
        normal = torch.zeros_like(frag)
        idx = found.nonzero().squeeze(1)
        frag[idx], normal[idx] = _object_hits(scene, o[idx], d[idx],
                                              tri[idx], dtype)
        return Hits(found, t, tri, frag, normal)
    best = Hits(torch.zeros((r,), dtype=torch.bool, device=dev),
                torch.full((r,), float("inf"), dtype=F32, device=dev),
                torch.full((r,), -1, dtype=torch.int64, device=dev),
                torch.zeros((r, 3), dtype=dtype, device=dev),
                torch.zeros((r, 3), dtype=dtype, device=dev))
    for i, pl in enumerate(scene.placements):
        o_obj = transform_points(o, pl.inverse)
        d_obj = transform_points(o + d, pl.inverse) - o_obj
        norm = torch.sqrt(dot(d_obj, d_obj))
        d_obj = d_obj / torch.where(norm == 0, 1.0, norm)[:, None]
        own = ignore // n == i
        _, tri = search(scene.boxes, scene.geo, o_obj, d_obj,
                        None if tmax is None else tmax * norm,
                        torch.where(own & (ignore >= 0), ignore % n, -1),
                        cull, dtype)
        idx = (tri >= 0).nonzero().squeeze(1)
        frag_obj, n_obj = _object_hits(scene, o_obj[idx], d_obj[idx],
                                       tri[idx], dtype)
        frag = transform_points(frag_obj, pl.world.to(dtype))
        to = frag - o[idx].to(dtype)
        t = torch.sqrt(dot(to, to)).to(F32)
        upd = t < best.t[idx]
        idx, t = idx[upd], t[upd]
        best.found[idx] = True
        best.t[idx] = t
        best.key[idx] = i * n + tri[idx]
        best.frag[idx] = frag[upd]
        best.normal[idx] = normalize(transform_vectors(
            n_obj[upd], pl.normals.to(dtype)))
    return best


def spot(scene: RefScene, frag, normal):
    """Spot light at fragments: (contribution (R, 3), unit direction to
    the light, distance to it)."""
    to = scene.light_pos.to(frag.dtype) - frag
    dist = torch.sqrt(dot(to, to))
    to_light = to / dist[..., None]
    sd = dot(to_light, normal)
    ld = dot(-to_light, scene.light_dir.to(frag.dtype))
    level = (scene.intensity * (ld - scene.cos_half)
             / (1.0 - scene.cos_half) ** scene.decay)
    contrib = (scene.light_color.to(frag.dtype) * (level * sd)[..., None]
               + (sd ** 12)[..., None])
    on = (sd >= 0.0) & (ld > scene.cos_half)
    return torch.where(on[..., None], contrib, 0.0), to_light, dist


def occluded(scene: RefScene, frag, to_light, dist, own, lit, dtype=F32):
    """Whether another triangle crosses each lit fragment's segment to the
    light; unlit fragments are never occluded.  A mesh placed once is
    searched from the light with mirrored culling (the program's shadow
    rays cast from the light), instances from the fragment."""
    idx = lit.nonzero().squeeze(1)
    out = torch.zeros_like(lit)
    if idx.numel() == 0:
        return out
    f, tl, dd = frag[idx].to(F32), to_light[idx].to(F32), dist[idx].to(F32)
    if not scene.placements:
        o = scene.light_pos.expand_as(f)
        t, _ = search(scene.boxes, scene.geo, o, -tl, dd, own[idx],
                      cull="reverse", dtype=dtype)
        out[idx] = torch.isfinite(t)
    else:
        h = hits(scene, f, tl, dd, own[idx], True, dtype)
        out[idx] = h.found & (h.t < dd)
    return out


def _light(scene, frag, normal, own, dtype):
    """Shadowed light at hit points (R, 3)."""
    contrib, to_light, dist = spot(scene, frag, normal)
    lit = (contrib != 0.0).any(-1)
    occ = occluded(scene, frag.detach(), to_light.detach(), dist.detach(),
                   own, lit, dtype)
    return contrib * (1.0 - occ.to(dtype))[:, None]


def trace(scene: RefScene, o, d, max_reflections, dtype=F32):
    """Colours (R, 3) of primary rays: shading, shadows and reflections."""
    r = o.shape[0]
    color = torch.zeros((r, 3), dtype=dtype, device=o.device)
    # Each level's rays: where their colour lands (index into the primary
    # rays) and the weight it carries there.
    slot = torch.arange(r, device=o.device)
    weight = torch.ones((r, 3), dtype=dtype, device=o.device)
    ignore = None
    surf = scene.color.to(dtype)
    for level in range(max_reflections + 1):
        last = level == max_reflections
        h = hits(scene, o, d, None, ignore, True, dtype)
        idx = h.found.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        d, slot, weight = d[idx], slot[idx], weight[idx]
        key, frag, normal = h.key[idx], h.frag[idx], h.normal[idx]
        light = _light(scene, frag, normal, key, dtype)
        refl = 0.0 if last else scene.reflect
        color.index_add_(0, slot, weight * ((1.0 - refl) * surf * light))
        b = refl * light
        alive = (b != 0.0).any(-1).nonzero().squeeze(1)
        if last or alive.numel() == 0:
            break
        dd, nn = d[alive].to(dtype), normal[alive]
        o = frag[alive].to(F32)
        d = normalize(dd - 2.0 * dot(dd, nn)[:, None] * nn).to(F32)
        slot, weight, ignore = slot[alive], weight[alive] * b[alive], \
            key[alive]
    return color


def to_bytes(color):
    """XNA's byte colour: round half to even of clamp(c, 0, 1) * 255."""
    return torch.round(color.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def render_frame(scene: RefScene, position, target, width, height,
                 max_reflections, dtype=F32, rows_per_chunk=1 << 18):
    """A frame's byte colours (height, width, 3) uint8, on the scene's
    device, traced in chunks of rows of pixels."""
    o, d = camera_rays(position, target, width, height, scene.corners.device)
    out = torch.empty((o.shape[0], 3), dtype=torch.uint8, device=o.device)
    for s in range(0, o.shape[0], rows_per_chunk):
        sl = slice(s, s + rows_per_chunk)
        out[sl] = to_bytes(trace(scene, o[sl], d[sl], max_reflections,
                                 dtype))
    return out.reshape(height, width, 3)


# ---- the fit ----------------------------------------------------------------

FIELDS = ("tri_v1", "tri_e1", "tri_e2")


def fit_steps(scene: RefScene, start, position, target, width, height, lr,
              steps, dtype=F32, half_batch=False):
    """The first ``steps`` steps of a geometry fit: pixel MSE of a
    differentiable render (hits searched on the scene's own geometry, their
    barycentrics, fragments and normals recomputed from the fitted
    geometry) against the scene's own byte-quantised frame, Adam at ``lr``.

    ``start``: the fitted fields' first values, {name: (T, 3)}.  Returns the
    loss of each step, each field's gradient norm at step 1 and each
    field's change after the steps.  ``half_batch``: the mean over the
    first half of the pixels alone (a fault, for the control tests)."""
    o, d = camera_rays(position, target, width, height, scene.corners.device)
    with torch.no_grad():
        _, tri = search(scene.boxes, scene.geo, o, d, cull=True, dtype=F32)
        hit = tri >= 0
        want = torch.zeros((o.shape[0], 3), dtype=F32, device=o.device)
        g = tri[hit]
        frag, normal = _object_hits(scene, o[hit], d[hit], g, F32)
        light = _light(scene, frag, normal, g, F32)
        want[hit] = (to_bytes(scene.color * light).float() / 255.0)
    params = {k: start[k].detach().to(dtype).clone().requires_grad_()
              for k in FIELDS}
    opt = torch.optim.Adam([params[k] for k in sorted(params)], lr=lr)
    losses, grads = [], {}
    rows = torch.arange(o.shape[0], device=o.device)
    use = rows < (o.shape[0] // 2) if half_batch else torch.ones_like(hit)
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        geo = Geometry(params["tri_v1"], params["tri_e1"], params["tri_e2"])
        frag, normal = _object_hits(scene, o[hit], d[hit], g, dtype, geo)
        light = _light(scene, frag, normal, g, dtype)
        color = torch.zeros((o.shape[0], 3), dtype=dtype, device=o.device)
        color = color.index_put((hit.nonzero().squeeze(1),),
                                scene.color.to(dtype) * light)
        err = ((color - want.to(dtype)) ** 2)[use]
        loss = err.mean()
        loss.backward()
        losses.append(float(loss.detach()))
        if step == 0:
            grads = {k: float(params[k].grad.double().norm()) for k in FIELDS}
        opt.step()
    change = {k: float((params[k].detach().double()
                        - start[k].double()).norm()) for k in FIELDS}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}
