"""Nearest-hit and any-hit cluster walks: the CUDA kernels and their plain
PyTorch version.

A query is cut into tiles of ``tile_size`` rays.  Each tile culls every
cluster against its beam (the box of its finite rays' origins and
directions) into a conservative entry bound, then walks the feasible
clusters front to back — argmin of the remaining entries, lowest cluster id
on equal entries — testing its rays against each picked cluster's
triangles in det-multiplied Möller–Trumbore form.  A nearest query keeps a
strict-min (t, slot code) per ray, ties to the lower lane, and settles a ray
once its best hit is at or before the next entry; an any-hit query settles
at the first accepted hit within ``t_max``.  The tile stops when all its
rays have settled or its entries run out.  The result is exact: the same
hits as testing every triangle.

``walk_cuda`` launches the kernels of ``csrc/walk.cu``; ``walk_plain`` is
the same walk in PyTorch, with the same arithmetic in the same order, and
the two agree bit for bit on the card.  ``nearest_hit_fused`` takes the
plain walk for tensors on the CPU and the kernels for CUDA tensors; there is
no fallback from one to the other.

Triangle ids ride as int32 end to end, so a scene may hold up to 2^31 - 1
triangle slots (the reference kernel carried ids as f32 values and stopped
at 2^24).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from raytpu_torch.accel.traverse import FLOAT_MAX, Hit
from raytpu_torch.core.intersect import (det_space_accept,
                                         det_space_accept_within)

INF = FLOAT_MAX
_TINY_DIR = float(np.float32(1e-30))
_CAP_SCALE = float(np.float32(1.0 + 1e-5))
GEO_ROWS = 18  # block rows the walk reads: 0-15 geometry, 16 tri, 17 mesh
# Shared memory one block may use on an H100 (232,448 bytes), less what
# the kernel declares statically.
SMEM_LIMIT = 232448 - 512
# Pair temporaries of the plain walk are capped at this many elements per
# chunk of tiles.
_PAIR_BUDGET = 1 << 24
_CULL_CODE = {False: 0, True: 1, "reverse": 2}

# Launches of each CUDA kernel; ``walk_cuda`` adds one per launch.
LAUNCHES = {"nearest": 0, "any_hit": 0}


class Query(NamedTuple):
    """Rays padded to whole tiles: (R, 3) origin/direction, (R,) t bound
    and ignore ids, ``tile`` rays per tile."""

    origin: torch.Tensor
    direction: torch.Tensor
    t_max: torch.Tensor
    ignore_tri: torch.Tensor
    ignore_mesh: torch.Tensor
    tile: int


class WalkOut(NamedTuple):
    """Raw walk results per padded ray.  ``t``: best distance (any-hit: 0 on
    hits), the capped t bound on misses; ``code``: winning slot (any-hit: 0),
    -1 on misses; nearest only: ``u``, ``v``, ``tri`` and the (R, 32) shade
    ``rows`` (channel 31 the mesh id as a value, zeros on misses)."""

    t: torch.Tensor
    code: torch.Tensor
    u: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    tri: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None


def pack_query(origin, direction, ignore_tri=None, ignore_mesh=None,
               t_max=None, tile_size: int = 256) -> Query:
    """Pad a ray batch to whole tiles.  Padding rays have NaN origins and
    directions (they never hit and stay out of the tile's beam) and t bound
    0."""
    r = origin.shape[0]
    if r == 0:
        raise ValueError("empty ray batch")
    dev = origin.device
    ts = min(tile_size, r)
    pad = (-r) % ts
    i32, f32 = torch.int32, torch.float32
    if ignore_tri is None:
        ignore_tri = torch.full((r,), -1, dtype=i32, device=dev)
    if ignore_mesh is None:
        ignore_mesh = torch.full((r,), -1, dtype=i32, device=dev)
    if t_max is None:
        t_max = torch.full((r,), INF, dtype=f32, device=dev)

    def padded(a, dtype, fill):
        a = a.to(dtype)
        if pad:
            a = torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])
        return a.contiguous()

    return Query(padded(origin, f32, float("nan")),
                 padded(direction, f32, float("nan")),
                 padded(t_max, f32, 0.0),
                 padded(ignore_tri, i32, -1),
                 padded(ignore_mesh, i32, -1), ts)


def assemble_hit(out: WalkOut, r: int, any_hit: bool):
    """The ``Hit`` of the first ``r`` rays, and their rows (None for
    any-hit)."""
    hit = out.code[:r] >= 0
    if any_hit:
        t = torch.where(hit, out.t[:r], INF)
        zero = torch.zeros_like(t)
        tri = torch.where(hit, 0, -1).to(torch.int32)
        return Hit(hit=hit, t=t, u=zero, v=zero, tri=tri), None
    t = torch.where(hit, out.t[:r], INF)
    u = torch.where(hit, out.u[:r], 0.0)
    v = torch.where(hit, out.v[:r], 0.0)
    tri = torch.where(hit, out.tri[:r], -1).to(torch.int32)
    return Hit(hit=hit, t=t, u=u, v=v, tri=tri), out.rows[:r]


def nearest_hit_fused(scene, origin, direction, ignore_tri=None,
                      ignore_mesh=None, cull=True, tile_size: int = 256,
                      t_max=None, any_hit: bool = False,
                      return_rows: bool = False):
    """Exact nearest hit (or any-hit occlusion) by the cluster walk.

    CPU tensors go through ``walk_plain``, CUDA tensors through the CUDA
    kernels.  ``return_rows``: return ``(Hit, rows)`` with the winners'
    (R, 32) shade rows; channel 31 carries the mesh id as a float value and
    misses get all-zero rows (None for any-hit queries)."""
    if origin.device.type == "cuda":
        walk = walk_cuda
    elif origin.device.type == "cpu":
        walk = walk_plain
    else:
        raise ValueError(f"no walk for device {origin.device}")
    q = pack_query(origin, direction, ignore_tri, ignore_mesh, t_max,
                   tile_size)
    out = walk(scene.clusters, scene.tri_shade, q, cull=cull,
               any_hit=any_hit)
    hit, rows = assemble_hit(out, origin.shape[0], any_hit)
    return (hit, rows) if return_rows else hit


# ---- The plain PyTorch walk -------------------------------------------------


def _interval(s_lo, s_hi, inv_lo, inv_hi, lo_pos, hi_pos, lo_neg, hi_neg):
    """Conservative [lo, hi] of t >= 0 with t*g in [s_lo, s_hi] for some g
    in [g_lo, g_hi] (given by reciprocals and signs)."""
    pos = s_lo > 0.0
    neg = s_hi < 0.0
    lo = torch.where(
        pos, torch.where(hi_pos, s_lo * inv_hi, INF),
        torch.where(neg, torch.where(lo_neg, s_hi * inv_lo, INF), 0.0))
    hi_same = torch.where(lo_pos, s_hi * inv_lo,
                          torch.where(hi_neg, s_lo * inv_hi, INF))
    hi = torch.where(
        pos, torch.where(lo_pos, s_hi * inv_lo, INF),
        torch.where(neg, torch.where(hi_neg, s_lo * inv_hi, INF), hi_same))
    return lo, hi


def _recip_nonzero(x):
    return 1.0 / torch.where(x == 0.0, 1.0, x)


def _entry_bounds(aabb, plane, finite, o3, d3, wcap):
    """(n, ncg) conservative entry bounds of every cluster for each tile's
    beam (the box of its finite rays): the slab interval intersected with
    the fitted-plane interval; INF where infeasible or at/after ``wcap``."""
    any_m = finite.any(1, keepdim=True)

    def bound(a, fill, default, reduce):
        return torch.where(any_m, reduce(torch.where(finite, a, fill)),
                           default)

    amin = lambda a: a.amin(1, keepdim=True)  # noqa: E731
    amax = lambda a: a.amax(1, keepdim=True)  # noqa: E731
    o_min = [bound(a, INF, 0.0, amin) for a in o3]
    o_max = [bound(a, -INF, 0.0, amax) for a in o3]
    d_min = [bound(a, INF, 1.0, amin) for a in d3]
    d_max = [bound(a, -INF, 1.0, amax) for a in d3]

    n, ncg = finite.shape[0], aabb.shape[1]
    t_lo = torch.zeros((n, ncg), dtype=aabb.dtype, device=aabb.device)
    t_hi = torch.full((n, ncg), INF, dtype=aabb.dtype, device=aabb.device)
    for k in range(3):
        d_lo, d_hi = d_min[k], d_max[k]
        lo, hi = _interval(aabb[k] - o_max[k], aabb[3 + k] - o_min[k],
                           _recip_nonzero(d_lo), _recip_nonzero(d_hi),
                           d_lo > 0.0, d_hi > 0.0, d_lo < 0.0, d_hi < 0.0)
        t_lo = torch.maximum(t_lo, lo)
        t_hi = torch.minimum(t_hi, hi)
    g_lo = torch.zeros_like(t_lo)
    g_hi = torch.zeros_like(t_lo)
    o_dlo = torch.zeros_like(t_lo)
    o_dhi = torch.zeros_like(t_lo)
    for k in range(3):
        p, q = plane[k] * d_min[k], plane[k] * d_max[k]
        g_lo = g_lo + torch.minimum(p, q)
        g_hi = g_hi + torch.maximum(p, q)
        c1, c2 = plane[k] * o_min[k], plane[k] * o_max[k]
        o_dlo = o_dlo + torch.minimum(c1, c2)
        o_dhi = o_dhi + torch.maximum(c1, c2)
    a_ = (plane[3] - o_dhi) - plane[4]
    b_ = (plane[3] - o_dlo) + plane[4]
    lo, hi = _interval(a_, b_, _recip_nonzero(g_lo), _recip_nonzero(g_hi),
                       g_lo > 0.0, g_hi > 0.0, g_lo < 0.0, g_hi < 0.0)
    t_lo = torch.maximum(t_lo, lo)
    t_hi = torch.minimum(t_hi, hi)
    feasible = (t_lo <= t_hi) & (t_lo < INF) & (t_lo < wcap[:, None])
    return torch.where(feasible & any_m, t_lo, INF)


def _pick(ent, idx):
    """Nearest remaining entry of tiles ``idx`` (lowest cluster id on equal
    entries); consumes it.  Returns (entry, cluster id)."""
    e = ent[idx]
    k = e.argmin(1)
    v = e.gather(1, k[:, None])[:, 0]
    ent[idx, k] = INF
    return v, k


def _walk_tiles(cl, tri_shade, o, d, tmax_in, itri, imesh, cull, any_hit):
    """Walk n whole tiles: ``o``/``d`` (n, ts, 3), the rest (n, ts)."""
    block, root = cl["block"], cl["root"]
    csize = block.shape[2]
    dev = o.device
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    finite = (torch.isfinite(ox) & torch.isfinite(oy) & torch.isfinite(oz)
              & torch.isfinite(dx) & torch.isfinite(dy) & torch.isfinite(dz))

    # Root-box t cap per ray.
    margin = root[6]
    t_en = torch.full_like(ox, -INF)
    t_ex = torch.full_like(ox, INF)
    for k, (ok_, dk) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        safe_d = torch.where(dk == 0.0, _TINY_DIR, dk)
        t1 = (root[k] - margin - ok_) / safe_d
        t2 = (root[3 + k] + margin - ok_) / safe_d
        t_en = torch.maximum(t_en, torch.minimum(t1, t2))
        t_ex = torch.minimum(t_ex, torch.maximum(t1, t2))
    root_hit = (t_en <= t_ex) & (t_ex >= 0.0)
    cap = torch.where(root_hit, t_ex * _CAP_SCALE + margin, 0.0)
    cap = torch.where(torch.isfinite(cap), cap, 0.0)
    tmax0 = torch.minimum(tmax_in, cap)

    ent = _entry_bounds(cl["aabb"], cl["plane"], finite, (ox, oy, oz),
                        (dx, dy, dz), tmax0.amax(1))

    n = tmax0.shape[0]
    bt = tmax0.clone()
    bc = torch.full_like(itri, -1)
    if not any_hit:
        bu = torch.zeros_like(bt)
        bv = torch.zeros_like(bt)
        bd = torch.ones_like(bt)
        bi = torch.full_like(itri, -1)
    resolved = ~finite | ~(tmax0 > 0.0)
    wx = dy * oz - dz * oy
    wy = dz * ox - dx * oz
    wz = dx * oy - dy * ox

    tiles = torch.arange(n, device=dev)
    cur_v, cur_k = _pick(ent, tiles)
    live = cur_v < INF
    while bool(live.any()):
        idx = tiles[live]
        k = cur_k[idx]
        g = block[k, :GEO_ROWS]  # (m, 18, C)
        row = lambda i: g[:, i, None, :]  # noqa: E731  (m, 1, C)
        col = lambda x: x[idx][:, :, None]  # noqa: E731  (m, ts, 1)
        rdx, rdy, rdz = col(dx), col(dy), col(dz)
        rwx, rwy, rwz = col(wx), col(wy), col(wz)
        nx, ny, nz = row(0), row(1), row(2)
        det = rdx * nx + rdy * ny + rdz * nz
        udet = (rwx * row(6) + rwy * row(7) + rwz * row(8)
                + rdx * row(3) + rdy * row(4) + rdz * row(5))
        vdet = (rwx * row(12) + rwy * row(13) + rwz * row(14)
                + rdx * row(9) + rdy * row(10) + rdz * row(11))
        tdet = row(15) - (col(ox) * nx + col(oy) * ny + col(oz) * nz)
        tid = g[:, 16].view(torch.int32)[:, None, :]
        keep = (tid != col(itri)) & (g[:, 17].view(torch.int32)[:, None, :]
                                     != col(imesh))
        if any_hit:
            ok = keep & det_space_accept_within(det, udet, vdet, tdet,
                                                col(tmax0), cull)
            bc[idx] = torch.where(ok.any(2), 0, bc[idx])
        else:
            ok = keep & det_space_accept(det, udet, vdet, tdet, cull)
            dist = torch.where(ok, tdet / det, INF)
            lane = dist.argmin(2, keepdim=True)  # first lane on ties
            take = lambda q: q.expand_as(dist).gather(2, lane)[..., 0]  # noqa: E731
            mint = take(dist)
            upd = mint < bt[idx]
            code = (k[:, None] * csize + lane[..., 0]).to(bc.dtype)
            bt[idx] = torch.where(upd, mint, bt[idx])
            bc[idx] = torch.where(upd, code, bc[idx])
            bu[idx] = torch.where(upd, take(udet), bu[idx])
            bv[idx] = torch.where(upd, take(vdet), bv[idx])
            bd[idx] = torch.where(upd, take(det), bd[idx])
            bi[idx] = torch.where(upd, take(tid), bi[idx])
        nv, nk = _pick(ent, idx)
        if any_hit:
            settle = (bc[idx] >= 0) | (tmax0[idx] <= nv[:, None])
        else:
            settle = bt[idx] <= nv[:, None]
        res = resolved[idx] | settle
        resolved[idx] = res
        live[idx] = (nv < INF) & ~res.all(1)
        cur_v[idx] = nv
        cur_k[idx] = nk

    if any_hit:
        return WalkOut(t=torch.where(bc >= 0, 0.0, bt), code=bc)
    hit = bc >= 0
    safe_det = torch.where(hit, bd, 1.0)
    srow = tri_shade[bi.clamp(min=0)]
    mesh = srow[..., 31].contiguous().view(torch.int32).to(srow.dtype)
    rows = torch.cat([srow[..., :31], mesh[..., None]], dim=-1)
    rows = torch.where(hit[..., None], rows, 0.0)
    return WalkOut(t=bt, code=bc, u=bu / safe_det, v=bv / safe_det, tri=bi,
                   rows=rows)


def walk_plain(clusters, tri_shade, q: Query, *, cull, any_hit: bool):
    """The walk in plain PyTorch, on any device; tiles are independent and
    run in chunks that bound the pair temporaries."""
    ts = q.tile
    nt = q.origin.shape[0] // ts
    ncg, _, csize = clusters["block"].shape
    step = max(1, min(_PAIR_BUDGET // (ts * csize), _PAIR_BUDGET // ncg))
    parts = []
    for s in range(0, nt, step):
        sl = slice(s * ts, min(s + step, nt) * ts)
        m = (sl.stop - sl.start) // ts
        parts.append(_walk_tiles(
            clusters, tri_shade,
            q.origin[sl].reshape(m, ts, 3), q.direction[sl].reshape(m, ts, 3),
            q.t_max[sl].reshape(m, ts), q.ignore_tri[sl].reshape(m, ts),
            q.ignore_mesh[sl].reshape(m, ts), cull, any_hit))
    return WalkOut(*(None if xs[0] is None else
                     torch.cat([x.flatten(0, 1) for x in xs])
                     for xs in zip(*parts)))


# ---- The CUDA kernels -------------------------------------------------------


def _smem_bytes(ncg: int, csize: int) -> int:
    """Dynamic shared memory of one walk block: the entry table and one
    staged cluster block."""
    return 4 * (ncg + GEO_ROWS * csize)


def _check(name, x, dev, dtype, shape):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the rays on {dev}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _validate(clusters, tri_shade, q: Query, cull):
    """The checks the kernel's wrapper makes before a launch: every tensor on
    the rays' device, of the kernel's dtype and shape, contiguous."""
    if cull not in _CULL_CODE:
        raise ValueError(f"cull must be True, False or 'reverse', got {cull!r}")
    block = clusters["block"]
    r, ts = q.origin.shape[0], q.tile
    ncg, _, csize = block.shape
    f32, i32 = torch.float32, torch.int32
    if not 1 <= ts <= 1024 or r % ts:
        raise ValueError(f"tile {ts} must be in [1, 1024] and divide {r} rays")
    for name, x, dtype, shape in (
            ("origin", q.origin, f32, (r, 3)),
            ("direction", q.direction, f32, (r, 3)),
            ("t_max", q.t_max, f32, (r,)),
            ("ignore_tri", q.ignore_tri, i32, (r,)),
            ("ignore_mesh", q.ignore_mesh, i32, (r,)),
            ("block", block, f32, (ncg, 24, csize)),
            ("aabb", clusters["aabb"], f32, (6, ncg)),
            ("plane", clusters["plane"], f32, (5, ncg)),
            ("root", clusters["root"], f32, (8,)),
            ("tri_shade", tri_shade, f32, (tri_shade.shape[0], 32))):
        _check(name, x, q.origin.device, dtype, shape)
    if _smem_bytes(ncg, csize) > SMEM_LIMIT:
        raise ValueError(
            f"{ncg} clusters of {csize} need {_smem_bytes(ncg, csize)} bytes "
            f"of shared memory per block; the limit is {SMEM_LIMIT}")


def walk_cuda(clusters, tri_shade, q: Query, *, cull, any_hit: bool):
    """Launch the walk kernel of ``csrc/walk.cu`` on the current stream.

    Replaces ``raytpu/kernels/fused.py``'s ``_tlane_kernel`` (nearest) and
    ``_fused_kernel`` with ``any_hit=True``; see the source for what bounds
    it on the card."""
    from raytpu_torch.kernels.build import load_library

    dev = q.origin.device
    if dev.type != "cuda":
        raise ValueError(f"walk_cuda needs CUDA tensors, got {dev}")
    _validate(clusters, tri_shade, q, cull)
    block, aabb = clusters["block"], clusters["aabb"]
    plane, root = clusters["plane"], clusters["root"]
    r, ts = q.origin.shape[0], q.tile
    ncg, _, csize = block.shape
    f32, i32 = torch.float32, torch.int32
    lib = load_library()
    p = lambda x: x.data_ptr()  # noqa: E731
    t = torch.empty((r,), dtype=f32, device=dev)
    code = torch.empty((r,), dtype=i32, device=dev)
    common = (p(q.origin), p(q.direction), p(q.t_max), p(q.ignore_tri),
              p(q.ignore_mesh), r, ts, p(root), p(aabb), p(plane), p(block),
              ncg, csize)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if any_hit:
            rc = lib.rt_any_hit(*common, _CULL_CODE[cull], p(t), p(code),
                                stream)
            out = WalkOut(t=t, code=code)
        else:
            u = torch.empty((r,), dtype=f32, device=dev)
            v = torch.empty((r,), dtype=f32, device=dev)
            tri = torch.empty((r,), dtype=i32, device=dev)
            rows = torch.empty((r, 32), dtype=f32, device=dev)
            rc = lib.rt_nearest_hit(*common, p(tri_shade), _CULL_CODE[cull],
                                    p(t), p(code), p(u), p(v), p(tri),
                                    p(rows), stream)
            out = WalkOut(t=t, code=code, u=u, v=v, tri=tri, rows=rows)
    if rc != 0:
        raise RuntimeError(
            f"walk kernel launch failed: {lib.rt_error_string(rc).decode()}")
    LAUNCHES["any_hit" if any_hit else "nearest"] += 1
    return out
