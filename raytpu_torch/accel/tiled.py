"""The tiled query: cull clusters per ray tile, then test dense chunks of
clusters front to back (raytpu/accel/tiled.py:40-313), in plain PyTorch.

1. **Tile summary**: rays are grouped into tiles of ``tile_size``, each
   summarised by the box of its finite rays' origins and directions.
2. **Conservative cull**: one interval slab test per (tile, leaf cluster)
   pair gives a may-hit mask and a lower bound on the entry distance.
3. **Front-to-back chunks**: each tile sorts its candidates by entry bound
   (stable: equal bounds in cluster order) and walks them ``chunk``
   clusters at a time, testing every ray of the tile against every
   triangle of the chunk (division-form Möller–Trumbore, strict-min
   update) until every ray's best hit is at or before the next chunk's
   entry bound (any-hit: found or provably clear) or the list runs out.

The result is the exact nearest hit; an exact-t tie goes to the cluster
visited first, then to the lowest slot.  The JAX package advances all tiles
in lockstep inside one ``while_loop``; here the tiles are cut into groups
whose (rays, triangles) temporaries stay within ``PAIR_BUDGET`` pairs, each
group walking in lockstep on its own with one host read per step.  Tiles
are independent, so the grouping changes no result.
"""

from __future__ import annotations

import torch

from raytpu_torch.accel.traverse import FLOAT_MAX, PAIR_BUDGET, Hit
from raytpu_torch.core.intersect import facing_gate, moller_trumbore

INF = FLOAT_MAX


def cull_clusters(o_min, o_max, d_min, d_max, cl_min, cl_max):
    """Conservative (tiles, clusters) may-hit test: ``o_min``..``d_max``
    (NT, 3) tile bounds, ``cl_min``/``cl_max`` (NC, 3).  Returns (mask,
    entry lower bound), (NT, NC) each; the bound is INF outside the mask.
    Per axis the interval of t >= 0 with t*d in [s_lo, s_hi] for some d in
    the tile's direction interval, division-free but for the per-tile
    reciprocals of the direction bounds."""
    big = INF
    t_lo = o_min.new_zeros((o_min.shape[0], cl_min.shape[0]))
    t_hi = torch.full_like(t_lo, big)
    for k in range(3):
        d_lo = d_min[:, None, k]
        d_hi = d_max[:, None, k]
        inv_hi = 1.0 / torch.where(d_hi == 0.0, 1.0, d_hi)
        inv_lo = 1.0 / torch.where(d_lo == 0.0, 1.0, d_lo)
        hi_pos = d_hi > 0.0
        lo_pos = d_lo > 0.0
        lo_neg = d_lo < 0.0
        hi_neg = d_hi < 0.0
        s_lo = cl_min[None, :, k] - o_max[:, None, k]
        s_hi = cl_max[None, :, k] - o_min[:, None, k]
        pos = s_lo > 0.0  # cluster strictly ahead along +k
        neg = s_hi < 0.0  # strictly behind (reachable only with d < 0)
        lo_k = torch.where(
            pos, torch.where(hi_pos, s_lo * inv_hi, big),
            torch.where(neg, torch.where(lo_neg, s_hi * inv_lo, big), 0.0))
        hi_same = torch.where(lo_pos, s_hi * inv_lo,
                              torch.where(hi_neg, s_lo * inv_hi, big))
        hi_k = torch.where(
            pos, torch.where(lo_pos, s_hi * inv_lo, big),
            torch.where(neg, torch.where(hi_neg, s_lo * inv_hi, big),
                        hi_same))
        t_lo = torch.maximum(t_lo, lo_k)
        t_hi = torch.minimum(t_hi, hi_k)
    mask = (t_lo <= t_hi) & (t_lo < big)
    return mask, torch.where(mask, t_lo, INF)


def _pad_to_tiles(a, tile, fill):
    pad = (-a.shape[0]) % tile
    if pad:
        a = torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])
    return a


def prepare_tiles(scene, origin, direction, ignore_tri, ignore_mesh, t_max,
                  tile_size: int):
    """Pad the ray batch to whole tiles (origin 0, direction 1, t bound 0,
    as the JAX package pads), cap each ray's bound at the exit of the
    scene's root box (with a margin), and cull the leaf clusters.

    Returns ``(o, d, itri, imesh, tmax)`` shaped (NT, TS[, 3]) and the
    ``(mask, entry)`` of ``cull_clusters``, pruned at each tile's largest
    bound."""
    cl = scene.clusters
    r, dev = origin.shape[0], origin.device
    if ignore_tri is None:
        ignore_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    if ignore_mesh is None:
        ignore_mesh = torch.full((r,), -1, dtype=torch.int32, device=dev)
    if t_max is None:
        t_max = torch.full((r,), INF, dtype=torch.float32, device=dev)
    ts = min(tile_size, max(r, 1))
    o = _pad_to_tiles(origin.to(torch.float32), ts, 0.0)
    d = _pad_to_tiles(direction.to(torch.float32), ts, 1.0)
    itri = _pad_to_tiles(ignore_tri.to(torch.int32), ts, -1)
    imesh = _pad_to_tiles(ignore_mesh.to(torch.int32), ts, -1)
    tmax = _pad_to_tiles(t_max.to(torch.float32), ts, 0.0).reshape(-1, ts)
    nt = o.shape[0] // ts
    o = o.reshape(nt, ts, 3)
    d = d.reshape(nt, ts, 3)
    itri = itri.reshape(nt, ts)
    imesh = imesh.reshape(nt, ts)

    # Non-finite rays (the reference's TIR refraction rays) never hit;
    # they stay out of the tile bounds.
    finite = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
    fo = torch.where(finite[..., None], o, 0.0)
    fd = torch.where(finite[..., None], d, 0.0)
    big = torch.where(finite[..., None], 0.0, INF)
    o_min = (fo + big).amin(1)
    o_max = (fo - big).amax(1)
    d_min = (fd + big).amin(1)
    d_max = (fd - big).amax(1)
    any_finite = finite.any(1)[:, None]
    o_min = torch.where(any_finite, o_min, 0.0)
    o_max = torch.where(any_finite, o_max, 0.0)
    d_min = torch.where(any_finite, d_min, 1.0)
    d_max = torch.where(any_finite, d_max, 1.0)

    # Per-ray search bound from the scene's root box: every triangle lies
    # inside it, so a hit lies before its exit (with a margin for float
    # error); rays that miss it get bound 0.
    root = cl["root"]
    margin = root[6]
    safe_d = torch.where(d == 0.0, 1e-30, d)
    t1 = (root[0:3] - margin - o) / safe_d
    t2 = (root[3:6] + margin - o) / safe_d
    t_en = torch.minimum(t1, t2).amax(-1)
    t_ex = torch.maximum(t1, t2).amin(-1)
    root_hit = (t_en <= t_ex) & (t_ex >= 0.0)
    cap = torch.where(root_hit, t_ex * (1.0 + 1e-5) + margin, 0.0)
    cap = torch.where(torch.isfinite(cap), cap, 0.0)
    tmax = torch.minimum(tmax, cap)

    mask, entry = cull_clusters(o_min, o_max, d_min, d_max,
                                cl["cluster_min"], cl["cluster_max"])
    # Clusters entirely beyond every ray's bound can never matter.
    mask &= entry < tmax.amax(1)[:, None]
    entry = torch.where(mask, entry, INF)
    return (o, d, itri, imesh, tmax), (mask, entry)


def lockstep_chunks(cl, o, d, itri, imesh, cand, keys, counts, chunk: int,
                    cull, init, start: int = 0, any_hit: bool = False,
                    tmax0=None):
    """Front-to-back chunk scan of tiles (NT, TS) over their sorted
    candidates ``cand``/``keys`` (NT, NC) in lockstep: a tile's rays stop
    updating once it is done (candidates exhausted, or settled: every ray's
    best at or before the next chunk's entry bound; any-hit: every ray found
    a hit within ``tmax0`` or has ``tmax0`` at or before that bound).
    ``init``: the (done, best_t, best_u, best_v, best_tri) starting state;
    ``start``: the chunk to begin at.  A chunk's slice of the candidate
    list is clamped to stay inside it, as ``jax.lax.dynamic_slice`` does.
    Returns (best_t, best_u, best_v, best_tri)."""
    nt, ts = o.shape[:2]
    nc = cand.shape[1]
    csize = cl["tri_v1"].shape[0] // cl["cluster_min"].shape[0]
    max_chunks = -(-nc // chunk)
    cc = chunk * csize  # triangles per chunk
    lanes = torch.arange(csize, dtype=torch.int32, device=o.device)
    done, best_t, best_u, best_v, best_tri = (x.clone() for x in init)
    o4, d4 = o[:, :, None, :], d[:, :, None, :]
    i = start
    while i < max_chunks and bool((~done).any()):
        s = min(i * chunk, nc - chunk)
        cid = cand[:, s:s + chunk]
        slot = (cid[:, :, None] * csize + lanes).reshape(nt, cc).long()
        tid = cl["tri_id"][slot]
        ok, u, v, dist = moller_trumbore(o4, d4, cl["tri_v1"][slot][:, None],
                                         cl["tri_e1"][slot][:, None],
                                         cl["tri_e2"][slot][:, None])
        if cull:
            ok &= facing_gate(cl["tri_snormal"][slot][:, None], d4, cull)
        ok &= tid[:, None, :] >= 0
        ok &= tid[:, None, :] != itri[:, :, None]
        ok &= cl["tri_mesh"][slot][:, None, :] != imesh[:, :, None]
        ok &= ~done[:, None, None]
        dist = torch.where(ok, dist, INF)
        j = dist.argmin(2, keepdim=True)  # the first slot on ties
        t_c = dist.gather(2, j)[..., 0]
        upd = t_c < best_t
        best_t = torch.where(upd, t_c, best_t)
        best_u = torch.where(upd, u.gather(2, j)[..., 0], best_u)
        best_v = torch.where(upd, v.gather(2, j)[..., 0], best_v)
        best_tri = torch.where(upd, tid.gather(1, j[..., 0]), best_tri)
        nxt = i + 1
        exhausted = nxt * chunk >= counts
        next_entry = (keys[:, min(nxt * chunk, nc - 1)] if nxt * chunk < nc
                      else torch.full_like(keys[:, 0], INF))
        if any_hit:
            settled = ((best_t < tmax0)
                       | (tmax0 <= next_entry[:, None])).all(1)
        else:
            settled = (best_t <= next_entry[:, None]).all(1)
        done = done | exhausted | settled
        i = nxt
    return best_t, best_u, best_v, best_tri


def nearest_hit_tiled(scene, origin, direction, ignore_tri=None,
                      ignore_mesh=None, cull=True, tile_size: int = 1024,
                      chunk: int = 1, t_max=None,
                      any_hit: bool = False) -> Hit:
    """Exact nearest hit by the tiled cull and front-to-back dense chunks
    (module docstring).  ``t_max`` (per ray) bounds the search: hits at or
    beyond it are not reported, and a tile stops once the next chunk's
    entry bound passes every ray's bound.  ``any_hit``: a tile settles once
    each ray has found some hit within its bound or is provably clear; the
    reported hit need not be the nearest."""
    cl = scene.clusters
    nc = cl["cluster_min"].shape[0]
    r = origin.shape[0]
    (o, d, itri, imesh, tmax), (mask, entry) = prepare_tiles(
        scene, origin, direction, ignore_tri, ignore_mesh, t_max, tile_size)
    nt, ts = o.shape[:2]
    csize = cl["tri_v1"].shape[0] // nc
    chunk = max(1, min(chunk, nc))
    keys, cand = torch.sort(entry, dim=1, stable=True)
    counts = mask.sum(1)
    outs = []
    step = max(1, PAIR_BUDGET // (ts * chunk * csize))
    for s in range(0, nt, step):
        sl = slice(s, s + step)
        zero = torch.zeros_like(tmax[sl])
        init = (counts[sl] == 0, zero + tmax[sl], zero, zero,
                torch.full_like(itri[sl], -1))
        outs.append(lockstep_chunks(
            cl, o[sl], d[sl], itri[sl], imesh[sl], cand[sl], keys[sl],
            counts[sl], chunk, cull, init, any_hit=any_hit, tmax0=tmax[sl]))
    bt, bu, bv, btri = (torch.cat(x).reshape(-1)[:r] for x in zip(*outs))
    hit = btri >= 0
    return Hit(hit=hit, t=torch.where(hit, bt, INF), u=bu, v=bv, tri=btri)
