"""The walk kernels' roofline over whole frames.

The least time the card could take for one walk call is the larger of

- operations over ``PEAK_OPS`` (FP32 lane operations: 132 SMs x 128 lanes
  x ~1.98 GHz; the kernels are built with -fmad=false), and
- bytes over ``PEAK_BYTES`` (HBM of the H100 SXM), each input read once
  and each output written once.

Frozen at commit ee2838e from ``chip_smoke.py``: the peaks, the operations
a ray-triangle pair needs by how far the pair test's early-outs take it
(``OPS_DET``, ``OPS_U``, ``OPS_PAIR``: walk_common.cuh's det and u*det
sign tests, then the rest), and the byte count of ``walk_bound``.

Which pairs a call needs is worked out here from the call's rays and the
bake's block boxes alone, not from how the walk visits them: a nearest
ray must test every triangle of every block its ray enters before its hit
(or anywhere, on a miss), an occlusion ray without a hit every block its
segment enters; an occlusion ray with a hit is counted at nothing, since
one block may prove it.  Any exact walk over these blocks tests at least
these pairs.  Their early-out stages are those of the pair test on the
block's det-space rows (accel/clusters.py: det = d . N, u*det = w . E2n +
d . M1n, w = d x o), counted on a fixed sample of the pairs.
"""

from __future__ import annotations

import contextlib

import torch

PEAK_OPS = 33.5e12
PEAK_BYTES = 3.35e12
OPS_PAIR = {False: 43, True: 44}
OPS_DET = 6
OPS_U = 12
SAMPLE_BLOCKS = 1 << 16   # (ray, block) pairs whose stages are counted
_TINY_DIR = 1e-30
INF = float("inf")


@contextlib.contextmanager
def recorded_walks():
    """Inside, every ``nearest_hit_fused`` call of the program is recorded:
    yields a list of dicts (its rays, t bound, cull, any-hit, tile and the
    hits it returned)."""
    from raytpu_torch.kernels import fused

    calls, inner = [], fused.nearest_hit_fused

    def wrapper(scene, origin, direction, ignore_tri=None, ignore_mesh=None,
                cull=True, tile_size=256, t_max=None, any_hit=False, **kw):
        out = inner(scene, origin, direction, ignore_tri, ignore_mesh, cull,
                    tile_size=tile_size, t_max=t_max, any_hit=any_hit, **kw)
        hit = out if hasattr(out, "hit") else out[0]
        calls.append({"clusters": scene.clusters, "origin": origin.detach(),
                      "direction": direction.detach(),
                      "t_max": None if t_max is None else t_max.detach(),
                      "cull": cull, "any_hit": any_hit, "tile": tile_size,
                      "hit": hit.hit, "t": hit.t,
                      "rows": bool(kw.get("return_rows"))})
        return out

    fused.nearest_hit_fused = wrapper
    try:
        yield calls
    finally:
        fused.nearest_hit_fused = inner


def _entries(cl, o, d):
    """Entry and exit distances (R, NCG) of rays into the blocks: their
    boxes, intersected with their fitted planes' slabs where the bake has
    them (accel/clusters.py: every vertex p of a block has |p . n - d0| <=
    eps), as the walk's own entry bounds are."""
    aabb = cl["aabb"]
    inv = 1.0 / torch.where(d == 0.0, _TINY_DIR, d)
    t1 = (aabb[None, 0:3].transpose(1, 2) - o[:, None]) * inv[:, None]
    t2 = (aabb[None, 3:6].transpose(1, 2) - o[:, None]) * inv[:, None]
    en = torch.minimum(t1, t2).amax(-1)
    ex = torch.maximum(t1, t2).amin(-1)
    if "plane" in cl:
        n, d0, eps = cl["plane"][0:3], cl["plane"][3], cl["plane"][4]
        s = o[:, 0:1] * n[0] + o[:, 1:2] * n[1] + o[:, 2:3] * n[2]
        k = d[:, 0:1] * n[0] + d[:, 1:2] * n[1] + d[:, 2:3] * n[2]
        inside = (s - d0).abs() <= eps
        kk = torch.where(k == 0.0, _TINY_DIR, k)
        p1, p2 = (d0 - eps - s) / kk, (d0 + eps - s) / kk
        lo = torch.where(k == 0.0, torch.where(inside, -INF, INF),
                         torch.minimum(p1, p2))
        hi = torch.where(k == 0.0, torch.where(inside, INF, -INF),
                         torch.maximum(p1, p2))
        en, ex = torch.maximum(en, lo), torch.minimum(ex, hi)
    return en, ex


def needed_blocks(call, budget=1 << 23):
    """The (ray, block) pairs a call needs: each live ray with every block
    it enters before its cap (module docstring), strictly."""
    cl = call["clusters"]
    ncg = cl["aabb"].shape[1]
    o, d = call["origin"].float(), call["direction"].float()
    r0, dev = o.shape[0], o.device
    tmax = (torch.full((r0,), float("inf"), device=dev)
            if call["t_max"] is None else call["t_max"].float())
    if call["any_hit"]:
        cap = torch.where(call["hit"], -1.0, tmax)
    else:
        cap = torch.where(call["hit"], call["t"].float(), tmax)
    live = (torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
            & (cap >= 0)).nonzero().squeeze(1)
    pair_ray, pair_blk = [live[:0]], [live[:0]]
    step = max(1, budget // ncg)
    for s in range(0, live.shape[0], step):
        idx = live[s:s + step]
        en, ex = _entries(cl, o[idx], d[idx])
        need = (en <= ex) & (ex >= 0.0) & (en < cap[idx, None])
        i, j = need.nonzero(as_tuple=True)
        pair_ray.append(idx[i])
        pair_blk.append(j)
    return torch.cat(pair_ray), torch.cat(pair_blk)


def call_bound(call, gen=None):
    """(operations, bytes) of one walk call."""
    block = call["clusters"]["block"]
    ncg, _, csize = block.shape
    o, d = call["origin"].float(), call["direction"].float()
    r0, dev = o.shape[0], o.device
    any_hit = call["any_hit"]
    ray, blk = needed_blocks(call)
    n_pairs = ray.shape[0] * csize
    ops = 0.0
    if n_pairs:
        pick = torch.randperm(ray.shape[0], generator=gen,
                              device="cpu")[:SAMPLE_BLOCKS].to(dev)
        rs, bs = ray[pick], blk[pick]
        g = block[bs, :9]                              # (S, 9, L)
        dd = d[rs][:, :, None]
        w = torch.linalg.cross(d[rs], o[rs])[:, :, None]
        det = dd[:, 0] * g[:, 0] + dd[:, 1] * g[:, 1] + dd[:, 2] * g[:, 2]
        udet = (w[:, 0] * g[:, 6] + w[:, 1] * g[:, 7] + w[:, 2] * g[:, 8]
                + dd[:, 0] * g[:, 3] + dd[:, 1] * g[:, 4] + dd[:, 2] * g[:, 5])
        if call["cull"] == "reverse":
            d_ok, u_ok = det > 0, (udet >= 0) & (det > 0)
        elif call["cull"]:
            d_ok, u_ok = det < 0, (udet <= 0) & (det < 0)
        else:
            sgn = torch.where(det < 0, -1.0, 1.0)
            d_ok, u_ok = det != 0, (udet * sgn >= 0) & (det * sgn > 0)
        share_d = float(d_ok.float().mean())
        share_u = float(u_ok.float().mean())
        ops = n_pairs * (OPS_DET + share_d * OPS_U
                         + share_u * (OPS_PAIR[any_hit] - OPS_DET - OPS_U))
    tile = min(call["tile"], r0)
    r = -(-r0 // tile) * tile
    nbytes = (r * 36 + ncg * (6 + 11 + 18 * csize) * 4 + 32 + (r // tile) * 12
              + r * (12 if any_hit else 24))
    if call["rows"] and not any_hit:
        nbytes += r * 128 + int(call["hit"].sum()) * 128
    return ops, nbytes


def bound_ms(calls) -> float:
    """The least time of a list of walk calls, in milliseconds: each call's
    larger bound, summed."""
    gen = torch.Generator().manual_seed(0)
    total = 0.0
    for call in calls:
        ops, nbytes = call_bound(call, gen)
        total += max(ops / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3
    return total
