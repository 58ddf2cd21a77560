"""Per-(block, light) shadow clearance (``cfg.shadow_clearance``): the
port's copy of raytpu/accel/shadowcull.py:61-222, in plain PyTorch.

For a geometry block ``b`` and a positionable light ``L`` the clearance
distance

    D(b) = min over blocks b' != b that meet the cone hull(L, AABB_b) of
           dist(L, AABB_b')        (INF if none)

bounds from below the distance from ``L`` of every occluder, outside ``b``,
of a segment from ``L`` to a point of ``b`` (a conservative per-axis
interval test, the case analysis of the tiled cull).  So every occluder of
such a segment lies at least ``min(D(b), the entry of b's own box along
the ray)`` from the light, and the reversed shadow query may start there
with its bound shortened to match: exact, and the walk then skips every
cluster between the light and the fragment's neighbourhood.  For a
directional light the analogue sweeps a cylinder along the shared
direction: ``D'(b)`` bounds from below, measured from the fragment, every
occluder outside ``b``; when it is INF the query may stop at the exit of
the fragment's own block.

The tables are computed on every frame, as one (NCB, NCB) interval sweep
in row chunks, so a moving light or refitted geometry never reads a stale
one.
"""

from __future__ import annotations

import torch

from raytpu_torch.accel.traverse import FLOAT_MAX

INF = FLOAT_MAX


def _block_aabbs(cl):
    """(NCB, 3) block boxes: the leaf boxes ``cluster_min``/``cluster_max``
    combined over the leaves of each block of a subcluster bake."""
    mn, mx = cl["cluster_min"], cl["cluster_max"]
    ncb = cl["block"].shape[0]
    if mn.shape[0] != ncb:
        sk = mn.shape[0] // ncb
        mn = mn.reshape(ncb, sk, 3).amin(1)
        mx = mx.reshape(ncb, sk, 3).amax(1)
    return mn, mx


def _interval_t(b_lo, b_hi, c_lo, c_hi):
    """Conservative [t_lo, t_hi] of {t >= 0 : t*[b_lo, b_hi] meets
    [c_lo, c_hi]}: one axis of the cone test."""
    inv_hi = 1.0 / torch.where(b_hi == 0.0, 1.0, b_hi)
    inv_lo = 1.0 / torch.where(b_lo == 0.0, 1.0, b_lo)
    hi_pos = b_hi > 0.0
    lo_pos = b_lo > 0.0
    lo_neg = b_lo < 0.0
    hi_neg = b_hi < 0.0
    pos = c_lo > 0.0
    neg = c_hi < 0.0
    t_lo = torch.where(
        pos, torch.where(hi_pos, c_lo * inv_hi, INF),
        torch.where(neg, torch.where(lo_neg, c_hi * inv_lo, INF), 0.0))
    hi_same = torch.where(lo_pos, c_hi * inv_lo,
                          torch.where(hi_neg, c_lo * inv_hi, INF))
    t_hi = torch.where(
        pos, torch.where(lo_pos, c_hi * inv_lo, INF),
        torch.where(neg, torch.where(hi_neg, c_lo * inv_hi, INF), hi_same))
    return t_lo, t_hi


def _chunked_rows(chunk, ncb, rows):
    """The (NCB,) result of ``chunk(start)`` over row windows of ``rows``;
    the last window is shifted back to stay in bounds (its overlapping rows
    compute the same values again)."""
    rows = min(rows, ncb)
    out = None
    for s in range(0, ncb, rows):
        start = min(s, ncb - rows)
        part = chunk(start)
        if out is None:
            out = part.new_zeros((ncb,))
        out[start:start + rows] = part
    return out


def clearance_spot(cl, light_pos, rows_per_chunk: int = 256):
    """(NCB,) clearance distances D(b) for a light at ``light_pos``
    (module docstring); INF where no other block can occlude."""
    mn, mx = _block_aabbs(cl)
    ncb = mn.shape[0]
    lp = torch.as_tensor(light_pos, dtype=torch.float32, device=mn.device)
    b_lo = mn - lp  # (NCB, 3) block intervals relative to the light
    b_hi = mx - lp
    # Distance from the light to each candidate occluder block.
    near = torch.minimum(torch.maximum(lp, mn), mx)
    d_near = torch.linalg.vector_norm(near - lp, dim=-1)
    idx = torch.arange(ncb, device=mn.device)
    rows_c = min(rows_per_chunk, ncb)

    def chunk(lo):
        bl, bh = b_lo[lo:lo + rows_c], b_hi[lo:lo + rows_c]
        t_lo = mn.new_zeros((rows_c, ncb))
        t_hi = torch.full_like(t_lo, INF)
        for k in range(3):
            lo_k, hi_k = _interval_t(bl[:, k:k + 1], bh[:, k:k + 1],
                                     b_lo[None, :, k], b_hi[None, :, k])
            t_lo = torch.maximum(t_lo, lo_k)
            t_hi = torch.minimum(t_hi, hi_k)
        # Some t in (0, 1] must work (a segment); the block itself is out.
        feasible = (t_lo <= t_hi) & (t_lo <= 1.0)
        feasible &= (lo + idx[:rows_c])[:, None] != idx[None, :]
        return torch.where(feasible, d_near[None, :], INF).amin(1)

    return _chunked_rows(chunk, ncb, rows_per_chunk)


def clearance_directional(cl, direction_to_light, rows_per_chunk: int = 256):
    """(NCB,) first-occluder distances D'(b) along ``direction_to_light``,
    measured from the fragment: INF where nothing outside the block lies
    toward the light."""
    mn, mx = _block_aabbs(cl)
    ncb = mn.shape[0]
    dl = torch.as_tensor(direction_to_light, dtype=torch.float32,
                         device=mn.device)
    idx = torch.arange(ncb, device=mn.device)
    rows_c = min(rows_per_chunk, ncb)

    def chunk(lo):
        bmn, bmx = mn[lo:lo + rows_c], mx[lo:lo + rows_c]
        s_lo = mn.new_zeros((rows_c, ncb))
        s_hi = torch.full_like(s_lo, INF)
        for k in range(3):
            lo_k = mn[None, :, k] - bmx[:, k:k + 1]  # s*dl_k in [lo, hi]
            hi_k = mx[None, :, k] - bmn[:, k:k + 1]
            dk = dl[k]
            div = torch.where(dk == 0, 1.0, dk)
            straddle = (lo_k <= 0.0) & (hi_k >= 0.0)
            big_pos = torch.where(
                dk > 0.0, lo_k / div,
                torch.where(dk < 0.0, hi_k / div,
                            torch.where(straddle, 0.0, INF)))
            small = torch.where(
                dk > 0.0, hi_k / div,
                torch.where(dk < 0.0, lo_k / div,
                            torch.where(straddle, INF, -INF)))
            s_lo = torch.maximum(s_lo, big_pos)
            s_hi = torch.minimum(s_hi, small)
        feasible = (s_lo <= s_hi) & (s_hi > 0.0)
        feasible &= (lo + idx[:rows_c])[:, None] != idx[None, :]
        return torch.where(feasible, torch.clamp(s_lo, min=0.0), INF).amin(1)

    return _chunked_rows(chunk, ncb, rows_per_chunk)


def own_block_entry_exit(cl, tri_block, hit_tri, origin, direction):
    """Each ray's slab entry and exit against the box of the block holding
    its triangle ``hit_tri`` (clamped into range: callers mask misses).
    Returns (block id, t entry, t exit)."""
    mn, mx = _block_aabbs(cl)
    b_id = tri_block[hit_tri.clamp(0, tri_block.shape[0] - 1).long()].long()
    bmn, bmx = mn[b_id], mx[b_id]
    t_en = torch.full(origin.shape[:-1], -INF, dtype=torch.float32,
                      device=origin.device)
    t_ex = torch.full_like(t_en, INF)
    for k in range(3):
        d = direction[..., k]
        safe = torch.where(d == 0.0, 1e-30, d)
        t1 = (bmn[..., k] - origin[..., k]) / safe
        t2 = (bmx[..., k] - origin[..., k]) / safe
        t_en = torch.maximum(t_en, torch.minimum(t1, t2))
        t_ex = torch.minimum(t_ex, torch.maximum(t1, t2))
    return b_id, t_en, t_ex
