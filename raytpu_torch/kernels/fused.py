"""Nearest-hit and any-hit cluster walks: the CUDA kernels and their plain
PyTorch versions.

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

Two opt-ins change the walk's shape and never its result (the counterparts
of ``_fused_kernel``'s ``pretest`` and ``recull_every``):

- ``pretest``: before a picked cluster's triangles are tested, every
  unresolved ray is slab-tested against the cluster's own box (its ``aabb``
  row, which equals block rows 18-23, widened by the root margin) up to its
  cap ``min(best_t, t_max)``; when no ray can reach the box before its cap,
  the cluster's tests are skipped.  Skipping is exact: a resolved ray's
  best is already at or before every untested entry, and an unresolved ray
  outside the box cannot hit inside it.
- ``recull_every``: every that many trips (after the settle check, while
  the tile walks on) the entries of the clusters not yet consumed are
  rebuilt from the beam of the unresolved rays only, pruned at the largest
  of their caps.  A sub-beam's interval bounds are never below the beam's
  in IEEE float arithmetic (every step is monotone), so a re-culled entry is
  never below the pick just consumed and the picks stay in non-decreasing
  order; consumed clusters are marked +inf (above every entry, FLOAT_MAX
  included) and stay consumed.

Two bounded walks leave the rays they could not prove unresolved, each
holding a true candidate (its best so far), and ``nearest_hit_fused``
finishes those with an unbudgeted classic walk whose per-ray ``t_max`` is
the candidate; that walk only takes strictly closer hits, so ties keep the
earlier winner (the single-walk semantics):

- ``max_trips`` (the counterpart of ``_fused_kernel``'s trip budget): the
  classic walk stops a tile after that many trips.  ``phase1_trips``
  drives it: phase 1 walks every tile on the budget, the unresolved rays
  are stably compacted to the front and re-tiled, so a few deep rays no
  longer keep a whole lockstep tile walking, and phase 2 finishes them.
- The prepick walk (the counterpart of ``_prepick_kernel``): entries from
  the slab test alone, up to ``picks`` of them drained front to back
  before the walk, which then tests exactly those clusters with no pick per
  trip, settling against the next pick's entry or, after the last, the
  tail bound (the least entry left).  Tiles with more feasible clusters
  than picks may leave rays unresolved; the rescue pass finishes them, and
  runs only when some ray is unresolved (a host read).

Two more shapes of the walk (the counterparts of ``_tlane_kernel`` with
``subk`` > 1 and of both reference kernels' ``chunk_k``):

- The subcluster walk, on a bake of cluster size 64 or 32, whose 128-lane
  blocks pack 2 or 4 leaves (accel/clusters.py): every leaf gets its own
  entry (its box, intersected with its fitted plane), a block's key is the
  least of its leaves' entries, the walk picks blocks by key and tests a
  picked block's leaves in order as separate passes.  With ``gate`` a pass
  is skipped when its leaf's entry is not below the largest min(best, t
  bound) of the tile's unresolved rays, taken once at the trip's start.
  A ray settles against the next block's key.  Equal-t ties between leaves
  of one block go to the lower leaf.
- ``chunk_k`` picks per trip: a trip takes the next K picks and tests them
  in pick order, and the rays settle against the next group's first pick.

Every walk counts per tile the trips (picks or groups of picks walked, the
counterpart of the reference kernel's ``iters``), the clusters whose
triangles were tested (picks less pretest or gate skips) and the ray tests
the function needs (each tested cluster's, or each leaf pass's, unresolved
rays, summed), and returns the per-ray resolved flag.

``walk_cuda`` and ``prepick_cuda`` launch the kernels of ``csrc/walk.cu``,
``subwalk_cuda`` (and ``walk_cuda`` with more than one pick a trip) the
group kernel of ``csrc/subwalk.cu``; ``walk_plain``, ``subwalk_plain`` and
``prepick_plain`` are the same walks in PyTorch, with the same arithmetic
in the same order, and each kernel agrees with its plain version bit for
bit on the card.  ``nearest_hit_fused`` takes the plain walks for tensors
on the CPU and the kernels for CUDA tensors; there is no fallback from one
to the other.

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
# Precisions of the matmul pair test (``mxu_values``).
MXU_PRECISIONS = ("highest", "default")
# Entry of a consumed cluster: above every entry bound, FLOAT_MAX included.
CONSUMED = float("inf")


def kernel_name(any_hit: bool, pretest: bool = False, budget: bool = False,
                prepick: bool = False, sub: bool = False, gate: bool = False,
                chunk: bool = False, mxu: Optional[str] = None) -> str:
    """The ``LAUNCHES`` key of a walk kernel launch: the query kind, then
    ``_prepick`` for the prepick walk, or ``_mxu_highest``/``_mxu_default``
    for the tensor-core walk, or ``_sub`` for the subcluster walk
    (``_gate`` with its gate on), ``_pretest`` for the pretest
    instantiation, ``_chunk`` for more than one pick per trip and
    ``_budget`` for a launch with a trip budget."""
    name = "any_hit" if any_hit else "nearest"
    if prepick:
        return name + "_prepick"
    return (name + (f"_mxu_{mxu}" if mxu else "")
            + ("_sub" if sub else "") + ("_gate" if gate else "")
            + ("_pretest" if pretest else "") + ("_chunk" if chunk else "")
            + ("_budget" if budget else ""))


# Launches of each CUDA kernel variant (``kernel_name``); ``walk_cuda``,
# ``subwalk_cuda`` and ``prepick_cuda`` add one per launch.
LAUNCHES = {kernel_name(a, p, b, chunk=c): 0 for a in (False, True)
            for p in (False, True) for b in (False, True)
            for c in (False, True)}
LAUNCHES.update({kernel_name(a, budget=b, sub=True, gate=g, chunk=c): 0
                 for a in (False, True) for b in (False, True)
                 for g in (False, True) for c in (False, True)})
LAUNCHES.update({kernel_name(a, prepick=True): 0 for a in (False, True)})
LAUNCHES.update({kernel_name(a, p, b, chunk=c, mxu=m): 0
                 for a in (False, True) for p in (False, True)
                 for b in (False, True) for c in (False, True)
                 for m in MXU_PRECISIONS})


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
    -1 on misses; nearest only: ``u``, ``v``, ``tri`` and, when asked for,
    the (R, 32) shade ``rows`` (channel 31 the mesh id as a value, zeros on
    misses); ``resolved``: (R,) int32, 1 once the ray is proven, 0 where a
    budget left it holding a candidate.  Per tile, (NT,) int32: ``iters``,
    the walk's trips; ``tests``, the clusters whose triangles were tested;
    ``ray_tests``, the unresolved rays of each tested cluster, summed."""

    t: torch.Tensor
    code: torch.Tensor
    u: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    tri: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    resolved: Optional[torch.Tensor] = None
    iters: Optional[torch.Tensor] = None
    tests: Optional[torch.Tensor] = None
    ray_tests: Optional[torch.Tensor] = None


_PER_TILE = ("iters", "tests", "ray_tests")
_PER_RAY = ("t", "code", "u", "v", "tri", "rows", "resolved")


def pack_query(origin, direction, ignore_tri=None, ignore_mesh=None,
               t_max=None, tile_size: int = 256) -> Query:
    """Pad a ray batch to whole tiles.  Padding rays have NaN origins and
    directions (they never hit and stay out of the tile's beam) and t bound
    0.  The walk sees detached tensors: it is not differentiable."""
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
        a = a.detach().to(dtype)
        if pad:
            a = torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])
        return a.contiguous()

    return Query(padded(origin, f32, float("nan")),
                 padded(direction, f32, float("nan")),
                 padded(t_max, f32, 0.0),
                 padded(ignore_tri, i32, -1),
                 padded(ignore_mesh, i32, -1), ts)


def gather_rows(tri_shade, tri, hit):
    """The winners' (R, 32) shade rows: ``tri_shade[tri]`` on channels 0-30,
    the mesh id as a float value on channel 31, zeros on misses."""
    srow = tri_shade[tri.clamp(min=0)]
    mesh = srow[..., 31].contiguous().view(torch.int32).to(srow.dtype)
    rows = torch.cat([srow[..., :31], mesh[..., None]], dim=-1)
    return torch.where(hit[..., None], rows, 0.0)


def assemble_hit(out: WalkOut, r: int, any_hit: bool):
    """The ``Hit`` of the first ``r`` rays, and their rows (None for
    any-hit or when the walk wrote none)."""
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
    rows = None if out.rows is None else out.rows[:r]
    return Hit(hit=hit, t=t, u=u, v=v, tri=tri), rows


def compact_order(resolved):
    """Stable permutation putting unresolved rays first (``_compact_order``,
    raytpu/kernels/fused.py:1614): ``order[j]`` is the source index of
    sorted slot ``j``."""
    return torch.argsort(resolved.to(torch.int8), stable=True)


def _finish_query(q: Query, out: WalkOut, unresolved) -> Query:
    """The query that finishes ``out``'s unresolved rays: the resolved ones
    ride along dead (NaN direction), the others get t bound = their
    candidate, so only strictly closer hits replace it."""
    nan = torch.tensor(float("nan"), dtype=q.direction.dtype,
                       device=q.direction.device)
    return q._replace(
        direction=torch.where(unresolved[:, None], q.direction, nan),
        t_max=torch.where(unresolved, out.t, 0.0).contiguous())


def _merge(first: WalkOut, second: WalkOut, unresolved) -> WalkOut:
    """``first`` with its unresolved rays' results replaced where the
    finishing walk ``second`` found a strictly closer hit; the counters of
    both walks summed per tile (by tile index, as the reference does)."""
    upd = unresolved & (second.code >= 0)
    fields = {}
    for name in ("t", "code", "u", "v", "tri"):
        a, b = getattr(first, name), getattr(second, name)
        fields[name] = None if a is None else torch.where(upd, b, a)
    for name in _PER_TILE:
        fields[name] = getattr(first, name) + getattr(second, name)
    return WalkOut(rows=None, resolved=second.resolved, **fields)


def _check_overflow(pretest, recull_every, phase1_trips, prepick, nbuf,
                    chunk_k):
    for name, value, least in (("phase1_trips", phase1_trips, 0),
                               ("prepick", prepick, 0), ("nbuf", nbuf, 1)):
        if not isinstance(value, int) or value < least:
            raise ValueError(f"{name} must be an int >= {least}, got "
                             f"{value!r}")
    if prepick and (pretest or recull_every or chunk_k > 1):
        raise ValueError("prepick is incompatible with pretest/recull_every/"
                         "chunk_k>1 (classic-walk-only settings)")
    if prepick and phase1_trips:
        raise ValueError("prepick and phase1_trips are mutually exclusive "
                         "overflow strategies")


def nearest_hit_fused(scene, origin, direction, ignore_tri=None,
                      ignore_mesh=None, cull=True, tile_size: int = 256,
                      t_max=None, any_hit: bool = False, chunk_k: int = 1,
                      mxu=None, mxu_precision: str = "highest",
                      recull_every: int = 0, pretest: bool = False,
                      phase1_trips: int = 0, prepick: int = 0, nbuf: int = 4,
                      layout=None, plane=None, gate: bool = False,
                      return_iters: bool = False, return_rows: bool = False):
    """Exact nearest hit (or any-hit occlusion) by the cluster walk.

    CPU tensors go through the plain walks, CUDA tensors through the CUDA
    kernels.  ``pretest``/``recull_every``: the walk-shape opt-ins (module
    docstring); the hits are the same with and without them.
    ``chunk_k``: picks per trip (at most the bake's block count); the hits
    are the same, except that an exact-t tie between two blocks of one trip
    goes to the earlier pick.
    ``phase1_trips`` > 0: the two-phase compaction, phase 1 on that
    trip budget.  ``prepick`` > 0: the prepick walk with at most that many
    picks per tile and the rescue pass; incompatible with ``pretest``,
    ``recull_every``, ``chunk_k`` > 1 and ``phase1_trips``.  ``nbuf``: the
    depth of the reference kernel's DMA ring for the prepick walk (any int
    >= 1); the CUDA walk stages one cluster at a time, so on the card it
    sets nothing, and it never changes a result.

    The reference's routing (raytpu/kernels/fused.py:1681-1714):
    ``layout`` chooses between the two walks and nothing else, since the
    card has no pair layouts: ``"t"`` the subcluster walk (the reference's
    transposed-layout kernel), ``"row"`` the classic walk.  ``None``: the
    subcluster walk on a subcluster bake (cluster size 64 or 32), any-hit
    queries included, unless the query asks for ``pretest``,
    ``recull_every`` or ``prepick``, which take the block-granularity
    classic or prepick walk, without planes; the classic walk on every
    other bake.  ``layout="t"`` with those raises ``ValueError``.
    ``plane``: intersect the entries with the fitted planes (None: on
    whenever the bake has the rows; a subcluster bake has leaf planes
    only).  ``gate``: the subcluster walk skips a sibling pass whose entry
    is not below the trip's largest unresolved cap (exact either way; the
    classic walk has no gate).

    ``mxu=True`` (raytpu/kernels/fused.py:1681-1691; None means False, as
    in the JAX package): the classic walk with the matmul form of the pair
    test on the ``gblock`` bake (``build_gblock=True``; ``ValueError``
    without it): each tested block's det-space values are ``R @ G``
    computed in TF32 on the tensor cores, ``mxu_precision`` ``"highest"``
    (3xTF32, the counterpart of the reference's 6-pass bf16 HIGHEST) or
    ``"default"`` (one TF32 pass, the counterpart of its one bf16 pass).
    Neither is the exact walk bit for bit: pairs whose det-space margin is
    within the rounding can flip, and the winner's t and (u, v) come from
    the matmul's values (the reference kernel's in-walk extraction, not an
    exact recompute).  It takes ``pretest``, ``recull_every``, ``chunk_k``
    and ``phase1_trips`` (phase 2 walks ``gblock`` too); with ``layout="t"``
    or ``prepick`` it raises ``ValueError``; on a subcluster bake it is the
    block-granularity classic walk without planes.

    ``return_rows``: return ``(Hit, rows)`` with the winners' (R, 32) shade
    rows; channel 31 carries the mesh id as a float value and misses get
    all-zero rows (None for any-hit queries; the overflow strategies gather
    them from ``tri_shade`` after the walks).  Otherwise ``return_iters``:
    return ``(Hit, iters)`` with the (NT,) int32 trips per tile, summed
    over the walks of a strategy."""
    mxu = bool(mxu)
    if layout not in (None, "row", "t"):
        raise ValueError(f"layout must be None, 'row' or 't', got {layout!r}")
    if mxu and prepick:
        raise ValueError("prepick is incompatible with mxu/pretest/"
                         "recull_every/max_trips/chunk_k>1 (classic-walk-only "
                         "knobs)")
    classic_only = bool(mxu or pretest or recull_every or prepick)
    if layout == "t" and classic_only:
        raise ValueError("layout='t' is incompatible with mxu/pretest/"
                         "recull_every/prepick")
    from raytpu_torch.accel.clusters import leaves_per_block

    if layout is None:
        layout = ("t" if leaves_per_block(scene.clusters) > 1
                  and not classic_only else "row")
    plane = True if plane is None else bool(plane)
    _check_walk_args(cull, recull_every, chunk_k=chunk_k)
    chunk_k = min(chunk_k, scene.clusters["block"].shape[0])
    _check_overflow(pretest, recull_every, phase1_trips, prepick, nbuf,
                    chunk_k)
    if origin.device.type == "cuda":
        walk, pick_walk = walk_cuda, prepick_cuda
        if layout == "t":
            walk = subwalk_cuda
    elif origin.device.type == "cpu":
        walk, pick_walk = walk_plain, prepick_plain
        if layout == "t":
            walk = subwalk_plain
    else:
        raise ValueError(f"no walk for device {origin.device}")
    q = pack_query(origin, direction, ignore_tri, ignore_mesh, t_max,
                   tile_size)
    tables = (scene.clusters, scene.tri_shade)
    kind = dict(cull=cull, any_hit=any_hit)
    shape = dict(chunk_k=chunk_k, plane=plane)
    if layout == "t":
        shape["gate"] = gate
    else:
        shape.update(pretest=pretest, recull_every=recull_every,
                     mxu=mxu_precision if mxu else None)
    if prepick:
        out = pick_walk(*tables, q, picks=prepick, **kind)
        unresolved = out.resolved == 0
        # The rescue runs only when some ray is unresolved: a host read
        # (the reference decides it on the device, with lax.cond).
        if bool(unresolved.any()):
            out = _merge(out, walk(*tables, _finish_query(q, out, unresolved),
                                   rows=False, **kind, **shape), unresolved)
    elif phase1_trips:
        first = walk(*tables, q, max_trips=phase1_trips, rows=False, **kind,
                     **shape)
        order = compact_order(first.resolved != 0)
        first_s = first._replace(**{
            f: getattr(first, f)[order] for f in _PER_RAY
            if getattr(first, f) is not None})
        q_s = Query(*(a[order] for a in q[:5]), q.tile)
        unresolved = first_s.resolved == 0
        merged = _merge(first_s, walk(*tables,
                                      _finish_query(q_s, first_s, unresolved),
                                      rows=False, **kind, **shape),
                        unresolved)
        out = merged._replace(**{
            f: torch.empty_like(getattr(merged, f)).index_copy_(
                0, order, getattr(merged, f))
            for f in _PER_RAY if getattr(merged, f) is not None})
    else:
        out = walk(*tables, q, rows=return_rows, **kind, **shape)
    if return_rows and not any_hit and out.rows is None:
        out = out._replace(rows=gather_rows(scene.tri_shade, out.tri,
                                            out.code >= 0))
    hit, rows = assemble_hit(out, origin.shape[0], any_hit)
    if return_rows:
        return hit, rows
    return (hit, out.iters) if return_iters else hit


# ---- The plain PyTorch walks ------------------------------------------------


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
    the fitted-plane interval (``plane`` None: the slab interval alone);
    INF where infeasible or at/after ``wcap``."""
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
    if plane is not None:
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
        lo, hi = _interval(a_, b_, _recip_nonzero(g_lo),
                           _recip_nonzero(g_hi), g_lo > 0.0, g_hi > 0.0,
                           g_lo < 0.0, g_hi < 0.0)
        t_lo = torch.maximum(t_lo, lo)
        t_hi = torch.minimum(t_hi, hi)
    feasible = (t_lo <= t_hi) & (t_lo < INF) & (t_lo < wcap[:, None])
    return torch.where(feasible & any_m, t_lo, INF)


def _pick(ent, idx):
    """Nearest remaining entry of tiles ``idx`` (lowest cluster id on equal
    entries); consumes it.  Returns (entry, cluster id); the entry is INF
    once the tile's feasible entries run out."""
    e = ent[idx]
    k = e.argmin(1)
    v = e.gather(1, k[:, None])[:, 0]
    took = v < INF
    ent[idx[took], k[took]] = CONSUMED
    return torch.where(took, v, INF), k


class _Tiles(NamedTuple):
    """The prologue of a walk over n whole tiles (``o``/``d`` (n, ts, 3),
    the rest (n, ts)): each ray's finite flag, root-capped t bound and
    resolved flag, and the largest bound of the unresolved rays."""

    o3: tuple
    d3: tuple
    finite: torch.Tensor
    tmax0: torch.Tensor
    resolved: torch.Tensor
    wcap: torch.Tensor


def _prologue(root, o, d, tmax_in) -> _Tiles:
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

    # Rays that cannot hit (non-finite, or t bound not above 0, NaN
    # included) start resolved; the entries are pruned at the largest bound
    # of the others, so a dead ray's NaN bound cannot poison its tile.
    resolved = ~finite | ~(tmax0 > 0.0)
    return _Tiles((ox, oy, oz), (dx, dy, dz), finite, tmax0, resolved,
                  torch.where(resolved, -INF, tmax0).amax(1))


class _Walk(NamedTuple):
    """The shape of a walk (``walk_plain``, ``subwalk_plain``): per-sibling
    cull tables ``aabb`` (subk, 6, NCG) and ``plane`` (subk, 5, NCG) or
    None (the slab interval alone); subk 1 is the classic walk, whose
    sibling is the block itself.  ``chunk_k``: picks per trip, already at
    most NCG.  ``gate``: skip a sibling pass whose entry is not below the
    trip's largest unresolved cap.  ``mxu``: the matmul pair test at that
    precision (``mxu_values``) on the ``gblock`` table, or None."""

    aabb: torch.Tensor
    plane: Optional[torch.Tensor]
    chunk_k: int = 1
    gate: bool = False
    pretest: bool = False
    recull_every: int = 0
    max_trips: int = 0
    mxu: Optional[str] = None


def _walk_state(tl: _Tiles, itri, any_hit):
    """Per-ray best, updated in place by _test_cluster."""
    state = {"bt": tl.tmax0.clone(), "bc": torch.full_like(itri, -1)}
    if not any_hit:
        bt = state["bt"]
        state.update(bu=torch.zeros_like(bt), bv=torch.zeros_like(bt),
                     bd=torch.ones_like(bt), bi=torch.full_like(itri, -1))
    (ox, oy, oz), (dx, dy, dz) = tl.o3, tl.d3
    w3 = (dy * oz - dz * oy, dz * ox - dx * oz, dx * oy - dy * ox)
    return state, w3


def _walk_out(state, resolved, any_hit, trips, tests, ray_tests):
    bc = state["bc"]
    res = resolved.to(torch.int32)
    if any_hit:
        return WalkOut(t=torch.where(bc >= 0, 0.0, state["bt"]), code=bc,
                       resolved=res, iters=trips, tests=tests,
                       ray_tests=ray_tests)
    safe_det = torch.where(bc >= 0, state["bd"], 1.0)
    return WalkOut(t=state["bt"], code=bc, u=state["bu"] / safe_det,
                   v=state["bv"] / safe_det, tri=state["bi"], resolved=res,
                   iters=trips, tests=tests, ray_tests=ray_tests)


def _pick_group(ent, idx, k):
    """The next ``k`` picks of tiles ``idx`` in pick order: (m, k) entries
    (INF past the end) and cluster ids."""
    picks = [_pick(ent, idx) for _ in range(k)]
    return (torch.stack([v for v, _ in picks], 1),
            torch.stack([c for _, c in picks], 1))


def _slab_viable(aabb, margin, k, cap, o3, inv_d, idx):
    """The pretest: can any unresolved ray of tiles ``idx`` reach cluster
    ``k``'s box (widened by the root margin) before its cap?  Resolved rays
    have cap -INF."""
    t_en = torch.full_like(cap, -INF)
    t_ex = torch.full_like(cap, INF)
    for a, (ok_, ik) in enumerate(zip(o3, inv_d)):
        mn = (aabb[a, k] - margin)[:, None]
        mx = (aabb[3 + a, k] + margin)[:, None]
        t1 = (mn - ok_[idx]) * ik[idx]
        t2 = (mx - ok_[idx]) * ik[idx]
        t_en = torch.maximum(t_en, torch.minimum(t1, t2))
        t_ex = torch.minimum(t_ex, torch.maximum(t1, t2))
    return ((t_en <= t_ex) & (t_ex >= 0.0) & (t_en < cap)).any(1)


def _walk_tiles(cl, tri_shade, o, d, tmax_in, itri, imesh, cull, any_hit,
                walk: _Walk, rows):
    """Walk n whole tiles: ``o``/``d`` (n, ts, 3), the rest (n, ts).

    A trip takes the next ``chunk_k`` picks (a block's key is the least of
    its siblings' entries) and tests them in pick order, each block's
    siblings in order ``h = 0..subk-1``, each sibling behind the gate when
    it is on; the rays then settle against the next group's first pick."""
    block = cl["gblock"] if walk.mxu else cl["block"]
    csize = cl["block"].shape[2]
    subk = walk.aabb.shape[0]
    csub = csize // subk
    margin = cl["root"][6]
    tl = _prologue(cl["root"], o, d, tmax_in)
    o3, d3, tmax0, resolved = tl.o3, tl.d3, tl.tmax0, tl.resolved
    state, w3 = _walk_state(tl, itri, any_hit)
    bt, bc = state["bt"], state["bc"]

    def entries(h, finite, o3_, d3_, wcap):
        return _entry_bounds(walk.aabb[h], None if walk.plane is None
                             else walk.plane[h], finite, o3_, d3_, wcap)

    esub = [entries(h, tl.finite, o3, d3, tl.wcap) for h in range(subk)]
    ent = esub[0].clone()
    for e in esub[1:]:
        ent = torch.minimum(ent, e)

    n = tmax0.shape[0]
    if walk.pretest:
        inv_d = [1.0 / torch.where(dk == 0.0, _TINY_DIR, dk) for dk in d3]
    trips = torch.zeros(n, dtype=torch.int32, device=o.device)
    tests = torch.zeros_like(trips)
    ray_tests = torch.zeros_like(trips)

    tiles = torch.arange(n, device=o.device)
    cur_v, cur_k = _pick_group(ent, tiles, walk.chunk_k)
    live = cur_v[:, 0] < INF
    # No feasible cluster: nothing to hit, every ray is proven.
    resolved |= ~live[:, None]
    while bool(live.any()):
        idx = tiles[live]
        trips[idx] += 1
        # The trip's caps, taken once at its start: min(best, t bound) of
        # each unresolved ray, -INF for resolved ones.
        unres = ~resolved[idx]
        n_unres = unres.sum(1, dtype=torch.int32)
        cap = torch.where(unres, torch.minimum(bt[idx], tmax0[idx]), -INF)
        capmax = cap.amax(1)
        for j in range(walk.chunk_k):
            v, k = cur_v[idx, j], cur_k[idx, j]
            valid = v < INF
            if walk.pretest:
                valid &= _slab_viable(cl["aabb"], margin, k, cap, o3, inv_d,
                                      idx)
            ran = torch.zeros_like(valid)
            for h in range(subk):
                run = valid
                if walk.gate:
                    e = v if subk == 1 else esub[h][idx, k]
                    run = run & (e < capmax)
                if not bool(run.any()):
                    continue
                tidx = idx[run]
                ray_tests[tidx] += n_unres[run]
                _test_cluster(block, tidx, k[run], o3, d3, w3, itri, imesh,
                              tmax0, cull, any_hit, state, h * csub,
                              (h + 1) * csub, mxu=walk.mxu)
                ran |= run
            tests[idx[ran]] += 1
        nxt_v, nxt_k = _pick_group(ent, idx, walk.chunk_k)
        nv = nxt_v[:, :1]
        if any_hit:
            settle = (bc[idx] >= 0) | (tmax0[idx] <= nv)
        else:
            settle = bt[idx] <= nv
        res = resolved[idx] | settle
        resolved[idx] = res
        go = (nv[:, 0] < INF) & ~res.all(1)
        if walk.max_trips:
            # The trip budget: the rays not yet resolved keep their best
            # as a candidate.
            go &= trips[idx] < walk.max_trips
        live[idx] = go
        cur_v[idx], cur_k[idx] = nxt_v, nxt_k
        if walk.recull_every:
            due = go & (trips[idx] % walk.recull_every == 0)
            if bool(due.any()):
                # Re-cull from the beam of the unresolved rays only, pruned
                # at the largest of their caps; consumed clusters stay so.
                r_ = idx[due]
                unres = ~resolved[r_]
                wcap = torch.where(unres, torch.minimum(bt[r_], tmax0[r_]),
                                   -INF).amax(1)
                fresh = entries(0, tl.finite[r_] & unres,
                                tuple(a[r_] for a in o3),
                                tuple(a[r_] for a in d3), wcap)
                e = ent[r_]
                ent[r_] = torch.where(e == CONSUMED, e, fresh)

    out = _walk_out(state, resolved, any_hit, trips, tests, ray_tests)
    if rows and not any_hit:
        out = out._replace(rows=gather_rows(tri_shade, out.tri,
                                            out.code >= 0))
    return out


def _prepick_tiles(cl, o, d, tmax_in, itri, imesh, cull, any_hit, picks):
    """The prepick walk of n whole tiles: ``o``/``d`` (n, ts, 3), the rest
    (n, ts)."""
    tl = _prologue(cl["root"], o, d, tmax_in)
    tmax0, resolved = tl.tmax0, tl.resolved
    state, w3 = _walk_state(tl, itri, any_hit)
    bt, bc = state["bt"], state["bc"]
    # Slab-only entries of the blocks (no fitted planes).
    ent = _entry_bounds(cl["aabb"], None, tl.finite, tl.o3, tl.d3, tl.wcap)
    n, ncg = ent.shape

    # Pick phase: the first ``picks`` entries in (entry, cluster id) order,
    # and the tail bound, the least entry left (INF once drained).  A
    # stable sort orders equal entries by id, like repeated argmins.
    vals, ks = torch.sort(ent, dim=1, stable=True)
    f = min(picks, ncg)
    tail = (vals[:, picks] if picks < ncg
            else torch.full((n,), INF, dtype=vals.dtype, device=vals.device))
    pv, pk = vals[:, :f], ks[:, :f]
    m = (pv < INF).sum(1)  # feasible picks per tile: a prefix
    # The entry each ray settles against after pick s.
    v_next = torch.cat([pv[:, 1:], tail[:, None]], dim=1)

    trips = torch.zeros(n, dtype=torch.int32, device=o.device)
    ray_tests = torch.zeros_like(trips)
    # No feasible cluster: nothing to hit, every ray is proven.
    resolved |= (m == 0)[:, None]
    tiles = torch.arange(n, device=o.device)
    live = (m > 0) & ~resolved.all(1)
    s = 0
    while bool(live.any()):
        idx = tiles[live]
        trips[idx] += 1
        ray_tests[idx] += (~resolved[idx]).sum(1, dtype=torch.int32)
        _test_cluster(cl["block"], idx, pk[idx, s], tl.o3, tl.d3, w3, itri,
                      imesh, tmax0, cull, any_hit, state)
        vn = v_next[idx, s][:, None]
        if any_hit:
            settle = (bc[idx] >= 0) | (tmax0[idx] <= vn)
        else:
            settle = bt[idx] <= vn
        res = resolved[idx] | settle
        resolved[idx] = res
        live[idx] = (s + 1 < m[idx]) & ~res.all(1)
        s += 1
    return _walk_out(state, resolved, any_hit, trips, trips.clone(),
                     ray_tests)


def tf32(x):
    """``x`` rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: half of the
    dropped 13 bits' range is added to the magnitude bits, which are then
    cut."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mxu_values(rmat, g, precision: str):
    """The matmul pair test's ``R @ G`` as the tensor cores compute it:
    ``rmat`` (..., 16) ray rows, ``g`` (..., 16, N) coefficients, both
    float32.  ``"highest"`` splits both into TF32 hi and lo parts and sums
    a_hi b_lo + a_lo b_hi + a_hi b_hi (3xTF32); ``"default"`` is one TF32
    pass, a_hi b_hi.  Every product of two TF32 values is exact in float32,
    so only the order of the float32 sums differs from the kernel's
    (csrc/mxuwalk.cu).  On the card the products are summed by float32
    matmuls, which needs ``torch.backends.cuda.matmul.allow_tf32 = False``
    (PyTorch's default); it raises otherwise."""
    if rmat.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("the plain mxu walk needs float32 matmuls: set "
                         "torch.backends.cuda.matmul.allow_tf32 = False")
    a_hi, b_hi = tf32(rmat), tf32(g)
    out = a_hi @ b_hi
    if precision == "highest":
        a_lo, b_lo = tf32(rmat - a_hi), tf32(g - b_hi)
        out = (a_hi @ b_lo + a_lo @ b_hi) + out
    elif precision != "default":
        raise ValueError(f"mxu_precision must be one of {MXU_PRECISIONS}, "
                         f"got {precision!r}")
    return out


def _pair_values(block, idx, k, o3, d3, w3, lo, hi, mxu):
    """Det-space values (m, ts, lanes) of the rays of tiles ``idx`` against
    lanes ``lo`` to ``hi - 1`` of blocks ``k``, and the lanes' triangle and
    mesh ids (m, 1, lanes): from the exact triple-product rows of ``block``
    or, ``mxu`` given, from the matmul ``R @ G`` on the ``gblock`` table
    (whole blocks), with R = [d, w, o, 1, 0 x 6] per ray."""
    col = lambda x: x[idx][:, :, None]  # noqa: E731  (m, ts, 1)
    if mxu:
        c = block.shape[2] // 4
        g = block[k]  # (m, 24, 4C)
        ones = torch.ones_like(col(d3[0]))
        rmat = torch.cat([col(a) for a in (*d3, *w3, *o3)] + [ones]
                         + [torch.zeros_like(ones)] * 6, dim=2)
        out = mxu_values(rmat, g[:, :16], mxu)
        ids = g[:, 16].view(torch.int32)[:, None, :]
        return (out[..., :c], out[..., c:2 * c], out[..., 2 * c:3 * c],
                out[..., 3 * c:], ids[..., :c], ids[..., c:2 * c])
    ox, oy, oz = o3
    dx, dy, dz = d3
    wx, wy, wz = w3
    g = block[k, :GEO_ROWS, lo:hi]  # (m, 18, lanes)
    row = lambda i: g[:, i, None, :]  # noqa: E731  (m, 1, C)
    rdx, rdy, rdz = col(dx), col(dy), col(dz)
    rwx, rwy, rwz = col(wx), col(wy), col(wz)
    nx, ny, nz = row(0), row(1), row(2)
    det = rdx * nx + rdy * ny + rdz * nz
    udet = (rwx * row(6) + rwy * row(7) + rwz * row(8)
            + rdx * row(3) + rdy * row(4) + rdz * row(5))
    vdet = (rwx * row(12) + rwy * row(13) + rwz * row(14)
            + rdx * row(9) + rdy * row(10) + rdz * row(11))
    tdet = row(15) - (col(ox) * nx + col(oy) * ny + col(oz) * nz)
    return (det, udet, vdet, tdet, g[:, 16].view(torch.int32)[:, None, :],
            g[:, 17].view(torch.int32)[:, None, :])


def _test_cluster(block, idx, k, o3, d3, w3, itri, imesh, tmax0, cull,
                  any_hit, state, lo=0, hi=None, mxu=None):
    """Test the rays of tiles ``idx`` against lanes ``lo`` to ``hi - 1``
    of blocks ``k`` (one per tile; default every lane) in lane order and
    update the per-ray best in ``state`` in place.  ``mxu``: ``block`` is
    the ``gblock`` table and the det-space values come from the matmul at
    that precision; acceptance, the strict-min update and the winner's
    (u, v) from ``udet/det`` and ``vdet/det`` are the exact test's."""
    col = lambda x: x[idx][:, :, None]  # noqa: E731  (m, ts, 1)
    det, udet, vdet, tdet, tid, tmesh = _pair_values(block, idx, k, o3, d3,
                                                     w3, lo, hi, mxu)
    keep = (tid != col(itri)) & (tmesh != col(imesh))
    bc = state["bc"]
    if any_hit:
        ok = keep & det_space_accept_within(det, udet, vdet, tdet,
                                            col(tmax0), cull)
        bc[idx] = torch.where(ok.any(2), 0, bc[idx])
        return
    ok = keep & det_space_accept(det, udet, vdet, tdet, cull)
    dist = torch.where(ok, tdet / det, INF)
    lane = dist.argmin(2, keepdim=True)  # first lane on ties
    take = lambda q: q.expand_as(dist).gather(2, lane)[..., 0]  # noqa: E731
    mint = take(dist)
    bt = state["bt"]
    upd = mint < bt[idx]
    lanes = block.shape[2] // 4 if mxu else block.shape[2]
    code = (k[:, None] * lanes + lo + lane[..., 0]).to(bc.dtype)
    bt[idx] = torch.where(upd, mint, bt[idx])
    bc[idx] = torch.where(upd, code, bc[idx])
    for name, q in (("bu", udet), ("bv", vdet), ("bd", det), ("bi", tid)):
        x = state[name]
        x[idx] = torch.where(upd, take(q), x[idx])


def _over_chunks(clusters, q: Query, walk_tiles):
    """Run ``walk_tiles(o, d, t_max, ignore_tri, ignore_mesh)`` over the
    query's tiles in chunks that bound the pair temporaries (tiles are
    independent), and join the results."""
    ts = q.tile
    nt = q.origin.shape[0] // ts
    ncg, _, csize = clusters["block"].shape
    step = max(1, min(_PAIR_BUDGET // (ts * csize), _PAIR_BUDGET // ncg))
    parts = []
    for s in range(0, nt, step):
        sl = slice(s * ts, min(s + step, nt) * ts)
        m = (sl.stop - sl.start) // ts
        parts.append(walk_tiles(
            q.origin[sl].reshape(m, ts, 3), q.direction[sl].reshape(m, ts, 3),
            q.t_max[sl].reshape(m, ts), q.ignore_tri[sl].reshape(m, ts),
            q.ignore_mesh[sl].reshape(m, ts)))
    return WalkOut(*(
        None if xs[0] is None else
        torch.cat(xs if name in _PER_TILE else [x.flatten(0, 1) for x in xs])
        for name, xs in zip(WalkOut._fields, zip(*parts))))


def _walk_spec(clusters, sub: bool, plane: bool, chunk_k: int,
               gate=False, pretest=False, recull_every=0,
               max_trips=0, mxu=None) -> _Walk:
    """The ``_Walk`` of the classic walk (``sub`` False: the block is its
    own sibling, with its fitted plane when the bake has block planes) or
    the subcluster walk (the bake's sibling tables; a bake of one leaf per
    block is its own sibling again).  ``plane`` False: slab intervals
    alone."""
    if sub and "sub_aabb" in clusters:
        aabb, planes = clusters["sub_aabb"], clusters["sub_plane"]
    else:
        aabb, planes = clusters["aabb"][None], clusters.get("plane")
        planes = None if planes is None else planes[None]
    if mxu is not None and mxu not in MXU_PRECISIONS:
        raise ValueError(f"mxu_precision must be one of {MXU_PRECISIONS}, "
                         f"got {mxu!r}")
    if mxu is not None and "gblock" not in clusters:
        raise ValueError("mxu=True requires the gblock bake: flatten the "
                         "scene with build_gblock=True")
    return _Walk(aabb, planes if plane else None,
                 min(chunk_k, clusters["block"].shape[0]), gate, pretest,
                 recull_every, max_trips, mxu)


def walk_plain(clusters, tri_shade, q: Query, *, cull, any_hit: bool,
               pretest: bool = False, recull_every: int = 0,
               max_trips: int = 0, rows: bool = True, chunk_k: int = 1,
               plane: bool = True, mxu: Optional[str] = None):
    """The classic walk in plain PyTorch, on any device.  ``max_trips`` > 0:
    stop each tile after that many trips.  ``rows``: a nearest query also
    returns the winners' shade rows.  ``chunk_k``: picks per trip.
    ``plane``: intersect the entries with the block's fitted plane when the
    bake has block planes (a subcluster bake has none).  ``mxu``
    (``"highest"`` or ``"default"``): the matmul pair test on the
    ``gblock`` table at that precision (``mxu_values``): the det-space
    values of every tested pair come from ``R @ G``, and so do the
    winner's t and (u, v) (``udet/det``, ``vdet/det``), as the JAX
    package's kernel extracts them in the walk; acceptance and the
    strict-min update are the exact walk's."""
    _check_walk_args(cull, recull_every, max_trips, chunk_k=chunk_k)
    spec = _walk_spec(clusters, False, plane, chunk_k, pretest=pretest,
                      recull_every=recull_every, max_trips=max_trips,
                      mxu=mxu)
    return _over_chunks(clusters, q, lambda *ray: _walk_tiles(
        clusters, tri_shade, *ray, cull, any_hit, spec, rows))


def subwalk_plain(clusters, tri_shade, q: Query, *, cull, any_hit: bool,
                  gate: bool = False, chunk_k: int = 1, max_trips: int = 0,
                  plane: bool = True, rows: bool = True):
    """The subcluster walk in plain PyTorch, on any device: per-sibling
    entries (with each leaf's fitted plane when ``plane``), ``chunk_k``
    blocks per trip, each sibling pass behind the ``gate`` when it is on.
    On a bake of one leaf per block it is the classic walk without the
    pretest and re-cull, and the gate skips whole blocks."""
    _check_walk_args(cull, 0, max_trips, chunk_k=chunk_k)
    spec = _walk_spec(clusters, True, plane, chunk_k, gate=bool(gate),
                      max_trips=max_trips)
    return _over_chunks(clusters, q, lambda *ray: _walk_tiles(
        clusters, tri_shade, *ray, cull, any_hit, spec, rows))


def prepick_plain(clusters, tri_shade, q: Query, *, cull, any_hit: bool,
                  picks: int):
    """The prepick walk in plain PyTorch, on any device: at most ``picks``
    clusters per tile.  No shade rows (``tri_shade`` is not read)."""
    _check_walk_args(cull, 0, 0, picks)
    return _over_chunks(clusters, q, lambda *ray: _prepick_tiles(
        clusters, *ray, cull, any_hit, picks))


# ---- The CUDA kernels -------------------------------------------------------


# Picks per trip the group kernel takes at most (its pass bits fit one
# 32-bit word), and the room of its beam in shared memory, in bytes.
MAX_CHUNK = 8
_BEAM_BYTES = 128


def _smem_bytes(ncg: int, csize: int, picks: int = 0, chunk_k: int = 0,
                subk: int = 1, mxu: Optional[str] = None) -> int:
    """Dynamic shared memory of one walk block: the entry (key) table and
    one staged cluster block and, for the prepick walk, its picks (entry
    and id).  ``chunk_k`` > 0: the group kernel's, with ``chunk_k`` staged
    blocks, the group's keys and ids and, ``subk`` > 1, their sibling
    entries and the beam (csrc/subwalk.cu ``group_smem_bytes``).  ``mxu``:
    the tensor-core walk's at that precision, whose staged block is 8
    coefficient rows of each of its 4 column blocks, each row padded by 8
    floats, as TF32 hi and, for ``"highest"``, lo parts, and the 2C ids
    (csrc/mxuwalk.cu ``mxu_smem_bytes``).  The re-cull needs no table of
    its own: a consumed cluster's entry is marked +inf in place
    (``CONSUMED``)."""
    if mxu:
        parts = 2 if mxu == "highest" else 1
        staged = 8 * (4 * csize + 8) * parts + 2 * csize
        return 4 * (ncg + chunk_k * staged) + 8 * chunk_k
    if not chunk_k:
        return 4 * (ncg + GEO_ROWS * csize) + 8 * picks
    n = 4 * (ncg + chunk_k * GEO_ROWS * csize) + 8 * chunk_k
    return n + (4 * chunk_k * subk + _BEAM_BYTES if subk > 1 else 0)


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


def _check_walk_args(cull, recull_every, max_trips=0, picks=None,
                     chunk_k=1):
    if cull not in _CULL_CODE:
        raise ValueError(
            f"cull must be True, False or 'reverse', got {cull!r}")
    for name, value, least in (("recull_every", recull_every, 0),
                               ("max_trips", max_trips, 0),
                               ("picks", 1 if picks is None else picks, 1),
                               ("chunk_k", chunk_k, 1)):
        if not isinstance(value, int) or value < least:
            raise ValueError(f"{name} must be an int >= {least}, got "
                             f"{value!r}")


def _validate(clusters, tri_shade, q: Query, cull, recull_every=0,
              max_trips=0, picks=None, spec: Optional[_Walk] = None,
              group=False):
    """The checks a kernel's wrapper makes before a launch: every tensor on
    the rays' device, of the kernel's dtype and shape, contiguous, at most
    ``MAX_CHUNK`` picks per trip, and the block's shared memory within the
    card's limit.  ``picks``: the prepick walk's (None for the others);
    ``spec``: the classic or subcluster walk's tables and shape (with
    ``spec.mxu``, the tensor-core walk's ``gblock``); ``group``: the walk
    launches the group kernel."""
    _check_walk_args(cull, recull_every, max_trips, picks)
    block = clusters["block"]
    r, ts = q.origin.shape[0], q.tile
    ncg, _, csize = block.shape
    f32, i32 = torch.float32, torch.int32
    if not 1 <= ts <= 1024 or r % ts:
        raise ValueError(f"tile {ts} must be in [1, 1024] and divide {r} rays")
    tables = [("origin", q.origin, f32, (r, 3)),
              ("direction", q.direction, f32, (r, 3)),
              ("t_max", q.t_max, f32, (r,)),
              ("ignore_tri", q.ignore_tri, i32, (r,)),
              ("ignore_mesh", q.ignore_mesh, i32, (r,)),
              ("block", block, f32, (ncg, 24, csize)),
              ("aabb", clusters["aabb"], f32, (6, ncg)),
              ("root", clusters["root"], f32, (8,)),
              ("tri_shade", tri_shade, f32, (tri_shade.shape[0], 32))]
    subk, chunk_k = 1, 0
    if spec is not None:
        subk = spec.aabb.shape[0]
        chunk_k = spec.chunk_k if group else 0
        tables.append(("sibling aabb", spec.aabb, f32, (subk, 6, ncg)))
        if spec.plane is not None:
            tables.append(("sibling plane", spec.plane, f32, (subk, 5, ncg)))
        if csize % subk or subk not in (1, 2, 4):
            raise ValueError(f"{subk} leaves per block of {csize} lanes")
        if spec.chunk_k > MAX_CHUNK:
            raise ValueError(f"chunk_k {spec.chunk_k} exceeds the kernel's "
                             f"{MAX_CHUNK} picks per trip")
        if spec.mxu:
            chunk_k = spec.chunk_k
            tables.append(("gblock", clusters["gblock"], f32,
                           (ncg, 24, 4 * csize)))
            if csize % 8:
                raise ValueError(f"the tensor-core walk tests groups of 8 "
                                 f"triangles; blocks of {csize} lanes")
    for name, x, dtype, shape in tables:
        _check(name, x, q.origin.device, dtype, shape)
    mxu = spec.mxu if spec is not None else None
    need = _smem_bytes(ncg, csize, picks or 0, chunk_k, subk, mxu)
    if need > SMEM_LIMIT:
        what = (f" and {picks} picks" if picks else
                f" and {chunk_k} picks per trip" if chunk_k else "")
        prec = f" with mxu precision {mxu!r}" if mxu else ""
        raise ValueError(
            f"{ncg} clusters of {csize}{what} need {need} bytes of shared "
            f"memory per block{prec}; the limit is {SMEM_LIMIT}")


def _outputs(r, nt, dev, nearest):
    f32, i32 = torch.float32, torch.int32
    out = {"t": torch.empty((r,), dtype=f32, device=dev),
           "code": torch.empty((r,), dtype=i32, device=dev),
           "resolved": torch.empty((r,), dtype=i32, device=dev),
           **{k: torch.empty((nt,), dtype=i32, device=dev)
              for k in _PER_TILE}}
    if nearest:
        out.update(u=torch.empty((r,), dtype=f32, device=dev),
                   v=torch.empty((r,), dtype=f32, device=dev),
                   tri=torch.empty((r,), dtype=i32, device=dev))
    return out


def _launch(name, fn, args, dev):
    from raytpu_torch.kernels.build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"walk kernel launch failed: {lib.rt_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def _launch_walk(clusters, tri_shade, q: Query, cull, any_hit, spec: _Walk,
                 rows, sub: bool):
    """Launch the classic walk (``sub`` False) or the subcluster walk:
    ``walk_kernel`` for the classic walk with one pick per trip, the group
    kernel ``subwalk_kernel`` for every other, and ``mxu_walk_kernel``
    for the classic walk with ``spec.mxu`` (the block's plane when the
    bake has one)."""
    dev = q.origin.device
    name = "subwalk_cuda" if sub else "walk_cuda"
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    group = sub or spec.chunk_k > 1
    _validate(clusters, tri_shade, q, cull, spec.recull_every,
              spec.max_trips, spec=spec, group=group)
    block, r, ts = clusters["block"], q.origin.shape[0], q.tile
    ncg, _, csize = block.shape
    p = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    out = _outputs(r, r // ts, dev, not any_hit)
    if rows and not any_hit:
        out["rows"] = torch.empty((r, 32), dtype=torch.float32, device=dev)
    rays = (p(q.origin), p(q.direction), p(q.t_max), p(q.ignore_tri),
            p(q.ignore_mesh), r, ts, p(clusters["root"]), p(clusters["aabb"]))
    plane = p(spec.plane)  # the block's own when the walk is classic
    shape = (_CULL_CODE[cull], int(spec.pretest), spec.recull_every,
             spec.max_trips)
    counts = tuple(p(out[k]) for k in ("resolved",) + _PER_TILE)
    winner = (() if any_hit else
              (p(out["u"]), p(out["v"]), p(out["tri"]), p(out.get("rows"))))
    shade = () if any_hit else (p(tri_shade),)
    kind = "any_hit" if any_hit else "nearest"
    if spec.mxu:
        args = (*rays, plane, p(clusters["gblock"]), ncg, csize, *shade,
                *shape, spec.chunk_k, int(spec.mxu == "highest"),
                p(out["t"]), p(out["code"]), *winner, *counts)
        fn = "rt_mxu_" + kind
    elif group:
        args = (*rays, p(block), ncg, csize, p(spec.aabb), plane,
                spec.aabb.shape[0], *shade, *shape, spec.chunk_k,
                int(spec.gate), p(out["t"]), p(out["code"]), *winner,
                *counts)
        fn = "rt_subwalk_" + kind
    else:
        args = (*rays, plane, p(block), ncg, csize, *shade, *shape,
                p(out["t"]), p(out["code"]), *winner, *counts)
        fn = "rt_" + ("any_hit" if any_hit else "nearest_hit")
    _launch(kernel_name(any_hit, spec.pretest, spec.max_trips > 0, sub=sub,
                        gate=spec.gate, chunk=spec.chunk_k > 1,
                        mxu=spec.mxu), fn, args, dev)
    return WalkOut(**out)


def walk_cuda(clusters, tri_shade, q: Query, *, cull, any_hit: bool,
              pretest: bool = False, recull_every: int = 0,
              max_trips: int = 0, rows: bool = True, chunk_k: int = 1,
              plane: bool = True, mxu: Optional[str] = None):
    """Launch the classic walk of ``csrc/walk.cu`` on the current stream
    (``walk_plain``'s arguments); more than one pick per trip launches the
    group kernel of ``csrc/subwalk.cu``, and ``mxu`` the tensor-core walk
    of ``csrc/mxuwalk.cu``.

    Replaces ``raytpu/kernels/fused.py``'s ``_tlane_kernel`` (nearest) and
    ``_fused_kernel`` (any-hit, and nearest with ``pretest``,
    ``recull_every``, ``max_trips`` and ``chunk_k``); see the sources for
    what bounds it on the card."""
    _check_walk_args(cull, recull_every, max_trips, chunk_k=chunk_k)
    spec = _walk_spec(clusters, False, plane, chunk_k, pretest=pretest,
                      recull_every=recull_every, max_trips=max_trips,
                      mxu=mxu)
    return _launch_walk(clusters, tri_shade, q, cull, any_hit, spec, rows,
                        sub=False)


def subwalk_cuda(clusters, tri_shade, q: Query, *, cull, any_hit: bool,
                 gate: bool = False, chunk_k: int = 1, max_trips: int = 0,
                 plane: bool = True, rows: bool = True):
    """Launch the subcluster walk of ``csrc/subwalk.cu`` on the current
    stream (``subwalk_plain``'s arguments).

    Replaces ``raytpu/kernels/fused.py``'s ``_tlane_kernel`` with subk > 1
    (and at subk 1 on a bake of one leaf per block), its ``gate`` and its
    ``chunk_k``; see the source for what bounds it on the card."""
    _check_walk_args(cull, 0, max_trips, chunk_k=chunk_k)
    spec = _walk_spec(clusters, True, plane, chunk_k, gate=bool(gate),
                      max_trips=max_trips)
    return _launch_walk(clusters, tri_shade, q, cull, any_hit, spec, rows,
                        sub=True)


def prepick_cuda(clusters, tri_shade, q: Query, *, cull, any_hit: bool,
                 picks: int):
    """Launch the prepick walk kernel of ``csrc/walk.cu`` on the current
    stream: at most ``picks`` clusters per tile, drained into shared memory
    before the walk.  Replaces ``raytpu/kernels/fused.py``'s
    ``_prepick_kernel``; see the source for what bounds it on the card."""
    dev = q.origin.device
    if dev.type != "cuda":
        raise ValueError(f"prepick_cuda needs CUDA tensors, got {dev}")
    _validate(clusters, tri_shade, q, cull, picks=picks)
    block, r, ts = clusters["block"], q.origin.shape[0], q.tile
    ncg, _, csize = block.shape
    p = lambda x: x.data_ptr()  # noqa: E731
    out = _outputs(r, r // ts, dev, not any_hit)
    head = (p(q.origin), p(q.direction), p(q.t_max), p(q.ignore_tri),
            p(q.ignore_mesh), r, ts, p(clusters["root"]),
            p(clusters["aabb"]), p(block), ncg, csize, _CULL_CODE[cull],
            picks, p(out["t"]), p(out["code"]))
    winner = () if any_hit else (p(out["u"]), p(out["v"]), p(out["tri"]))
    counts = tuple(p(out[k]) for k in ("resolved",) + _PER_TILE)
    _launch(kernel_name(any_hit, prepick=True),
            "rt_prepick_any_hit" if any_hit else "rt_prepick_nearest",
            (*head, *winner, *counts), dev)
    return WalkOut(**out)
