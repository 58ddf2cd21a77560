"""Nearest-hit queries: the ``Hit`` result, the brute-force sweep, the
stackless octree walk and the intersector dispatch.

The query semantics follow the reference's scene query
(OctreeSpatialManager.GetRayIntersection, OctreeSpatialManager.cs:312-455):
optional backface culling, an ``ignore_tri`` id for self-intersection
avoidance (MeshOctree.cs:290) and an ``ignore_mesh`` id for convex-geometry
reflection rays (RayTracer.cs:554-559), with ties broken by scan order
(strict ``<`` on distance).  Every backend returns the *exact* nearest hit;
they differ only in which triangle wins an exact-t tie.

The brute-force sweep and the octree walk are plain PyTorch, as the JAX
package computes them with XLA outside any kernel
(raytpu/accel/traverse.py:39-238); the tiled query is in accel/tiled.py and
the cluster walk, whose CUDA kernels the card runs, in kernels/fused.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch.config import Intersector
from raytpu_torch.core.intersect import facing_gate, moller_trumbore, ray_aabb

FLOAT_MAX = float(np.finfo(np.float32).max)  # 3.4028235e38
# Ray-triangle pairs a sweep or a tiled chunk evaluates at once: every
# (rays, triangles) temporary of eager PyTorch is materialised, so the rays
# are cut into chunks as well as the triangles (2^25 pairs: 128 MB per
# float temporary).
PAIR_BUDGET = 1 << 25
# The octree walk reads on the host whether any ray still walks once every
# this many steps; the steps in between are no-ops for finished rays.
OCTREE_CHECK_EVERY = 8
# Steps, leaf passes and host reads of the last octree query.
OCTREE_STATS = {"steps": 0, "leaf_passes": 0, "host_reads": 0}


class Hit(NamedTuple):
    """Nearest-hit result per ray (IntersectionResult,
    OctreeSpatialManager.cs:11-33, minus the world position)."""

    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) distance (FLOAT_MAX on miss)
    u: torch.Tensor  # (R,)
    v: torch.Tensor  # (R,)
    tri: torch.Tensor  # (R,) int32 triangle index (-1 on miss)


def _defaults(origin, ignore_tri, ignore_mesh, t_max):
    r, dev = origin.shape[0], origin.device
    i32 = torch.int32
    if ignore_tri is None:
        ignore_tri = torch.full((r,), -1, dtype=i32, device=dev)
    if ignore_mesh is None:
        ignore_mesh = torch.full((r,), -1, dtype=i32, device=dev)
    if t_max is None:
        t_max = torch.full((r,), FLOAT_MAX, dtype=torch.float32, device=dev)
    return ignore_tri.to(i32), ignore_mesh.to(i32), t_max.to(torch.float32)


def _finish(best_t, best_u, best_v, best_tri) -> Hit:
    hit = best_tri >= 0
    return Hit(hit=hit, t=torch.where(hit, best_t, FLOAT_MAX), u=best_u,
               v=best_v, tri=best_tri)


def _triangles(scene):
    """The scene's triangles from its shade rows: v1, e1, e2, snormal,
    mesh id, and which rows are triangles (a bridged bake's padding rows
    carry mesh id -1)."""
    s = scene.tri_shade
    mesh = s[:, 31].contiguous().view(torch.int32)
    return s[:, 0:3], s[:, 3:6], s[:, 6:9], s[:, 24:27], mesh, mesh >= 0


def nearest_hit_brute(scene, origin, direction, ignore_tri=None,
                      ignore_mesh=None, cull=True, block: int = 2048,
                      t_max=None) -> Hit:
    """Dense sweep over every triangle (raytpu/accel/traverse.py:60-116):
    division-form Möller–Trumbore with the facing gate on (rays, ``block``
    triangles) pairs and a strict-min update, so the lowest triangle index
    wins an exact-t tie.

    The JAX package sweeps all rays at once and XLA fuses the pass; eager
    PyTorch materialises every (rays, triangles) intermediate, so the rays
    are cut into chunks too (``PAIR_BUDGET`` pairs each).  Rays that cannot
    hit (a non-finite origin or direction, or a t bound not above 0) are
    left out of the sweep: their tests would all fail.  Neither changes a
    result."""
    r = origin.shape[0]
    itri, imesh, tmax = _defaults(origin, ignore_tri, ignore_mesh, t_max)
    v1, e1, e2, sn, mesh, valid = _triangles(scene)
    n = v1.shape[0]
    block = max(1, min(block, n))
    best_t = tmax.clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_tri = torch.full_like(itri, -1)
    live = (torch.isfinite(origin).all(-1) & torch.isfinite(direction).all(-1)
            & (tmax > 0.0)).nonzero()[:, 0]
    step = max(1, PAIR_BUDGET // block)
    for s in range(0, live.shape[0], step):
        rows = live[s:s + step]
        o = origin[rows][:, None, :]
        d = direction[rows][:, None, :]
        bt, bu, bv, bi = (best_t[rows], best_u[rows], best_v[rows],
                          best_tri[rows])
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            ok, u, v, dist = moller_trumbore(o, d, v1[None, lo:hi],
                                             e1[None, lo:hi], e2[None, lo:hi])
            if cull:
                ok &= facing_gate(sn[None, lo:hi], d, cull)
            ok &= valid[None, lo:hi]
            idx = torch.arange(lo, hi, dtype=torch.int32, device=o.device)
            ok &= idx[None, :] != itri[rows][:, None]
            ok &= mesh[None, lo:hi] != imesh[rows][:, None]
            dist = torch.where(ok, dist, FLOAT_MAX)
            j = dist.argmin(1, keepdim=True)  # the first lane on ties
            cand = dist.gather(1, j)[:, 0]
            upd = cand < bt
            bt = torch.where(upd, cand, bt)
            bu = torch.where(upd, u.gather(1, j)[:, 0], bu)
            bv = torch.where(upd, v.gather(1, j)[:, 0], bv)
            bi = torch.where(upd, idx[j[:, 0]], bi)
        best_t[rows], best_u[rows], best_v[rows], best_tri[rows] = (
            bt, bu, bv, bi)
    return _finish(best_t, best_u, best_v, best_tri)


def nearest_hit_octree(scene, origin, direction, ignore_tri=None,
                       ignore_mesh=None, cull=True, t_max=None) -> Hit:
    """Lockstep stackless octree walk (raytpu/accel/traverse.py:119-238)
    over ``scene.octree`` (accel/octree.py).

    The whole batch advances together: in the inner loop every unfinished
    ray steps its preorder node pointer (to ``i + 1`` when it enters an
    internal node before its best t, else to ``skip[i]``) until it parks on
    a leaf chunk or walks off the end; then every parked ray tests its
    chunk's (chunk, 3) triangle block with one dense Möller–Trumbore and a
    strict-min update, and jumps to ``skip``.  JAX's ``while_loop``s become
    Python loops that read on the host whether a ray still walks once every
    ``OCTREE_CHECK_EVERY`` inner steps and once per leaf pass; the counts
    of the last query are in ``OCTREE_STATS``."""
    oct_ = scene.octree
    if oct_ is None:
        raise ValueError("Intersector.OCTREE needs the octree bake: flatten "
                         "the scene with build_octree=True")
    node_min, node_max = oct_["node_min"], oct_["node_max"]
    node_skip = oct_["node_skip"].long()
    node_chunk = oct_["node_chunk"].long()
    leaf_tris = oct_["leaf_tris"]
    num_nodes = node_min.shape[0]
    itri, imesh, tmax = _defaults(origin, ignore_tri, ignore_mesh, t_max)
    # NaN rays (the reference's TIR refraction rays) never hit.
    bad = ~(torch.isfinite(direction).all(-1) & torch.isfinite(origin).all(-1))
    node = torch.where(bad, num_nodes, 0).long()
    best_t = tmax.clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_tri = torch.full_like(itri, -1)
    stats = {"steps": 0, "leaf_passes": 0, "host_reads": 0}
    while True:
        stats["host_reads"] += 1
        if not bool((node < num_nodes).any()):
            break
        parked = torch.zeros_like(bad)
        while True:
            for _ in range(OCTREE_CHECK_EVERY):
                safe = node.clamp(max=num_nodes - 1)
                box_hit, t_near = ray_aabb(origin, direction,
                                           node_min[safe], node_max[safe])
                active = (node < num_nodes) & ~parked
                enter = box_hit & (t_near < best_t)
                is_leaf = node_chunk[safe] >= 0
                newpark = active & enter & is_leaf
                nxt = torch.where(enter & ~is_leaf, node + 1, node_skip[safe])
                node = torch.where(active & ~newpark, nxt, node)
                parked = parked | newpark
                stats["steps"] += 1
            stats["host_reads"] += 1
            if not bool(((node < num_nodes) & ~parked).any()):
                break
        # Leaf pass: a dense (R, chunk) test of each parked ray's chunk.
        stats["leaf_passes"] += 1
        safe = node.clamp(max=num_nodes - 1)
        row = torch.where(parked, node_chunk[safe], 0)
        tri_ids = leaf_tris[row]
        d3 = direction[:, None, :]
        ok, u, v, dist = moller_trumbore(origin[:, None, :], d3,
                                         oct_["leaf_v1"][row],
                                         oct_["leaf_e1"][row],
                                         oct_["leaf_e2"][row])
        if cull:
            ok &= facing_gate(oct_["leaf_snormal"][row], d3, cull)
        ok &= tri_ids >= 0
        ok &= tri_ids != itri[:, None]
        ok &= oct_["leaf_mesh"][row] != imesh[:, None]
        ok &= parked[:, None]
        dist = torch.where(ok, dist, FLOAT_MAX)
        j = dist.argmin(1, keepdim=True)
        cand = dist.gather(1, j)[:, 0]
        upd = cand < best_t
        best_t = torch.where(upd, cand, best_t)
        best_u = torch.where(upd, u.gather(1, j)[:, 0], best_u)
        best_v = torch.where(upd, v.gather(1, j)[:, 0], best_v)
        best_tri = torch.where(upd, tri_ids.gather(1, j)[:, 0], best_tri)
        node = torch.where(parked, node_skip[safe], node)
    OCTREE_STATS.update(stats)
    return _finish(best_t, best_u, best_v, best_tri)


_BY_NAME = {"auto": Intersector.AUTO, "brute": Intersector.BRUTE,
            "octree": Intersector.OCTREE, "pallas": Intersector.PALLAS,
            "tiled": Intersector.TILED}


def resolve_intersector(scene, intersector, brute_force_max_tris: int = 4096):
    """The backend ``nearest_hit`` takes (raytpu/accel/traverse.py:
    275-291): ``AUTO`` is the brute-force sweep for scenes of up to
    ``brute_force_max_tris`` triangles; above that the cluster walk
    (``PALLAS``: its CUDA kernels on the card, its plain version on the CPU,
    at every cluster size) when the scene has clusters, else the octree
    walk when it has an octree, else the sweep."""
    mode = (_BY_NAME[intersector] if isinstance(intersector, str)
            else Intersector(intersector))
    if mode != Intersector.AUTO:
        return mode
    if scene.num_tris <= brute_force_max_tris:
        return Intersector.BRUTE
    if getattr(scene, "clusters", None) is not None:
        return Intersector.PALLAS
    if getattr(scene, "octree", None) is not None:
        return Intersector.OCTREE
    return Intersector.BRUTE


def nearest_hit(scene, origin, direction, ignore_tri=None, ignore_mesh=None,
                cull=True, intersector=Intersector.AUTO, block: int = 2048,
                brute_force_max_tris: int = 4096, cull_tile: int = 256,
                cull_chunk: int = 1, t_max=None, any_hit: bool = False,
                cull_pretest: bool = True, cull_recull: int = 6,
                cull_phase1: int = 0, cull_prepick: int = 0,
                cull_nbuf: int = 4, with_rows: bool = False,
                gate: bool = False):
    """Dispatch by configured intersector (config.Intersector, or its
    lower-case name), as ``resolve_intersector`` says.

    ``BRUTE`` sweeps ``block`` triangles at a time; ``OCTREE`` walks the
    octree bake; ``TILED`` (accel/tiled.py) tests tiles of ``cull_tile``
    rays against ``cull_chunk`` clusters per step.  ``PALLAS`` is the
    cluster walk (kernels/fused.py::nearest_hit_fused):
    ``cull_pretest``/``cull_recull``: its slab pretest and its re-cull
    every that many trips (0 = never), on by default as in the JAX package;
    they change the walk's shape, never its hits.  ``cull_phase1``: the
    two-phase compaction on that trip budget; ``cull_prepick``: the prepick
    walk with that many picks per tile and its rescue pass (it refuses the
    pretest and the re-cull with ``ValueError``, as the JAX package does);
    ``cull_nbuf``: the reference's DMA ring depth, any int >= 1, which sets
    nothing on the card; ``cull_chunk``: clusters per walk trip.  On a
    subcluster bake (cluster size 64 or 32) a walk without the pretest, the
    re-cull and the prepick walk is the subcluster walk; ``gate`` turns on
    its sibling gate (exact either way; the JAX package's ``nearest_hit``
    leaves it off).
    ``any_hit``: occlusion-query mode — the hit/no-hit boolean (against
    ``t_max``) is exact but the reported hit may not be the nearest
    (IsLightPathObstructed's early-out, RayTracer.cs:465-502); the sweep
    and the octree walk return the nearest hit, whose boolean is the same.
    ``with_rows``: return ``(Hit, rows)`` with the winners' (R, 32) shade
    rows (channel 31 = mesh id as a float value, zeros on misses; the
    walk's any-hit queries return None)."""
    mode = resolve_intersector(scene, intersector, brute_force_max_tris)
    if mode == Intersector.PALLAS:
        from raytpu_torch.kernels.fused import nearest_hit_fused

        return nearest_hit_fused(
            scene, origin, direction, ignore_tri, ignore_mesh, cull,
            tile_size=cull_tile, chunk_k=cull_chunk, t_max=t_max,
            any_hit=any_hit, pretest=cull_pretest, recull_every=cull_recull,
            phase1_trips=cull_phase1, prepick=cull_prepick, nbuf=cull_nbuf,
            gate=gate, return_rows=with_rows)
    if mode == Intersector.BRUTE:
        out = nearest_hit_brute(scene, origin, direction, ignore_tri,
                                ignore_mesh, cull, block, t_max=t_max)
    elif mode == Intersector.OCTREE:
        out = nearest_hit_octree(scene, origin, direction, ignore_tri,
                                 ignore_mesh, cull, t_max=t_max)
    elif mode == Intersector.TILED:
        from raytpu_torch.accel.tiled import nearest_hit_tiled

        out = nearest_hit_tiled(scene, origin, direction, ignore_tri,
                                ignore_mesh, cull, tile_size=cull_tile,
                                chunk=cull_chunk, t_max=t_max,
                                any_hit=any_hit)
    else:
        raise ValueError(f"no intersector {mode!r}")
    if not with_rows:
        return out
    from raytpu_torch.kernels.fused import gather_rows

    return out, gather_rows(scene.tri_shade, out.tri, out.hit)
