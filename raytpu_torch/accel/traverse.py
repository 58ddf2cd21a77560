"""Nearest-hit queries: the ``Hit`` result and the intersector dispatch.

The query semantics follow the reference's scene query
(OctreeSpatialManager.GetRayIntersection, OctreeSpatialManager.cs:312-455):
optional backface culling, an ``ignore_tri`` id for self-intersection
avoidance (MeshOctree.cs:290) and an ``ignore_mesh`` id for convex-geometry
reflection rays (RayTracer.cs:554-559).  The result is the *exact* nearest
hit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch.config import Intersector

FLOAT_MAX = float(np.finfo(np.float32).max)  # 3.4028235e38


class Hit(NamedTuple):
    """Nearest-hit result per ray (IntersectionResult,
    OctreeSpatialManager.cs:11-33, minus the world position)."""

    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) distance (FLOAT_MAX on miss)
    u: torch.Tensor  # (R,)
    v: torch.Tensor  # (R,)
    tri: torch.Tensor  # (R,) int32 triangle index (-1 on miss)


def _refuse(name, value, default, item):
    if value != default:
        raise NotImplementedError(
            f"{name}={value!r} is not ported yet: ROADMAP.md, {item}")


def nearest_hit(scene, origin, direction, ignore_tri=None, ignore_mesh=None,
                cull=True, intersector=Intersector.AUTO, block: int = 2048,
                brute_force_max_tris: int = 4096, cull_tile: int = 256,
                cull_chunk: int = 1, t_max=None, any_hit: bool = False,
                cull_pretest: bool = True, cull_recull: int = 6,
                cull_phase1: int = 0, cull_prepick: int = 0,
                cull_nbuf: int = 4, with_rows: bool = False,
                gate: bool = False):
    """Dispatch by configured intersector (config.Intersector).

    ``AUTO`` and ``PALLAS`` run the cluster walk (kernels/fused.py) at every
    scene size: the port's ``AUTO`` always walks, where the JAX package's
    takes its brute-force sweep up to ``brute_force_max_tris`` triangles
    (that backend is ROADMAP.md queue 1 item 5).  ``block`` (the sweep's
    triangle block) and ``brute_force_max_tris`` keep the JAX signature;
    values other than their defaults raise ``NotImplementedError``.
    ``cull_pretest``/``cull_recull``: the walk's slab pretest and its
    re-cull every that many trips (0 = never), on by default as in the JAX
    package; they change the walk's shape, never its hits.
    ``cull_phase1``: the two-phase compaction on that trip budget;
    ``cull_prepick``: the prepick walk with that many picks per tile and its
    rescue pass (it refuses the pretest and the re-cull with ``ValueError``,
    as the JAX package does); ``cull_nbuf``: the reference's DMA ring
    depth, any int >= 1, which sets nothing on the card; ``cull_chunk``:
    clusters per walk trip (``kernels/fused.py::nearest_hit_fused``).
    On a subcluster bake (cluster size 64 or 32) a query without the
    pretest, the re-cull and the prepick walk takes the subcluster walk;
    ``gate`` turns on its sibling gate (exact either way; the JAX
    package's ``nearest_hit`` leaves it off).
    ``any_hit``: occlusion-query mode — the hit/no-hit boolean (against
    ``t_max``) is exact but the reported hit is not the nearest
    (IsLightPathObstructed's early-out, RayTracer.cs:465-502).
    ``with_rows``: return ``(Hit, rows)`` with the winners' (R, 32) shade
    rows (channel 31 = mesh id as a float value; None for any-hit)."""
    if intersector not in (Intersector.AUTO, Intersector.PALLAS):
        raise NotImplementedError(
            f"intersector {Intersector(intersector).name} is not ported yet: "
            "ROADMAP.md, queue 1 item 5 (the other query backends)")
    _refuse("block", block, 2048, "queue 1 item 5 (the other query backends)")
    _refuse("brute_force_max_tris", brute_force_max_tris, 4096,
            "queue 1 item 5 (the other query backends)")
    from raytpu_torch.kernels.fused import nearest_hit_fused

    return nearest_hit_fused(
        scene, origin, direction, ignore_tri, ignore_mesh, cull,
        tile_size=cull_tile, chunk_k=cull_chunk, t_max=t_max,
        any_hit=any_hit, pretest=cull_pretest, recull_every=cull_recull,
        phase1_trips=cull_phase1, prepick=cull_prepick, nbuf=cull_nbuf,
        gate=gate, return_rows=with_rows,
    )
