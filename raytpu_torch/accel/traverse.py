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

from raytpu.config import Intersector

FLOAT_MAX = float(np.finfo(np.float32).max)  # 3.4028235e38


class Hit(NamedTuple):
    """Nearest-hit result per ray (IntersectionResult,
    OctreeSpatialManager.cs:11-33, minus the world position)."""

    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) distance (FLOAT_MAX on miss)
    u: torch.Tensor  # (R,)
    v: torch.Tensor  # (R,)
    tri: torch.Tensor  # (R,) int32 triangle index (-1 on miss)


def nearest_hit(scene, origin, direction, ignore_tri=None, ignore_mesh=None,
                cull=True, intersector=Intersector.AUTO, cull_tile: int = 256,
                t_max=None, any_hit: bool = False, with_rows: bool = False):
    """Dispatch by configured intersector (config.Intersector).

    ``AUTO`` and ``PALLAS`` run the cluster walk (kernels/fused.py).
    ``any_hit``: occlusion-query mode — the hit/no-hit boolean (against
    ``t_max``) is exact but the reported hit is not the nearest
    (IsLightPathObstructed's early-out, RayTracer.cs:465-502).
    ``with_rows``: return ``(Hit, rows)`` with the winners' (R, 32) shade
    rows (channel 31 = mesh id as a float value; None for any-hit)."""
    if intersector not in (Intersector.AUTO, Intersector.PALLAS):
        raise NotImplementedError(
            f"intersector {Intersector(intersector).name} is not ported yet: "
            "ROADMAP.md, queue 1 item 5 (the other query backends)")
    from raytpu_torch.kernels.fused import nearest_hit_fused

    return nearest_hit_fused(
        scene, origin, direction, ignore_tri, ignore_mesh, cull,
        tile_size=cull_tile, t_max=t_max, any_hit=any_hit,
        return_rows=with_rows,
    )
