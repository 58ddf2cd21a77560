"""Möller–Trumbore acceptance in det-multiplied space, on tensors, the
guarded Möller–Trumbore recompute of the differentiable render, and the
division-form test, backface gate and slab test of the brute-force, octree
and tiled queries (accel/).

``kernels/csrc/walk.cu`` carries the acceptance rule in C++ (``accept`` and
``accept_within``); the plain walk in ``kernels/fused.py`` calls these.
"""

from __future__ import annotations

import torch

from raytpu_torch.core.math3d import cross, dot


def _det_sign(det):
    return torch.where(det < 0.0, -1.0, 1.0).to(det.dtype)


def det_space_accept(det, udet, vdet, tdet, cull):
    """Acceptance of a (ray, triangle) pair from its det-space quantities.

    ``cull=True``: backface culling accepts det < 0 only (sign(det) ==
    sign(dot(snormal, d)) under the accel/clusters.py packing).
    ``cull="reverse"``: accepts det > 0 only — the mirror, for queries cast
    along the reversed ray (shadow rays cast from the light).
    ``cull=False``: folds the sign; ``ps > 0`` excludes det == 0, which the
    reference's guardless division never accepts either
    (RayExtensions.cs:13-75)."""
    if cull == "reverse":
        return ((udet >= 0.0) & (vdet >= 0.0) & (tdet >= 0.0)
                & (udet + vdet <= det) & (det > 0.0))
    if cull:
        return ((udet <= 0.0) & (vdet <= 0.0) & (tdet <= 0.0)
                & (udet + vdet >= det) & (det < 0.0))
    s = _det_sign(det)
    us, vs, ts_, ps = udet * s, vdet * s, tdet * s, det * s
    return ((us >= 0.0) & (vs >= 0.0) & (ts_ >= 0.0)
            & (us + vs <= ps) & (ps > 0.0))


def det_space_accept_within(det, udet, vdet, tdet, t_max, cull):
    """``det_space_accept`` AND hit distance strictly below ``t_max``,
    without a division: ``tdet/det < t_max`` as a det-sign-aware product
    comparison (IsLightPathObstructed, RayTracer.cs:465-502)."""
    ok = det_space_accept(det, udet, vdet, tdet, cull)
    if cull == "reverse":
        return ok & (tdet < t_max * det)
    if cull:
        return ok & (tdet > t_max * det)
    s = _det_sign(det)
    return ok & (tdet * s < t_max * (det * s))


def moller_trumbore_safe(origin, direction, v1, e1, e2, eps: float = 1e-20):
    """Möller–Trumbore (RayExtensions.cs:13-39) with a determinant guard,
    for the differentiable recompute (render/wavefront.py,
    ``cfg.differentiable``).  Returns ``(u, v, d)``.

    For a triangle that passed the acceptance test the determinant is
    nonzero and the guard never fires; for masked-out lanes (missed rays
    gathering a placeholder triangle) it keeps inf/NaN out of the values,
    whose zero cotangents would otherwise turn the gradients NaN."""
    t = origin - v1
    p = cross(direction, e2)
    q = cross(t, e1)
    det = dot(p, e1)
    det = torch.where(det.abs() < eps, 1.0, det)
    inv_det = 1.0 / det
    d = dot(q, e2) * inv_det
    u = dot(p, t) * inv_det
    v = dot(q, direction) * inv_det
    return u, v, d


def moller_trumbore(origin, direction, v1, e1, e2):
    """Möller–Trumbore over broadcastable (..., 3) stacks of rays and
    triangles (``e1 = v2 - v1``, ``e2 = v3 - v1``), exactly as
    ``RayExtensions.IntersectsTriangle`` (RayExtensions.cs:13-39): no guard
    on the determinant (a parallel ray divides by zero, and the inf/NaN
    fails the acceptance), acceptance ``u >= 0 && v >= 0 && d >= 0 &&
    u + v <= 1``.  Returns ``(hit, u, v, d)``."""
    t = origin - v1
    p = cross(direction, e2)
    q = cross(t, e1)
    det = dot(p, e1)
    inv_det = 1.0 / det
    d = dot(q, e2) * inv_det
    u = dot(p, t) * inv_det
    v = dot(q, direction) * inv_det
    hit = (u >= 0.0) & (v >= 0.0) & (d >= 0.0) & (u + v <= 1.0)
    return hit, u, v, d


def facing_gate(surface_normal, direction, cull):
    """The backface-cull gate (RayExtensions.cs:48-51) as a mask:
    ``cull=True`` accepts triangles facing the ray, ``cull="reverse"`` those
    that would face the reversed ray (shadow rays cast from the light)."""
    if cull == "reverse":
        return dot(surface_normal, direction) >= 0.0
    return dot(surface_normal, direction) <= 0.0


def ray_aabb(origin, direction, box_min, box_max):
    """XNA ``BoundingBox.Intersects(ref Ray)`` slab test over (..., 3) rays
    and boxes.  Returns ``(hit, t_near)``: ``t_near`` is 0 when the origin
    is inside the box, else the slab entry distance.  An axis with
    ``|d| < 1e-6`` is parallel: it misses unless the origin lies in its
    slab, and does not constrain t."""
    parallel = direction.abs() < 1e-6
    inside_slab = (origin >= box_min) & (origin <= box_max)
    inv = 1.0 / torch.where(parallel, 1.0, direction)
    t1 = (box_min - origin) * inv
    t2 = (box_max - origin) * inv
    t_lo = torch.where(parallel, -float("inf"), torch.minimum(t1, t2))
    t_hi = torch.where(parallel, float("inf"), torch.maximum(t1, t2))
    t_near = torch.clamp(t_lo.amax(-1), min=0.0)
    t_far = t_hi.amin(-1)
    hit = ((t_near <= t_far) & (t_far >= 0.0)
           & (~parallel | inside_slab).all(-1))
    return hit, t_near
