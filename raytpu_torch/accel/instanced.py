"""Two-level instanced intersection — the reference's scene-octree design.

The reference's scene level (OctreeSpatialManager.cs:312-482) keeps ONE
copy of each mesh and intersects instances by transforming the ray into
each candidate object's space via ``InverseWorld`` — the two-point method:
transform origin and origin+dir as points, re-subtract, normalize
(OctreeSpatialManager.cs:349-364) — then compares WORLD distances of the
per-object hits (OctreeSpatialManager.cs:438-452).

The baked path (scene/flatten.py) puts instances into one world-space
triangle soup.  This module is the two-level alternative for scenes where N
instances of a large mesh would cost N copies of its bake: per unique mesh
one FlatScene bake in object space, per instance a world/inverse pair; rays
are transformed per instance, intersected against the shared bake and
merged by world-space distance.

Scene-level pruning (the OctreeSpatialManager.cs:457-482 analog): before
each instance's pass, every ray runs a slab test against the instance's
conservative WORLD box (the transformed object-bounds corners), bounded by
its current best world distance.  Rays that provably cannot hit the
instance closer than their running best enter the pass as dead lanes (NaN
direction), which the walk keeps out of its tile beams; a pass with no live
ray at all is skipped.  That skip asks the host whether any ray is live
(``bool(live.any())``), one device synchronisation per instance pass.

Transforms are written out term by term, so they round the same on the CPU
and on the card.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from raytpu_torch.accel.traverse import FLOAT_MAX, nearest_hit
from raytpu_torch.config import Intersector
from raytpu_torch.core.math3d import length

INF = FLOAT_MAX


class InstancedHit(NamedTuple):
    """Nearest hit over all instances, distances in WORLD space."""

    hit: torch.Tensor       # (R,) bool
    t_world: torch.Tensor   # (R,) world-space distance to the hit
    u: torch.Tensor         # (R,) barycentric u (object space — invariant)
    v: torch.Tensor         # (R,)
    tri: torch.Tensor       # (R,) int32 triangle id within the winning bake
    instance: torch.Tensor  # (R,) int32 winning instance index (-1 on miss)


class Instance(NamedTuple):
    mesh_index: int        # index into the shared mesh bakes
    world: np.ndarray      # (4, 4) row-vector convention (p @ W)
    inv_world: np.ndarray  # (4, 4)


def make_instance(mesh_index: int, world: np.ndarray) -> Instance:
    world = np.asarray(world, np.float32)
    return Instance(mesh_index, world, np.linalg.inv(world).astype(np.float32))


def transform_points(p, m):
    """``p @ m[:3, :3] + m[3, :3]`` for (..., 3) points and a (4, 4) or
    per-point (..., 4, 4) row-vector matrix, summed left to right."""
    return (p[..., 0, None] * m[..., 0, :3] + p[..., 1, None] * m[..., 1, :3]
            + p[..., 2, None] * m[..., 2, :3]) + m[..., 3, :3]


def transform_vectors(v, m):
    """``v @ m`` for (..., 3) vectors and (..., 3, 3) matrices."""
    return (v[..., 0, None] * m[..., 0, :] + v[..., 1, None] * m[..., 1, :]
            + v[..., 2, None] * m[..., 2, :])


_CORNERS = [[(i >> k) & 1 for k in range(3)] for i in range(8)]


def _world_box(root, world):
    pick = torch.as_tensor(_CORNERS, dtype=torch.bool, device=root.device)
    corners = torch.where(pick, root[3:6], root[0:3])  # (8, 3)
    cw = transform_points(corners, world)
    return cw.amin(0), cw.amax(0)


def instance_world_aabb(bake, world):
    """Conservative world-space box ``(min, max)`` of a mesh bake under
    ``world`` ((4, 4), on the bake's device): the 8 corners of the
    object-space root box transformed, then min/max."""
    return _world_box(bake.clusters["root"], world)


def _instance_tables(mesh_bakes, instances, device):
    """Per-instance world and inverse matrices (I, 4, 4) on ``device``, in
    one host-to-device copy, and each instance's world box (I, 3) twice."""
    mats = torch.as_tensor(
        np.stack([np.stack([i.world, i.inv_world]) for i in instances]),
        device=device)
    worlds, invs = mats[:, 0], mats[:, 1]
    boxes = [instance_world_aabb(mesh_bakes[inst.mesh_index], worlds[i])
             for i, inst in enumerate(instances)]
    mns = torch.stack([b[0] for b in boxes])
    mxs = torch.stack([b[1] for b in boxes])
    return worlds, invs, mns, mxs


def _prune_mask(origin, direction, mn, mx, cap):
    """Rays that could still hit inside [mn, mx] closer than ``cap``.

    Conservative slab test with a relative margin; misses and rays whose
    entry distance already exceeds their running best are pruned exactly
    (the box contains the instance, so no closer hit exists inside)."""
    margin = 1e-4 * (mx - mn).amax() + 1e-5
    t_en = torch.full(origin.shape[:1], -INF, dtype=torch.float32,
                      device=origin.device)
    t_ex = torch.full_like(t_en, INF)
    for k in range(3):
        d = direction[:, k]
        safe_d = torch.where(d == 0.0, 1e-30, d)
        t1 = (mn[k] - margin - origin[:, k]) / safe_d
        t2 = (mx[k] + margin - origin[:, k]) / safe_d
        t_en = torch.maximum(t_en, torch.minimum(t1, t2))
        t_ex = torch.minimum(t_ex, torch.maximum(t1, t2))
    return (t_en <= t_ex) & (t_ex >= 0.0) & (t_en < cap)


def order_front_to_back(instances: List[Instance], mesh_bakes: List,
                        eye) -> List[int]:
    """Instance indices ordered by world-box distance from ``eye``.

    Host-side: the instance-hierarchy role of the reference's sorted
    scene-octree walk (OctreeSpatialManager.cs:457-482).  Passing near
    instances first tightens every ray's running best early, so the
    per-instance prune (and the pass skip) eliminates far instances."""
    eye = np.asarray(eye, np.float32)
    d = []
    for inst in instances:
        root = mesh_bakes[inst.mesh_index].clusters["root"].cpu()
        mn, mx = _world_box(root, torch.as_tensor(inst.world))
        nearest = np.clip(eye, mn.numpy(), mx.numpy())
        d.append(float(np.linalg.norm(nearest - eye)))
    return [int(i) for i in np.argsort(d, kind="stable")]


def _object_rays(origin, direction, inv):
    """Rays in an instance's object space by the two-point method, and the
    object length of a unit world step."""
    o_obj = transform_points(origin, inv)
    d_obj = transform_points(origin + direction, inv) - o_obj
    norm = length(d_obj)
    return o_obj, d_obj / torch.where(norm == 0, 1.0, norm)[:, None], norm


def _merge_pass(best: InstancedHit, bake, origin, o_obj, d_obj, world,
                inst_id, t_max_obj, itri, intersector, kw) -> InstancedHit:
    """One instance's intersector pass, merged into ``best`` by world
    distance (OctreeSpatialManager.cs:438-452)."""
    h = nearest_hit(bake, o_obj, d_obj, t_max=t_max_obj, ignore_tri=itri,
                    intersector=intersector, **kw)
    s = bake.tri_shade[h.tri.clamp(min=0)]
    frag_obj = (s[:, 0:3] + s[:, 3:6] * h.u[:, None]
                + s[:, 6:9] * h.v[:, None])
    t_world = length(transform_points(frag_obj, world) - origin)
    t_world = torch.where(h.hit, t_world, INF)
    upd = t_world < best.t_world
    return InstancedHit(
        hit=best.hit | (upd & h.hit),
        t_world=torch.where(upd, t_world, best.t_world),
        u=torch.where(upd, h.u, best.u),
        v=torch.where(upd, h.v, best.v),
        tri=torch.where(upd, h.tri, best.tri),
        instance=torch.where(upd, inst_id, best.instance),
    )


def _no_hit(r, device) -> InstancedHit:
    i32 = torch.int32
    return InstancedHit(
        hit=torch.zeros((r,), dtype=torch.bool, device=device),
        t_world=torch.full((r,), INF, dtype=torch.float32, device=device),
        u=torch.zeros((r,), dtype=torch.float32, device=device),
        v=torch.zeros((r,), dtype=torch.float32, device=device),
        tri=torch.full((r,), -1, dtype=i32, device=device),
        instance=torch.full((r,), -1, dtype=i32, device=device),
    )


def _ignore_for(ignore_tri, ignore_instance, inst_id):
    if ignore_tri is None:
        return None
    return torch.where(ignore_instance == inst_id, ignore_tri.to(torch.int32),
                       -1)


def nearest_hit_instanced(mesh_bakes: List, instances: List[Instance],
                          origin, direction, t_max=None,
                          ignore_tri=None, ignore_instance=None,
                          intersector: Intersector = Intersector.AUTO,
                          prune: bool = True, return_stats: bool = False,
                          skip_empty: bool = True, order=None,
                          **kw) -> InstancedHit:
    """Nearest hit of ``origin``/``direction`` (R, 3, world space) over all
    instances, merged by world distance.

    ``mesh_bakes``: per unique mesh, a FlatScene of that mesh alone in
    OBJECT space, on the rays' device.  One intersector pass per instance
    (OctreeSpatialManager.cs:366-379), with ``nearest_hit``'s walk defaults
    (pretest on, re-cull every 6 trips) unless ``kw`` names others.

    ``t_max``: (R,) WORLD-space bound (converted per instance to object
    scale through the direction-transform norm).  ``ignore_tri`` with
    ``ignore_instance``: per-ray (triangle, instance) to skip — the other
    instances of the same mesh still test that triangle.

    ``prune``: scene-level world-box ray pruning (module docstring), exact.
    ``return_stats``: also return the (num_instances,) live-ray counts per
    pass.  ``skip_empty``: skip a pass with no live ray (a host
    synchronisation per pass); ``order``: the instance order, a permutation
    of ``range(len(instances))`` (e.g. ``order_front_to_back``)."""
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    r, dev = origin.shape[0], origin.device
    best = _no_hit(r, dev)
    if order is not None:
        order = list(order)
        if sorted(order) != list(range(len(instances))):
            raise ValueError(
                f"order must be a permutation of range({len(instances)})")
    worlds, invs, mns, mxs = _instance_tables(mesh_bakes, instances, dev)
    if t_max is not None:
        t_max = t_max.to(torch.float32)
    stats = [None] * len(instances)
    for idx in (order if order is not None else range(len(instances))):
        bake = mesh_bakes[instances[idx].mesh_index]
        o_obj, d_obj, norm = _object_rays(origin, direction, invs[idx])
        live = None
        if prune:
            cap = (best.t_world if t_max is None
                   else torch.minimum(best.t_world, t_max))
            live = _prune_mask(origin, direction, mns[idx], mxs[idx], cap)
            d_obj = torch.where(live[:, None], d_obj, float("nan"))
            if return_stats:
                stats[idx] = live.sum().to(torch.int32)
        elif return_stats:
            stats[idx] = torch.tensor(r, dtype=torch.int32, device=dev)
        if skip_empty and live is not None and not bool(live.any()):
            continue
        best = _merge_pass(best, bake, origin, o_obj, d_obj, worlds[idx], idx,
                           None if t_max is None else t_max * norm,
                           _ignore_for(ignore_tri, ignore_instance, idx),
                           intersector, kw)
    if return_stats:
        return best, torch.stack(stats)
    return best


def nearest_hit_instanced_scan(mesh_bakes: List, instances: List[Instance],
                               origin, direction, t_max=None,
                               ignore_tri=None, ignore_instance=None,
                               intersector: Intersector = Intersector.AUTO,
                               prune: bool = True,
                               return_stats: bool = False, **kw):
    """``nearest_hit_instanced`` grouped by mesh bake, each group's
    instances in front-to-back order for this batch.

    The JAX package runs each group as one ``lax.scan`` so that its traced
    program does not grow with the instance count; the port runs eagerly,
    so each group is a Python loop.  The order is the reference's: per
    group, instances sorted (stably) by the distance of their world box from
    the centroid of the batch's finite origins, so the running best
    tightens on near instances first.  A pass with no live ray is skipped
    (one host synchronisation per instance, plus one per group for its
    order).  ``return_stats``: live counts indexed by ORIGINAL instance
    position."""
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    r, dev = origin.shape[0], origin.device
    best = _no_hit(r, dev)
    stats = torch.zeros((len(instances),), dtype=torch.int32, device=dev)
    worlds, invs, mns, mxs = _instance_tables(mesh_bakes, instances, dev)
    cap_user = None if t_max is None else t_max.to(torch.float32)

    finite_o = torch.isfinite(origin).all(-1, keepdim=True)
    centroid = (torch.where(finite_o, origin, 0.0).sum(0)
                / finite_o.sum().clamp(min=1))

    groups = {}
    for idx, inst in enumerate(instances):
        groups.setdefault(inst.mesh_index, []).append(idx)
    for mesh_index, grp in groups.items():
        bake = mesh_bakes[mesh_index]
        ids = torch.as_tensor(grp, device=dev)
        near = torch.minimum(torch.maximum(centroid, mns[ids]), mxs[ids])
        dist = length(near - centroid)
        for inst_id in ids[torch.argsort(dist, stable=True)].tolist():
            o_obj, d_obj, norm = _object_rays(origin, direction,
                                              invs[inst_id])
            cap = (best.t_world if cap_user is None
                   else torch.minimum(best.t_world, cap_user))
            if prune:
                live = _prune_mask(origin, direction, mns[inst_id],
                                   mxs[inst_id], cap)
            else:
                live = torch.ones((r,), dtype=torch.bool, device=dev)
            d_obj = torch.where(live[:, None], d_obj, float("nan"))
            stats[inst_id] = live.sum().to(torch.int32)
            if not bool(live.any()):
                continue
            best = _merge_pass(
                best, bake, origin, o_obj, d_obj, worlds[inst_id], inst_id,
                None if cap_user is None else cap_user * norm,
                _ignore_for(ignore_tri, ignore_instance, inst_id),
                intersector, kw)
    if return_stats:
        return best, stats
    return best
