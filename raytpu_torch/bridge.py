"""State carried across from the JAX package: baked scenes as NumPy arrays.

The caller converts the reference's ``FlatScene`` leaves (and its
``clusters`` dict) with ``np.asarray``, and an ``InstancedScene``'s bakes,
instance matrices and lights likewise; this module never imports JAX.  The
port's own bakes (scene/flatten.py, render/instanced.py) produce the same
arrays bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.device import resolve
from raytpu_torch.scene.types import FlatScene

TABLES = ("tri_shade", "mesh_material", "mesh_convex", "mat_reflect",
          "mat_transparent", "mat_refraction", "mat_use_texture",
          "mat_interp_normals", "mat_texture", "textures", "tex_hw")
META = ("num_tris", "num_meshes", "num_lights", "light_kinds",
        "has_transparent", "has_textures")


def _tensor(a):
    return torch.from_numpy(np.array(a))  # a contiguous, writable copy


def flat_scene_from_numpy(arrays: dict, meta: dict,
                          device="cuda") -> FlatScene:
    """Build the port's FlatScene from the reference bake's arrays, on
    ``device`` (the card unless the caller names another).

    ``arrays``: the tables named in ``TABLES``, ``lights`` (dict) and
    ``clusters`` (dict with ``block`` (NCG, 24, C), ``aabb`` (6, 8, NC8),
    ``sub_plane`` (1, 5, 8, NC8) and ``root`` (1, 8)).  ``meta``: the
    static fields named in ``META``.  The cull tables are cut from the
    reference's padded (8, NC8) grids to (6, NCG) and (5, NCG)."""
    dev = resolve(device)
    cl = arrays["clusters"]
    block = np.asarray(cl["block"], np.float32)
    ncg = block.shape[0]
    if "sub_aabb" in cl or "sub_plane" not in cl:
        raise NotImplementedError(
            "only cluster_size-128-style bakes with fitted planes are "
            "ported: ROADMAP.md, queue 2 item 3 (subcluster walk)")
    aabb = np.asarray(cl["aabb"], np.float32).reshape(6, -1)[:, :ncg]
    plane = np.asarray(cl["sub_plane"], np.float32).reshape(5, -1)[:, :ncg]
    root = np.asarray(cl["root"], np.float32).reshape(8)

    tables = {k: _tensor(arrays[k]) for k in TABLES}
    clusters = {"block": _tensor(block), "aabb": _tensor(aabb),
                "plane": _tensor(plane), "root": _tensor(root)}
    # Triangle and mesh ids ride as int32 bits in block rows 16/17 and in
    # tri_shade channel 31; the walk indexes tri_shade with the former.
    n_tris = tables["tri_shade"].shape[0]
    n_mesh = tables["mesh_material"].shape[0]
    ids = clusters["block"][:, 16].view(torch.int32)
    meshes = clusters["block"][:, 17].view(torch.int32)
    row_mesh = tables["tri_shade"][:, 31].contiguous().view(torch.int32)
    if not (bool(((ids >= -1) & (ids < n_tris)).all())
            and bool(((meshes >= -1) & (meshes < n_mesh)).all())
            and bool(((row_mesh >= -1) & (row_mesh < n_mesh)).all())):
        raise ValueError("triangle or mesh ids out of range in the bake")
    scene = FlatScene(
        clusters=clusters,
        lights={k: _tensor(a) for k, a in arrays["lights"].items()},
        **tables,
        **{k: meta[k] for k in META},
    )
    return scene.to(dev)


def instanced_scene_from_numpy(bakes, instances, lights: dict,
                               num_lights: int, device="cuda"):
    """Build the port's InstancedScene from a reference ``InstancedScene``'s
    arrays, on ``device`` (the card unless the caller names another).

    ``bakes``: per shared bake, the ``(arrays, meta)`` that
    ``flat_scene_from_numpy`` takes; ``instances``: per instance,
    ``(mesh_index, world, inv_world)`` with (4, 4) matrices; ``lights``: the
    packed light tables."""
    from raytpu_torch.accel.instanced import Instance
    from raytpu_torch.render.instanced import assemble_instanced

    dev = resolve(device)
    return assemble_instanced(
        [flat_scene_from_numpy(a, m, device=dev) for a, m in bakes],
        [Instance(int(mi), np.asarray(w, np.float32),
                  np.asarray(iw, np.float32)) for mi, w, iw in instances],
        {k: np.array(v) for k, v in lights.items()}, num_lights, dev)
