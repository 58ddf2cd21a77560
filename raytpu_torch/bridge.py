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
# Cluster tables carried across as they are: the tiled query's leaf
# tables, shadow clearance's triangle-to-block map and, when baked, the
# matmul pair test's coefficient table.
CARRIED = ("cluster_min", "cluster_max", "tri_id", "tri_mesh", "tri_v1",
           "tri_e1", "tri_e2", "tri_snormal", "tri_block", "gblock")
META = ("num_tris", "num_meshes", "num_lights", "light_kinds",
        "has_transparent", "has_textures", "has_dual_branch")


def _tensor(a):
    return torch.from_numpy(np.array(a))  # a contiguous, writable copy


def _cut(grid, ncg):
    """A reference cull grid (..., 8, NC8) as (..., NCG): block g sits at
    flat position g of the (8, NC8) grid."""
    a = np.asarray(grid, np.float32)
    return a.reshape(a.shape[:-2] + (-1,))[..., :ncg]


def flat_scene_from_numpy(arrays: dict, meta: dict,
                          device="cuda") -> FlatScene:
    """Build the port's FlatScene from the reference bake's arrays, on
    ``device`` (the card unless the caller names another).

    ``arrays``: the tables named in ``TABLES``, ``lights`` (dict),
    ``clusters`` (dict with ``block`` (NCG, 24, L), ``aabb`` (6, 8, NC8),
    ``sub_plane`` (subk, 5, 8, NC8), ``root`` (1, 8) and, for a subcluster
    bake (cluster size 64 or 32, subk > 1), ``sub_aabb`` (subk, 6, 8,
    NC8); the tables named in ``CARRIED`` ride across as they are) and,
    optionally, ``octree`` (the reference's ``FlatOctree.as_device_arrays``
    dict, or None).  ``meta``: the static fields named in ``META``.  The
    cull tables are cut from the reference's padded (8, NC8) grids to
    (6, NCG) and (5, NCG) (a 128-style bake's ``sub_plane`` becomes
    ``plane``), or to (subk, 6, NCG) and (subk, 5, NCG)."""
    dev = resolve(device)
    cl = arrays["clusters"]
    block = np.asarray(cl["block"], np.float32)
    ncg = block.shape[0]
    if "sub_plane" not in cl:
        raise ValueError("the bake has no fitted-plane rows (sub_plane); "
                         "bake it with build_plane=True")
    clusters = {"block": block, "aabb": _cut(cl["aabb"], ncg),
                "root": np.asarray(cl["root"], np.float32).reshape(8)}
    sub_plane = _cut(cl["sub_plane"], ncg)
    if "sub_aabb" in cl:
        clusters["sub_aabb"] = _cut(cl["sub_aabb"], ncg)
        clusters["sub_plane"] = sub_plane
    else:
        clusters["plane"] = sub_plane[0]
    clusters.update({k: cl[k] for k in CARRIED if k in cl})
    clusters = {k: _tensor(a) for k, a in clusters.items()}
    octree = arrays.get("octree")
    if octree is not None:
        octree = {k: _tensor(a) for k, a in octree.items()}

    tables = {k: _tensor(arrays[k]) for k in TABLES}
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
        octree=octree,
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


def fit_state_from_numpy(params: dict, adam=None, learning_rate: float = 1e-2,
                         device="cuda"):
    """Carry a fit's training state across: the reference fit's params (a
    dict of NumPy arrays, ``diff/params.py`` field names) and, optionally,
    its ``optax.adam`` state as NumPy, ``(count, mu, nu)`` with ``mu`` and
    ``nu`` dicts like ``params``.

    Returns ``(params, state)``: the port's params (leaf tensors on
    ``device``, floating ones requiring grad) and the ``state_dict`` of a
    ``torch.optim.Adam(learning_rate)`` over them in the order of their
    names (as ``fit`` holds them), with the same moments and step count
    (None without ``adam``).  The
    pair is what ``diff/fit.py::fit`` checkpoints, so a fit begun in one
    package goes on in the other through ``io/checkpoint.py``."""
    dev = resolve(device)
    out = {}
    for name, a in params.items():
        x = _tensor(a).to(dev)
        out[name] = x.requires_grad_() if x.is_floating_point() else x
    if adam is None:
        return out, None
    count, mu, nu = adam
    opt = torch.optim.Adam([out[k] for k in sorted(out)], lr=learning_rate)
    for name, x in out.items():
        opt.state[x] = {
            "step": torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32),
            "exp_avg": _tensor(mu[name]).to(dev),
            "exp_avg_sq": _tensor(nu[name]).to(dev)}
    return out, opt.state_dict()
