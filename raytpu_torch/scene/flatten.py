"""Scene → FlatScene baking (host-side NumPy, then tensors on a device).

Instance transforms are applied to vertices (world matrix) and vertex
normals (inverse-transpose, normalized — TracerModelProcessor.cs:190-197);
face normals are recomputed as ``normalize(cross(e2, e1))``
(TracerModelProcessor.cs:199-203).  The arithmetic is the reference bake's,
so the arrays agree with it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.accel.clusters import build_clusters
from raytpu_torch.device import resolve
from raytpu_torch.scene import lights as lights_mod
from raytpu_torch.scene.types import FlatScene, Scene


def _transform_points(p: np.ndarray, m: np.ndarray) -> np.ndarray:
    return p @ m[:3, :3] + m[3, :3]


MAX_LIGHTS = 4  # light slots of the packed table, as in the reference bake


def flatten_scene(scene: Scene, cluster_size: int = 128,
                  build_octree: bool = True, leaf_threshold: int = 50,
                  max_depth: int = 12, build_gblock: bool = False,
                  device="cuda") -> FlatScene:
    """Bake ``scene`` into a FlatScene on ``device`` (the card unless the
    caller names another; with no card the default raises).

    The bake switches are the JAX package's, with its defaults
    (raytpu/scene/flatten.py:32-41): ``build_octree`` builds the octree of
    the OCTREE query (accel/octree.py, ``leaf_threshold`` triangles a leaf
    at most, ``max_depth`` levels) — host time that grows with the scene,
    so bakes of large scenes that never take that query pass False;
    ``build_gblock`` adds the coefficient table of the matmul pair test
    (kernels/fused.py ``mxu``), 4x the walk's geometry table."""
    dev = resolve(device)
    tri_v = []
    tri_n = []
    tri_uv = []
    tri_color = []
    tri_mesh = []
    mesh_material = []
    mesh_convex = []
    materials = []  # unique Material objects
    mat_ids = {}

    mesh_id = 0
    for obj in scene.objects:
        world = obj.world_matrix()
        # Inverse-transpose for normals (TracerModelProcessor.cs:140-141).
        inv_t = np.linalg.inv(world).T.astype(np.float32)
        for mesh in obj.meshes:
            t = mesh.num_triangles
            v = _transform_points(mesh.vertices.reshape(-1, 3), world)
            v = v.reshape(t, 3, 3).astype(np.float32)
            if mesh.normals is not None:
                n = mesh.normals.reshape(-1, 3) @ inv_t[:3, :3]
                norms = np.linalg.norm(n, axis=-1, keepdims=True)
                n = (n / np.where(norms == 0, 1, norms)).reshape(t, 3, 3)
            else:
                # No normal channel: fall back to face normals per corner.
                e1 = v[:, 1] - v[:, 0]
                e2 = v[:, 2] - v[:, 0]
                fn = np.cross(e2, e1)
                fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
                n = np.repeat(fn[:, None, :], 3, axis=1)
            uv = mesh.uvs if mesh.uvs is not None else np.zeros((t, 3, 2), np.float32)
            if mesh.colors is not None:
                col = mesh.colors
            else:
                col = np.tile(
                    np.asarray(mesh.material.diffuse_color, np.float32), (t, 1)
                )
            key = id(mesh.material)
            if key not in mat_ids:
                mat_ids[key] = len(materials)
                materials.append(mesh.material)
            tri_v.append(v)
            tri_n.append(n.astype(np.float32))
            tri_uv.append(uv.astype(np.float32))
            tri_color.append(col.astype(np.float32))
            tri_mesh.append(np.full(t, mesh_id, np.int32))
            mesh_material.append(mat_ids[key])
            mesh_convex.append(mesh.convex)
            mesh_id += 1

    if not tri_v:
        raise ValueError("scene has no meshes")

    v = np.concatenate(tri_v)
    n = np.concatenate(tri_n)
    uv = np.concatenate(tri_uv)
    color = np.concatenate(tri_color)
    mesh_idx = np.concatenate(tri_mesh)
    num_tris = v.shape[0]

    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    snormal = np.cross(e2, e1)
    snormal /= np.maximum(np.linalg.norm(snormal, axis=-1, keepdims=True), 1e-30)

    clusters = build_clusters(v, cluster_size=cluster_size)
    octree = None
    if build_octree:
        from raytpu_torch.accel.octree import build_octree as _build_octree

        octree = _build_octree(v, leaf_threshold=leaf_threshold,
                               max_depth=max_depth).as_device_arrays(
                                   v[:, 0], e1, e2, snormal, mesh_idx)

    # Textures: pad to a common shape.
    tex_list = [m.texture for m in materials if m.texture is not None]
    if tex_list:
        max_h = max(t.shape[0] for t in tex_list)
        max_w = max(t.shape[1] for t in tex_list)
        textures = np.zeros((len(tex_list), max_h, max_w, 3), np.float32)
        tex_hw = np.zeros((len(tex_list), 2), np.int32)
        ti = 0
        tex_of_mat = {}
        for mi, m in enumerate(materials):
            if m.texture is not None:
                t = np.asarray(m.texture)
                if t.ndim == 2:
                    t = np.repeat(t[..., None], 3, axis=-1)
                textures[ti, : t.shape[0], : t.shape[1]] = t[..., :3].astype(np.float32)
                tex_hw[ti] = (t.shape[0], t.shape[1])
                tex_of_mat[mi] = ti
                ti += 1
        mat_texture = np.array(
            [tex_of_mat.get(i, -1) for i in range(len(materials))], np.int32
        )
    else:
        textures = np.zeros((1, 1, 1, 3), np.float32)
        tex_hw = np.ones((1, 2), np.int32)
        mat_texture = np.full(len(materials), -1, np.int32)

    lights = lights_mod.pack_lights(scene.lights, max_lights=MAX_LIGHTS)

    # Packed shading row (FlatScene.tri_shade): one (32,)-float row per
    # shaded ray.
    shade = np.zeros((num_tris, 32), np.float32)
    shade[:, 0:3] = v[:, 0]
    shade[:, 3:6] = e1
    shade[:, 6:9] = e2
    shade[:, 9:12] = n[:, 0]
    shade[:, 12:15] = n[:, 1]
    shade[:, 15:18] = n[:, 2]
    shade[:, 18:20] = uv[:, 0]
    shade[:, 20:22] = uv[:, 1]
    shade[:, 22:24] = uv[:, 2]
    shade[:, 24:27] = snormal
    shade[:, 27:31] = color
    shade[:, 31] = mesh_idx.view(np.float32)

    t_ = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    cl = clusters.as_device_arrays(v[:, 0], e1, e2, mesh_idx, snormal,
                                   build_gblock=build_gblock)
    return FlatScene(
        tri_shade=t_(shade),
        clusters={k: t_(a) for k, a in cl.items()},
        octree=(None if octree is None
                else {k: t_(a) for k, a in octree.items()}),
        mesh_material=t_(np.asarray(mesh_material, np.int32)),
        mesh_convex=t_(np.asarray(mesh_convex, bool)),
        mat_reflect=t_(np.asarray([m.reflectiveness for m in materials],
                                  np.float32)),
        mat_transparent=t_(np.asarray([m.transparent for m in materials],
                                      bool)),
        mat_refraction=t_(np.asarray(
            [m.refraction_index for m in materials], np.float32)),
        mat_use_texture=t_(np.asarray([m.use_texture for m in materials],
                                      bool)),
        mat_interp_normals=t_(np.asarray(
            [m.interpolate_normals for m in materials], bool)),
        mat_texture=t_(mat_texture),
        textures=t_(textures),
        tex_hw=t_(tex_hw),
        lights={k: t_(a) for k, a in lights.items()},
        num_tris=num_tris,
        num_meshes=mesh_id,
        num_lights=len(scene.lights),
        light_kinds=tuple(
            lights_mod.SPOT if isinstance(lt, lights_mod.SpotLight)
            else lights_mod.DIRECTIONAL
            for lt in scene.lights
        ),
        has_transparent=bool(any(m.transparent for m in materials)),
        has_textures=bool(tex_list),
        has_dual_branch=bool(any(
            m.transparent and m.reflectiveness > 0.0 for m in materials)),
    )
