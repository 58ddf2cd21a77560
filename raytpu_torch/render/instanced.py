"""Wavefront rendering over shared mesh bakes + per-instance transforms.

End-to-end shading for the two-level instanced path (accel/instanced.py),
the reference's own architecture: one mesh copy, per-object transforms,
rays moved into object space per candidate and hits compared in world space
(OctreeSpatialManager.cs:312-482).  It mirrors the baked renderer's level
expansion and linear combine (render/wavefront.py, same ``LevelRecord``
algebra) and trades per-level selects over the mesh bakes for the N-fold
geometry memory a baked scene would cost.

Capabilities, as in the JAX package's instanced renderer: textures and
vertex colours, interpolated or face normals (transformed by each
instance's inverse-transpose), spot and directional lights, shadow rays as
nearest-occluder queries with transparent-occluder attenuation, recursive
reflection and Snell refraction.  Every query goes through
``nearest_hit``'s dispatch (``cfg.intersector``; ``AUTO`` sweeps a bake of
up to ``cfg.brute_force_max_tris`` triangles by brute force, as the JAX
package does; larger ones take the walk, with the slab pretest and a
re-cull every 6 trips, on the card and the tiled query on the CPU).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raytpu_torch.accel.instanced import (Instance, InstancedHit,
                                          make_instance,
                                          nearest_hit_instanced,
                                          transform_points, transform_vectors)
from raytpu_torch.config import Quantize, RenderConfig
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.core.math3d import normalize, reflect, refract_xna
from raytpu_torch.core.xna import quantize_color
from raytpu_torch.device import resolve
from raytpu_torch.render.wavefront import LevelRecord, block_order_perm
from raytpu_torch.scene import lights as lights_mod
from raytpu_torch.scene import texture as texture_mod
from raytpu_torch.scene.flatten import MAX_LIGHTS
from raytpu_torch.scene.types import FlatScene, Scene, SceneObject

_NAN = float("nan")


class InstancedScene(NamedTuple):
    """The two-level scene: shared bakes and per-instance transforms, all
    tensors on one device."""

    bakes: Tuple[FlatScene, ...]        # per unique mesh set, OBJECT space
    instances: Tuple[Instance, ...]
    worlds: torch.Tensor                # (I, 4, 4)
    inv_t: torch.Tensor                 # (I, 3, 3) inverse-transpose
    bake_of_instance: Tuple[int, ...]
    bake_index: torch.Tensor            # (I,) int32, bake_of_instance
    lights: dict
    num_lights: int
    has_transparent: bool

    @property
    def device(self) -> torch.device:
        return self.worlds.device


def assemble_instanced(bakes, instances, lights: dict, num_lights: int,
                       device) -> InstancedScene:
    """An InstancedScene from bakes already on ``device``, the instances
    and packed lights (NumPy arrays, scene/lights.py::pack_lights)."""
    dev = resolve(device)
    return InstancedScene(
        bakes=tuple(bakes),
        instances=tuple(instances),
        worlds=torch.as_tensor(np.stack([i.world for i in instances]),
                               device=dev),
        inv_t=torch.as_tensor(
            np.stack([i.inv_world.T[:3, :3] for i in instances]),
            device=dev),
        bake_of_instance=tuple(i.mesh_index for i in instances),
        bake_index=torch.as_tensor([i.mesh_index for i in instances],
                                   dtype=torch.int32, device=dev),
        lights={k: torch.as_tensor(v, device=dev) for k, v in lights.items()},
        num_lights=num_lights,
        has_transparent=any(b.has_transparent for b in bakes),
    )


def flatten_instanced(scene: Scene, cluster_size: int = 128,
                      device="cuda", **flatten_kw) -> InstancedScene:
    """Bake each unique mesh set once; record per-object transforms.

    Objects sharing the same ``meshes`` list (by identity) share one bake,
    the memory win the reference gets from Model.Tag reuse
    (SceneObject.cs:123-134).  On the card unless ``device`` names
    another; ``flatten_kw`` goes to each bake (scene/flatten.py, e.g.
    ``build_octree=False``)."""
    dev = resolve(device)
    bakes: List[FlatScene] = []
    bake_ids = {}
    instances: List[Instance] = []
    for obj in scene.objects:
        key = tuple(id(m) for m in obj.meshes)
        if key not in bake_ids:
            bake_ids[key] = len(bakes)
            bakes.append(
                Scene(objects=[SceneObject(meshes=obj.meshes)],
                      lights=scene.lights).flatten(
                          cluster_size=cluster_size, device=dev,
                          **flatten_kw))
        instances.append(make_instance(
            bake_ids[key], np.asarray(obj.world_matrix(), np.float32)))
    lights = lights_mod.pack_lights(scene.lights, max_lights=MAX_LIGHTS)
    return assemble_instanced(bakes, instances, lights, len(scene.lights),
                              dev)


class _RaySet(NamedTuple):
    origin: torch.Tensor
    direction: torch.Tensor
    ignore_tri: torch.Tensor
    ignore_inst: torch.Tensor
    cur_ref: torch.Tensor
    alive: torch.Tensor


def _select_by_bake(iscene: InstancedScene, inst_idx, per_bake_fn):
    """Evaluate ``per_bake_fn(bake, safe_tri_fn)`` for every bake and select
    per ray by the winning instance's bake (a B-way select; B is small).
    ``safe_tri_fn(tri)`` clamps triangle ids into that bake's table: a ray
    won by another bake carries ids that mean nothing here."""
    bake_id = iscene.bake_index[inst_idx.clamp(min=0)]
    out = None
    for b, bake in enumerate(iscene.bakes):
        val = per_bake_fn(
            bake, lambda tri, n=bake.num_tris: tri.clamp(0, max(n - 1, 0)))
        if out is None:
            out = val
            continue
        sel = bake_id == b
        out = {k: torch.where(sel.reshape(sel.shape + (1,) * (o.ndim - 1)),
                              val[k], o)
               for k, o in out.items()}
    return out


def _shade_inputs(iscene: InstancedScene, cfg: RenderConfig,
                  ih: InstancedHit):
    """Per-ray world-space shading inputs from the winning bake/instance."""
    u, v = ih.u[..., None], ih.v[..., None]

    def gather(bake, safe):
        s = bake.tri_shade[safe(ih.tri)]
        mesh = s[..., 31].contiguous().view(torch.int32)
        mat = bake.mesh_material[mesh]
        uv = (s[..., 18:20] + (s[..., 20:22] - s[..., 18:20]) * u
              + (s[..., 22:24] - s[..., 18:20]) * v)
        base = s[..., 27:30]
        if bake.has_textures:
            tex_id = bake.mat_texture[mat].clamp(min=0)
            tex = texture_mod.lookup_uv(
                bake.textures, tex_id, bake.tex_hw[tex_id, 0],
                bake.tex_hw[tex_id, 1], uv, cfg.address_mode, cfg.filtering)
            use = bake.mat_use_texture[mat] & (bake.mat_texture[mat] >= 0)
            base = torch.where(use[..., None], tex, base)
        n_obj = torch.where(
            bake.mat_interp_normals[mat][..., None],
            normalize(s[..., 9:12] + (s[..., 12:15] - s[..., 9:12]) * u
                      + (s[..., 15:18] - s[..., 9:12]) * v),
            s[..., 24:27])
        frag_obj = s[..., 0:3] + s[..., 3:6] * u + s[..., 6:9] * v
        return {
            "surface": base,
            "alpha": s[..., 30],
            "n_obj": n_obj,
            "frag_obj": frag_obj,
            "refl": bake.mat_reflect[mat],
            "transparent": bake.mat_transparent[mat],
            "ior": bake.mat_refraction[mat],
        }

    g = _select_by_bake(iscene, ih.instance, gather)
    safe_inst = ih.instance.clamp(min=0)
    frag_w = transform_points(g["frag_obj"], iscene.worlds[safe_inst])
    normal_w = normalize(transform_vectors(g["n_obj"],
                                           iscene.inv_t[safe_inst]))
    return g, frag_w, normal_w


def _light_result(iscene: InstancedScene, cfg: RenderConfig, frag_pos,
                  normal, tri, inst, valid):
    """Shadow-tested light sum (wavefront._light_result, instanced): each
    shadow ray is a nearest-occluder query bounded by the light distance,
    and a transparent occluder lets ``1 - alpha`` of the light through."""
    total = torch.zeros_like(frag_pos)
    for i in range(iscene.num_lights):
        sdir, sdist = lights_mod.light_shadow_query(iscene.lights, i,
                                                    frag_pos)
        contrib = lights_mod.light_contrib(iscene.lights, i, frag_pos, normal)
        lit = valid & (contrib != 0.0).any(-1)
        shadow = nearest_hit_instanced(
            iscene.bakes, list(iscene.instances), frag_pos,
            torch.where(lit[..., None], sdir, _NAN),
            t_max=sdist, ignore_tri=tri, ignore_instance=inst,
            intersector=cfg.intersector, cull_tile=cfg.cull_tile,
            block=cfg.tri_block,
            brute_force_max_tris=cfg.brute_force_max_tris)
        obstructed = shadow.hit & (shadow.t_world < sdist)
        if iscene.has_transparent:
            def occluder(bake, safe):
                s = bake.tri_shade[safe(shadow.tri)]
                mesh = s[..., 31].contiguous().view(torch.int32)
                return {"trans": bake.mat_transparent[
                            bake.mesh_material[mesh]],
                        "alpha": s[..., 30]}

            g = _select_by_bake(iscene, shadow.instance, occluder)
            amount = torch.where(
                obstructed, torch.where(g["trans"], g["alpha"], 1.0), 0.0)
        else:
            amount = obstructed.to(torch.float32)
        total = total + contrib * (1.0 - amount)[..., None]
    return total


def _trace_level(iscene: InstancedScene, cfg: RenderConfig, rays: _RaySet,
                 is_max: bool):
    """One wavefront level: intersect, shade, and spawn the reflection and
    (in scenes with transparency) refraction children."""
    ih = nearest_hit_instanced(
        iscene.bakes, list(iscene.instances), rays.origin,
        torch.where(rays.alive[..., None], rays.direction, _NAN),
        ignore_tri=rays.ignore_tri, ignore_instance=rays.ignore_inst,
        intersector=cfg.intersector, cull_tile=cfg.cull_tile,
        block=cfg.tri_block, brute_force_max_tris=cfg.brute_force_max_tris)
    mask = ih.hit & rays.alive
    g, frag_w, normal_w = _shade_inputs(iscene, cfg, ih)
    light = _light_result(iscene, cfg, frag_w, normal_w, ih.tri,
                          ih.instance, mask)

    refl = g["refl"][..., None]
    alpha = g["alpha"]
    transparent = g["transparent"] & iscene.has_transparent

    if is_max:
        a = g["surface"] * light
        b = torch.zeros_like(a)
        c = torch.zeros_like(alpha)
        children = None
    else:
        a_op = (1.0 - refl) * g["surface"] * light
        b_op = refl * light
        t3 = transparent[..., None]
        a = torch.where(t3, alpha[..., None] * a_op, a_op)
        b = torch.where(t3, alpha[..., None] * b_op, b_op)
        c = torch.where(transparent, 1.0 - alpha, 0.0)

        keep_tri = torch.where(mask, ih.tri, -1)
        keep_inst = torch.where(mask, ih.instance, -1)
        refl_rays = _RaySet(
            origin=frag_w,
            direction=normalize(reflect(rays.direction, normal_w)),
            ignore_tri=keep_tri, ignore_inst=keep_inst,
            cur_ref=rays.cur_ref, alive=mask & (b != 0.0).any(-1))
        refr_rays = None
        if iscene.has_transparent:
            inside = rays.cur_ref == g["ior"]
            n1 = torch.where(inside, 1.0, g["ior"])
            n2 = torch.where(inside, rays.cur_ref, 1.0)
            refr_rays = _RaySet(
                origin=frag_w,
                direction=normalize(refract_xna(rays.direction, normal_w,
                                                n1, n2)),
                ignore_tri=keep_tri, ignore_inst=keep_inst, cur_ref=n2,
                alive=mask & (c != 0.0))
        children = (refl_rays, refr_rays)

    m3 = mask[..., None]
    rec = LevelRecord(mask=mask, a=torch.where(m3, a, 0.0),
                      b=torch.where(m3, b, 0.0),
                      c=torch.where(mask, c, 0.0))
    return rec, children


def trace_colors_instanced(iscene: InstancedScene, cfg: RenderConfig,
                           origin, direction):
    """Batched CastRay over the instanced scene (wavefront.trace_colors):
    colors (R, 3); a miss is black."""
    r0, dev = origin.shape[0], origin.device
    rays = _RaySet(
        origin=origin, direction=direction,
        ignore_tri=torch.full((r0,), -1, dtype=torch.int32, device=dev),
        ignore_inst=torch.full((r0,), -1, dtype=torch.int32, device=dev),
        cur_ref=torch.ones((r0,), dtype=torch.float32, device=dev),
        alive=torch.ones((r0,), dtype=torch.bool, device=dev))
    records = []
    for level in range(cfg.max_reflections + 1):
        is_max = level == cfg.max_reflections
        rec, children = _trace_level(iscene, cfg, rays, is_max)
        records.append(rec)
        if not is_max:
            refl_rays, refr_rays = children
            rays = (_RaySet(*(torch.cat([x, y]) for x, y in
                              zip(refl_rays, refr_rays)))
                    if iscene.has_transparent else refl_rays)

    color = None
    for rec in reversed(records):
        rl = rec.a.shape[0]
        if color is None:
            node = rec.a
        else:
            node = rec.a + rec.b * color[:rl]
            if iscene.has_transparent:
                node = node + rec.c[..., None] * color[rl:]
        node = torch.where(rec.mask[..., None], node, 0.0)
        if cfg.quantize == Quantize.BOUNCE:
            node = quantize_color(node)
        color = node
    if cfg.quantize == Quantize.FINAL:
        color = quantize_color(color)
    return color


def render_image_instanced(iscene: InstancedScene, cfg: RenderConfig,
                           camera: Optional[Camera] = None):
    """Full-frame instanced render → (H, W, 3) float32 on the scene's
    device.

    The JAX package traces the frame's rays in raster order in one batch;
    the port traces them in square-block order, ``cfg.tile_pixels`` rays at
    a time, as ``render_image`` does, so each walk tile is a compact beam.
    A pure permutation and split of independent rays: the image is the
    same."""
    camera = camera or Camera(aspect=cfg.width / cfg.height)
    dev = iscene.device
    o, d = camera_rays(camera, cfg.width, cfg.height, device=dev)
    block = max(1, int(cfg.cull_tile ** 0.5))
    perm = block_order_perm(cfg.width, cfg.height, block, dev)
    o, d = o[perm], d[perm]
    step = cfg.tile_pixels
    colors = torch.cat([
        trace_colors_instanced(iscene, cfg, o[s:s + step], d[s:s + step])
        for s in range(0, o.shape[0], step)])
    out = torch.empty_like(colors)
    out[perm] = colors
    return out.reshape(cfg.height, cfg.width, 3)
