"""The wavefront renderer for opaque scenes.

``RayTracer.CastRay`` (RayTracer.cs:506-737) is a recursive tree: every hit
spawns a reflection ray (RayTracer.cs:545-559), combined as

    colorVector = lerp(reflection, surface, 1 - reflectiveness) * light

The combine is *linear* in the child color, so the recursion maps to a
two-pass wavefront over ray levels:

1. **Forward expansion** — level ``l`` holds the rays at recursion depth
   ``l``.  Each level runs one nearest-hit query plus one shadow query per
   light and records per-node coefficients ``color(node) = a + b *
   color(reflection) + c * color(refraction)`` with ``a = (1-refl)*S*L``
   and ``b = refl*L``, both scaled by alpha on transparent hits, and ``c =
   1 - alpha`` there (at the reflection limit the reference shades ``S*L``
   with no child — RayTracer.cs:708-727).  In scenes with transparency a
   level's children sit in one of two layouts: *merged* (no material both
   reflects and refracts, so a parent has at most one live child, which
   takes the parent's slot, ``b`` and ``c`` folded into ``b``) or
   *dual-branch* (``[reflection | refraction]``, doubling per level, live
   rays first when ``cfg.compact_wavefront``).
2. **Backward combine** — colors propagate from the deepest level to the
   root.  XNA quantizes every ``CastRay`` return into a byte ``Color``;
   ``Quantize.BOUNCE`` replicates that, ``FINAL`` only rounds the
   framebuffer write, ``NONE`` is full fp32.

Differentiable mode (``cfg.differentiable``) detaches the discrete
search, inputs and outputs alike, and recomputes (u, v, t) from the hit
triangle's gathered row, so gradients reach the scene parameters through
shading and the row gather, never through the walk (``_trace_level``).

``cfg.use_multisampling`` hands the frame to the adaptive supersampler
(render/supersample.py), which traces its corner rays through
``trace_colors``; the debug channels (``RenderMode.NORMALS``,
``CONVEXFLAG``) are one primary query each (``debug_mode_colors``), and
``_trace_level(capture_hits=True)`` hands render/debug.py the level's own
hits.

The renderer reaches geometry only through a ``query`` callable, the
per-triangle shade rows only through ``gather`` and texels only through
``texel_fetch`` (raytpu/render/wavefront.py:154-173, :368-416): the
ring-sharded renderer of dist/bigscene.py injects its own and reuses every
line of the level and shading code.  A query that sets ``supports_rows``
(the default one) is asked for the winners' shade rows with the hits; the
others have them gathered.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import NamedTuple, Optional

import torch

from raytpu_torch.config import Quantize, RenderConfig, RenderMode
from raytpu_torch.accel.shadowcull import (clearance_directional,
                                          clearance_spot,
                                          own_block_entry_exit)
from raytpu_torch.accel.traverse import nearest_hit
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.core.intersect import moller_trumbore_safe
from raytpu_torch.core.math3d import normalize, reflect, refract_xna
from raytpu_torch.core.xna import quantize_color
from raytpu_torch.scene import lights as lights_mod
from raytpu_torch.scene import texture as texture_mod
from raytpu_torch.scene.types import FlatScene

_NAN = float("nan")


class LevelRecord(NamedTuple):
    mask: torch.Tensor  # (R,) valid-hit mask
    a: torch.Tensor  # (R, 3) local emission coefficient
    b: torch.Tensor  # (R, 3) reflection-child weight
    c: Optional[torch.Tensor] = None  # (R,) refraction-child weight


class RaySet(NamedTuple):
    origin: torch.Tensor
    direction: torch.Tensor
    ignore_tri: torch.Tensor
    ignore_mesh: torch.Tensor
    cur_ref: torch.Tensor  # (R,) refraction index of the medium
    alive: torch.Tensor


def shade_row_views(s, mesh_as_value: bool = False):
    """Field views of packed (…, 32)-float shade rows (FlatScene.tri_shade).

    ``mesh_as_value``: channel 31 carries the mesh id as a float VALUE (the
    walk's winner rows) instead of tri_shade's int32 bits."""
    mesh = s[..., 31]
    mesh = (mesh.to(torch.int32) if mesh_as_value
            else mesh.contiguous().view(torch.int32))
    return {
        "v1": s[..., 0:3],
        "e1": s[..., 3:6],
        "e2": s[..., 6:9],
        "n1": s[..., 9:12],
        "n2": s[..., 12:15],
        "n3": s[..., 15:18],
        "uv1": s[..., 18:20],
        "uv2": s[..., 20:22],
        "uv3": s[..., 22:24],
        "snormal": s[..., 24:27],
        "color": s[..., 27:31],
        "mesh": mesh,
    }


class _GatherRowsGeo(torch.autograd.Function):
    """``table[tri]`` whose backward scatters only the geometry channels
    (``_gather_rows_geo``, raytpu/render/wavefront.py:97-126).

    The cotangent of the non-geometry channels (normals, uv, color, mesh:
    scene constants under GEOMETRY fits) is dropped and the scatter-add runs
    on a (T, 12) table (v1 e1 e2 | snormal) instead of (T, 32).  Used when
    ``cfg.grad_channels == "geometry"`` (exactness contract in config.py).
    ``tri`` holds no negative index (``_gather_tri`` maps misses)."""

    @staticmethod
    def forward(ctx, table, tri):
        ctx.save_for_backward(tri)
        ctx.rows = table.shape[0]
        return table[tri]

    @staticmethod
    def backward(ctx, ct):
        (tri,) = ctx.saved_tensors
        with torch.profiler.record_function("geo_rows_scatter_add"):
            packed = torch.cat([ct[..., 0:9], ct[..., 24:27]], dim=-1)
            z = ct.new_zeros((ctx.rows, 12)).index_add_(
                0, tri.reshape(-1), packed.reshape(-1, 12))
        zeros = lambda n: ct.new_zeros((ctx.rows, n))  # noqa: E731
        return torch.cat([z[:, 0:9], zeros(15), z[:, 9:12], zeros(5)],
                         dim=-1), None


def _gather_tri(scene: FlatScene, tri, grad_channels: str = "all"):
    """The hit triangles' shade-row views, differentiable in ``tri_shade``
    (raytpu/render/wavefront.py:129-151).  A miss (``tri`` -1) reads the
    last row, as the reference's wrapping gather does: finite values whose
    cotangent is zero, and never a negative index for ``index_add_``."""
    rows = scene.tri_shade.shape[0]
    idx = torch.where(tri < 0, rows - 1, tri).long()
    if grad_channels == "geometry":
        return shade_row_views(_GatherRowsGeo.apply(scene.tri_shade, idx))
    return shade_row_views(scene.tri_shade[idx])


def _detached(scene: FlatScene) -> FlatScene:
    """The scene as the walk sees it in differentiable mode: the cluster
    tables are the bake's (never trained), the shade rows detached (a
    scene stripped of them, dist/bigscene.py::strip_for_ring, as it is)."""
    if scene.tri_shade is None:
        return scene
    return dataclasses.replace(scene, tri_shade=scene.tri_shade.detach())


def _surface_color(scene: FlatScene, cfg: RenderConfig, tri_data, mat, u, v,
                   texel_fetch=None):
    """Texture lookup or per-triangle color (RayTracer.cs:568-581).
    ``texel_fetch``: the texel backend (None: the scene's atlas)."""
    base = tri_data["color"][..., :3]
    if not scene.has_textures:
        return base
    uv = (
        tri_data["uv1"]
        + (tri_data["uv2"] - tri_data["uv1"]) * u[..., None]
        + (tri_data["uv3"] - tri_data["uv1"]) * v[..., None]
    )
    tex_id = torch.clamp(scene.mat_texture[mat], min=0)
    h = scene.tex_hw[tex_id, 0]
    w = scene.tex_hw[tex_id, 1]
    tex = texture_mod.lookup_uv(scene.textures, tex_id, h, w, uv,
                                cfg.address_mode, cfg.filtering,
                                fetch=texel_fetch)
    use = scene.mat_use_texture[mat] & (scene.mat_texture[mat] >= 0)
    return torch.where(use[..., None], tex, base)


def _default_query(cfg: RenderConfig):
    """Bind cfg's intersector settings into the standard nearest-hit query.

    The renderer reaches geometry only through a ``query`` callable, so a
    caller may pass its own (for instance one that records each query).
    This one sets ``supports_rows``: asked ``with_rows=True``, it returns
    the winners' shade rows with the hits."""

    def query(scene, origin, direction, *, ignore_tri=None, ignore_mesh=None,
              t_max=None, any_hit=False, cull=True, with_rows=False):
        return nearest_hit(
            scene, origin, direction, ignore_tri=ignore_tri,
            ignore_mesh=ignore_mesh, cull=cull, intersector=cfg.intersector,
            block=cfg.tri_block,
            brute_force_max_tris=cfg.brute_force_max_tris,
            cull_tile=cfg.cull_tile, cull_chunk=cfg.cull_chunk,
            cull_pretest=cfg.cull_pretest, cull_recull=cfg.cull_recull,
            cull_phase1=cfg.cull_phase1, cull_prepick=cfg.cull_prepick,
            cull_nbuf=cfg.cull_nbuf, t_max=t_max, any_hit=any_hit,
            with_rows=with_rows)

    query.supports_rows = True
    return query


def _light_result(scene: FlatScene, cfg: RenderConfig, frag_pos, normal,
                  hit_tri, valid, query, gather=_gather_tri):
    """Per-fragment light sum with shadow rays (RayTracer.cs:533-542).  An
    opaque occluder blocks the light fully; a transparent one lets ``1 -
    alpha`` of it through (IsLightPathObstructed, RayTracer.cs:465-502), so
    in scenes with transparency the shadow queries are nearest queries
    bounded at the light, and the occluder's alpha stays differentiable
    through the row gather.

    ``valid`` masks live fragments: dead lanes carry garbage ``frag_pos``,
    so their shadow rays get NaN directions — they never hit and stay out of
    the walk's tile beams.  ``gather``: the shade-row backend, which
    resolves a transparent occluder's row."""
    gather = _bound_gather(cfg, gather)
    total = torch.zeros_like(frag_pos)
    lt = scene.lights
    wscene = _detached(scene) if cfg.differentiable else scene
    for i in range(scene.num_lights):
        sdir, sdist = lights_mod.light_shadow_query(lt, i, frag_pos)
        contrib = lights_mod.light_contrib(lt, i, frag_pos, normal)
        # Fragments the light cannot reach anyway (outside the spot cone,
        # facing away — SpotLight.cs:45-52) skip their shadow ray outright.
        lit = valid & (contrib != 0.0).any(-1)
        # Positionable lights in opaque scenes cast the segment test from
        # the LIGHT toward the fragment: all rays of the query share one
        # origin, so tile beams are thin cones and the cull prunes far more
        # clusters.  Same segment and t bound with mirrored backface
        # culling.  Not in scenes with transparency: their shadows need the
        # occluder nearest the fragment.
        reverse = (cfg.shadow_from_light and not scene.has_transparent
                   and i < len(scene.light_kinds)
                   and scene.light_kinds[i] == lights_mod.SPOT)
        # Per-block shadow clearance (accel/shadowcull.py): every occluder
        # of a fragment lies at least min(D(own block), the ray's entry of
        # its own block) from the light, so a reversed query whose far
        # field is provably clear starts there; a directional query stops
        # at its own block's exit when nothing lies beyond it.  Exact, and
        # computed on every frame.
        use_clear = (cfg.shadow_clearance and scene.clusters is not None
                     and "tri_block" in scene.clusters)
        # Shadow visibility is discrete: in differentiable mode the query
        # sees detached inputs (its outputs carry no gradient).
        if reverse:
            origin_q = lt["position"][i].detach().expand_as(frag_pos)
            dir_q = -sdir.detach()
            tmax_q = sdist.detach()
            if use_clear:
                origin_q, tmax_q = _clear_spot(
                    scene.clusters, lt["position"][i].detach(),
                    hit_tri, origin_q, dir_q, tmax_q, lit)
            shadow = query(
                wscene, origin_q,
                torch.where(lit[..., None], dir_q, _NAN),
                ignore_tri=hit_tri, cull="reverse", t_max=tmax_q,
                any_hit=True)
        else:
            tmax_q = sdist.detach()
            if use_clear and (i < len(scene.light_kinds) and
                              scene.light_kinds[i] == lights_mod.DIRECTIONAL):
                tmax_q = _clear_directional(
                    scene.clusters, -lt["direction"][i].detach(), hit_tri,
                    frag_pos.detach(), tmax_q)
            shadow = query(
                wscene, frag_pos.detach(),
                torch.where(lit[..., None], sdir, _NAN).detach(),
                ignore_tri=hit_tri, cull=True, t_max=tmax_q,
                any_hit=not scene.has_transparent)
        obstructed = shadow.hit & (shadow.t < sdist)
        if scene.has_transparent:
            occ = gather(scene, shadow.tri)
            occ_transparent = scene.mat_transparent[
                scene.mesh_material[occ["mesh"]]]
            light_amount = torch.where(
                obstructed, torch.where(occ_transparent, occ["color"][..., 3],
                                        1.0), 0.0)
        else:
            light_amount = torch.where(obstructed, 1.0, 0.0)
        total = total + contrib * (1.0 - light_amount)[..., None]
    return total


def _clear_spot(clusters, light_pos, hit_tri, origin_q, dir_q, tmax_q, lit):
    """A reversed spot query's origin and t bound under shadow clearance
    (raytpu/render/wavefront.py:275-303): a lit ray whose far field is
    provably clear (its block's clearance reaches its own-block entry)
    starts just before that entry, shaved so that float rounding never
    moves it past an occluder; the others are left as they are.  The shift
    is all or nothing per ray, so the rays of a block-coherent tile shift
    together."""
    dvals = clearance_spot(clusters, light_pos)
    b_id, t_en, _ = own_block_entry_exit(clusters, clusters["tri_block"],
                                         hit_tri, origin_q, dir_q)
    t_en = torch.clamp(t_en, min=0.0)
    clear_ray = dvals[b_id] >= t_en
    tmin = torch.where(lit & clear_ray,
                       torch.clamp(t_en * (1.0 - 1e-4) - 1e-4, min=0.0), 0.0)
    return origin_q + tmin[..., None] * dir_q, tmax_q - tmin


def _clear_directional(clusters, dl, hit_tri, frag_pos, tmax_q):
    """A directional query's t bound under shadow clearance
    (raytpu/render/wavefront.py:312-322): where nothing outside the
    fragment's block lies toward the light, the search stops at the block's
    exit."""
    dvals = clearance_directional(clusters, dl)
    b_id, _, t_ex = own_block_entry_exit(clusters, clusters["tri_block"],
                                         hit_tri, frag_pos,
                                         dl.expand_as(frag_pos))
    own_cap = torch.clamp(t_ex, min=0.0) * (1.0 + 1e-4) + 1e-4
    return torch.where(dvals[b_id] >= tmax_q, torch.minimum(tmax_q, own_cap),
                       tmax_q)


def _bound_gather(cfg: RenderConfig, gather):
    """``gather``, with cfg's gradient-channel contract bound in when it is
    the default one (an injected gather manages its own gradients)."""
    if gather is _gather_tri:
        return functools.partial(_gather_tri,
                                 grad_channels=cfg.grad_channels)
    return gather


def _trace_level(scene: FlatScene, cfg: RenderConfig, rays: RaySet,
                 is_max_level: bool, query, capture_hits: bool = False,
                 gather=_gather_tri, texel_fetch=None):
    """One wavefront level: intersect, shade, and spawn the reflection
    child and (in scenes with transparency) the refraction child.

    ``capture_hits``: also return ``(hit, frag_pos)``, so that
    render/debug.py draws the level's own intersections instead of
    querying again.  ``query``/``gather``/``texel_fetch``: the backends
    (module docstring)."""
    gather = _bound_gather(cfg, gather)
    # Dead lanes become non-finite: they never hit and stay out of the
    # walk's tile beams.
    direction = torch.where(rays.alive[..., None], rays.direction, _NAN)
    qargs = dict(ignore_tri=rays.ignore_tri, ignore_mesh=rays.ignore_mesh,
                 cull=True)
    soft_vis = None
    if cfg.differentiable:
        # Detach the discrete search, inputs and outputs, and recompute
        # (u, v, t) from the hit triangle's row: the same formula on the
        # same inputs gives the same forward values, and gradients flow
        # through the gathered row (raytpu/render/wavefront.py:390-451).
        # The query asks for no rows; shading reads the differentiable
        # gather, whose misses take the last row.
        hit = query(_detached(scene), rays.origin.detach(),
                    direction.detach(), **qargs)
        td = gather(scene, hit.tri)
        # Rays that cannot hit (dead lanes; refraction children of a total
        # internal reflection, whose direction is NaN) recompute with a
        # zero direction: their values are masked below, and a zero
        # cotangent times a NaN would turn the gradients of the rows and of
        # the parents' hit points NaN (the JAX package's do: ROADMAP.md,
        # queue 3).
        finite = torch.isfinite(rays.direction).all(-1, keepdim=True)
        u_d, v_d, t_d = moller_trumbore_safe(
            rays.origin, torch.where(finite, rays.direction, 0.0), td["v1"],
            td["e1"], td["e2"])
        if cfg.soft_tau > 0.0:
            # Straight-through silhouette gradients: the forward is the
            # exact hard visibility; the backward sees a sigmoid of the
            # barycentric edge distance.
            edge = torch.minimum(torch.minimum(u_d, v_d), 1.0 - u_d - v_d)
            soft = torch.sigmoid(edge / cfg.soft_tau)
            soft_vis = soft - soft.detach()
        hit = hit._replace(u=torch.where(hit.hit, u_d, 0.0),
                           v=torch.where(hit.hit, v_d, 0.0),
                           t=torch.where(hit.hit, t_d, hit.t))
    elif getattr(query, "supports_rows", False):
        hit, krows = query(scene, rays.origin, direction, with_rows=True,
                           **qargs)
        td = shade_row_views(krows, mesh_as_value=True)
    else:
        # A query without rows (the ring's): the rows are gathered, misses
        # reading the gather's placeholder row (raytpu/render/wavefront.py:
        # 400-416).
        hit = query(scene, rays.origin, direction, **qargs)
        td = gather(scene, hit.tri)
    mask = hit.hit & rays.alive
    tri = hit.tri
    mat = scene.mesh_material[td["mesh"]]

    # Fragment normal (RayTracer.cs:520-531).  Hard renders' miss rows are
    # all-zero, so their normals are NaN; every use below is masked.
    interp = scene.mat_interp_normals[mat]
    n_lerped = normalize(
        td["n1"]
        + (td["n2"] - td["n1"]) * hit.u[..., None]
        + (td["n3"] - td["n1"]) * hit.v[..., None]
    )
    normal = torch.where(interp[..., None], n_lerped, td["snormal"])

    # World-space hit position (MeshOctree.cs:310-322).
    frag_pos = (td["v1"] + td["e1"] * hit.u[..., None]
                + td["e2"] * hit.v[..., None])

    light = _light_result(scene, cfg, frag_pos, normal, tri, mask, query,
                          gather)
    surface = _surface_color(scene, cfg, td, mat, hit.u, hit.v, texel_fetch)
    refl = scene.mat_reflect[mat][..., None]
    alpha = td["color"][..., 3]
    transparent = scene.mat_transparent[mat] & scene.has_transparent

    if is_max_level:
        # Reflection-limit shading: S * L (RayTracer.cs:708-727).
        a = surface * light
        b = torch.zeros_like(a)
        c = torch.zeros_like(alpha)
        children = None
    else:
        a_opaque = (1.0 - refl) * surface * light
        b_opaque = refl * light
        t3 = transparent[..., None]
        a = torch.where(t3, alpha[..., None] * a_opaque, a_opaque)
        b = torch.where(t3, alpha[..., None] * b_opaque, b_opaque)
        c = torch.where(transparent, 1.0 - alpha, 0.0)
        keep_tri = torch.where(mask, tri, -1)
        # Reflection child (RayTracer.cs:545-559).
        convex = scene.mesh_convex[td["mesh"]]
        refl_rays = RaySet(
            origin=frag_pos,
            direction=normalize(reflect(rays.direction, normal)),
            ignore_tri=keep_tri,
            ignore_mesh=torch.where(mask & convex, td["mesh"], -1),
            cur_ref=rays.cur_ref,
            alive=mask & (b != 0.0).any(-1),
        )
        refr_rays = None
        if scene.has_transparent:
            # Refraction child (RayTracer.cs:656-699): n1/n2 from the
            # medium's index against the material's; the child travels in
            # n2.
            ior = scene.mat_refraction[mat]
            inside = rays.cur_ref == ior
            n1 = torch.where(inside, 1.0, ior)
            n2 = torch.where(inside, rays.cur_ref, 1.0)
            refr_rays = RaySet(
                origin=frag_pos,
                direction=normalize(refract_xna(rays.direction, normal, n1,
                                                n2)),
                ignore_tri=keep_tri,
                ignore_mesh=torch.full_like(tri, -1),
                cur_ref=n2,
                alive=mask & (c != 0.0),
            )
        children = (refl_rays, refr_rays)
    m3 = mask[..., None]
    a = torch.where(m3, a, 0.0)
    b = torch.where(m3, b, 0.0)
    c = torch.where(mask, c, 0.0)
    if soft_vis is not None:
        # Zero-forward residual: hit lanes scaled by (1 + soft - sg(soft)),
        # so silhouette-adjacent hits carry d(pixel)/d(edge distance).
        stm = 1.0 + torch.where(mask, soft_vis, 0.0)
        a, b, c = a * stm[..., None], b * stm[..., None], c * stm
    record = LevelRecord(mask=mask, a=a, b=b, c=c)
    if capture_hits:
        return record, children, (hit, frag_pos)
    return record, children


def _inverse(order):
    """The inverse of the permutation ``order``."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv


def primary_rays(origin, direction, alive=None) -> RaySet:
    """Primary rays: no ignore ids, in air, all alive unless ``alive``
    says otherwise."""
    r0 = origin.shape[0]
    dev = origin.device
    return RaySet(
        origin=origin,
        direction=direction,
        ignore_tri=torch.full((r0,), -1, dtype=torch.int32, device=dev),
        ignore_mesh=torch.full((r0,), -1, dtype=torch.int32, device=dev),
        cur_ref=torch.ones((r0,), dtype=torch.float32, device=dev),
        alive=(torch.ones((r0,), dtype=torch.bool, device=dev)
               if alive is None else alive),
    )


def debug_mode_colors(scene: FlatScene, cfg: RenderConfig, origin,
                      direction, query=None, gather=_gather_tri):
    """Diagnostic render channels (RayTracer.cs:563-566,
    raytpu/render/wavefront.py:541-584).

    One primary nearest-hit, no recursion or lights: ``NORMALS`` clamps the
    fragment normal into RGB like XNA's ``new Color(Vector3)`` (negative
    components saturate to 0); ``CONVEXFLAG`` paints convex meshes green,
    the rest red.  Misses stay black."""
    if query is None:
        query = _default_query(cfg)
    hit = query(scene, origin, direction, cull=True)
    td = gather(scene, hit.tri)
    mat = scene.mesh_material[td["mesh"]]
    if cfg.render_mode == RenderMode.NORMALS:
        interp = scene.mat_interp_normals[mat]
        n_lerped = normalize(
            td["n1"]
            + (td["n2"] - td["n1"]) * hit.u[..., None]
            + (td["n3"] - td["n1"]) * hit.v[..., None])
        normal = torch.where(interp[..., None], n_lerped, td["snormal"])
        color = torch.clamp(normal, 0.0, 1.0)
    elif cfg.render_mode == RenderMode.CONVEXFLAG:
        convex = scene.mesh_convex[td["mesh"]]
        green = origin.new_tensor([0.0, 128.0 / 255.0, 0.0])
        red = origin.new_tensor([1.0, 0.0, 0.0])
        color = torch.where(convex[..., None], green, red)
    else:
        raise ValueError(cfg.render_mode)
    return torch.where(hit.hit[..., None], color, 0.0)


def trace_colors(scene: FlatScene, cfg: RenderConfig, origin, direction,
                 alive=None, query=None, gather=_gather_tri,
                 texel_fetch=None):
    """Batched CastRay: colors (R, 3) for an arbitrary set of primary rays.
    Miss = black (RayTracer.cs:729-735).  ``alive`` (optional (R,) bool):
    the rays that are traced; the others take NaN directions and come back
    black (the supersampler's dead quadrants).  ``query``: the nearest-hit
    backend (default: cfg's intersector); ``gather``, ``texel_fetch``: the
    shade-row and texel backends (module docstring).  A debug
    ``render_mode`` gives ``debug_mode_colors``."""
    if query is None:
        query = _default_query(cfg)
    if cfg.render_mode != RenderMode.SHADED:
        if alive is not None:
            direction = torch.where(alive[..., None], direction, _NAN)
        return debug_mode_colors(scene, cfg, origin, direction, query,
                                 gather)
    rays = primary_rays(origin, direction, alive)
    # The children's layout (module docstring): dual-branch doubling, or
    # merged into the parents' slots.
    dual = scene.has_transparent and scene.has_dual_branch
    merged = scene.has_transparent and not scene.has_dual_branch
    records = []
    orders = [None] * (cfg.max_reflections + 1)
    for level in range(cfg.max_reflections + 1):
        is_max = level == cfg.max_reflections
        record, children = _trace_level(scene, cfg, rays, is_max, query,
                                        gather=gather,
                                        texel_fetch=texel_fetch)
        if not is_max:
            refl_rays, refr_rays = children
            if dual:
                rays = RaySet(*(torch.cat([x, y])
                                for x, y in zip(refl_rays, refr_rays)))
                if cfg.compact_wavefront:
                    # Live rays first (a stable permutation), so dead slots
                    # fill whole walk tiles that end in their prologue.
                    from raytpu_torch.kernels.fused import compact_order

                    order = compact_order(~rays.alive)
                    rays = RaySet(*(x[order] for x in rays))
                    orders[level + 1] = order
            elif merged:
                # One live child per parent: it takes the parent's slot,
                # and the two combine weights fold into b.
                sel = refl_rays.alive
                rays = RaySet(*(
                    torch.where(sel.reshape(sel.shape + (1,) * (x.ndim - 1)),
                                x, y) for x, y in zip(refl_rays, refr_rays)))
                record = record._replace(
                    b=torch.where(sel[:, None], record.b,
                                  record.c[:, None].expand_as(record.b)),
                    c=torch.zeros_like(record.c))
            else:
                rays = refl_rays
        records.append(record)

    # Backward combine (child colors → parent), deepest level first.
    color = None
    for level in reversed(range(cfg.max_reflections + 1)):
        rec = records[level]
        rl = rec.a.shape[0]
        if color is None:
            node = rec.a
        else:
            if orders[level + 1] is not None:
                # The child level ran live-first: back to [reflection |
                # refraction] slot order.
                color = color[_inverse(orders[level + 1])]
            node = rec.a + rec.b * color[:rl]
            if dual:
                node = node + rec.c[..., None] * color[rl:]
        node = torch.where(rec.mask[..., None], node, 0.0)
        if cfg.quantize == Quantize.BOUNCE:
            node = quantize_color(node)
        color = node
    if cfg.quantize == Quantize.FINAL:
        color = quantize_color(color)
    return color


def _pad_rays(origin, direction, tile: int):
    """Pad a ray batch to whole tiles with rays that are traced and
    dropped: (origin, direction, the batch's own count)."""
    n = origin.shape[0]
    pad = (-n) % tile
    if pad:
        origin = torch.cat([origin, origin.new_zeros((pad, 3))])
        direction = torch.cat([direction, direction.new_ones((pad, 3))])
    return origin, direction, n


def render_rays(scene: FlatScene, cfg: RenderConfig, origin, direction,
                on_tile=None, query=None, gather=_gather_tri,
                texel_fetch=None):
    """Trace an arbitrary ray batch tile by tile (``cfg.tile_pixels`` rays
    each; the last tile is padded with rays that are traced and dropped).
    ``on_tile(done, total, colors)``, where given, runs after each tile,
    with the list of the tiles' colors so far.  ``query``, ``gather``,
    ``texel_fetch``: the backends (``trace_colors``)."""
    origin, direction, n = _pad_rays(origin, direction, cfg.tile_pixels)
    tile = cfg.tile_pixels
    tiles = origin.shape[0] // tile
    colors = []
    for i in range(tiles):
        colors.append(trace_colors(scene, cfg, origin[i * tile:(i + 1) * tile],
                                   direction[i * tile:(i + 1) * tile],
                                   query=query, gather=gather,
                                   texel_fetch=texel_fetch))
        if on_tile is not None:
            on_tile(i + 1, tiles, colors)
    return torch.cat(colors)[:n]


def block_order_perm(width: int, height: int, block: int, device):
    """Raster indices in square-block-major order, an int64 tensor on
    ``device``: block rows, then blocks, then rows and pixels within a block.

    The walk's tiles are consecutive ray runs; square pixel blocks give each
    tile a compact direction cone where scanline runs would give a wide
    one.  A pure permutation — per-ray results are unchanged.  Built on the
    device as the argsort of one composed integer key per pixel (a host
    sort of a 1024² frame's keys costs a quarter of a second)."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    nbx = -(-width // block)
    key = (((ys // block) * nbx + xs // block) * block + ys % block) * block \
        + xs % block
    return torch.argsort(key.reshape(-1))


def render_image(scene: FlatScene, cfg: RenderConfig,
                 camera: Optional[Camera] = None, progress=None,
                 watch_path: Optional[str] = None, watch_every: int = 4):
    """Full-frame render → (H, W, 3) float32 on the scene's device.

    Primary rays go through the integer pixel coordinates and are traced in
    square-block order (RayTracer.cs:391-428).  With
    ``cfg.use_multisampling`` the adaptive 4-corner supersampler runs
    instead (RayTracer.cs:128-311, render/supersample.py).

    ``progress``: ``callback(done, total)`` after each tile of
    ``cfg.tile_pixels`` rays, the reference's ``Progress`` fraction
    (RayTracer.cs:43-46).  ``watch_path``: write the partial frame (traced
    tiles filled in, the rest black) to this PNG every ``watch_every``
    tiles but the last, the analog of watching the reference's
    RenderTarget fill in (Game1.cs:389-416).  The supersampler reports
    neither: with ``cfg.use_multisampling`` both are ignored, with a
    warning."""
    camera = camera or Camera(aspect=cfg.width / cfg.height)
    if cfg.use_multisampling:
        from raytpu_torch.render.supersample import render_image_multisampled

        if progress is not None or watch_path is not None:
            # As in the JAX package, the supersampler reports no tiles.
            warnings.warn("progress and watch_path are ignored with "
                          "use_multisampling", stacklevel=2)
        return render_image_multisampled(scene, cfg, camera)
    o, d = camera_rays(camera, cfg.width, cfg.height, device=scene.device)
    block = max(1, int(cfg.cull_tile ** 0.5))
    perm = block_order_perm(cfg.width, cfg.height, block, scene.device)

    def image(colors):
        out = torch.zeros((perm.shape[0], 3), dtype=colors.dtype,
                          device=colors.device)
        out[perm[:colors.shape[0]]] = colors[:perm.shape[0]]
        return out.reshape(cfg.height, cfg.width, 3)

    def on_tile(done, tiles, parts):
        if progress is not None:
            progress(done, tiles)
        if watch_path is not None and done < tiles and done % watch_every == 0:
            from raytpu_torch.io.image import write_image

            write_image(watch_path, image(torch.cat(parts)))

    return image(render_rays(scene, cfg, o[perm], d[perm], on_tile=on_tile))
