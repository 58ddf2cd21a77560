"""The wavefront renderer for opaque scenes.

``RayTracer.CastRay`` (RayTracer.cs:506-737) is a recursive tree: every hit
spawns a reflection ray (RayTracer.cs:545-559), combined as

    colorVector = lerp(reflection, surface, 1 - reflectiveness) * light

The combine is *linear* in the child color, so the recursion maps to a
two-pass wavefront over ray levels:

1. **Forward expansion** — level ``l`` holds the rays at recursion depth
   ``l``.  Each level runs one nearest-hit query plus one shadow query per
   light and records per-node coefficients ``color(node) = a + b *
   color(child)`` with ``a = (1-refl)*S*L`` and ``b = refl*L`` (at the
   reflection limit the reference shades ``S*L`` with no child —
   RayTracer.cs:708-727).
2. **Backward combine** — colors propagate from the deepest level to the
   root.  XNA quantizes every ``CastRay`` return into a byte ``Color``;
   ``Quantize.BOUNCE`` replicates that, ``FINAL`` only rounds the
   framebuffer write, ``NONE`` is full fp32.

Transparency, supersampling, the debug channels and differentiable renders
are not ported yet; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raytpu_torch.config import Quantize, RenderConfig, RenderMode
from raytpu_torch.accel.traverse import nearest_hit
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.core.math3d import normalize, reflect
from raytpu_torch.core.xna import quantize_color
from raytpu_torch.scene import lights as lights_mod
from raytpu_torch.scene import texture as texture_mod
from raytpu_torch.scene.types import FlatScene

_NAN = float("nan")


class LevelRecord(NamedTuple):
    mask: torch.Tensor  # (R,) valid-hit mask
    a: torch.Tensor  # (R, 3) local emission coefficient
    b: torch.Tensor  # (R, 3) reflection-child weight
    # (R,) refraction-child weight; only render/instanced.py sets it.
    c: Optional[torch.Tensor] = None


class RaySet(NamedTuple):
    origin: torch.Tensor
    direction: torch.Tensor
    ignore_tri: torch.Tensor
    ignore_mesh: torch.Tensor
    alive: torch.Tensor


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, {item}")


def check_supported(scene: FlatScene, cfg: RenderConfig):
    """Raise ``NotImplementedError`` for what the port cannot render yet,
    naming the ROADMAP.md item that ports it."""
    if scene.has_transparent:
        raise _unported("transparent materials",
                        "queue 1 item 1 (transparency and refraction)")
    if cfg.use_multisampling:
        raise _unported("use_multisampling", "queue 1 item 3 (supersampling)")
    if cfg.render_mode != RenderMode.SHADED:
        raise _unported(f"render_mode={cfg.render_mode.name}",
                        "queue 1 item 4 (debug channels)")
    if cfg.shadow_clearance:
        raise _unported("shadow_clearance",
                        "queue 1 item 5 (the other query backends)")
    if cfg.differentiable:
        raise _unported("differentiable rendering",
                        "queue 1 item 6 (differentiable rendering)")
    if cfg.cull_prepick:
        raise _unported("cull_prepick", "queue 2 item 1 (prepick walk)")
    if cfg.cull_chunk > 1:
        raise _unported("cull_chunk > 1", "queue 2 item 2 (walk opt-ins)")
    if cfg.cull_phase1:
        raise _unported("cull_phase1", "queue 2 item 4 (trip budget)")


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


def _surface_color(scene: FlatScene, cfg: RenderConfig, tri_data, mat, u, v):
    """Texture lookup or per-triangle color (RayTracer.cs:568-581)."""
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
                                cfg.address_mode, cfg.filtering)
    use = scene.mat_use_texture[mat] & (scene.mat_texture[mat] >= 0)
    return torch.where(use[..., None], tex, base)


def _default_query(cfg: RenderConfig):
    """Bind cfg's intersector settings into the standard nearest-hit query.

    The renderer reaches geometry only through a ``query`` callable, so a
    caller may pass its own (for instance one that records each query)."""

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

    return query


def _light_result(scene: FlatScene, cfg: RenderConfig, frag_pos, normal,
                  hit_tri, valid, query):
    """Per-fragment light sum with shadow rays (RayTracer.cs:533-542); an
    occluder blocks the light fully (opaque scenes).

    ``valid`` masks live fragments: dead lanes carry garbage ``frag_pos``,
    so their shadow rays get NaN directions — they never hit and stay out of
    the walk's tile beams."""
    total = torch.zeros_like(frag_pos)
    lt = scene.lights
    for i in range(scene.num_lights):
        sdir, sdist = lights_mod.light_shadow_query(lt, i, frag_pos)
        contrib = lights_mod.light_contrib(lt, i, frag_pos, normal)
        # Fragments the light cannot reach anyway (outside the spot cone,
        # facing away — SpotLight.cs:45-52) skip their shadow ray outright.
        lit = valid & (contrib != 0.0).any(-1)
        # Positionable lights cast the segment test from the LIGHT toward
        # the fragment: all rays of the query share one origin, so tile
        # beams are thin cones and the cull prunes far more clusters.  Same
        # segment and t bound with mirrored backface culling.
        reverse = (cfg.shadow_from_light
                   and i < len(scene.light_kinds)
                   and scene.light_kinds[i] == lights_mod.SPOT)
        if reverse:
            shadow = query(
                scene, lt["position"][i].expand_as(frag_pos),
                torch.where(lit[..., None], -sdir, _NAN),
                ignore_tri=hit_tri, cull="reverse", t_max=sdist,
                any_hit=True)
        else:
            shadow = query(
                scene, frag_pos, torch.where(lit[..., None], sdir, _NAN),
                ignore_tri=hit_tri, cull=True, t_max=sdist, any_hit=True)
        obstructed = shadow.hit & (shadow.t < sdist)
        light_amount = torch.where(obstructed, 1.0, 0.0)
        total = total + contrib * (1.0 - light_amount)[..., None]
    return total


def _trace_level(scene: FlatScene, cfg: RenderConfig, rays: RaySet,
                 is_max_level: bool, query):
    """One wavefront level: intersect + shade + spawn the reflection child."""
    # Dead lanes become non-finite: they never hit and stay out of the
    # walk's tile beams.
    hit, krows = query(
        scene, rays.origin,
        torch.where(rays.alive[..., None], rays.direction, _NAN),
        ignore_tri=rays.ignore_tri, ignore_mesh=rays.ignore_mesh, cull=True,
        with_rows=True)
    mask = hit.hit & rays.alive
    tri = hit.tri
    td = shade_row_views(krows, mesh_as_value=True)
    mat = scene.mesh_material[td["mesh"]]

    # Fragment normal (RayTracer.cs:520-531).  Miss rows are all-zero, so
    # their normals are NaN; every use below is masked.
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

    light = _light_result(scene, cfg, frag_pos, normal, tri, mask, query)
    surface = _surface_color(scene, cfg, td, mat, hit.u, hit.v)
    refl = scene.mat_reflect[mat][..., None]

    if is_max_level:
        # Reflection-limit shading: S * L (RayTracer.cs:708-727).
        a = surface * light
        b = torch.zeros_like(a)
        child = None
    else:
        a = (1.0 - refl) * surface * light
        b = refl * light
        # Reflection child (RayTracer.cs:545-559).
        refl_dir = normalize(reflect(rays.direction, normal))
        convex = scene.mesh_convex[td["mesh"]]
        refl_ignore_mesh = torch.where(convex, td["mesh"], -1)
        child = RaySet(
            origin=frag_pos,
            direction=refl_dir,
            ignore_tri=torch.where(mask, tri, -1),
            ignore_mesh=torch.where(mask, refl_ignore_mesh, -1),
            alive=mask & (b != 0.0).any(-1),
        )
    m3 = mask[..., None]
    record = LevelRecord(mask=mask, a=torch.where(m3, a, 0.0),
                         b=torch.where(m3, b, 0.0))
    return record, child


def trace_colors(scene: FlatScene, cfg: RenderConfig, origin, direction,
                 query=None):
    """Batched CastRay: colors (R, 3) for an arbitrary set of primary rays.
    Miss = black (RayTracer.cs:729-735).  ``query``: the nearest-hit
    backend (default: cfg's intersector)."""
    check_supported(scene, cfg)
    if query is None:
        query = _default_query(cfg)
    r0 = origin.shape[0]
    dev = origin.device
    rays = RaySet(
        origin=origin,
        direction=direction,
        ignore_tri=torch.full((r0,), -1, dtype=torch.int32, device=dev),
        ignore_mesh=torch.full((r0,), -1, dtype=torch.int32, device=dev),
        alive=torch.ones((r0,), dtype=torch.bool, device=dev),
    )
    records = []
    for level in range(cfg.max_reflections + 1):
        is_max = level == cfg.max_reflections
        record, child = _trace_level(scene, cfg, rays, is_max, query)
        records.append(record)
        rays = child

    # Backward combine (child colors → parent), deepest level first.
    color = None
    for rec in reversed(records):
        node = rec.a if color is None else rec.a + rec.b * color
        node = torch.where(rec.mask[..., None], node, 0.0)
        if cfg.quantize == Quantize.BOUNCE:
            node = quantize_color(node)
        color = node
    if cfg.quantize == Quantize.FINAL:
        color = quantize_color(color)
    return color


def render_rays(scene: FlatScene, cfg: RenderConfig, origin, direction):
    """Trace an arbitrary ray batch tile by tile (``cfg.tile_pixels`` rays
    each; the last tile is padded with rays that are traced and dropped)."""
    n = origin.shape[0]
    pad = (-n) % cfg.tile_pixels
    if pad:
        origin = torch.cat([origin, origin.new_zeros((pad, 3))])
        direction = torch.cat([direction, direction.new_ones((pad, 3))])
    colors = [
        trace_colors(scene, cfg, origin[s:s + cfg.tile_pixels],
                     direction[s:s + cfg.tile_pixels])
        for s in range(0, origin.shape[0], cfg.tile_pixels)
    ]
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
                 watch_path: Optional[str] = None):
    """Full-frame render → (H, W, 3) float32 on the scene's device.

    Primary rays go through the integer pixel coordinates and are traced in
    square-block order (RayTracer.cs:391-428)."""
    if progress is not None or watch_path is not None:
        raise _unported("progress/watch_path", "queue 1 item 9 (CLI and IO)")
    camera = camera or Camera(aspect=cfg.width / cfg.height)
    o, d = camera_rays(camera, cfg.width, cfg.height, device=scene.device)
    block = max(1, int(cfg.cull_tile ** 0.5))
    perm = block_order_perm(cfg.width, cfg.height, block, scene.device)
    colors = render_rays(scene, cfg, o[perm], d[perm])
    out = torch.empty_like(colors)
    out[perm] = colors
    return out.reshape(cfg.height, cfg.width, 3)
