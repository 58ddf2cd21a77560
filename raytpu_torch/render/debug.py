"""Single-ray debug casting, the reference's ray visualizer
(``raytpu/render/debug.py``).

The reference casts one ray through the screen center every 80 ms and draws
its reflection and refraction path as line segments (Game1.cs:289-328,
RayTracer.CastRay's ``points`` at RayTracer.cs:543, :701, :740-747; drawn
at Game1.cs:402-416).

:func:`cast_ray_debug` is the batch equivalent: it traces rays through the
wavefront recursion and returns every path segment — (start, end) world
positions, the segment kind (primary / reflection / refraction), bounce
level, hit flag and hit triangle — as flat NumPy arrays.
:func:`cast_screen_ray` casts through a pixel like the reference's
center-screen ticker; :func:`draw_aabbs` and :func:`draw_ray_path` draw
wireframes onto an image.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.core import xna
from raytpu_torch.core.camera import Camera, rays_through_screen
from raytpu_torch.render.wavefront import (RaySet, _default_query,
                                           _trace_level, primary_rays)

#: Segment kinds.
PRIMARY = 0
REFLECTION = 1
REFRACTION = 2

#: Length drawn for segments that escape to infinity (the reference draws
#: origin + direction * 300 for misses, RayTracer.cs:736).
MISS_LENGTH = 300.0


class RayPath(NamedTuple):
    """Flat (S,) arrays over all captured segments of all input rays."""

    ray: np.ndarray    # input-ray index
    level: np.ndarray  # recursion depth (0 = primary)
    kind: np.ndarray   # PRIMARY / REFLECTION / REFRACTION
    start: np.ndarray  # (S, 3)
    end: np.ndarray    # (S, 3) hit position, or start + dir * MISS_LENGTH
    hit: np.ndarray    # bool — segment terminated on geometry
    tri: np.ndarray    # hit triangle id (-1 on miss)


def _capture(rays: RaySet, hit_mask, frag_pos, tri, r0, level, kind):
    """The segments of the alive rays of one kind-block of a level."""
    n = rays.origin.shape[0]
    # Ray index within the original batch: children are concatenated
    # [reflection | refraction], each block aligned with its parents.
    idx = np.arange(n) % r0
    start = rays.origin.cpu().numpy()
    # Dead-direction children (a total internal reflection makes
    # refract_xna return NaN) draw as zero-length segments.
    d = rays.direction.cpu().numpy()
    d = np.where(np.isfinite(d).all(axis=-1, keepdims=True), d, 0.0)
    end_miss = start + d * MISS_LENGTH
    hm = hit_mask.cpu().numpy()
    keep = rays.alive.cpu().numpy()
    return (idx[keep],
            np.full(keep.sum(), level, np.int32),
            np.full(keep.sum(), kind, np.int32),
            start[keep],
            np.where(hm[keep, None], frag_pos.cpu().numpy()[keep],
                     end_miss[keep]),
            hm[keep],
            tri.cpu().numpy()[keep])


def cast_ray_debug(scene, cfg: RenderConfig, origin, direction) -> RayPath:
    """Trace ``origin``/``direction`` (R, 3) and capture every path segment.

    Runs the renderer's own level expansion (``_trace_level`` with
    ``capture_hits``), so the captured path is what the renderer computes,
    with no second query.  The rays go to the scene's device; the segments
    come back as NumPy arrays."""
    dev = scene.device
    origin = torch.as_tensor(origin, dtype=torch.float32,
                             device=dev).reshape(-1, 3)
    direction = torch.as_tensor(direction, dtype=torch.float32,
                                device=dev).reshape(-1, 3)
    r0 = origin.shape[0]
    query = _default_query(cfg)
    rays = primary_rays(origin, direction)
    segs = []
    kinds = [PRIMARY]
    for level in range(cfg.max_reflections + 1):
        is_max = level == cfg.max_reflections
        record, children, (hit, frag) = _trace_level(
            scene, cfg, rays, is_max, query, capture_hits=True)
        blk = rays.origin.shape[0] // len(kinds)
        for b, kind in enumerate(kinds):
            sl = slice(b * blk, (b + 1) * blk)
            segs.append(_capture(RaySet(*(a[sl] for a in rays)),
                                 record.mask[sl], frag[sl], hit.tri[sl], r0,
                                 level, kind))
        if is_max:
            break
        refl_rays, refr_rays = children
        if scene.has_transparent:
            rays = RaySet(*(torch.cat([x, y])
                            for x, y in zip(refl_rays, refr_rays)))
            kinds = [REFLECTION] * len(kinds) + [REFRACTION] * len(kinds)
        else:
            rays = refl_rays
            kinds = [REFLECTION] * len(kinds)

    def cat(i):
        return np.concatenate([s[i] for s in segs])

    return RayPath(ray=cat(0), level=cat(1), kind=cat(2), start=cat(3),
                   end=cat(4), hit=cat(5), tri=cat(6))


def cast_screen_ray(scene, cfg: RenderConfig, camera: Camera,
                    px: float = None, py: float = None) -> RayPath:
    """Cast through a pixel (default: screen center, like Game1.cs:307)."""
    if px is None:
        px = cfg.width / 2.0
    if py is None:
        py = cfg.height / 2.0
    sx = torch.tensor([px], dtype=torch.float32, device=scene.device)
    sy = torch.tensor([py], dtype=torch.float32, device=scene.device)
    o, d = rays_through_screen(camera, cfg.width, cfg.height, sx, sy)
    return cast_ray_debug(scene, cfg, o, d)


# ---------------------------------------------------------------------------
# Wireframe overlays: the reference's AABB and octree-node views
# (DrawableBox.cs:29-97, OctreeSpatialManager.DrawNode at
# OctreeSpatialManager.cs:277-310).

_BOX_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),  # bottom
    (4, 5), (5, 7), (7, 6), (6, 4),  # top
    (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
]


def _project(points, camera: Camera, width: int, height: int):
    """World points → pixel coordinates and an in-front mask (row-vector
    XNA view and projection, core/xna.py)."""
    view = camera.view().numpy()
    p = np.asarray(points, np.float32)
    xyz, w = xna.transform_homogeneous(
        torch.from_numpy(p @ view[:3, :3] + view[3, :3]),
        camera.projection())
    xyz, w = xyz.numpy(), w.numpy()
    in_front = w > 1e-6
    ndc = xyz / np.where(in_front, w, 1.0)[..., None]
    px = (ndc[..., 0] * 0.5 + 0.5) * width
    py = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * height
    return np.stack([px, py], axis=-1), in_front


def _draw_line(img, p0, p1, color):
    """Clipped DDA line rasterization into an (H, W, 3) float image."""
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xi = np.round(np.linspace(p0[0], p1[0], n + 1)).astype(int)
    yi = np.round(np.linspace(p0[1], p1[1], n + 1)).astype(int)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    img[yi[ok], xi[ok]] = color


def _as_image(image):
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    return np.array(image, np.float32, copy=True)


def draw_aabbs(image, camera: Camera, box_min, box_max,
               color=(0.0, 1.0, 0.0)):
    """Overlay wireframe AABBs ((B, 3) corners) onto a copy of ``image``
    ((H, W, 3), a tensor on any device or an array) → NumPy.  Edges with an
    endpoint behind the camera are skipped."""
    img = _as_image(image)
    h, w = img.shape[:2]
    bmin = np.asarray(box_min, np.float32).reshape(-1, 3)
    bmax = np.asarray(box_max, np.float32).reshape(-1, 3)
    color = np.asarray(color, np.float32)
    for mn, mx in zip(bmin, bmax):
        corners = np.asarray([
            [mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]],
            [mn[0], mx[1], mn[2]], [mx[0], mx[1], mn[2]],
            [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
            [mn[0], mx[1], mx[2]], [mx[0], mx[1], mx[2]],
        ], np.float32)
        px, front = _project(corners, camera, w, h)
        for a, b in _BOX_EDGES:
            if front[a] and front[b]:
                _draw_line(img, px[a], px[b], color)
    return img


def draw_ray_path(image, camera: Camera, path: RayPath,
                  colors=((1.0, 1.0, 0.0), (0.0, 1.0, 1.0),
                          (1.0, 0.0, 1.0))):
    """Overlay captured ray segments (``cast_ray_debug``) onto a copy of
    ``image`` → NumPy, colored by kind: primary / reflection / refraction
    (Game1.cs:402-416)."""
    img = _as_image(image)
    h, w = img.shape[:2]
    for i in range(len(path.ray)):
        ends = np.stack([path.start[i], path.end[i]])
        px, front = _project(ends, camera, w, h)
        if front.all():
            _draw_line(img, px[0], px[1],
                       np.asarray(colors[int(path.kind[i]) % len(colors)]))
    return img
