"""Adaptive 4-corner supersampling (RayTracer.cs:128-311,
``raytpu/render/supersample.py``).

The reference's ``GetColorForQuadrant(cx, cy, size, iter)`` casts 4 corner
rays at ``(cx ± size/4, cy ± size/4)`` and, while ``iter <
MultisampleQuality``, subdivides every corner whose color-vector length
deviates from the length of the 4-corner average by more than ``TRESHOLD =
0.5`` (RayTracer.cs:288-306), returning the byte-quantized corner average
(RayTracer.cs:309).

The recursion runs level-synchronously, as in the JAX package: level ``l``
holds every quadrant at subdivision depth ``l`` (``4^l`` slots per pixel,
with an ``alive`` mask; a dead quadrant's corner rays take NaN directions
and come back black).  Each level is one ``trace_colors`` of ``4·Q_l``
corner rays; the backward pass replaces subdivided corners with their
child quadrant's result and re-averages.

The reference bug at RayTracer.cs:305 (the lower-right child's result is
written into ``urColor``) is fixed by default and replicated when
``RenderConfig.replicate_lr_bug`` is set.
"""

from __future__ import annotations

import torch

from raytpu_torch.config import Quantize, RenderConfig
from raytpu_torch.core.camera import Camera, rays_through_screen
from raytpu_torch.core.xna import quantize_color
from raytpu_torch.render.wavefront import trace_colors

# Corner order: upper-left, upper-right, lower-left, lower-right
# (RayTracer.cs:223-276).
_CORNER_OFF = ((-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0), (1.0, 1.0))


def _length(c):
    """Color-vector length, the square root of the summed squares."""
    return torch.sqrt((c * c).sum(-1))


def supersample_colors(scene, cfg: RenderConfig, camera: Camera, cx, cy,
                       alive=None):
    """Colors (Q, 3) of the quadrants of size 1 centered at the screen
    points (cx, cy), through the whole adaptive recursion; ``alive``
    (optional (Q,) bool) marks the quadrants that are traced."""
    if alive is None:
        alive = torch.ones(cx.shape, dtype=torch.bool, device=cx.device)
    off = cx.new_tensor(_CORNER_OFF)
    qx, qy, qa = cx, cy, alive
    alives = [alive]
    corner_colors = []  # (Q_l, 4, 3) per level
    size = 1.0
    for level in range(cfg.multisample_quality + 1):
        quarter = size * 0.25
        sx = (qx[:, None] + off[None, :, 0] * quarter).reshape(-1)
        sy = (qy[:, None] + off[None, :, 1] * quarter).reshape(-1)
        o, d = rays_through_screen(camera, cfg.width, cfg.height, sx, sy)
        colors = trace_colors(scene, cfg, o, d,
                              alive=qa.repeat_interleave(4))
        colors = colors.reshape(-1, 4, 3)
        corner_colors.append(colors)
        if level < cfg.multisample_quality:
            # Subdivision (RayTracer.cs:281-306): a corner's length against
            # the length of the corners' average.
            avg_len = _length(colors.mean(dim=1))
            subdiv = (avg_len[:, None] - _length(colors)).abs() \
                > cfg.multisample_threshold
            qa = (qa[:, None] & subdiv).reshape(-1)
            qx, qy = sx, sy
            alives.append(qa)
        size *= 0.5

    # Backward combine, deepest level first.
    result = None
    for level in reversed(range(cfg.multisample_quality + 1)):
        corners = corner_colors[level]
        if result is not None:
            child = result.reshape(-1, 4, 3)
            used = alives[level + 1].reshape(-1, 4)
            if cfg.replicate_lr_bug:
                # RayTracer.cs:305: the lower-right child's result lands in
                # urColor; the lower-right corner keeps its own ray's color.
                lr_used = used[:, 3].clone()
                used = used.clone()
                used[:, 3] = False
                corners = torch.where(used[..., None], child, corners)
                corners[:, 1] = torch.where(lr_used[:, None], child[:, 3],
                                            corners[:, 1])
            else:
                corners = torch.where(used[..., None], child, corners)
        result = corners.mean(dim=1)
        if cfg.quantize != Quantize.NONE:
            # new Color(average) byte-packs every quadrant's return
            # (RayTracer.cs:309).
            result = quantize_color(result)
    return result


def render_image_multisampled(scene, cfg: RenderConfig, camera: Camera):
    """Full-frame adaptive-supersampled render (RenderFirstPass,
    RayTracer.cs:170-213: quadrant centers at the integer pixel
    coordinates) → (H, W, 3) on the scene's device.

    Pixels go in equal batches of ``cfg.tile_pixels // (4·4^quality)``
    quadrants, the last padded with dead quadrants, as in the JAX package."""
    dev = scene.device
    ys, xs = torch.meshgrid(
        torch.arange(cfg.height, dtype=torch.float32, device=dev),
        torch.arange(cfg.width, dtype=torch.float32, device=dev),
        indexing="ij")
    cx, cy = xs.reshape(-1), ys.reshape(-1)
    n = cx.shape[0]
    tile = max(1, cfg.tile_pixels // (4 ** cfg.multisample_quality * 4))
    pad = (-n) % tile
    if pad:
        cx = torch.cat([cx, cx.new_zeros(pad)])
        cy = torch.cat([cy, cy.new_zeros(pad)])
    alive = torch.arange(cx.shape[0], device=dev) < n
    outs = [supersample_colors(scene, cfg, camera, cx[s:s + tile],
                               cy[s:s + tile], alive[s:s + tile])
            for s in range(0, cx.shape[0], tile)]
    return torch.cat(outs)[:n].reshape(cfg.height, cfg.width, 3)
