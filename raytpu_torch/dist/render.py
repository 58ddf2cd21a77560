"""Ray-sharded full-frame rendering (``raytpu/dist/render.py``).

Each entry of the mesh traces a contiguous block of the frame's rays with
the same wavefront a single device runs (render/wavefront.py), on its own
replica of the scene, and the blocks come back to the mesh's first device.
This replaces the reference's scanline dispenser and Thread.Join barrier
(RayTracer.cs:48-52, :108-120); the split is static, as in the JAX
package, since ray cost variance averages out over device-sized blocks.

A block is a whole number of the render's tiles (``cfg.tile_pixels`` rays,
or the supersampler's batches of quadrants), so the shards trace exactly
the tiles a single device traces: the frame is the single-device frame.
"""

from __future__ import annotations

from typing import Optional

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.dist.mesh import Mesh, make_mesh, replicate_scene
from raytpu_torch.render.wavefront import block_order_perm, render_rays


def _replicas(scene, mesh: Mesh) -> list:
    """The scene per mesh entry: ``scene`` itself where it is already the
    list ``replicate_scene`` gives, else its replicas."""
    if isinstance(scene, (list, tuple)):
        if len(scene) != mesh.size:
            raise ValueError(f"{len(scene)} replicas for a mesh of "
                             f"{mesh.size}")
        return list(scene)
    return replicate_scene(scene, mesh)


def _chunk(n: int, n_dev: int, unit: int) -> int:
    """Items per shard: n over the devices, rounded up to whole units."""
    chunk = -(-n // n_dev)
    return -(-chunk // unit) * unit


def render_rays_sharded(scene, cfg: RenderConfig, origin, direction,
                        mesh: Mesh):
    """Trace a ray batch sharded over the mesh → (R, 3) colors on the
    mesh's first device.  ``scene``: a FlatScene or its replicas.  The rays
    are padded to the device count times a whole number of tiles with rays
    of zero origin and all-ones direction (traced and dropped), as
    raytpu/dist/render.py:36-44 pads them."""
    reps = _replicas(scene, mesh)
    devs = mesh.device_list
    n = origin.shape[0]
    chunk = _chunk(n, mesh.size, cfg.tile_pixels)
    pad = chunk * mesh.size - n
    if pad:
        origin = torch.cat([origin, origin.new_zeros((pad, 3))])
        direction = torch.cat([direction, direction.new_ones((pad, 3))])
    colors = []
    for i, (rep, dev) in enumerate(zip(reps, devs)):
        s = slice(i * chunk, (i + 1) * chunk)
        colors.append(render_rays(rep, cfg, origin[s].to(dev),
                                  direction[s].to(dev)))
    return torch.cat([c.to(devs[0]) for c in colors])[:n]


def render_image_sharded(scene, cfg: RenderConfig,
                         camera: Optional[Camera] = None,
                         mesh: Optional[Mesh] = None):
    """Full-frame render over a device mesh → (H, W, 3) float32 on the
    mesh's first device: the sharded ``render_image``, in square-block
    order, including ``cfg.use_multisampling`` (sharded over pixels,
    ``render_image_multisampled_sharded``).  ``mesh`` defaults to every
    CUDA device."""
    mesh = mesh or make_mesh()
    camera = camera or Camera(aspect=cfg.width / cfg.height)
    if cfg.use_multisampling:
        return render_image_multisampled_sharded(scene, cfg, camera, mesh)
    dev = mesh.device_list[0]
    o, d = camera_rays(camera, cfg.width, cfg.height, device=dev)
    block = max(1, int(cfg.cull_tile ** 0.5))
    perm = block_order_perm(cfg.width, cfg.height, block, dev)
    colors = render_rays_sharded(scene, cfg, o[perm], d[perm], mesh)
    out = torch.zeros_like(colors)
    out[perm] = colors
    return out.reshape(cfg.height, cfg.width, 3)


def render_image_multisampled_sharded(scene, cfg: RenderConfig,
                                      camera: Optional[Camera] = None,
                                      mesh: Optional[Mesh] = None):
    """The adaptive-supersampled frame sharded over the pixel axis
    (raytpu/dist/render.py:99-148): each entry runs the supersampler
    (render/supersample.py) on its contiguous block of pixels, in the
    single-device batches, with dead quadrants (``alive`` False) padding
    the pixel count; the subdivision is per-quadrant data, so the shards
    need no communication."""
    from raytpu_torch.render.supersample import supersample_colors

    mesh = mesh or make_mesh()
    camera = camera or Camera(aspect=cfg.width / cfg.height)
    reps = _replicas(scene, mesh)
    devs = mesh.device_list
    dev = devs[0]
    ys, xs = torch.meshgrid(
        torch.arange(cfg.height, dtype=torch.float32, device=dev),
        torch.arange(cfg.width, dtype=torch.float32, device=dev),
        indexing="ij")
    cx, cy = xs.reshape(-1), ys.reshape(-1)
    n = cx.shape[0]
    batch = max(1, cfg.tile_pixels // (4 ** cfg.multisample_quality * 4))
    chunk = _chunk(n, mesh.size, batch)
    pad = chunk * mesh.size - n
    if pad:
        cx = torch.cat([cx, cx.new_zeros(pad)])
        cy = torch.cat([cy, cy.new_zeros(pad)])
    alive = torch.arange(cx.shape[0], device=dev) < n
    colors = []
    for i, (rep, d) in enumerate(zip(reps, devs)):
        for s in range(i * chunk, (i + 1) * chunk, batch):
            sl = slice(s, s + batch)
            colors.append(supersample_colors(
                rep, cfg, camera, cx[sl].to(d), cy[sl].to(d),
                alive[sl].to(d)).to(dev))
    return torch.cat(colors)[:n].reshape(cfg.height, cfg.width, 3)
