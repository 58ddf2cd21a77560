"""Camera and primary-ray generation (Camera.cs:9-193, RayTracer.cs:410-421)."""

from __future__ import annotations

import dataclasses
import math

import torch

from raytpu_torch.core import xna
from raytpu_torch.core.math3d import normalize


@dataclasses.dataclass(frozen=True)
class Camera:
    """Perspective look-at camera (Camera.cs:25-54).

    Defaults mirror the reference app (Game1.cs:111): fov π/4, near 1,
    far 1000."""

    position: tuple = (0.0, 16.0, 32.0)
    target: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov: float = math.pi / 4
    aspect: float = 1.0
    near: float = 1.0
    far: float = 1000.0

    def view(self):
        return xna.look_at(self.position, self.target, self.up)

    def projection(self):
        return xna.perspective_fov(self.fov, self.aspect, self.near, self.far)


def camera_rays(camera: Camera, width: int, height: int, device="cpu"):
    """Primary rays through the integer pixel coordinates (pixel corners,
    RayTracer.cs:412-413), raster-ordered: index = y * width + x.

    Returns ``(origins, directions)``, each (width * height, 3) on
    ``device``."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return rays_through_screen(camera, width, height, xs.reshape(-1),
                               ys.reshape(-1))


def rays_through_screen(camera: Camera, width: int, height: int, sx, sy):
    """Unproject screen points at z=0 and z=1 → normalized rays.

    The direction is combined in homogeneous space: the far point's ``a``
    can round to exactly 0 in f32, where ``far/a_f - near/a_n`` breaks
    down; ``xyz_f*a_n - xyz_n*a_f`` is the same direction up to positive
    scale and exact in that limit."""
    view = camera.view()
    proj = camera.projection()
    near_pts = torch.stack([sx, sy, torch.zeros_like(sx)], dim=-1)
    far_pts = torch.stack([sx, sy, torch.ones_like(sx)], dim=-1)
    n_xyz, n_a = xna.unproject_h(near_pts, view, proj, (width, height))
    f_xyz, f_a = xna.unproject_h(far_pts, view, proj, (width, height))
    o = n_xyz / n_a[..., None]
    d = normalize(f_xyz * n_a[..., None] - n_xyz * f_a[..., None])
    return o, d
