"""XNA-parity matrix math (row-vector convention), on tensors.

Ray generation is exactly ``Viewport.Unproject`` of the near/far pixel
points (RayTracer.cs:410-421).  XNA uses *row vectors* (``v' = [v, 1] @ M``)
and a right-handed view space looking down -Z.  The 4x4 matrices are built
in float32 on the CPU; the per-pixel transforms run on the device of the
screen points.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.core.math3d import cross, dot, normalize

_F32 = torch.float32


def _vec(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def look_at(position, target, up):
    """XNA ``Matrix.CreateLookAt`` (row-vector, RH; Camera.cs:40-47)."""
    position, target, up = _vec(position), _vec(target), _vec(up)
    zaxis = normalize(position - target)
    xaxis = normalize(cross(up, zaxis))
    yaxis = cross(zaxis, xaxis)
    m = torch.zeros((4, 4), dtype=_F32)
    m[0:3, 0] = xaxis
    m[0:3, 1] = yaxis
    m[0:3, 2] = zaxis
    m[3, 0] = -dot(xaxis, position)
    m[3, 1] = -dot(yaxis, position)
    m[3, 2] = -dot(zaxis, position)
    m[3, 3] = 1.0
    return m


def perspective_fov(fov, aspect, near, far):
    """XNA ``Matrix.CreatePerspectiveFieldOfView`` (row-vector, RH;
    Camera.cs:49-54)."""
    y_scale = 1.0 / torch.tan(torch.tensor(fov, dtype=_F32) * 0.5)
    x_scale = y_scale / aspect
    m = torch.zeros((4, 4), dtype=_F32)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 2] = float(np.float32(far / (near - far)))
    m[2, 3] = -1.0
    m[3, 2] = float(np.float32(near * far / (near - far)))
    return m


def transform_homogeneous(p, m):
    """Full 4-component row-vector transform of (..., 3) points: (xyz, w)."""
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    xyz = x * m[0, 0:3] + y * m[1, 0:3] + z * m[2, 0:3] + m[3, 0:3]
    w = x[..., 0] * m[0, 3] + y[..., 0] * m[1, 3] + z[..., 0] * m[2, 3] + m[3, 3]
    return xyz, w


def unproject_h(screen, view, proj, viewport_wh):
    """``Viewport.Unproject`` without the final perspective division:
    ``(xyz, a)`` (see core/camera.py::rays_through_screen for why).

    ``screen`` is (..., 3): pixel x, pixel y, depth in [0, 1]."""
    # The viewport sizes divide as tensors on the screen's device: CUDA
    # turns a division by a Python number into a multiplication by its
    # rounded reciprocal, which would make rays differ by device.
    w, h = (screen.new_tensor(float(x)) for x in viewport_wh)
    inv = torch.linalg.inv(view @ proj).to(screen.device)
    sx = screen[..., 0] / w * 2.0 - 1.0
    sy = -(screen[..., 1] / h * 2.0 - 1.0)
    src = torch.stack([sx, sy, screen[..., 2]], dim=-1)
    return transform_homogeneous(src, inv)


def compose_world_np(scale_v, rotation_v, position_v) -> np.ndarray:
    """SceneObject world matrix S · Rx · Ry · Rz · T in NumPy, composed in
    float32 steps (SceneObject.cs:183-199)."""
    sx, sy, sz = (float(s) for s in np.asarray(scale_v).reshape(3))
    ax, ay, az = (float(a) for a in np.asarray(rotation_v).reshape(3))
    tx, ty, tz = (float(t) for t in np.asarray(position_v).reshape(3))

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array(
            [[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1]], np.float64
        )

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array(
            [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float64
        )

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array(
            [[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64
        )

    t = np.eye(4)
    t[3, :3] = (tx, ty, tz)
    m32 = np.diag([sx, sy, sz, 1.0]).astype(np.float32)
    for r in (rx(ax), ry(ay), rz(az), t):
        m32 = (m32 @ r.astype(np.float32)).astype(np.float32)
    return m32


def quantize_color(v):
    """XNA ``new Color(Vector3)`` byte packing, as a float in [0, 1].

    ``torch.round`` rounds half to even like .NET ``Math.Round``.  The
    divisor is a tensor on ``v``'s device so CUDA divides exactly instead of
    multiplying by a rounded reciprocal."""
    return torch.round(v.clamp(0.0, 1.0) * 255.0) / v.new_tensor(255.0)
