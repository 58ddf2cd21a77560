"""Vector math helpers shared by the tracer (tensors, broadcasting over (..., 3)).

Sums over the three components are written out left to right so the
rounding is the same on every device and in every kernel that mirrors them.
"""

from __future__ import annotations

import torch


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    """XNA ``Vector3.Normalize``: divide by length (no epsilon guard)."""
    return v / length(v)[..., None]


def reflect(d, n):
    """XNA ``Vector3.Reflect``: d - 2*dot(d, n)*n (RayTracer.cs:549)."""
    return d - 2.0 * dot(d, n)[..., None] * n
