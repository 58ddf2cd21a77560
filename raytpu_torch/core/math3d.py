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


def refract_xna(direction, normal, n1, n2):
    """The reference's vector Snell refraction (RayTracer.cs:675-690).

    Returns the *unnormalized* refraction direction; the caller normalizes
    (RayTracer.cs:694).  Total internal reflection produces NaN (the C# code
    takes sqrt of a negative), which downstream intersection tests treat as
    a miss — replicated deliberately.  The NaN is a constant selected in
    after the square root of a sanitized radicand, so no gradient flows
    through it: a zero cotangent times a NaN would be NaN.  ``n1``/``n2``:
    (R,) tensors."""
    ratio = n1 / n2
    cos1 = dot(normal, -direction)
    k = 1.0 - ratio * ratio * (1.0 - cos1 * cos1)
    tir = ~(k >= 0.0)  # NaN included
    cos2 = torch.sqrt(torch.where(tir, 1.0, k))
    term = (ratio * cos1 - cos2)[..., None]
    base = ratio[..., None] * direction
    out = torch.where((cos1 >= 0.0)[..., None], base + term * normal,
                      base - term * normal)
    return torch.where(tir[..., None], float("nan"), out)
