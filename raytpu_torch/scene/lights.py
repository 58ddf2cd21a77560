"""Lights: host-side descriptions plus the shading formulas on tensors.

- SpotLight (SpotLight.cs:37-62): cone test ``dot(-dirToLight, Direction) >
  cos(angle/2)``, intensity ``I*(lightDot-cosA)/(1-cosA)^DecayExponent``,
  diffuse ``* surfaceDot`` plus the hard-coded ``surfaceDot^12`` term, zero
  when the fragment faces away.
- DirectionalLight (DirectionalLight.cs:23-30): ``Color * max(dot(Direction,
  normal), 0) * Intensity`` — the reference dots the light's *forward*
  direction; replicated as-is.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytpu_torch.core.math3d import dot, normalize

SPOT = 0
DIRECTIONAL = 1
FLOAT_MAX = float(np.finfo(np.float32).max)  # float.MaxValue


@dataclasses.dataclass
class SpotLight:
    """Reference defaults: DecayExponent 1.3, Intensity 1 (SpotLight.cs:31-35)."""

    position: tuple = (0.0, 5.0, 20.0)
    direction: tuple = (0.0, 0.0, -1.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    decay_exponent: float = 1.3
    spot_angle: float = math.pi / 2

    @property
    def angle_cosine(self) -> float:
        # SpotLight.SpotAngle setter (SpotLight.cs:22-27).
        return math.cos(self.spot_angle * 0.5)


@dataclasses.dataclass
class DirectionalLight:
    direction: tuple = (0.0, -1.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0


def pack_lights(lights, max_lights=None):
    """Pack a list of lights into SoA numpy arrays (padded, mask in 'valid')."""
    n = len(lights)
    m = max_lights or max(n, 1)
    out = {
        "type": np.zeros(m, np.int32),
        "position": np.zeros((m, 3), np.float32),
        "direction": np.zeros((m, 3), np.float32),
        "color": np.zeros((m, 3), np.float32),
        "intensity": np.zeros(m, np.float32),
        "decay_exponent": np.ones(m, np.float32),
        "angle_cosine": np.zeros(m, np.float32),
        "valid": np.zeros(m, bool),
    }
    for i, lt in enumerate(lights):
        out["valid"][i] = True
        out["color"][i] = lt.color
        out["intensity"][i] = lt.intensity
        out["direction"][i] = lt.direction
        if isinstance(lt, SpotLight):
            out["type"][i] = SPOT
            out["position"][i] = lt.position
            out["decay_exponent"][i] = lt.decay_exponent
            out["angle_cosine"][i] = lt.angle_cosine
        elif isinstance(lt, DirectionalLight):
            out["type"][i] = DIRECTIONAL
        else:
            raise TypeError(f"unknown light {lt!r}")
    return out


def spot_contrib(position, direction, color, intensity, decay_exp, angle_cos,
                 frag_pos, normal):
    """SpotLight.GetLightForFragment (SpotLight.cs:37-62), batched over rays."""
    dir_to_light = normalize(position - frag_pos)
    surface_dot = dot(dir_to_light, normal)
    light_dot = dot(-dir_to_light, direction)
    spot_intensity = (intensity * (light_dot - angle_cos)
                      / (1.0 - angle_cos) ** decay_exp)
    contrib = (color * (spot_intensity * surface_dot)[..., None]
               + (surface_dot ** 12)[..., None])
    on = (surface_dot >= 0.0) & (light_dot > angle_cos)
    return torch.where(on[..., None], contrib, 0.0)


def directional_contrib(direction, color, intensity, frag_pos, normal):
    """DirectionalLight.GetLightForFragment (DirectionalLight.cs:23-30)."""
    surface_dot = torch.clamp(dot(direction, normal), min=0.0)
    return color * (surface_dot * intensity)[..., None]


def light_contrib(lt, i, frag_pos, normal):
    """Evaluate packed light ``i`` for a batch of fragments; a
    SPOT/DIRECTIONAL select implements the ILight dispatch (ILight.cs:9-16)."""
    spot = spot_contrib(
        lt["position"][i], lt["direction"][i], lt["color"][i],
        lt["intensity"][i], lt["decay_exponent"][i], lt["angle_cosine"][i],
        frag_pos, normal,
    )
    direc = directional_contrib(
        lt["direction"][i], lt["color"][i], lt["intensity"][i], frag_pos, normal
    )
    return torch.where(lt["type"][i] == SPOT, spot, direc)


def light_shadow_query(lt, i, frag_pos):
    """Shadow-ray setup (IsLightPathObstructed, RayTracer.cs:465-479).

    Positionable lights: direction toward the light, distance to it.
    Directional: ``-Direction`` with float.MaxValue distance."""
    to_light = lt["position"][i] - frag_pos
    dist = torch.sqrt(dot(to_light, to_light))
    pos_dir = to_light / dist[..., None]
    is_pos = lt["type"][i] == SPOT
    dir_out = torch.where(is_pos, pos_dir, -lt["direction"][i])
    dist_out = torch.where(is_pos, dist, FLOAT_MAX)
    return dir_out, dist_out
