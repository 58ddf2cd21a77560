"""The benchmark's scenes, generated from a configuration file's numbers.

Frozen copies, so that the yardstick does not move with the program:

- ``height_field`` is ``raytpu_torch/scene/procedural.py::subdivided_plane``
  with the height function of ``bench.py::build_scene`` (999,698
  triangles at 1e6), copied at commit ee2838e.  The arithmetic is the
  same, so the arrays equal those of ``chip_smoke.py::bench_scene``.
- The instance placement is ``chip_smoke.py::instanced_frame_scene``'s
  (``INSTANCES``: 2x2 over 80x80 units, each a further quarter turn about
  y), copied at commit ee2838e.

Everything here is NumPy on the host; the program and the plain reference
(reference.py) are handed the same arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SceneArrays:
    """One mesh, its placements and one spot light.

    ``vertices``, ``normals``: (T, 3, 3) float32 corners and vertex
    normals; ``uvs`` (T, 3, 2); ``color`` the RGBA diffuse color;
    ``instances``: None for the mesh placed once as it is, else a list of
    (x, z, quarter turns about y)."""

    vertices: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    color: tuple
    reflectiveness: float
    light: dict
    instances: Optional[list] = None

    @property
    def num_triangles(self) -> int:
        n = self.vertices.shape[0]
        return n * (len(self.instances) if self.instances else 1)


def _height(terms):
    """``sum(a * f(x * kx) * g(z * kz))`` over ``terms`` of the form
    ``[a, f, kx, g, kz]``, f and g named NumPy functions ("sin", "cos")."""

    def fn(x, z):
        out = 0.0
        for a, f, kx, g, kz in terms:
            out = out + a * getattr(np, f)(x * kx) * getattr(np, g)(z * kz)
        return out

    return fn


def height_field(size, divisions, height_terms, uv_scale=1.0):
    """``subdivided_plane`` (frozen copy): a (divisions+1)^2 vertex grid over
    ``size``, two triangles a cell wound so that the face normal
    ``normalize(cross(e2, e1))`` points +y, smooth vertex normals from the
    accumulated face normals.  Returns (vertices, normals, uvs)."""
    n = divisions
    xs = np.linspace(-size[0] / 2, size[0] / 2, n + 1)
    zs = np.linspace(-size[1] / 2, size[1] / 2, n + 1)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    yy = 0.0 + _height(height_terms)(xx, zz)
    pts = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
    u = (xx / size[0] + 0.5) * uv_scale
    v = (zz / size[1] + 0.5) * uv_scale
    uvs = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)

    cols = n + 1
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (ii * cols + jj).reshape(-1)
    b = a + 1
    c = a + cols
    d = c + 1
    faces = np.concatenate([np.stack([a, c, b], -1), np.stack([b, c, d], -1)])
    tri = pts[faces]
    fn = np.cross(tri[:, 2] - tri[:, 0], tri[:, 1] - tri[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
    vert_n = np.zeros_like(pts)
    for k in range(3):
        np.add.at(vert_n, faces[:, k], fn)
    vert_n /= np.maximum(np.linalg.norm(vert_n, axis=-1, keepdims=True), 1e-30)
    return (pts[faces], vert_n.astype(np.float32)[faces], uvs[faces])


def build(config: dict) -> SceneArrays:
    """The scene of a configuration file (configs/*.json)."""
    t = config["terrain"]
    divisions = max(8, int(round((float(t["triangles"]) / 2) ** 0.5)))
    verts, normals, uvs = height_field(t["size"], divisions,
                                       t["height_terms"])
    inst = config.get("instances")
    return SceneArrays(
        vertices=np.ascontiguousarray(verts, np.float32),
        normals=np.ascontiguousarray(normals, np.float32),
        uvs=np.ascontiguousarray(uvs, np.float32),
        color=tuple(float(c) for c in t["diffuse_color"]),
        reflectiveness=float(t["reflectiveness"]),
        light=dict(config["light"]),
        instances=[tuple(i) for i in inst] if inst else None)


def world_matrix(x: float, z: float, quarter_turns: int) -> np.ndarray:
    """Row-vector world matrix (p' = [p, 1] @ W) of a placement: a turn of
    ``quarter_turns * pi / 2`` about y, then the move to (x, 0, z)
    (XNA's ``CreateRotationY`` and ``CreateTranslation``), in float64."""
    a = quarter_turns * math.pi / 2
    c, s = math.cos(a), math.sin(a)
    w = np.eye(4)
    w[0, 0], w[0, 2], w[2, 0], w[2, 2] = c, -s, s, c
    w[3, :3] = (x, 0.0, z)
    return w


def orbit_pose(camera, poses: int, k: int):
    """Pose ``k`` of a turntable orbit of ``poses`` poses a turn about the y
    axis through ``camera`` (``cli/main.py::cmd_animate``'s orbit)."""
    cx, cy, cz = camera
    radius = math.hypot(cx, cz)
    ang = math.atan2(cx, cz) + 2.0 * math.pi * (k % poses) / poses
    return (radius * math.sin(ang), cy, radius * math.cos(ang))
