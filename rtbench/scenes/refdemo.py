"""The reference engine's own demo: a glass sphere, a mirror torus and a
textured ground under one spot light (``assets/reference_demo.toml``).

The meshes are generated here in NumPy, from the configuration's numbers
alone (the reference's FBX files are not in the repository):

- ``uv_sphere`` and ``torus`` are frozen copies of the arithmetic of
  ``raytpu/scene/procedural.py::uv_sphere`` and ``::torus``, ``plane`` of
  its ``plane`` (two triangles, face normal +y);
- each object is placed in the world here, by XNA's S · Rx · Ry · Rz · T
  (row vectors, SceneObject.cs:183-199), its normals turned by the rotation
  and renormalised; the program and the plain reference are handed the
  same world-space arrays;
- the checker is ``raytpu_torch/scene/procedural.py::checker_texture``'s
  formula, standing in for ``checkers.bmp``.

Every triangle carries the id of its mesh; each mesh has one material.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from rtbench import reference_whitted


@dataclasses.dataclass
class DemoArrays:
    """World-space triangles of several meshes, their materials, one atlas
    and one spot light.

    ``vertices``, ``normals``: (T, 3, 3) float32 corners and unit vertex
    normals; ``uvs`` (T, 3, 2); ``mesh`` (T,) int32, each triangle's mesh;
    ``materials``: one dict a mesh (``diffuse_color`` RGBA in [0, 1],
    ``reflectiveness``, ``transparent``, ``refraction_index``,
    ``interpolate_normals``, ``use_texture``, ``convex``); ``texture``
    (H, W, 3) uint8, the atlas of the textured materials."""

    vertices: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    mesh: np.ndarray
    materials: list
    texture: np.ndarray
    light: dict
    instances: Optional[list] = None   # never instanced

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]


def _grid_faces(rows, cols, keep):
    """Two triangles a cell of a (rows+1) x (cols+1) vertex grid, wound
    (a, c, b), (b, c, d); ``keep(i, first)`` drops a pole's empty ones."""
    faces = []
    for i in range(rows):
        for j in range(cols):
            a = i * (cols + 1) + j
            b, c = a + 1, a + cols + 1
            if keep(i, True):
                faces.append((a, c, b))
            if keep(i, False):
                faces.append((b, c, c + 1))
    return np.asarray(faces, np.int64)


def uv_sphere(stacks, slices):
    """Unit lat-long sphere: (points, normals, uvs, faces)."""
    phi = np.linspace(0.0, np.pi, stacks + 1)
    theta = np.linspace(0.0, 2.0 * np.pi, slices + 1)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    pts = np.stack([np.sin(pp) * np.cos(tt), np.cos(pp),
                    np.sin(pp) * np.sin(tt)], -1).reshape(-1, 3)
    pts = pts.astype(np.float32)
    uvs = np.stack([(tt / (2 * np.pi)).reshape(-1),
                    (pp / np.pi).reshape(-1)], -1).astype(np.float32)
    faces = _grid_faces(stacks, slices,
                        lambda i, first: i > 0 if first else i < stacks - 1)
    return pts, pts.copy(), uvs, faces


def torus(major, minor, rings, sides):
    """Torus about the y axis: (points, normals, uvs, faces)."""
    u = np.linspace(0, 2 * np.pi, rings + 1)
    v = np.linspace(0, 2 * np.pi, sides + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    pts = np.stack([np.cos(uu) * (major + minor * np.cos(vv)),
                    minor * np.sin(vv),
                    np.sin(uu) * (major + minor * np.cos(vv))], -1)
    pts = pts.reshape(-1, 3).astype(np.float32)
    centers = np.stack([np.cos(uu) * major, np.zeros_like(uu),
                        np.sin(uu) * major], -1).reshape(-1, 3)
    normals = pts - centers
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    uvs = np.stack([uu / (2 * np.pi), vv / (2 * np.pi)], -1).reshape(-1, 2)
    faces = _grid_faces(rings, sides, lambda i, first: True)
    return pts, normals.astype(np.float32), uvs.astype(np.float32), faces


def plane(size, uv_scale):
    """Two triangles facing +y: (points, normals, uvs, faces)."""
    hx, hz = size[0] * 0.5, size[1] * 0.5
    pts = np.asarray([(-hx, 0, -hz), (hx, 0, -hz), (hx, 0, hz), (-hx, 0, hz)],
                     np.float32)
    uvs = np.asarray([(0, 0), (uv_scale, 0), (uv_scale, uv_scale),
                      (0, uv_scale)], np.float32)
    normals = np.tile(np.asarray([0, 1, 0], np.float32), (4, 1))
    return pts, normals, uvs, np.asarray([(0, 1, 2), (0, 2, 3)], np.int64)


MESHES = {"uv_sphere": uv_sphere, "torus": torus, "plane": plane}


def world_matrix(scale, rotation_degrees, position):
    """XNA's S · Rx · Ry · Rz · T (row vectors), float64."""
    ax, ay, az = (math.radians(a) for a in rotation_degrees)
    m = np.diag([scale, scale, scale, 1.0])
    for axis, a in ((0, ax), (1, ay), (2, az)):
        c, s = math.cos(a), math.sin(a)
        r = np.eye(4)
        i, j = [k for k in range(3) if k != axis]
        # Rx: [[1,0,0],[0,c,s],[0,-s,c]]; Ry: [[c,0,-s],[0,1,0],[s,0,c]];
        # Rz: [[c,s,0],[-s,c,0],[0,0,1]].
        sign = -1.0 if axis == 1 else 1.0
        r[i, i], r[j, j], r[i, j], r[j, i] = c, c, sign * s, -sign * s
        m = m @ r
    t = np.eye(4)
    t[3, :3] = position
    return m @ t


def _color(rgba):
    """Byte RGBA as XNA's ``new Color(byte, byte, byte, byte)`` reads it."""
    return tuple(float(np.float32(c / 255.0)) for c in rgba)


def checker(tex: dict) -> np.ndarray:
    """``checker_texture(n, size)``'s formula: ``on`` on the odd squares."""
    size, n = tex["size"], tex["squares"]
    y, x = np.mgrid[0:size, 0:size]
    cells = ((x * n // size) + (y * n // size)) % 2
    img = np.where(cells > 0, tex["on"], tex["off"]).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=-1)


def build(config: dict) -> DemoArrays:
    verts, norms, uvs, mesh, materials = [], [], [], [], []
    for k, obj in enumerate(config["objects"]):
        spec = dict(obj["mesh"])
        pts, nrm, uv, faces = MESHES[spec.pop("kind")](**spec)
        w = world_matrix(obj["scale"], obj["rotation_degrees"],
                         obj["position"])
        p = (pts.astype(np.float64) @ w[:3, :3] + w[3, :3]).astype(np.float32)
        n = nrm.astype(np.float64) @ w[:3, :3]
        n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
        verts.append(p[faces])
        norms.append(n[faces])
        uvs.append(uv[faces])
        mesh.append(np.full(faces.shape[0], k, np.int32))
        mat = dict(obj["material"], convex=bool(obj["convex"]))
        mat["diffuse_color"] = _color(mat["diffuse_color"])
        materials.append(mat)
    return DemoArrays(
        vertices=np.ascontiguousarray(np.concatenate(verts)),
        normals=np.ascontiguousarray(np.concatenate(norms)),
        uvs=np.ascontiguousarray(np.concatenate(uvs)),
        mesh=np.concatenate(mesh), materials=materials,
        texture=checker(config["texture"]), light=dict(config["light"]))


def program_scene(arrays: DemoArrays, config: dict, device):
    """The program's bake: one object of one mesh per mesh, placed as it
    is (the arrays are in world space), ``flatten``."""
    from raytpu_torch.scene.lights import SpotLight
    from raytpu_torch.scene.types import Material, Mesh, Scene, SceneObject

    objects = []
    for k, m in enumerate(arrays.materials):
        sel = arrays.mesh == k
        mat = Material(
            reflectiveness=m["reflectiveness"], use_texture=m["use_texture"],
            transparent=m["transparent"],
            refraction_index=m["refraction_index"],
            interpolate_normals=m["interpolate_normals"],
            texture=arrays.texture if m["use_texture"] else None,
            diffuse_color=m["diffuse_color"])
        objects.append(SceneObject(meshes=[Mesh(
            vertices=arrays.vertices[sel], normals=arrays.normals[sel],
            uvs=arrays.uvs[sel], material=mat, convex=m["convex"])]))
    lt = arrays.light
    light = SpotLight(position=tuple(lt["position"]),
                      direction=tuple(lt["direction"]))
    bake = config["bake"]
    return Scene(objects=objects, lights=[light]).flatten(
        cluster_size=bake["cluster_size"], build_octree=bake["build_octree"],
        device=device)


def reference(arrays: DemoArrays, device):
    return reference_whitted.WhittedScene(arrays, device)
