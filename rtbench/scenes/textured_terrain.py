"""The textured height field: ``bench.py::build_scene(textured=True)``.

The height field of scene.py (its frozen ``height_field``) with its UVs
scaled by ``terrain.uv_scale``, one material that takes its colour from a
checker atlas (``use_texture``), and the spot light of the configuration.
The atlas is ``config["texture"]``: ``size`` texels a side, squares of
``square`` texels, channel ``scale * c + offset`` with c = 1 on the odd
squares (bench.py:45-51: R 180c + 40, G 120c + 60, B 90).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from rtbench import reference_textured, scene


@dataclasses.dataclass
class TexturedArrays(scene.SceneArrays):
    """The scene's arrays and its atlas, (H, W, 3) uint8."""

    texture: Optional[np.ndarray] = None


def checker(tex: dict) -> np.ndarray:
    n, sq = tex["size"], tex["square"]
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = ((xx // sq + yy // sq) % 2)[..., None]
    return (c * np.asarray(tex["scale"]) + np.asarray(tex["offset"])).astype(
        np.uint8)


def build(config: dict) -> TexturedArrays:
    t = config["terrain"]
    divisions = max(8, int(round((float(t["triangles"]) / 2) ** 0.5)))
    verts, normals, uvs = scene.height_field(t["size"], divisions,
                                             t["height_terms"], t["uv_scale"])
    return TexturedArrays(
        vertices=np.ascontiguousarray(verts, np.float32),
        normals=np.ascontiguousarray(normals, np.float32),
        uvs=np.ascontiguousarray(uvs, np.float32),
        color=tuple(float(c) for c in t["diffuse_color"]),
        reflectiveness=float(t["reflectiveness"]),
        light=dict(config["light"]), texture=checker(config["texture"]))


def program_scene(arrays: TexturedArrays, config: dict, device):
    """The program's bake: one textured mesh, ``flatten``."""
    from raytpu_torch.scene.lights import SpotLight
    from raytpu_torch.scene.types import Material, Mesh, Scene, SceneObject

    mat = Material(reflectiveness=arrays.reflectiveness, use_texture=True,
                   texture=arrays.texture, diffuse_color=arrays.color)
    mesh = Mesh(vertices=arrays.vertices, normals=arrays.normals,
                uvs=arrays.uvs, material=mat)
    lt = arrays.light
    light = SpotLight(position=tuple(lt["position"]),
                      direction=tuple(lt["direction"]))
    bake = config["bake"]
    return Scene(objects=[SceneObject(meshes=[mesh])],
                 lights=[light]).flatten(cluster_size=bake["cluster_size"],
                                         build_octree=bake["build_octree"],
                                         device=device)


def reference(arrays: TexturedArrays, device):
    return reference_textured.TexturedScene(arrays, device)
