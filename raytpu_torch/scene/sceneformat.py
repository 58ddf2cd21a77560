"""TOML scene files — the per-asset material-params analog (the port's
own copy of ``raytpu/scene/sceneformat.py``).

The reference configures each shipped asset through MSBuild processor
parameters on its content project entry
(``RayTraceProjectContent.contentproj:90-226``): ``DiffuseColor`` (byte
RGBA), ``Reflectiveness``, ``Transparent``, ``RefractionIndex``,
``UseTexture``/``TextureFilePath``, ``InterpolateNormals``, ``Scale``,
``RotationX/Y`` — consumed by ``TracerModelProcessor.cs:32-101``.  This
module is the standalone equivalent: one TOML file describes meshes (builtin
procedural shapes or .obj/.fbx paths relative to the file), their transforms,
their material parameters (same names, snake_case), plus lights and an
optional camera:

    [camera]
    position = [0.0, 16.0, 32.0]
    target = [0.0, 0.0, 0.0]

    [[lights]]
    type = "spot"                     # or "directional"
    position = [0.0, 5.0, 20.0]
    direction = [0.0, -0.24, -0.97]

    [[objects]]
    mesh = "sphere"                   # sphere | plane | box | path.obj/.fbx
    radius = 2.0
    position = [-4.0, 2.0, -4.0]
    scale = 1.0                       # scalar or [x, y, z]
    rotation_degrees = [0, 45, 0]     # RotationX/Y analog (or `rotation`
                                      # in radians)
    convex = true
      [objects.material]
      diffuse_color = [255, 0, 0, 100]   # byte RGBA like the reference,
                                         # or floats in [0, 1]
      reflectiveness = 0.7
      transparent = true
      refraction_index = 1.32
      use_texture = true
      texture = "checker"                # builtin, or an image path

Load with ``load_scene_toml`` → ``(Scene, Camera | None)``.
"""

from __future__ import annotations

import math
import os
import tomllib
from typing import Optional, Tuple

import numpy as np

from raytpu_torch.scene.types import Material, Scene, SceneObject


def _vec(v, n=3):
    v = list(v)
    if len(v) != n:
        raise ValueError(f"expected {n} components, got {v}")
    return tuple(float(x) for x in v)


def _color(v):
    """RGBA floats in [0, 1]; byte values (any component > 1) divide by 255
    like XNA's ``new Color(byte, byte, byte, byte)``."""
    v = [float(x) for x in v]
    if len(v) == 3:
        v = v + [255.0 if max(v) > 1.0 else 1.0]
    if max(v) > 1.0:
        v = [x / 255.0 for x in v]
    return tuple(v)


def _texture(spec, base_dir: str) -> np.ndarray:
    if spec == "checker":
        from raytpu_torch.scene.procedural import checker_texture

        return checker_texture()
    from raytpu_torch.io.image import read_image

    return np.asarray(read_image(os.path.join(base_dir, spec)), np.float32)


def _material(tbl: dict, base_dir: str) -> Material:
    m = Material()
    if "reflectiveness" in tbl:
        m.reflectiveness = float(tbl["reflectiveness"])
    if "transparent" in tbl:
        m.transparent = bool(tbl["transparent"])
    if "refraction_index" in tbl:
        m.refraction_index = float(tbl["refraction_index"])
    if "interpolate_normals" in tbl:
        m.interpolate_normals = bool(tbl["interpolate_normals"])
    if "diffuse_color" in tbl:
        m.diffuse_color = _color(tbl["diffuse_color"])
    if "texture" in tbl:
        m.texture = _texture(tbl["texture"], base_dir)
        m.use_texture = True
    if "use_texture" in tbl:
        m.use_texture = bool(tbl["use_texture"])
    if m.use_texture and m.texture is None:
        # The reference pairs UseTexture with TextureFilePath; silently
        # sampling a missing texture would render garbage colors.
        raise ValueError(
            "material sets use_texture = true but no `texture` key "
            "(builtin name or image path)")
    return m


def _meshes(tbl: dict, material: Material, base_dir: str, convex: bool):
    from raytpu_torch.scene import procedural

    spec = tbl.get("mesh", "sphere")
    if spec == "sphere":
        meshes = [procedural.uv_sphere(
            radius=float(tbl.get("radius", 1.0)),
            stacks=int(tbl.get("stacks", 24)),
            slices=int(tbl.get("slices", 48)),
            material=material)]
    elif spec == "plane":
        size = tbl.get("size", [40.0, 40.0])
        meshes = [procedural.plane(size=_vec(size, 2), material=material)]
    elif spec == "box":
        size = tbl.get("size", [1.0, 1.0, 1.0])
        meshes = [procedural.box(size=_vec(size, 3), material=material)]
    else:
        path = os.path.join(base_dir, spec)
        ext = os.path.splitext(path)[1].lower()
        if ext == ".obj":
            from raytpu_torch.scene.obj_loader import load_obj

            meshes = [load_obj(path, material=material)]
        elif ext == ".fbx":
            from raytpu_torch.scene.fbx_loader import load_fbx

            meshes = load_fbx(path, material=material)
        else:
            raise ValueError(f"unknown mesh spec {spec!r}")
    # convexGeometry applies to every mesh kind (Triangle.cs:22).
    for m in meshes:
        m.convex = convex
    return meshes


def _rotation(tbl: dict):
    if "rotation_degrees" in tbl:
        return tuple(math.radians(float(x))
                     for x in _vec(tbl["rotation_degrees"]))
    return _vec(tbl.get("rotation", (0.0, 0.0, 0.0)))


def load_scene_toml(path: str) -> Tuple[Scene, Optional[object]]:
    """Parse a TOML scene file → (Scene, Camera or None)."""
    from raytpu_torch.core.camera import Camera
    from raytpu_torch.scene.lights import DirectionalLight, SpotLight

    with open(path, "rb") as f:
        doc = tomllib.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))

    objects = []
    for tbl in doc.get("objects", []):
        mat = _material(tbl.get("material", {}), base_dir)
        convex = bool(tbl.get("convex", False))
        scale = tbl.get("scale", 1.0)
        if isinstance(scale, (int, float)):
            scale = (float(scale),) * 3
        else:
            scale = _vec(scale)
        objects.append(SceneObject(
            meshes=_meshes(tbl, mat, base_dir, convex),
            scale=scale,
            rotation=_rotation(tbl),
            position=_vec(tbl.get("position", (0.0, 0.0, 0.0))),
        ))

    lights = []
    for tbl in doc.get("lights", []):
        kind = tbl.get("type", "spot")
        if kind == "spot":
            kw = {}
            if "spot_angle" in tbl:
                kw["spot_angle"] = float(tbl["spot_angle"])
            lights.append(SpotLight(position=_vec(tbl["position"]),
                                    direction=_vec(tbl["direction"]), **kw))
        elif kind == "directional":
            lights.append(DirectionalLight(direction=_vec(tbl["direction"])))
        else:
            raise ValueError(f"unknown light type {kind!r}")

    camera = None
    if "camera" in doc:
        c = doc["camera"]
        kw = {}
        if "fov" in c:
            kw["fov"] = float(c["fov"])
        camera = Camera(position=_vec(c.get("position", (0.0, 16.0, 32.0))),
                        target=_vec(c.get("target", (0.0, 0.0, 0.0))), **kw)

    return Scene(objects=objects, lights=lights), camera
