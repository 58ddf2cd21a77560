"""Scene model.

The host-side builder classes (``Material``, ``Mesh``, ``SceneObject``,
``Scene``) are the reference package's, in NumPy.  ``FlatScene`` is the
baked scene the renderer reads: a plain dataclass of tensors on one device,
holding what the forward render path uses — the packed shade rows, the
cluster tables of the walk kernels, the mesh/material/texture tables and
the lights — plus static flags.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Material:
    """Material parameters (Material.cs:25-57, TracerModelProcessor.cs:32-101).

    ``texture`` is an (H, W, 3) uint8 array (the RayTracerTexture analog)."""

    reflectiveness: float = 0.5
    use_texture: bool = False
    transparent: bool = False
    refraction_index: float = 1.33
    interpolate_normals: bool = True
    texture: Optional[np.ndarray] = None
    diffuse_color: tuple = (1.0, 1.0, 1.0, 1.0)


@dataclasses.dataclass
class Mesh:
    """A triangle soup + material (Mesh.cs:9-41).

    ``vertices``: (T, 3, 3) float32 corners; ``uvs``: (T, 3, 2) or None;
    ``normals``: (T, 3, 3) vertex normals or None (face normals used);
    ``colors``: (T, 4) per-triangle RGBA or None (diffuse color used);
    ``convex``: the reference's convexGeometry flag (Triangle.cs:22)."""

    vertices: np.ndarray
    material: Material = dataclasses.field(default_factory=Material)
    uvs: Optional[np.ndarray] = None
    normals: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    convex: bool = False

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3, 3)
        t = self.vertices.shape[0]
        if self.uvs is not None:
            self.uvs = np.asarray(self.uvs, np.float32).reshape(t, 3, 2)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, np.float32).reshape(t, 3, 3)
        if self.colors is not None:
            self.colors = np.asarray(self.colors, np.float32).reshape(t, 4)

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]


@dataclasses.dataclass
class SceneObject:
    """A placed instance of a mesh list (SceneObject.cs:12-258); world
    matrix S·Rx·Ry·Rz·T (SceneObject.cs:183-199)."""

    meshes: List[Mesh]
    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    name: str = ""

    def world_matrix(self) -> np.ndarray:
        from raytpu_torch.core import xna

        return xna.compose_world_np(self.scale, self.rotation, self.position)


@dataclasses.dataclass
class Scene:
    """Host-side scene: objects + lights.  ``flatten()`` bakes a FlatScene."""

    objects: List[SceneObject] = dataclasses.field(default_factory=list)
    lights: List[Any] = dataclasses.field(default_factory=list)

    def flatten(self, **kw) -> "FlatScene":
        """``scene/flatten.py::flatten_scene``: on the card unless ``device``
        names another."""
        from raytpu_torch.scene.flatten import flatten_scene

        return flatten_scene(self, **kw)


@dataclasses.dataclass
class FlatScene:
    """The baked scene: tensors on one device, one world space.

    ``tri_shade`` (N, 32) f32 is one packed shading row per triangle: v1 e1
    e2 n1 n2 n3 (3 each), uv1 uv2 uv3 (2 each), snormal (3), color (4),
    mesh id (1, int32 bits).  ``clusters`` holds the walk's tables
    (accel/clusters.py): ``block`` (NCG, 24, C), ``aabb`` (6, NCG),
    ``root`` (8,) and ``plane`` (5, NCG) or, baked at cluster size 64 or 32,
    ``sub_aabb`` (subk, 6, NCG) and ``sub_plane`` (subk, 5, NCG); the
    tiled query's leaf tables, ``tri_block`` and, when baked, ``gblock``
    and ``gsplit``.
    ``octree``: the OCTREE query's tables (accel/octree.py) or None."""

    tri_shade: torch.Tensor
    clusters: dict
    mesh_material: torch.Tensor  # (M,) int32
    mesh_convex: torch.Tensor  # (M,) bool
    mat_reflect: torch.Tensor  # (K,) f32
    mat_transparent: torch.Tensor  # (K,) bool
    mat_refraction: torch.Tensor  # (K,) f32 refraction index
    mat_use_texture: torch.Tensor  # (K,) bool
    mat_interp_normals: torch.Tensor  # (K,) bool
    mat_texture: torch.Tensor  # (K,) int32, -1 = none
    textures: torch.Tensor  # (T, H, W, 3) f32 raw 0..255 byte values
    tex_hw: torch.Tensor  # (T, 2) int32 true (height, width)
    lights: dict  # packed lights (scene/lights.py::pack_lights)
    octree: Optional[dict] = None
    num_tris: int = 0
    num_meshes: int = 0
    num_lights: int = 0
    light_kinds: tuple = ()
    has_transparent: bool = False
    has_textures: bool = False
    # A material both reflective and transparent: such a scene's levels
    # double ([reflection | refraction]); a fit that trains mat_reflect
    # sets it (diff/fit.py).
    has_dual_branch: bool = False

    @property
    def device(self) -> torch.device:
        return self.mesh_material.device

    def to(self, device) -> "FlatScene":
        """A copy with every tensor on ``device``."""
        move = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
        fields = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = v.to(device)
            elif isinstance(v, dict):
                v = move(v)
            fields[f.name] = v
        return FlatScene(**fields)
