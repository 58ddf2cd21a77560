"""Trainable-parameter views over a FlatScene (``raytpu/diff/params.py``).

The reference has no notion of optimization; differentiability is added on
top of its forward semantics (BASELINE.md, config 4: "differentiable
vertex+texture optimization").  A parameter set is a dict of field tensors.
The port's FlatScene keeps the per-triangle fields only as columns of the
packed ``tri_shade`` rows, so the per-triangle field names (``tri_v1``,
``tri_e1``, ...) name column ranges of it; ``apply_params`` rebuilds the
rows in-graph, and recomputes the face normals when geometry moved, so the
scene stays self-consistent the way TracerModelProcessor.cs:199-203 defines
them (``surfaceNormal = normalize(cross(e2, e1))``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from raytpu_torch.core.math3d import cross, normalize
from raytpu_torch.scene.types import FlatScene

#: Parameter groups a fit can select (BASELINE config 4 uses GEOMETRY+TEXTURE).
GEOMETRY = ("tri_v1", "tri_e1", "tri_e2")

# Fields whose gradients flow through the non-geometry tri_shade channels:
# training any of these requires cfg.grad_channels == "all" (the geometry
# gather's backward drops those channels, render/wavefront.py::
# _GatherRowsGeo).  tri_snormal is not here: its channel (24:27) is kept.
SHADE_CONST_FIELDS = frozenset({
    "tri_n1", "tri_n2", "tri_n3", "tri_uv1", "tri_uv2", "tri_uv3",
    "tri_color", "tri_mesh",
})
NORMALS = ("tri_n1", "tri_n2", "tri_n3")
TEXTURE = ("textures",)
VERTEX_COLORS = ("tri_color",)
MATERIALS = ("mat_reflect", "mat_refraction")

#: The per-triangle fields and their ``tri_shade`` columns, in row order
#: (FlatScene.tri_shade); ``tri_mesh`` is column 31, int32 bits.
SHADE_COLUMNS = {
    "tri_v1": (0, 3), "tri_e1": (3, 6), "tri_e2": (6, 9),
    "tri_n1": (9, 12), "tri_n2": (12, 15), "tri_n3": (15, 18),
    "tri_uv1": (18, 20), "tri_uv2": (20, 22), "tri_uv3": (22, 24),
    "tri_snormal": (24, 27), "tri_color": (27, 31), "tri_mesh": (31, 32),
}


def _field(scene: FlatScene, name: str) -> torch.Tensor:
    if name not in SHADE_COLUMNS:
        return getattr(scene, name)
    lo, hi = SHADE_COLUMNS[name]
    col = scene.tri_shade[:, lo:hi]
    if name == "tri_mesh":
        return col[:, 0].contiguous().view(torch.int32)
    return col


def extract_params(scene: FlatScene,
                   fields: Sequence[str] = GEOMETRY + TEXTURE
                   ) -> Dict[str, torch.Tensor]:
    """The requested fields as fresh leaf tensors (copies), floating ones
    with ``requires_grad=True``."""
    out = {}
    for f in fields:
        x = _field(scene, f).detach().clone()
        out[f] = x.requires_grad_() if x.is_floating_point() else x
    return out


def pack_shade(fields: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(N, 32) packed shading rows from the per-triangle fields named in
    ``SHADE_COLUMNS`` (``tri_mesh`` int32, stored as its bits); in-graph,
    so gradients flow back to the fields."""
    cols = []
    for name in SHADE_COLUMNS:
        x = fields[name]
        if name == "tri_mesh":
            x = x.to(torch.int32).contiguous().view(torch.float32)[:, None]
        cols.append(x)
    return torch.cat(cols, dim=-1)


def apply_params(scene: FlatScene,
                 params: Dict[str, torch.Tensor]) -> FlatScene:
    """Merge trained fields back: the scene-level ones replace their
    fields, the per-triangle ones rebuild ``tri_shade`` in-graph, with the
    face normals recomputed when geometry moved.  The cluster tables are
    not rebuilt (``diff/fit.py::rebuild_accel`` does that between epochs)."""
    tri = {f: params.get(f, _field(scene, f)) for f in SHADE_COLUMNS}
    if any(f in params for f in GEOMETRY):
        tri["tri_snormal"] = normalize(cross(tri["tri_e2"], tri["tri_e1"]))
    rest = {f: v for f, v in params.items() if f not in SHADE_COLUMNS}
    if len(rest) == len(params):
        return dataclasses.replace(scene, **rest)
    return dataclasses.replace(scene, tri_shade=pack_shade(tri), **rest)
