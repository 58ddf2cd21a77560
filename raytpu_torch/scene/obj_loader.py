"""Wavefront OBJ ingestion: the port's own copy of
``raytpu/scene/obj_loader.py``, NumPy on the host.

Replaces the reference's offline FBX content pipeline
(TracerModelProcessor.cs:105-242): positions/normals/uvs are read, faces are
triangulated (fan), and the result is a :class:`Mesh` ready for flattening.
Missing normals fall back to face normals (matching the processor's
transformed-normal path only when the channel exists).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from raytpu_torch.scene.types import Material, Mesh


def load_obj(path: str, material: Optional[Material] = None,
             convex: bool = False) -> Mesh:
    positions = []
    uvs = []
    normals = []
    face_v, face_vt, face_vn = [], [], []

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                positions.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                vals = line.split()[1:3]
                uvs.append([float(vals[0]), float(vals[1])])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                corners = line.split()[1:]
                idx = []
                for c in corners:
                    parts = c.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    idx.append((vi, ti, ni))
                for k in range(1, len(idx) - 1):  # triangle fan
                    # OBJ faces are CCW-front (outward normal =
                    # cross(e1, e2)); the framework's face-normal
                    # convention is the reference's ``cross(e2, e1)``
                    # (TracerModelProcessor.cs:199-203, with XNA's
                    # CW-front triangle order), so flip the winding to
                    # keep snormal outward and backface culling correct.
                    face_v.append((idx[0][0], idx[k + 1][0], idx[k][0]))
                    face_vt.append((idx[0][1], idx[k + 1][1], idx[k][1]))
                    face_vn.append((idx[0][2], idx[k + 1][2], idx[k][2]))

    pos = np.asarray(positions, np.float32)
    uv = np.asarray(uvs, np.float32) if uvs else None
    nrm = np.asarray(normals, np.float32) if normals else None

    def resolve(indices, count):
        out = np.asarray(indices, np.int64)
        return np.where(out > 0, out - 1, out + count)

    fv = resolve(face_v, pos.shape[0])
    verts = pos[fv]

    mesh_uv = None
    if uv is not None and any(any(t) for t in face_vt):
        ft = resolve(face_vt, uv.shape[0])
        mesh_uv = uv[np.clip(ft, 0, uv.shape[0] - 1)]
        # OBJ v runs bottom-up; textures sample top-down like the reference's
        # GDI+ bitmaps, so flip v.
        mesh_uv = mesh_uv.copy()
        mesh_uv[..., 1] = 1.0 - mesh_uv[..., 1]

    mesh_n = None
    if nrm is not None and any(any(t) for t in face_vn):
        fn = resolve(face_vn, nrm.shape[0])
        mesh_n = nrm[np.clip(fn, 0, nrm.shape[0] - 1)]

    return Mesh(
        vertices=verts,
        uvs=mesh_uv,
        normals=mesh_n,
        material=material or Material(),
        convex=convex,
    )
