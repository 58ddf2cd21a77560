"""Procedural test geometry (NumPy).

Stands in for the reference's FBX asset set (sphere, crate, ground plane)
so every configuration runs without an FBX toolchain.  Every generator
returns a :class:`raytpu_torch.scene.types.Mesh`.
"""

from __future__ import annotations

import numpy as np

from raytpu_torch.scene.types import Material, Mesh


def checker_texture(n: int = 8, size: int = 256) -> np.ndarray:
    """checkers.bmp stand-in (the reference ships one in its content)."""
    y, x = np.mgrid[0:size, 0:size]
    cells = ((x * n // size) + (y * n // size)) % 2
    img = np.where(cells[..., None] > 0, 220.0, 40.0)
    return np.repeat(img, 3, axis=-1).reshape(size, size, 3).astype(np.float32)


def _mesh_from_indexed(verts, normals, uvs, faces, material, **kw):
    faces = np.asarray(faces, np.int64)
    v = verts[faces]  # (T, 3, 3)
    n = normals[faces] if normals is not None else None
    uv = uvs[faces] if uvs is not None else None
    return Mesh(vertices=v, normals=n, uvs=uv, material=material, **kw)


def uv_sphere(radius=1.0, stacks=24, slices=48, material=None, convex=False):
    """Lat-long sphere with smooth normals and spherical UVs (the reference's
    'sphere' demo asset analog, Game1.cs:98-107)."""
    material = material or Material()
    phi = np.linspace(0.0, np.pi, stacks + 1)
    theta = np.linspace(0.0, 2.0 * np.pi, slices + 1)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(pp) * np.cos(tt)
    y = np.cos(pp)
    z = np.sin(pp) * np.sin(tt)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    normals = pts.copy()
    verts = pts * radius
    u = (tt / (2 * np.pi)).reshape(-1)
    v = (pp / np.pi).reshape(-1)
    uvs = np.stack([u, v], axis=-1).astype(np.float32)

    cols = slices + 1
    faces = []
    for i in range(stacks):
        for j in range(slices):
            a = i * cols + j
            b = a + 1
            c = a + cols
            d = c + 1
            if i > 0:
                faces.append((a, c, b))
            if i < stacks - 1:
                faces.append((b, c, d))
    return _mesh_from_indexed(verts, normals, uvs, faces, material, convex=convex)


def box(size=(1.0, 1.0, 1.0), material=None, uv_per_face=True):
    """Axis-aligned box with per-face normals/UVs (the crate asset analog)."""
    material = material or Material()
    sx, sy, sz = (s * 0.5 for s in size)
    # faces: +X -X +Y -Y +Z -Z, each with outward normal and [0,1]^2 uv.
    face_defs = [
        ((+1, 0, 0), [(sx, -sy, -sz), (sx, sy, -sz), (sx, sy, sz), (sx, -sy, sz)]),
        ((-1, 0, 0), [(-sx, -sy, sz), (-sx, sy, sz), (-sx, sy, -sz), (-sx, -sy, -sz)]),
        ((0, +1, 0), [(-sx, sy, -sz), (-sx, sy, sz), (sx, sy, sz), (sx, sy, -sz)]),
        ((0, -1, 0), [(-sx, -sy, sz), (-sx, -sy, -sz), (sx, -sy, -sz), (sx, -sy, sz)]),
        ((0, 0, +1), [(-sx, -sy, sz), (sx, -sy, sz), (sx, sy, sz), (-sx, sy, sz)]),
        ((0, 0, -1), [(sx, -sy, -sz), (-sx, -sy, -sz), (-sx, sy, -sz), (sx, sy, -sz)]),
    ]
    tri_v, tri_n, tri_uv = [], [], []
    quad_uv = [(0.0, 1.0), (1.0, 1.0), (1.0, 0.0), (0.0, 0.0)]
    for normal, corners in face_defs:
        c = np.asarray(corners, np.float32)
        uv = np.asarray(quad_uv, np.float32)
        for tri in ((0, 2, 1), (0, 3, 2)):
            tri_v.append(c[list(tri)])
            tri_n.append(np.tile(np.asarray(normal, np.float32), (3, 1)))
            tri_uv.append(uv[list(tri)])
    return Mesh(
        vertices=np.stack(tri_v),
        normals=np.stack(tri_n),
        uvs=np.stack(tri_uv),
        material=material,
    )


def plane(size=(40.0, 40.0), y=0.0, material=None, uv_scale=1.0):
    """Ground plane facing +Y (the 'Ground' asset analog, Game1.cs:80-84)."""
    material = material or Material()
    hx, hz = size[0] * 0.5, size[1] * 0.5
    corners = np.asarray(
        [(-hx, y, -hz), (hx, y, -hz), (hx, y, hz), (-hx, y, hz)], np.float32
    )
    uvs = np.asarray(
        [(0, 0), (uv_scale, 0), (uv_scale, uv_scale), (0, uv_scale)], np.float32
    )
    # Winding chosen so the face normal (normalize(cross(e2, e1)),
    # TracerModelProcessor.cs:199-203) points +Y.
    tris = [(0, 1, 2), (0, 2, 3)]
    v = np.stack([corners[list(t)] for t in tris])
    uv = np.stack([uvs[list(t)] for t in tris])
    n = np.tile(np.asarray([0, 1, 0], np.float32), (2, 3, 1))
    return Mesh(vertices=v, normals=n, uvs=uv, material=material)


def subdivided_plane(size=(40.0, 40.0), y=0.0, divisions=64, material=None,
                     uv_scale=1.0, height_fn=None):
    """Dense tessellated plane; with ``height_fn(x, z)`` it yields large
    benchmark meshes (100k/1M-triangle configs) with meaningful geometry."""
    material = material or Material()
    n = divisions
    xs = np.linspace(-size[0] / 2, size[0] / 2, n + 1)
    zs = np.linspace(-size[1] / 2, size[1] / 2, n + 1)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    yy = np.full_like(xx, y)
    if height_fn is not None:
        yy = y + height_fn(xx, zz)
    pts = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
    u = (xx / size[0] + 0.5) * uv_scale
    v = (zz / size[1] + 0.5) * uv_scale
    uvs = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)

    cols = n + 1
    i = np.arange(n)
    j = np.arange(n)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    a = (ii * cols + jj).reshape(-1)
    b = a + 1
    c = a + cols
    d = c + 1
    # Winding such that the face normal (normalize(cross(e2, e1)),
    # TracerModelProcessor.cs:199-203) points +Y, like plane().
    f1 = np.stack([a, c, b], -1)
    f2 = np.stack([b, c, d], -1)
    faces = np.concatenate([f1, f2])
    # Smooth normals via face-normal accumulation.
    tri = pts[faces]
    fn = np.cross(tri[:, 2] - tri[:, 0], tri[:, 1] - tri[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
    vert_n = np.zeros_like(pts)
    for k in range(3):
        np.add.at(vert_n, faces[:, k], fn)
    vert_n /= np.maximum(np.linalg.norm(vert_n, axis=-1, keepdims=True), 1e-30)
    return _mesh_from_indexed(pts, vert_n.astype(np.float32), uvs, faces, material)
