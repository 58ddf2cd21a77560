"""FBX scene ingestion — the content-pipeline replacement for FBX assets
(the port's own copy of ``raytpu/scene/fbx_loader.py``, NumPy and zlib).

The reference ingests FBX at build time through XNA's ModelImporter +
TracerModelProcessor (TracerModelProcessor.cs:105-242): vertices transformed
into world space by each node's AbsoluteTransform, normals by its
inverse-transpose (TracerModelProcessor.cs:178-197), UV/color channels
optional, one Material per model (TracerModelProcessor.cs:121-131).  This
module is the standalone equivalent: it parses FBX files directly — both
ASCII and binary containers (the reference's content ships both: cube.fbx
is ASCII 6100, Android.FBX is binary 6000) — and produces
:class:`raytpu_torch.scene.types.Mesh` lists with baked node transforms.

Scope: geometry (Vertices/PolygonVertexIndex with fan triangulation),
normals (ByVertice/ByVertex/ByPolygonVertex/ByPolygon x Direct/
IndexToDirect), UV layer 0 (same mappings), vertex colors (LayerElementColor)
and per-node local transforms (Lcl Translation/Rotation/Scaling, rotation
XYZ in degrees) accumulated through the Connections graph.  Cameras, lights,
animation curves and embedded media are ignored — the reference's processor
only consumes geometry too.
"""

from __future__ import annotations

import dataclasses
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from raytpu_torch.scene.types import Material, Mesh

# ---------------------------------------------------------------------------
# Generic node tree (shared between the ASCII and binary parsers)


@dataclasses.dataclass
class FbxNode:
    name: str
    props: list
    children: List["FbxNode"]

    def find(self, name: str) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]


# ---------------------------------------------------------------------------
# ASCII parser (FBX 6100 text, e.g. Blender 2.x exporter)

_TOKEN = re.compile(
    r"""
    "(?:[^"\\]|\\.)*"          # quoted string
  | [A-Za-z_][A-Za-z0-9_]*:    # node / property name
  | [-+0-9][-+0-9.eE]*         # number
  | [{},*]
    """,
    re.VERBOSE,
)


def _strip_comments(text: str) -> str:
    return re.sub(r";[^\n]*", "", text)


def _parse_ascii(text: str) -> FbxNode:
    toks = _TOKEN.findall(_strip_comments(text))
    root = FbxNode("", [], [])
    stack = [root]
    i = 0
    n = len(toks)
    current: Optional[FbxNode] = None
    while i < n:
        t = toks[i]
        if t.endswith(":") and not t[0].isdigit():
            current = FbxNode(t[:-1], [], [])
            stack[-1].children.append(current)
            i += 1
        elif t == "{":
            stack.append(current)
            i += 1
        elif t == "}":
            stack.pop()
            i += 1
        elif t == ",":
            i += 1
        elif t == "*":
            i += 1  # FBX 7 ASCII array size marker: "*N { a: ... }"
        else:
            if t.startswith('"'):
                current.props.append(t[1:-1])
            else:
                try:
                    current.props.append(int(t))
                except ValueError:
                    current.props.append(float(t))
            i += 1
    # FBX 7 ASCII wraps array payloads in an "a:" child; splice them up.
    def splice(node: FbxNode):
        for c in node.children:
            splice(c)
            a = c.find("a")
            if a is not None and not c.props:
                c.props = a.props
                c.children.remove(a)

    splice(root)
    return root


# ---------------------------------------------------------------------------
# Binary parser ("Kaydara FBX Binary") — 6.x scalar-run and 7.x array props

_MAGIC = b"Kaydara FBX Binary  \x00"


def _parse_binary(data: bytes) -> FbxNode:
    version = struct.unpack_from("<I", data, 23)[0]
    # FBX >= 7500 widens the node-record header fields to u64.
    wide = version >= 7500
    hdr = struct.Struct("<QQQB" if wide else "<IIIB")

    def read_props(pos: int, count: int) -> Tuple[list, int]:
        props = []
        for _ in range(count):
            tc = data[pos:pos + 1]
            pos += 1
            if tc == b"Y":
                props.append(struct.unpack_from("<h", data, pos)[0]); pos += 2
            elif tc == b"C":
                props.append(bool(data[pos])); pos += 1
            elif tc == b"I":
                props.append(struct.unpack_from("<i", data, pos)[0]); pos += 4
            elif tc == b"F":
                props.append(struct.unpack_from("<f", data, pos)[0]); pos += 4
            elif tc == b"D":
                props.append(struct.unpack_from("<d", data, pos)[0]); pos += 8
            elif tc == b"L":
                props.append(struct.unpack_from("<q", data, pos)[0]); pos += 8
            elif tc in (b"S", b"R"):
                ln = struct.unpack_from("<I", data, pos)[0]; pos += 4
                raw = data[pos:pos + ln]; pos += ln
                props.append(raw.decode("utf-8", "replace")
                             if tc == b"S" else raw)
            elif tc in (b"f", b"d", b"i", b"l", b"b"):
                alen, enc, clen = struct.unpack_from("<III", data, pos)
                pos += 12
                raw = data[pos:pos + clen]; pos += clen
                if enc == 1:
                    raw = zlib.decompress(raw)
                dt = {b"f": "<f4", b"d": "<f8", b"i": "<i4", b"l": "<i8",
                      b"b": "<i1"}[tc]
                props.extend(np.frombuffer(raw, dt).tolist())
            else:
                raise ValueError(f"unknown FBX binary type code {tc!r}")
        return props, pos

    def read_node_full(pos: int) -> Tuple[Optional[FbxNode], int]:
        end, num_props, _plen, name_len = hdr.unpack_from(data, pos)
        pos += hdr.size
        if end == 0:
            return None, pos
        name = data[pos:pos + name_len].decode("utf-8", "replace")
        pos += name_len
        props, pos = read_props(pos, num_props)
        children: List[FbxNode] = []
        while pos < end:
            child, pos = read_node_full(pos)
            if child is None:
                break
            children.append(child)
        return FbxNode(name, props, children), end

    root = FbxNode("", [], [])
    pos = 27
    while pos < len(data):
        node, pos = read_node_full(pos)
        if node is None:
            break
        root.children.append(node)
    return root


# ---------------------------------------------------------------------------
# Geometry extraction


def _euler_xyz_deg(rx, ry, rz) -> np.ndarray:
    """FBX Lcl Rotation: XYZ order, degrees — column-vector R = Rz @ Ry @ Rx."""
    rx, ry, rz = np.radians([rx, ry, rz])
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def _node_local_matrix(model: FbxNode) -> np.ndarray:
    t = np.zeros(3)
    r = np.zeros(3)
    s = np.ones(3)
    props = model.find("Properties60") or model.find("Properties70")
    if props is not None:
        pname = "Property" if model.find("Properties60") else "P"
        for p in props.find_all(pname):
            if not p.props:
                continue
            key = p.props[0]
            vals = [v for v in p.props if isinstance(v, (int, float))][-3:]
            if key == "Lcl Translation" and len(vals) == 3:
                t = np.asarray(vals, np.float64)
            elif key == "Lcl Rotation" and len(vals) == 3:
                r = np.asarray(vals, np.float64)
            elif key == "Lcl Scaling" and len(vals) == 3:
                s = np.asarray(vals, np.float64)
    m = np.eye(4)
    m[:3, :3] = _euler_xyz_deg(*r) @ np.diag(s)
    m[:3, 3] = t
    return m


def _layer_values(elem: FbxNode, data_name: str, index_name: str,
                  width: int, n_poly_verts: int, poly_vert_idx: np.ndarray,
                  n_polys: int, poly_of_pv: np.ndarray) -> Optional[np.ndarray]:
    """Resolve a layer element to per-polygon-vertex values (PV, width)."""
    dn = elem.find(data_name)
    if dn is None or not dn.props:
        return None
    vals = np.asarray(dn.props, np.float64).reshape(-1, width)
    mapping = (elem.find("MappingInformationType") or FbxNode("", [""], [])
               ).props[0]
    ref = (elem.find("ReferenceInformationType") or FbxNode("", ["Direct"], [])
           ).props[0]
    idx_node = elem.find(index_name)
    if ref == "IndexToDirect" and idx_node is not None and idx_node.props:
        idx = np.asarray(idx_node.props, np.int64)
        # -1 marks "no value" in some exporters; clamp and let it read row 0.
        vals_pv_src = vals[np.maximum(idx, 0)]
    else:
        vals_pv_src = vals

    if mapping in ("ByVertice", "ByVertex"):
        return vals_pv_src[poly_vert_idx]
    if mapping == "ByPolygonVertex":
        return vals_pv_src[:n_poly_verts]
    if mapping == "ByPolygon":
        return vals_pv_src[poly_of_pv]
    if mapping == "AllSame":
        return np.broadcast_to(vals_pv_src[0], (n_poly_verts, width)).copy()
    return None


def _extract_mesh(geom: FbxNode, world: np.ndarray,
                  material: Material) -> Optional[Mesh]:
    vn = geom.find("Vertices")
    pn = geom.find("PolygonVertexIndex")
    if vn is None or pn is None or not vn.props or not pn.props:
        return None
    verts = np.asarray(vn.props, np.float64).reshape(-1, 3)
    raw_idx = np.asarray(pn.props, np.int64)

    # Decode polygons: negative index = ~last_index_of_polygon.
    pv = np.where(raw_idx < 0, ~raw_idx, raw_idx)
    poly_end = np.flatnonzero(raw_idx < 0)
    poly_start = np.concatenate([[0], poly_end[:-1] + 1])
    n_pv = pv.shape[0]
    poly_of_pv = np.zeros(n_pv, np.int64)
    poly_of_pv[poly_start[1:]] = 1
    poly_of_pv = np.cumsum(poly_of_pv)

    # Fan triangulation, winding FLIPPED to (s, s+i+1, s+i): FBX polygons
    # are CCW-front (outward normal = cross(e1, e2)); the framework's
    # face-normal convention is the reference's ``cross(e2, e1)``
    # (TracerModelProcessor.cs:199-203, whose XNA-imported triangles are
    # CW-front), so the flip keeps snormal outward and backface culling
    # correct.
    tri_pv = []
    for s, e in zip(poly_start, poly_end):
        for k in range(s + 1, e):
            tri_pv.append((s, k + 1, k))
    if not tri_pv:
        return None
    tri_pv = np.asarray(tri_pv, np.int64)  # (T, 3) indices into the PV stream
    tri_vert_idx = pv[tri_pv]  # (T, 3) indices into verts

    # World-space positions (TracerModelProcessor.cs:178-189).
    pos = verts[tri_vert_idx]  # (T, 3, 3)
    pos = pos @ world[:3, :3].T + world[:3, 3]

    normals = None
    ln = geom.find("LayerElementNormal")
    if ln is not None:
        nv = _layer_values(ln, "Normals", "NormalsIndex", 3, n_pv, pv,
                           len(poly_start), poly_of_pv)
        if nv is not None:
            # Normals by the world inverse-transpose
            # (TracerModelProcessor.cs:190-197).
            it = np.linalg.inv(world[:3, :3]).T
            nrm = nv[tri_pv] @ it.T
            ln2 = np.linalg.norm(nrm, axis=-1, keepdims=True)
            normals = (nrm / np.maximum(ln2, 1e-30)).astype(np.float32)

    uvs = None
    lu = geom.find("LayerElementUV")
    if lu is not None:
        uv = _layer_values(lu, "UV", "UVIndex", 2, n_pv, pv,
                           len(poly_start), poly_of_pv)
        if uv is not None:
            uv = uv[tri_pv]
            # FBX V axis is bottom-up; textures sample top-down
            # (Material.LookupUV flips the same way via bitmap layout).
            uv[..., 1] = 1.0 - uv[..., 1]
            uvs = uv.astype(np.float32)

    colors = None
    lc = geom.find("LayerElementColor")
    if lc is not None:
        col = _layer_values(lc, "Colors", "ColorIndex", 4, n_pv, pv,
                            len(poly_start), poly_of_pv)
        if col is not None:
            # Per-triangle color = first corner's color (the reference keeps
            # per-vertex colors but shades with triangle color at u=v=0's
            # corner semantics; we take the mean for stability).
            colors = col[tri_pv].mean(axis=1).astype(np.float32)

    return Mesh(
        vertices=pos.astype(np.float32),
        material=material,
        uvs=uvs,
        normals=normals,
        colors=colors,
    )


def parse_fbx(path: str) -> FbxNode:
    """Parse an FBX file (ASCII or binary) into a generic node tree."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_MAGIC):
        return _parse_binary(data)
    return _parse_ascii(data.decode("utf-8", "replace"))


def load_fbx(path: str, material: Optional[Material] = None,
             scale: float = 1.0) -> List[Mesh]:
    """Load every mesh model in an FBX file as world-space Meshes.

    Handles both the 6.x object model (geometry inline in ``Model`` nodes,
    string-keyed connections — the reference's ASCII and binary-6000 assets)
    and the 7.x object model (geometry in ``Geometry`` nodes linked to
    models by numeric-id connections — its Max-2011 exports).

    ``material`` is shared by all meshes (one Material per model, matching
    TracerModelProcessor.CreateMaterial, TracerModelProcessor.cs:121-131).
    """
    root = parse_fbx(path)
    objects = root.find("Objects")
    if objects is None:
        return []
    material = material or Material()

    # Parent links via Connections (OO links, child -> parent).  Keys are
    # "Model::name" strings in 6.x, numeric ids in 7.x.
    parents: Dict[object, object] = {}
    conn = root.find("Connections")
    if conn is not None:
        for c in conn.find_all("Connect") + conn.find_all("C"):
            if c.props and c.props[0] == "OO" and len(c.props) >= 3:
                parents[c.props[1]] = c.props[2]

    models: Dict[object, FbxNode] = {}
    geometries: Dict[object, FbxNode] = {}
    for m in objects.children:
        if not m.props:
            continue
        if m.name == "Model":
            key = m.props[0]  # 6.x: "Model::name"; 7.x: numeric id
            models[key] = m
        elif m.name == "Geometry" and isinstance(m.props[0], int):
            geometries[m.props[0]] = m

    def world_of(key) -> np.ndarray:
        m = np.eye(4)
        seen = set()
        cur = key
        while cur in models and cur not in seen:
            seen.add(cur)
            m = _node_local_matrix(models[cur]) @ m
            cur = parents.get(cur)
        if scale != 1.0:
            m = np.diag([scale, scale, scale, 1.0]) @ m
        return m

    def obj_class(node: FbxNode) -> str:
        # 6.x: props = [name, class]; 7.x: props = [id, "name\x00\x01Class",
        # subclass].
        for p in node.props[1:]:
            if isinstance(p, str):
                return p.split("\x00\x01")[-1]
        return ""

    meshes: List[Mesh] = []
    if geometries:
        # FBX 7.x: geometry -> owning model(s) via connections.
        geo_parents: Dict[int, list] = {}
        for child, parent in parents.items():
            if child in geometries and parent in models:
                geo_parents.setdefault(child, []).append(parent)
        for gid, geom in geometries.items():
            for model_key in geo_parents.get(gid, []):
                mesh = _extract_mesh(geom, world_of(model_key), material)
                if mesh is not None and mesh.num_triangles:
                    meshes.append(mesh)
    for key, model in models.items():
        if obj_class(model) != "Mesh" or model.find("Vertices") is None:
            continue
        mesh = _extract_mesh(model, world_of(key), material)
        if mesh is not None and mesh.num_triangles:
            meshes.append(mesh)
    return meshes
