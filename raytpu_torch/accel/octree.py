"""Host-side octree build: flattened arrays for the stackless walk of the
OCTREE query (accel/traverse.py::nearest_hit_octree).

The port's own NumPy copy of ``raytpu/accel/octree.py:56-350``.  The tree
spans all triangles; a node splits 8-way while it holds more than
``leaf_threshold`` triangles (MeshOctree.cs:42), triangles are duplicated
into every child they overlap (MeshOctree.cs:224-232), and the tree is
flattened into preorder arrays with *escape indices*: a ray moves to
``i + 1`` (first child) when it enters an internal node and to ``skip[i]``
otherwise, with no stack.  Every leaf's triangle list is split into chains
of ``chunk``-sized slots (same box, skip to the next slot), padded with
``-1``, so the walk tests a dense (rays, chunk) block per leaf visit.  The
build is level-synchronous and vectorised.

Child membership uses a triangle/AABB separating-axis test (the
reference's vertex-containment test, MeshOctree.cs:226-228, drops
triangles that span a node without a vertex inside it;
``vertex_containment=True`` replicates it), and ``max_depth`` bounds the
recursion.  The same inputs give the JAX package's arrays bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_CHILD_OFFSETS = np.asarray(
    [[i, j, k] for i in range(2) for j in range(2) for k in range(2)],
    np.float32,
)  # SplitCuboid child order (MeshOctree.cs:204-236)


@dataclasses.dataclass
class FlatOctree:
    """Preorder-flattened, leaf-chunked octree.

    ``node_min/max``: (S, 3) AABBs (leaf chains repeat their AABB).
    ``node_skip``: (S,) next preorder slot when not descending; for leaf
    chunks this chains to the next chunk / the subtree escape; the walk ends
    at ``S``.
    ``node_chunk``: (S,) row into ``leaf_tris`` for leaf slots, -1 internal.
    ``node_is_leaf`` / ``node_leaf_count``: per-slot diagnostics.
    ``leaf_tris``: (C, chunk) triangle ids, -1 padding (row 0 is the shared
    all-empty row used by empty leaves).
    """

    node_min: np.ndarray
    node_max: np.ndarray
    node_skip: np.ndarray
    node_chunk: np.ndarray
    node_is_leaf: np.ndarray
    node_leaf_count: np.ndarray
    leaf_tris: np.ndarray
    chunk: int
    max_leaf_count: int

    def as_device_arrays(self, tri_v1, tri_e1, tri_e2, tri_snormal,
                         tri_mesh) -> dict:
        """The query's tables as NumPy arrays: the node tables, and the
        leaf triangles' data gathered per chunk row, so the walk's leaf
        phase reads contiguous (chunk, 3) blocks."""
        rows = np.maximum(self.leaf_tris, 0)
        return {
            "node_min": self.node_min,
            "node_max": self.node_max,
            "node_skip": self.node_skip,
            "node_chunk": self.node_chunk,
            "leaf_tris": self.leaf_tris,
            "leaf_v1": np.asarray(tri_v1)[rows],
            "leaf_e1": np.asarray(tri_e1)[rows],
            "leaf_e2": np.asarray(tri_e2)[rows],
            "leaf_snormal": np.asarray(tri_snormal)[rows],
            "leaf_mesh": np.asarray(tri_mesh)[rows],
        }


def tri_box_overlap(v0, v1, v2, box_min, box_max):
    """Vectorized triangle/AABB separating-axis test (Akenine-Möller).

    ``v0/v1/v2``: (T, 3); ``box_min/max``: (3,) or (T, 3).  Returns (T,) bool.
    """
    box_min = np.broadcast_to(np.asarray(box_min, np.float32), v0.shape)
    box_max = np.broadcast_to(np.asarray(box_max, np.float32), v0.shape)
    c = (box_min + box_max) * 0.5
    h = (box_max - box_min) * 0.5
    p0 = v0 - c
    p1 = v1 - c
    p2 = v2 - c

    # 1. AABB overlap of the triangle's AABB.
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)
    ok = np.all((tmin <= h) & (tmax >= -h), axis=-1)

    # 2. Plane/AABB overlap.
    e0 = p1 - p0
    e1 = p2 - p1
    n = np.cross(e0, e1)
    d = -np.sum(n * p0, axis=-1)
    r = np.sum(h * np.abs(n), axis=-1)
    ok &= np.abs(d) <= r + 1e-12

    # 3. Nine cross-axis tests.
    e2 = p0 - p2
    for e in (e0, e1, e2):
        for axis in range(3):
            a = np.zeros((1, 3), np.float32)
            a[:, axis] = 1.0
            ax = np.cross(a, e)
            pr0 = np.sum(ax * p0, axis=-1)
            pr1 = np.sum(ax * p1, axis=-1)
            pr2 = np.sum(ax * p2, axis=-1)
            rad = np.sum(h * np.abs(ax), axis=-1)
            mn = np.minimum(np.minimum(pr0, pr1), pr2)
            mx = np.maximum(np.maximum(pr0, pr1), pr2)
            ok &= (mn <= rad + 1e-12) & (mx >= -rad - 1e-12)
    return ok


def _vertex_containment(v0, v1, v2, box_min, box_max):
    """The reference's membership test (MeshOctree.cs:226-228): any vertex
    inside-or-on the box."""

    def inside(p):
        return np.all((p >= box_min) & (p <= box_max), axis=-1)

    return inside(v0) | inside(v1) | inside(v2)


def _excl_cumsum(a, axis=-1):
    c = np.cumsum(a, axis=axis)
    return c - a


def build_octree(tri_verts: np.ndarray, leaf_threshold: int = 50,
                 max_depth: int = 12, vertex_containment: bool = False,
                 chunk: int = 16) -> FlatOctree:
    """Build the flattened octree over (T, 3, 3) world-space triangles."""
    tri_verts = np.asarray(tri_verts, np.float32)
    t = tri_verts.shape[0]
    v0, v1, v2 = tri_verts[:, 0], tri_verts[:, 1], tri_verts[:, 2]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)

    root_min = tri_min.min(axis=0)
    root_max = tri_max.max(axis=0)

    # --- Phase 1: level-synchronous split ---------------------------------
    # Frontier state per level: node boxes + membership CSR sorted by node.
    levels = []  # dicts: bmin, bmax, is_leaf, counts, l_node, l_tri
    f_min = root_min[None, :]
    f_max = root_max[None, :]
    ent_node = np.zeros(t, np.int64)
    ent_tri = np.arange(t, dtype=np.int64)

    for depth in range(max_depth + 1):
        f = f_min.shape[0]
        counts = np.bincount(ent_node, minlength=f)
        is_leaf = (counts <= leaf_threshold) | (depth == max_depth)
        leaf_sel = is_leaf[ent_node]
        levels.append(
            dict(
                bmin=f_min,
                bmax=f_max,
                is_leaf=is_leaf,
                counts=counts,
                l_node=ent_node[leaf_sel],
                l_tri=ent_tri[leaf_sel],
            )
        )
        internal = ~is_leaf
        n_int = int(internal.sum())
        if n_int == 0:
            break
        int_rank = np.cumsum(internal) - 1  # node id -> internal rank

        pmin = f_min[internal]
        pmax = f_max[internal]
        half = (pmax - pmin) * 0.5
        cmin = pmin[:, None, :] + half[:, None, :] * _CHILD_OFFSETS[None]
        cmax = cmin + half[:, None, :]

        keep = internal[ent_node]
        e_tri = ent_tri[keep]
        e_rank = int_rank[ent_node[keep]]

        # Stage 1: triangle-AABB vs child-box prefilter, (E', 8).
        tmin_e = tri_min[e_tri][:, None, :]
        tmax_e = tri_max[e_tri][:, None, :]
        s1 = np.all(
            (tmin_e <= cmax[e_rank]) & (tmax_e >= cmin[e_rank]), axis=-1
        )
        ei, ci = np.nonzero(s1)  # entry-major order keeps tri order stable
        cand_tri = e_tri[ei]
        cand_child = e_rank[ei] * 8 + ci
        bmin_p = cmin[e_rank[ei], ci]
        bmax_p = cmax[e_rank[ei], ci]
        if vertex_containment:
            ok = _vertex_containment(
                v0[cand_tri], v1[cand_tri], v2[cand_tri], bmin_p, bmax_p
            )
        else:
            ok = tri_box_overlap(
                v0[cand_tri], v1[cand_tri], v2[cand_tri], bmin_p, bmax_p
            )
        cand_tri = cand_tri[ok]
        cand_child = cand_child[ok]
        order = np.argsort(cand_child, kind="stable")
        ent_node = cand_child[order]
        ent_tri = cand_tri[order]
        f_min = cmin.reshape(-1, 3)
        f_max = cmax.reshape(-1, 3)

    # --- Phase 2: bottom-up subtree sizes (in flat slots) -----------------
    # A leaf with k entries occupies max(1, ceil(k / chunk)) chained slots.
    n_levels = len(levels)
    chains = [
        np.where(
            lv["is_leaf"], np.maximum(1, -(-lv["counts"] // chunk)), 0
        ).astype(np.int64)
        for lv in levels
    ]
    sizes = [None] * n_levels
    sizes[-1] = chains[-1]  # deepest level is all leaves
    for d in range(n_levels - 2, -1, -1):
        lv = levels[d]
        child_sum = sizes[d + 1].reshape(-1, 8).sum(axis=1)
        sz = chains[d].copy()
        sz[~lv["is_leaf"]] = 1 + child_sum
        sizes[d] = sz

    # --- Phase 3: top-down preorder indices -------------------------------
    pre = [None] * n_levels
    pre[0] = np.zeros(1, np.int64)
    for d in range(n_levels - 1):
        lv = levels[d]
        internal = ~lv["is_leaf"]
        base = pre[d][internal] + 1
        child_sizes = sizes[d + 1].reshape(-1, 8)
        pre[d + 1] = (base[:, None] + _excl_cumsum(child_sizes, axis=1)).ravel()

    total = int(sizes[0][0])

    # --- Phase 4: emit flat arrays ----------------------------------------
    node_min = np.empty((total, 3), np.float32)
    node_max = np.empty((total, 3), np.float32)
    node_skip = np.empty(total, np.int64)
    node_chunk = np.full(total, -1, np.int64)
    node_is_leaf = np.zeros(total, bool)
    node_leaf_count = np.zeros(total, np.int64)

    chunk_rows = [np.full((1, chunk), -1, np.int64)]  # row 0: shared empty
    next_row = 1
    for d, lv in enumerate(levels):
        is_leaf = lv["is_leaf"]
        internal = ~is_leaf
        p = pre[d]
        s = sizes[d]
        # Internal slots.
        ii = p[internal]
        node_min[ii] = lv["bmin"][internal]
        node_max[ii] = lv["bmax"][internal]
        node_skip[ii] = ii + s[internal]

        # Leaf chains.
        leaf_ids = np.nonzero(is_leaf)[0]
        if leaf_ids.size == 0:
            continue
        k = chains[d][leaf_ids]
        starts = p[leaf_ids]
        slot = np.repeat(starts, k) + (
            np.arange(k.sum()) - np.repeat(_excl_cumsum(k), k)
        )
        node_min[slot] = np.repeat(lv["bmin"][leaf_ids], k, axis=0)
        node_max[slot] = np.repeat(lv["bmax"][leaf_ids], k, axis=0)
        node_skip[slot] = slot + 1  # chain; the last chunk's +1 IS the escape
        node_is_leaf[slot] = True

        counts = lv["counts"][leaf_ids]
        nonempty = counts > 0
        # Row assignment: empty leaves share row 0; nonempty leaves get
        # consecutive rows in chain order.
        rows_per_leaf = np.where(nonempty, k, 0)
        row0 = next_row + _excl_cumsum(rows_per_leaf)
        n_rows = int(rows_per_leaf.sum())
        chunk_of_slot = np.repeat(
            np.where(nonempty, row0, 0), k
        ) + np.where(
            np.repeat(nonempty, k),
            np.arange(k.sum()) - np.repeat(_excl_cumsum(k), k),
            0,
        )
        node_chunk[slot] = chunk_of_slot

        # Scatter triangle entries into (n_rows, chunk).
        if n_rows:
            rows = np.full((n_rows, chunk), -1, np.int64)
            leaf_rank = np.cumsum(is_leaf) - 1  # node id -> leaf index
            lr = leaf_rank[lv["l_node"]]  # per-entry leaf index
            ent_starts = _excl_cumsum(lv["counts"][leaf_ids])
            pos = np.arange(lv["l_tri"].size) - ent_starts[lr]
            r = (row0 - next_row)[lr] + pos // chunk
            rows[r, pos % chunk] = lv["l_tri"]
            chunk_rows.append(rows)
            next_row += n_rows
            # Per-slot counts (diagnostics): chunk full except the tail.
            full = np.minimum(
                np.repeat(counts, k)
                - (np.arange(k.sum()) - np.repeat(_excl_cumsum(k), k)) * chunk,
                chunk,
            )
            node_leaf_count[slot] = np.maximum(full, 0)

    leaf_tris = np.concatenate(chunk_rows, axis=0)
    counts_all = node_leaf_count[node_is_leaf]
    return FlatOctree(
        node_min=node_min,
        node_max=node_max,
        node_skip=node_skip.astype(np.int32),
        node_chunk=node_chunk.astype(np.int32),
        node_is_leaf=node_is_leaf,
        node_leaf_count=node_leaf_count.astype(np.int32),
        leaf_tris=leaf_tris.astype(np.int32),
        chunk=chunk,
        max_leaf_count=int(counts_all.max()) if counts_all.size else 0,
    )
