"""Spatial triangle clusters — the acceleration structure the walk kernels read.

Triangles are grouped into fixed-size clusters of ``cluster_size``
(spatial-median BVH leaves by default, ordered by the Morton code of their
centroids).  A walk culls whole clusters against a ray tile's beam, visits
the survivors front to back by a conservative entry bound and tests every
triangle of a visited cluster (kernels/fused.py).  At cluster sizes 64 and
32 several leaves share one 128-lane block (subclusters), culled and tested
leaf by leaf.  The build is host-side
NumPy; ``as_device_arrays`` emits the tables the walk reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

BIG = np.float32(3.4028235e38)
# Leaves per 128-lane block of a subcluster bake, by cluster size.
SUBK = {64: 2, 32: 4}


def morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave three 10-bit integer coordinates into a 30-bit Morton code."""

    def spread(v):
        v = v.astype(np.uint64) & np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return (spread(x) << np.uint64(2)) | (spread(y) << np.uint64(1)) | spread(z)


@dataclasses.dataclass
class ClusterTable:
    """Host-side cluster build result.

    ``order``: (Tp,) original triangle index per slot (-1 padding);
    ``cluster_min/max``: (NC, 3) cluster AABBs."""

    order: np.ndarray
    cluster_min: np.ndarray
    cluster_max: np.ndarray
    cluster_size: int

    @property
    def num_clusters(self) -> int:
        return self.cluster_min.shape[0]

    def as_device_arrays(self, tri_v1, tri_e1, tri_e2, tri_mesh):
        """The walk's tables, as NumPy arrays:

        - ``block`` (NCG, 24, L) f32: per block, the triangles in the
          *triple-product* form of Möller–Trumbore.  With per-ray w = d x o,
          ``det = d·N`` (rows 0-2, N = cross(e2, e1)), ``u*det = w·E2n +
          d·M1n`` (M1n = cross(v1, e2) rows 3-5, E2n = -e2 rows 6-8),
          ``v*det = w·E1 + d·M2`` (M2 = cross(e1, v1) rows 9-11, E1 = e1
          rows 12-14), ``t*det = c0 - o·N`` (c0 = v1·N, row 15).  Row 16 is
          the original triangle id and row 17 the mesh id, both as int32
          bits; padding slots are all-zero geometry (det == 0, never
          accepted) with ids -1.  Rows 18-23 hold the block's AABB (min
          xyz, max xyz) across lanes, as in the reference bake.
        - ``aabb`` (6, NCG): block AABB planes (min xyz, max xyz).
        - ``root`` (8,): scene box min xyz, max xyz, a margin, 0.

        Fitted-plane rows (normal xyz, offset d0, half-thickness eps) are
        baked per leaf: every member vertex p of a leaf satisfies
        |p·n - d0| <= eps, so a beam's interval of t inside the thickened
        plane bounds every hit in the leaf.

        ``cluster_size`` 128 (or any size other than 64 and 32): one leaf
        per block (NCG = NC, L = cluster_size), and ``plane`` (5, NCG).

        ``cluster_size`` 64 or 32 (subclusters): ``subk = 128 //
        cluster_size`` consecutive leaves pack into one 128-lane block,
        leaf h of block g in lanes ``h*cluster_size`` to
        ``(h+1)*cluster_size - 1``; the leaves are padded to a whole block
        with empty, never-feasible ones.  ``block`` and ``aabb`` stay at
        block granularity (the block box is the min/max over its leaves),
        and the per-leaf tables are block-indexed: ``sub_aabb`` (subk, 6,
        NCG) and ``sub_plane`` (subk, 5, NCG), sibling h of block g in
        column g.  Such a bake has no block-level ``plane``: leaf planes
        cannot be combined (raytpu/accel/clusters.py:139-301).
        """
        c = self.cluster_size
        subk = SUBK.get(c, 1)
        order = self.order
        cmin = self.cluster_min.astype(np.float32)
        cmax = self.cluster_max.astype(np.float32)
        nc = self.num_clusters
        if nc % subk:
            padl = subk - nc % subk
            order = np.concatenate([order, np.full(padl * c, -1,
                                                   order.dtype)])
            cmin = np.concatenate([cmin, np.full((padl, 3), BIG, np.float32)])
            cmax = np.concatenate([cmax, np.full((padl, 3), -BIG,
                                                 np.float32)])
            nc += padl
        ncg = nc // subk   # blocks
        lanes = c * subk   # block lane width
        safe = np.maximum(order, 0)
        pad = order < 0
        tri_id = np.where(pad, -1, safe).astype(np.int32)
        mesh = np.where(pad, -1, np.asarray(tri_mesh)[safe]).astype(np.int32)

        def permh(a, fill=0.0):
            out = np.asarray(a, np.float32)[safe].copy()
            out[pad] = fill
            return out

        v1h = permh(tri_v1)
        e1h = permh(tri_e1)
        e2h = permh(tri_e2)
        nrm = np.cross(e2h, e1h)
        m1n = np.cross(v1h, e2h)
        m2 = np.cross(e1h, v1h)
        c0 = np.sum(v1h * nrm, axis=-1)
        block = np.zeros((24, ncg, lanes), np.float32)
        rows = (
            [nrm[:, k] for k in range(3)]
            + [m1n[:, k] for k in range(3)]
            + [-e2h[:, k] for k in range(3)]
            + [m2[:, k] for k in range(3)]
            + [e1h[:, k] for k in range(3)]
            + [c0]
        )
        for i, r in enumerate(rows):
            block[i] = r.reshape(ncg, lanes)
        block[16] = tri_id.reshape(ncg, lanes).view(np.float32)
        block[17] = mesh.reshape(ncg, lanes).view(np.float32)
        mn_g = cmin.reshape(ncg, subk, 3).min(axis=1)
        mx_g = cmax.reshape(ncg, subk, 3).max(axis=1)
        for k3 in range(3):
            block[18 + k3] = mn_g[:, k3:k3 + 1]
            block[21 + k3] = mx_g[:, k3:k3 + 1]
        block = np.ascontiguousarray(block.transpose(1, 0, 2))

        aabb = np.concatenate([mn_g.T, mx_g.T]).astype(np.float32)
        root_min = cmin.min(axis=0)
        root_max = cmax.max(axis=0)
        diag = np.float32(np.max(root_max - root_min))
        margin = np.float32(1e-3) * diag + np.float32(1e-4)
        root = np.zeros(8, np.float32)
        root[0:3] = root_min
        root[3:6] = root_max
        root[6] = margin

        # Fitted plane per leaf: the smallest-covariance-eigenvector plane
        # of its member vertices; eps covers every vertex (f64, padded by a
        # diag-relative slack that swallows the walk's f32 interval
        # rounding).
        p3 = np.stack([v1h, v1h + e1h, v1h + e2h], axis=1)
        p3 = p3.astype(np.float64).reshape(nc, c * 3, 3)
        memb = np.repeat((order >= 0).reshape(nc, c), 3, axis=1)
        w = memb.astype(np.float64)
        cnt = np.maximum(w.sum(1), 1.0)
        mean = (p3 * w[..., None]).sum(1) / cnt[:, None]
        dctr = (p3 - mean[:, None, :]) * w[..., None]
        cov = np.einsum("npk,npl->nkl", dctr, dctr)
        _evals, evec = np.linalg.eigh(cov)
        nrm_pl = evec[:, :, 0]  # min-variance direction, unit length
        proj = np.einsum("npk,nk->np", p3, nrm_pl)
        pmin = np.where(memb, proj, np.inf).min(1)
        pmax = np.where(memb, proj, -np.inf).max(1)
        empty = ~memb.any(1)
        pmin = np.where(empty, 0.0, pmin)
        pmax = np.where(empty, 0.0, pmax)
        d0 = (pmin + pmax) * 0.5
        half = (pmax - pmin) * 0.5
        eps = half * (1.0 + 1e-4) + 1e-5 * float(diag) + 1e-30
        # Empty leaves: a never-constraining plane (their AABB is already
        # infeasible).
        nrm_pl = np.where(empty[:, None], [0.0, 0.0, 1.0], nrm_pl)
        d0 = np.where(empty, 0.0, d0)
        eps = np.where(empty, float(BIG), eps)
        plane = np.concatenate(
            [nrm_pl.T, d0[None, :], eps[None, :]]).astype(np.float32)

        tables = {"block": block, "aabb": aabb, "root": root}
        if subk == 1:
            tables["plane"] = plane
        else:
            tables["sub_aabb"] = np.stack([
                np.concatenate([cmin[h::subk].T, cmax[h::subk].T])
                for h in range(subk)])
            tables["sub_plane"] = np.stack([plane[:, h::subk]
                                            for h in range(subk)])
        return {k: np.ascontiguousarray(a) for k, a in tables.items()}


def _median_split_leaves(centroids: np.ndarray, idx: np.ndarray,
                         cluster_size: int) -> list:
    """Spatial-median BVH leaves of <= cluster_size triangles each.

    Level-synchronous longest-axis median splits (argpartition per segment).
    Versus fixed-length Morton runs this yields tight, nearly disjoint leaf
    AABBs, and so fewer front-to-back trips per tile in the walk.  The split
    point is the multiple of ``cluster_size`` nearest the median, so leaves
    pack full.  Splits operate on *positions* into ``centroids`` and map
    back through ``idx`` at the end."""
    n = idx.shape[0]
    segments = [np.arange(n, dtype=np.int64)]
    leaves = []
    while segments:
        nxt = []
        for seg in segments:
            if seg.shape[0] <= cluster_size:
                leaves.append(idx[seg])
                continue
            c = centroids[seg]
            ext = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(ext))
            half = seg.shape[0] // 2
            m = int(round(half / cluster_size)) * cluster_size
            m = min(max(m, cluster_size), seg.shape[0] - 1)
            part = np.argpartition(c[:, axis], m)
            nxt.append(seg[part[:m]])
            nxt.append(seg[part[m:]])
        segments = nxt
    return leaves


def build_clusters(tri_verts: np.ndarray, cluster_size: int = 128,
                   valid: Optional[np.ndarray] = None,
                   pad_clusters_to: Optional[int] = None) -> ClusterTable:
    """Cluster ``tri_verts`` (T, 3, 3) into fixed-size spatial groups:
    spatial-median BVH leaves (see _median_split_leaves), or one cluster in
    Morton order when the scene fits in one.

    ``valid``: (T,) bool, the triangles to cluster (default all).
    ``pad_clusters_to``: pad the table to that many clusters with empty,
    never-feasible ones (±big box), so rebuilds of moving geometry keep
    every table's shape (diff/fit.py ``rebuild_every``); below the built
    count it raises ``ValueError``."""
    v = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    idx = (np.arange(v.shape[0]) if valid is None
           else np.flatnonzero(valid))
    centroids = v[idx].mean(axis=1)

    if idx.shape[0] > cluster_size:
        leaves = _median_split_leaves(centroids, idx, cluster_size)
        # Order leaves by the Morton code of their centroid so neighboring
        # slots stay spatially local (slot order breaks exact-tie picks).
        cents = np.stack([centroids[np.searchsorted(idx, lf)].mean(axis=0)
                          for lf in leaves])
        lo = cents.min(axis=0)
        extent = np.maximum(cents.max(axis=0) - lo, 1e-30)
        q = np.clip(((cents - lo) / extent) * 1023.0, 0, 1023).astype(
            np.uint32)
        codes = morton3(q[:, 0], q[:, 1], q[:, 2])
        leaves = [leaves[i] for i in np.argsort(codes, kind="stable")]
        nc = len(leaves)
        slots = np.full(nc * cluster_size, -1, np.int64)
        for i, lf in enumerate(leaves):
            slots[i * cluster_size:i * cluster_size + lf.shape[0]] = lf
    else:
        lo = centroids.min(axis=0)
        hi = centroids.max(axis=0)
        extent = np.maximum(hi - lo, 1e-30)
        q = np.clip(((centroids - lo) / extent) * 1023.0, 0, 1023).astype(
            np.uint32)
        codes = morton3(q[:, 0], q[:, 1], q[:, 2])
        order = idx[np.argsort(codes, kind="stable")].astype(np.int64)

        n = order.shape[0]
        nc = max(1, -(-n // cluster_size))
        slots = np.full(nc * cluster_size, -1, np.int64)
        slots[:n] = order

    if pad_clusters_to is not None:
        if pad_clusters_to < nc:
            raise ValueError(
                f"pad_clusters_to={pad_clusters_to} < built count {nc}")
        slots = np.concatenate(
            [slots, np.full((pad_clusters_to - nc) * cluster_size, -1,
                            np.int64)])
        nc = pad_clusters_to

    member = v[np.maximum(slots, 0)]  # (Tp, 3, 3)
    mn = np.where(slots[:, None, None] >= 0, member, BIG).reshape(
        nc, cluster_size, 3, 3
    )
    mx = np.where(slots[:, None, None] >= 0, member, -BIG).reshape(
        nc, cluster_size, 3, 3
    )
    cluster_min = mn.min(axis=(1, 2))
    cluster_max = mx.max(axis=(1, 2))
    # Fully padded clusters keep +/-big bounds and are never feasible.

    return ClusterTable(
        order=slots,
        cluster_min=cluster_min.astype(np.float32),
        cluster_max=cluster_max.astype(np.float32),
        cluster_size=cluster_size,
    )


def leaves_per_block(clusters) -> int:
    """Leaves per block of a bake's tables (``as_device_arrays``): 1, or
    the sibling count of a subcluster bake."""
    return clusters["sub_aabb"].shape[0] if "sub_aabb" in clusters else 1


def leaf_size(clusters) -> int:
    """Triangles per leaf of a bake's tables: the block's lane width over
    its leaves."""
    return clusters["block"].shape[2] // leaves_per_block(clusters)
