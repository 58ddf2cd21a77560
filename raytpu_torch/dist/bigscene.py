"""Ring-sharded scenes: scenes larger than one device's memory
(``raytpu/dist/bigscene.py``).

The cluster tables are cut into contiguous shards of the spatial cluster
order, one per mesh entry, and the RAYS go round the ring: each hop
intersects the visiting block of rays against the entry's resident shard,
with the block's running bests as per-ray search bounds, and a strict-min
merge carries the winner along.  After ``N`` hops every ray has visited
every shard and is back on its home entry with the exact global nearest
hit.

- Geometry never moves: what travels is the ray state (~48 B a ray), moved
  to the next entry with ``.to()``, the counterpart of ``ppermute``.
- On CUDA tensors the in-shard query is the classic walk kernel
  (``nearest_hit_fused``): the running best enters as ``t_max``, so later
  shards' walks settle early wherever earlier shards already found close
  hits.  On the CPU it is the dense sweep straight off the packed block
  (``_brute_from_block``, the walk's det-space acceptance), as the JAX
  package sweeps off the accelerator; ``intersector="pallas"`` takes the
  walk on either device (the plain walk on the CPU).
- Contiguous shards of the median-split cluster order are spatially
  compact, so per-shard root boxes stay tight.

Tie semantics: hits improve strictly (``t < best``), so an exact
cross-shard distance tie goes to the shard a ray visits FIRST (its home
ring order), unlike the single walk's entry-order tie-break: the JAX
package's documented deviation (raytpu/dist/bigscene.py:27-31).

Shading tables are a separate concern: only the per-ray winner is shaded,
so the renderer shards ``tri_shade`` the same way (``shard_scene_shade``)
and resolves winner rows with one more ring pass (``gather_rows_ring``),
texels likewise (``shard_scene_textures``); ``render_image_ring`` runs the
unmodified wavefront on top of them through its backend injection.

The mesh is single-controller (dist/mesh.py): the ring visits its entries
in turn, and a mesh that repeats one device runs every shard on it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from raytpu_torch.accel.traverse import FLOAT_MAX, PAIR_BUDGET, Hit
from raytpu_torch.core.intersect import det_space_accept
from raytpu_torch.dist.mesh import Mesh, make_mesh

INF = FLOAT_MAX
# A padding block's fitted plane: never constraining (accel/clusters.py's
# empty leaves).
_FREE_PLANE = (0.0, 0.0, 1.0, 0.0, FLOAT_MAX)


class _ShardScene(NamedTuple):
    """What ``nearest_hit_fused`` reads of a scene: the shard's cluster
    tables and a one-row ``tri_shade`` (a ring query asks for no rows)."""

    clusters: dict
    tri_shade: torch.Tensor


def _one_d(mesh: Mesh):
    if len(mesh.axis_names) != 1:
        raise ValueError("ring sharding wants a 1-D mesh")
    return mesh.device_list


def shard_scene_clusters(flat, mesh: Mesh) -> dict:
    """The walk's tables of ``flat`` cut into one shard per mesh entry,
    shard ``i`` on ``mesh.device_list[i]``: per key a list of tensors.

    - ``block`` (NCs, 24, C): the shard's blocks, padded with all-zero
      blocks (det 0: never accepted).  Winner triangle ids need no offset:
      block row 16 carries global ids.
    - ``aabb`` (6, NCs): the blocks' boxes, padding blocks the box of
      FLOAT_MAX corners (the JAX package's BIG).  On a subcluster bake the
      bake's ``aabb`` already holds the block boxes (the group reduce of
      the leaf boxes that raytpu/dist/bigscene.py:77-84 makes), and the
      shard is walked at block granularity.
    - ``root`` (8,): the shard's box and the bake's global margin.
    - ``plane`` (5, NCs), where the bake has block planes (cluster size
      128): the fitted planes, padding blocks unconstrained.

    Also ``tri_shade`` (one zero row per shard), ``devices`` and
    ``n_shards``."""
    devs = _one_d(mesh)
    cl = flat.clusters
    n = mesh.size
    block, aabb = cl["block"], cl["aabb"]
    nc, _, csize = block.shape
    ncs = -(-nc // n)
    margin = cl["root"][6]
    planes = cl.get("plane")
    out = {"block": [], "aabb": [], "root": [], "tri_shade": [],
           "devices": devs, "n_shards": n}
    if planes is not None:
        out["plane"] = []
    for i, dev in enumerate(devs):
        lo, hi = min(i * ncs, nc), min((i + 1) * ncs, nc)
        k = hi - lo
        b = block.new_zeros((ncs, 24, csize))
        b[:k] = block[lo:hi]
        a = aabb.new_full((6, ncs), INF)
        a[:, :k] = aabb[:, lo:hi]
        root = aabb.new_zeros(8)
        if k:
            root[0:3] = aabb[0:3, lo:hi].amin(1)
            root[3:6] = aabb[3:6, lo:hi].amax(1)
        root[6] = margin
        out["block"].append(b.to(dev))
        out["aabb"].append(a.to(dev))
        out["root"].append(root.to(dev))
        out["tri_shade"].append(torch.zeros((1, 32), device=dev))
        if planes is not None:
            p = planes.new_tensor(_FREE_PLANE)[:, None].repeat(1, ncs)
            p[:, :k] = planes[:, lo:hi]
            out["plane"].append(p.to(dev))
    return out


def _shard_tables(shards: dict, i: int) -> dict:
    keys = ("block", "aabb", "root", "plane")
    return {k: shards[k][i] for k in keys if k in shards}


def nearest_hit_ring(shards: dict, origin, direction, mesh: Mesh,
                     ignore_tri=None, ignore_mesh=None, cull=True,
                     tile_size: int = 256, t_max=None,
                     intersector: str = "auto",
                     any_hit: bool = False) -> Hit:
    """Exact nearest hit over ring-sharded geometry (module docstring), on
    ``origin``'s device, in input order.

    The rays are cut into one block per entry (padded with NaN rays of t
    bound 0); block ``j`` starts on entry ``j`` and visits the shards in
    ring order, each hop's search capped at ``min(t_max, best.t)``.

    ``any_hit``: occlusion-query mode — only ``hit`` (and the bounded
    ``t``) mean anything (accel/traverse.nearest_hit); every shard is
    still visited, but a found occlusion drives the cap to 0, so the
    shards after it settle at once.

    ``intersector``: ``"auto"`` walks with the kernel on CUDA shards and
    sweeps CPU shards (``_brute_from_block``); ``"pallas"`` walks on
    either (the plain walk on the CPU).  The JAX package also sweeps on
    its accelerator where Mosaic's DMA rule (a cluster size that is not a
    multiple of 128) or its kernel's f32 winner ids (2^24 global slots or
    more) forbid its walk; the walk kernel here has neither limit (ids
    ride as int32 bits), so the card always walks."""
    devs = _one_d(mesh)
    n = mesh.size
    if shards["n_shards"] != n:
        raise ValueError(f"{shards['n_shards']} shards for a mesh of {n}")
    if intersector not in ("auto", "pallas"):
        raise ValueError(f"intersector must be 'auto' or 'pallas', got "
                         f"{intersector!r}")
    f32, i32 = torch.float32, torch.int32
    home = origin.device
    r = origin.shape[0]
    chunk = -(-r // n)
    pad = chunk * n - r
    o = origin.detach().to(f32)
    d = direction.detach().to(f32)
    # With no ignore ids the in-shard walk skips the id comparisons.
    has_ignore = ignore_tri is not None or ignore_mesh is not None
    itri = (torch.full((r,), -1, dtype=i32, device=home) if ignore_tri is None
            else ignore_tri.detach().to(i32))
    imesh = (torch.full((r,), -1, dtype=i32, device=home)
             if ignore_mesh is None else ignore_mesh.detach().to(i32))
    tmax = (torch.full((r,), INF, dtype=f32, device=home) if t_max is None
            else t_max.detach().to(f32))
    if pad:
        nan = float("nan")
        o = torch.cat([o, o.new_full((pad, 3), nan)])
        d = torch.cat([d, d.new_full((pad, 3), nan)])
        itri = torch.cat([itri, itri.new_full((pad,), -1)])
        imesh = torch.cat([imesh, imesh.new_full((pad,), -1)])
        tmax = torch.cat([tmax, tmax.new_zeros(pad)])

    def block(j):
        s = slice(j * chunk, (j + 1) * chunk)
        dev = devs[j]
        best = Hit(hit=torch.zeros((chunk,), dtype=torch.bool, device=dev),
                   t=torch.full((chunk,), INF, dtype=f32, device=dev),
                   u=torch.zeros((chunk,), dtype=f32, device=dev),
                   v=torch.zeros((chunk,), dtype=f32, device=dev),
                   tri=torch.full((chunk,), -1, dtype=i32, device=dev))
        return [x[s].to(dev) for x in (o, d, itri, imesh, tmax)] + [best]

    # state[i]: the block of rays on entry i.
    state = [block(j) for j in range(n)]
    for _ in range(n):
        for i in range(n):
            o2, d2, it2, im2, tm2, best = state[i]
            cap = torch.minimum(tm2, best.t)
            fused = intersector == "pallas" or devs[i].type == "cuda"
            h = _local_query(shards, i, o2, d2, it2, im2, cap, cull,
                             tile_size, fused, has_ignore, any_hit)
            upd = h.hit & (h.t < best.t)
            best = Hit(*(torch.where(upd, a, b) for a, b in zip(h, best)))
            state[i][5] = best
        # Every block moves on to the next entry (ppermute i -> i + 1);
        # after n moves each is home.
        state = [[x.to(devs[i]) if isinstance(x, torch.Tensor)
                  else Hit(*(y.to(devs[i]) for y in x))
                  for x in state[i - 1]] for i in range(n)]
    best = Hit(*(torch.cat([state[j][5][f].to(home) for j in range(n)])[:r]
                 for f in range(5)))
    return best._replace(t=torch.where(best.hit, best.t, INF))


def _local_query(shards, i, o, d, itri, imesh, cap, cull, tile_size, fused,
                 has_ignore, any_hit=False):
    """Shard ``i``'s hits for a visiting block, capped at ``cap``."""
    tables = _shard_tables(shards, i)
    if fused:
        from raytpu_torch.kernels.fused import nearest_hit_fused

        return nearest_hit_fused(
            _ShardScene(tables, shards["tri_shade"][i]), o, d,
            ignore_tri=itri if has_ignore else None,
            ignore_mesh=imesh if has_ignore else None, cull=cull,
            tile_size=tile_size, t_max=cap, any_hit=any_hit)
    return _brute_from_block(tables, o, d, itri, imesh, cap, cull,
                             has_ignore)


def _brute_from_block(cl, o, d, itri, imesh, cap, cull, has_ignore=True):
    """Dense exact sweep straight off the packed (NCs, 24, C) block
    (raytpu/dist/bigscene.py:262-310): the det-space Möller–Trumbore of
    block rows 0-17, in the JAX package's arithmetic order, taking a
    cluster's best lane (the lowest lane on equal t) only where it is
    strictly below the best so far, in cluster order.  Hits must lie
    strictly below ``cap``."""
    block = cl["block"]
    r = o.shape[0]
    nc, _, csize = block.shape
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    wx = dy * oz - dz * oy
    wy = dz * ox - dx * oz
    wz = dx * oy - dy * ox
    best_t = cap.clone()
    best_u = torch.zeros_like(cap)
    best_v = torch.zeros_like(cap)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    rows = torch.arange(r, device=o.device)
    step = max(1, PAIR_BUDGET // max(1, r * csize))
    for c0 in range(0, nc, step):
        g = block[c0:c0 + step].transpose(0, 1).reshape(24, 1, -1)
        row = lambda k: g[k]  # noqa: E731  (1, K*C)
        det = dx * row(0) + dy * row(1) + dz * row(2)
        udet = (wx * row(6) + wy * row(7) + wz * row(8)
                + dx * row(3) + dy * row(4) + dz * row(5))
        vdet = (wx * row(12) + wy * row(13) + wz * row(14)
                + dx * row(9) + dy * row(10) + dz * row(11))
        tdet = row(15) - (ox * row(0) + oy * row(1) + oz * row(2))
        ok = det_space_accept(det, udet, vdet, tdet, cull)
        tid = g[16].contiguous().view(torch.int32)
        if has_ignore:
            tmesh = g[17].contiguous().view(torch.int32)
            ok &= (tid != itri[:, None]) & (tmesh != imesh[:, None])
        dist = torch.where(ok, tdet / det, INF)
        # The first slot of the least t: the lowest lane of the first
        # cluster that reaches it, as the JAX package's cluster scan takes.
        j = torch.argmin(dist, dim=1)
        cand = dist[rows, j]
        upd = cand < best_t
        safe = det[rows, j]
        safe = torch.where(safe == 0.0, 1.0, safe)
        best_u = torch.where(upd, udet[rows, j] / safe, best_u)
        best_v = torch.where(upd, vdet[rows, j] / safe, best_v)
        best_tri = torch.where(upd, tid[0, j], best_tri)
        best_t = torch.where(upd, cand, best_t)
    hit = best_tri >= 0
    return Hit(hit=hit, t=torch.where(hit, best_t, INF), u=best_u, v=best_v,
               tri=best_tri)


# ---------------------------------------------------------------------------
# Rendering: ring-sharded shade rows and texels under the full wavefront.
# ---------------------------------------------------------------------------


def _row_shards(rows: torch.Tensor, mesh: Mesh) -> dict:
    """(T, K) rows cut into one (Ts, K) shard of consecutive rows per
    entry, zero-padded."""
    devs = _one_d(mesh)
    n = mesh.size
    t = rows.shape[0]
    ts = -(-t // n)
    padded = rows.new_zeros((n * ts,) + tuple(rows.shape[1:]))
    padded[:t] = rows
    return {"shade": [padded[i * ts:(i + 1) * ts].to(dev)
                      for i, dev in enumerate(devs)],
            "rows_per_shard": ts, "n_shards": n, "devices": devs}


def shard_scene_shade(flat, mesh: Mesh) -> dict:
    """``flat.tri_shade`` cut into per-entry row shards: entry ``i`` holds
    rows ``[i*Ts, (i+1)*Ts)`` of the ORIGINAL triangle ids, independent of
    the geometry shards (winner rows are resolved by their own ring pass).
    Padding rows are zero."""
    if flat.tri_shade is None:
        raise ValueError("ring shading needs the packed tri_shade bake")
    return _row_shards(flat.tri_shade.detach(), mesh)


def _ring_gather(tables, ids_blocks, ts: int, devs) -> list:
    """The forward ring pass: id block ``j`` (on entry ``j``) visits the
    entries in ring order, each contributing the rows it owns; returns the
    (chunk, K) rows of each block, home again."""
    n = len(devs)
    k = tables[0].shape[1]
    state = [(ids, torch.zeros((ids.shape[0], k), dtype=tables[0].dtype,
                               device=ids.device)) for ids in ids_blocks]
    for _ in range(n):
        for i in range(n):
            ids2, acc = state[i]
            local = ids2 - i * ts
            mine = (local >= 0) & (local < ts)
            rows = tables[i][local.clamp(0, ts - 1)]
            state[i] = (ids2, torch.where(mine[:, None], rows, acc))
        state = [tuple(x.to(devs[i]) for x in state[i - 1])
                 for i in range(n)]
    return [acc for _, acc in state]


class _RingGather(torch.autograd.Function):
    """``gather_rows_ring``'s differentiable twin: the forward is the ring
    pass of ids and rows; the backward sends each block's cotangent rows
    round the ring with its ids, and every entry scatter-adds those of the
    ids it owns into its own (Ts, K) gradient, so neither pass ever
    gathers a table (raytpu/dist/bigscene.py:369-419)."""

    @staticmethod
    def forward(ctx, ts, devs, home, ids_p, *tables):
        chunk = ids_p.shape[0] // len(devs)
        blocks = [ids_p[j * chunk:(j + 1) * chunk].to(dev)
                  for j, dev in enumerate(devs)]
        ctx.save_for_backward(ids_p)
        ctx.ts, ctx.devs = ts, devs
        rows = _ring_gather(tables, blocks, ts, devs)
        return torch.cat([x.to(home) for x in rows])

    @staticmethod
    def backward(ctx, ct):
        (ids_p,) = ctx.saved_tensors
        devs, ts = ctx.devs, ctx.ts
        n = len(devs)
        chunk = ids_p.shape[0] // n
        grads = [torch.zeros((ts, ct.shape[1]), dtype=ct.dtype, device=dev)
                 for dev in devs]
        state = [(ids_p[j * chunk:(j + 1) * chunk].to(dev),
                  ct[j * chunk:(j + 1) * chunk].to(dev))
                 for j, dev in enumerate(devs)]
        for _ in range(n):
            for i in range(n):
                ids2, ct2 = state[i]
                local = ids2 - i * ts
                mine = (local >= 0) & (local < ts)
                grads[i].index_add_(0, local.clamp(0, ts - 1),
                                    torch.where(mine[:, None], ct2, 0.0))
            state = [tuple(x.to(devs[i]) for x in state[i - 1])
                     for i in range(n)]
        return (None, None, None, None, *grads)


def gather_rows_ring(shade: dict, ids, mesh: Mesh,
                     differentiable: bool = False):
    """Rows of per-ray original triangle ids (negative: none, a zero row)
    from the row shards ``shade`` (``shard_scene_shade``), on ``ids``'
    device.  The ids travel the ring with a (R, K) accumulator and each
    entry contributes the rows it owns; what travels is ids and rows
    (~132 B a ray a hop), never the table.

    ``differentiable``: through ``_RingGather``, whose backward sends the
    cotangent rows back round the ring to their owner shards, so a loss
    reaches the sharded table (the differentiable wavefront reads triangle
    data only through the gather)."""
    devs = _one_d(mesh)
    n = mesh.size
    ts = shade["rows_per_shard"]
    r = ids.shape[0]
    chunk = -(-r // n)
    ids_p = ids.detach().long()
    if chunk * n - r:
        ids_p = torch.cat([ids_p, ids_p.new_full((chunk * n - r,), -1)])
    if differentiable:
        out = _RingGather.apply(ts, devs, ids.device, ids_p, *shade["shade"])
    else:
        blocks = [ids_p[j * chunk:(j + 1) * chunk].to(dev)
                  for j, dev in enumerate(devs)]
        out = torch.cat([x.to(ids.device) for x in
                         _ring_gather(shade["shade"], blocks, ts, devs)])
    return out[:r]


def strip_for_ring(flat, strip_textures: bool = True):
    """``flat`` with every per-triangle table dropped (the shade rows, the
    cluster tables, the octree) and, with ``strip_textures``, the atlas:
    the ring renderer reaches geometry only through its query and gather
    and texels only through its fetch, so the big tables need not exist on
    any one device.  The small tables (materials, meshes, lights, texture
    sizes) stay replicated."""
    none = dict(tri_shade=None, clusters=None, octree=None)
    if strip_textures:
        none["textures"] = None
    return dataclasses.replace(flat, **none)


def make_ring_backends(shards: dict, shade: dict, mesh: Mesh,
                       tile_size: int = 256, intersector: str = "auto",
                       differentiable: bool = False):
    """``(query, gather)`` for the wavefront's backend injection
    (render/wavefront.py): ``nearest_hit_ring`` over the geometry shards,
    and the shade rows of the winners by ``gather_rows_ring``.  The query
    has no rows (no ``supports_rows``), so the wavefront gathers them.
    ``differentiable``: the gather's ring backward (the query is always
    detached by the differentiable wavefront)."""
    from raytpu_torch.render.wavefront import shade_row_views

    def query(scene, origin, direction, *, ignore_tri=None,
              ignore_mesh=None, t_max=None, any_hit=False, cull=True):
        return nearest_hit_ring(
            shards, origin, direction, mesh, ignore_tri=ignore_tri,
            ignore_mesh=ignore_mesh, cull=cull, tile_size=tile_size,
            t_max=t_max, intersector=intersector, any_hit=any_hit)

    def gather(scene, tri):
        return shade_row_views(gather_rows_ring(
            shade, tri, mesh, differentiable=differentiable))

    return query, gather


def _texel_fetch(flat, mesh: Mesh, texshards, differentiable: bool):
    """The ring texel fetch of a textured scene: over ``texshards``, or
    over the scene's own atlas sharded now; None for a scene without
    textures."""
    if not flat.has_textures:
        return None
    if texshards is None and flat.textures is not None:
        texshards = shard_scene_textures(flat, mesh)
    if texshards is None:
        raise ValueError("textured scene stripped of its atlas: pass "
                         "texshards=shard_scene_textures(original_flat, "
                         "mesh)")
    return make_texel_fetch_ring(texshards, mesh,
                                 differentiable=differentiable)


def render_rays_ring(flat, cfg, origin, direction, mesh: Optional[Mesh],
                     shards: Optional[dict] = None,
                     shade: Optional[dict] = None,
                     texshards: Optional[dict] = None):
    """Trace a ray batch against ring-sharded geometry → (R, 3) colors.

    ``flat`` gives the replicated small tables (materials, lights, texture
    sizes) on the device the shading runs on; its per-triangle tables are
    not read when ``shards`` and ``shade`` are given — pass
    ``strip_for_ring(flat)`` for a scene whose tables fit no one device.
    ``cfg.differentiable``: the gathers take the ring backward, so a loss
    over these colors reaches the sharded tables."""
    mesh = mesh or make_mesh()
    if shards is None:
        shards = shard_scene_clusters(flat, mesh)
    if shade is None:
        shade = shard_scene_shade(flat, mesh)
    texel_fetch = _texel_fetch(flat, mesh, texshards, cfg.differentiable)
    query, gather = make_ring_backends(shards, shade, mesh,
                                       tile_size=cfg.cull_tile,
                                       differentiable=cfg.differentiable)
    from raytpu_torch.render.wavefront import trace_colors

    return trace_colors(flat, cfg, origin, direction, query=query,
                        gather=gather, texel_fetch=texel_fetch)


def render_image_ring(flat, cfg, camera=None, mesh: Optional[Mesh] = None,
                      shards: Optional[dict] = None,
                      shade: Optional[dict] = None,
                      texshards: Optional[dict] = None):
    """Full-frame ring-sharded render → (H, W, 3) float32 on ``flat``'s
    device, in ``render_image``'s square-block order.  ``mesh`` defaults to
    every CUDA device."""
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.render.wavefront import block_order_perm

    camera = camera or Camera(aspect=cfg.width / cfg.height)
    dev = flat.device
    o, d = camera_rays(camera, cfg.width, cfg.height, device=dev)
    perm = block_order_perm(cfg.width, cfg.height,
                            max(1, int(cfg.cull_tile ** 0.5)), dev)
    colors = render_rays_ring(flat, cfg, o[perm], d[perm], mesh,
                              shards=shards, shade=shade,
                              texshards=texshards)
    out = torch.zeros_like(colors)
    out[perm] = colors
    return out.reshape(cfg.height, cfg.width, 3)


# ---------------------------------------------------------------------------
# Differentiable ring fits: geometry optimization on sharded scenes.
# ---------------------------------------------------------------------------

GEOMETRY_COLUMNS = {"tri_v1": slice(0, 3), "tri_e1": slice(3, 6),
                    "tri_e2": slice(6, 9)}
_COL_MID = slice(9, 24)      # n1 n2 n3 uv1 uv2 uv3 (shade constants)
_COL_TAIL = slice(27, 32)    # color rgba, mesh bits


def extract_ring_params(flat, mesh: Mesh) -> dict:
    """The geometry parameters cut like ``shard_scene_shade``: for each of
    ``tri_v1``, ``tri_e1``, ``tri_e2`` a list of (Ts, 3) leaf tensors,
    entry ``i`` holding rows ``[i*Ts, (i+1)*Ts)`` on its device.  Padding
    rows are zero and no ray gathers them."""
    rows = flat.tri_shade.detach()
    return {f: [x.clone().requires_grad_()
                for x in _row_shards(rows[:, cols], mesh)["shade"]]
            for f, cols in GEOMETRY_COLUMNS.items()}


def ring_shade_from_params(shade_const, params: dict) -> list:
    """The shade shards with their geometry columns rebuilt from the
    sharded ``params``: v1, e1, e2 from them, the face normal
    ``normalize(cross(e2, e1))`` (TracerModelProcessor.cs:199-203), the
    shade constants from the baked shards ``shade_const``.  Shard by
    shard, on each shard's device."""
    from raytpu_torch.core.math3d import cross, normalize

    out = []
    for i, const in enumerate(shade_const):
        v1, e1, e2 = (params[f][i] for f in GEOMETRY_COLUMNS)
        sn = normalize(cross(e2, e1))
        out.append(torch.cat([v1, e1, e2, const[:, _COL_MID], sn,
                              const[:, _COL_TAIL]], dim=-1))
    return out


def make_ring_fit_step(flat, cfg, mesh: Mesh, optimizer,
                       shards: Optional[dict] = None,
                       shade: Optional[dict] = None,
                       texshards: Optional[dict] = None):
    """A geometry fit step over a ring-sharded scene
    (raytpu/dist/bigscene.py:628-688).

    ``flat`` gives the replicated small tables (``strip_for_ring(flat)``
    with prebuilt shards for a scene that fits no one device); the
    parameters are ``extract_ring_params``'s shards, held by the
    ``torch.optim`` ``optimizer``.  The loss, the pixel MSE, renders
    through the differentiable ring backends: the shade-row gather's
    backward sends cotangent rows back to their owner shards, so neither
    pass gathers a whole table.  As in the replicated fit, the walk's
    shards are the bake's and lag the geometry until re-sharded.

    Returns ``step(params, origin, direction, target) -> loss`` (detached);
    the parameters update in place and keep their gradients in
    ``.grad``."""
    from raytpu_torch.render.wavefront import trace_colors

    if shards is None:
        shards = shard_scene_clusters(flat, mesh)
    if shade is None:
        shade = shard_scene_shade(flat, mesh)
    texel_fetch = _texel_fetch(flat, mesh, texshards, True)
    cfg = dataclasses.replace(cfg, differentiable=True)
    shade_const = shade["shade"]

    def step(params, origin, direction, target):
        optimizer.zero_grad(set_to_none=True)
        sh = dict(shade, shade=ring_shade_from_params(shade_const, params))
        query, gather = make_ring_backends(
            shards, sh, mesh, tile_size=cfg.cull_tile, differentiable=True)
        colors = trace_colors(flat, cfg, origin, direction, query=query,
                              gather=gather, texel_fetch=texel_fetch)
        loss = torch.mean((colors - target) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# Ring-sharded texture atlases.
# ---------------------------------------------------------------------------


def shard_scene_textures(flat, mesh: Mesh) -> Optional[dict]:
    """The (T, Hp, Wp, 3) atlas as (T*Hp*Wp, 3) texel rows cut into
    per-entry shards like the shade rows, resolved by the same ring pass.
    None for a scene without an atlas."""
    if flat.textures is None:
        return None
    t, hp, wp, _ = flat.textures.shape
    out = _row_shards(flat.textures.detach().reshape(-1, 3), mesh)
    out.update(hp=hp, wp=wp)
    return out


def make_texel_fetch_ring(texshards: dict, mesh: Mesh,
                          differentiable: bool = False):
    """``fetch(tex_id, y, x) -> (..., 3)`` raw texels over ring-sharded
    atlas rows, for the texture sampler's ``fetch``
    (scene/texture.py::lookup_uv): one ring gather per point sample, four
    per bilinear one.  ``differentiable``: the gathers' ring backward."""
    hp, wp = texshards["hp"], texshards["wp"]

    def fetch(tex_id, y, x):
        idx = (tex_id.long() * hp + y.long()) * wp + x.long()
        rows = gather_rows_ring(texshards, idx.reshape(-1), mesh,
                                differentiable=differentiable)
        return rows.reshape(idx.shape + (3,))

    return fetch
