"""The port's subcluster bakes and walks (cluster sizes 64 and 32) and the
walks' multi-cluster trips (``chunk_k``) against the JAX package: its bake,
its ``_tlane_kernel`` and ``_fused_kernel`` in interpret mode
(``nearest_hit_fused(layout=..., plane=..., gate=..., chunk_k=...)``), its
routing and its fit's re-bake.

On the CPU ``nearest_hit_fused`` runs the plain PyTorch walks, the versions
the CUDA kernels are held to bit for bit on the card (chip_smoke.py).
Tolerances, as in test_torch_kernels.py: bakes bit for bit; hit and any-hit
booleans exact; triangle ids exact where no other hit of the batch shares
the t; t/u/v to rtol 1e-6, because XLA contracts a*b+c into FMAs inside the
reference's interpret-mode kernel and the port does not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.accel import traverse
from raytpu.diff.fit import rebuild_accel as jax_rebuild_accel
from raytpu.diff.params import extract_params as jax_extract_params
from raytpu.kernels import fused as jfused
from raytpu_torch.accel.clusters import leaf_size, leaves_per_block
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.diff.fit import rebuild_accel
from raytpu_torch.diff.params import GEOMETRY, extract_params
from raytpu_torch.kernels import fused
from raytpu_torch.kernels.fused import nearest_hit_fused
from raytpu_torch.render.wavefront import block_order_perm
from tests.torch_scenes import flagship, jax_bake, random_rays
from tests.torch_scenes import sphere_and_plane, t, terrain, to_port

torch.set_num_threads(1)


def jax_fused(flat, o, d, **kw):
    """The reference query, jitted (one program per signature)."""
    return jax.jit(functools.partial(jfused.nearest_hit_fused, **kw))(
        flat, o, d)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _unique_t(tvals, hit):
    tv = np.where(hit, tvals, np.nan)
    _, inv, counts = np.unique(tv, return_inverse=True, return_counts=True)
    return hit & (counts[inv] == 1)


def _assert_nearest(ph, ref, rtol=1e-6):
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(ph.hit.numpy(), hit)
    np.testing.assert_allclose(ph.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=rtol)
    solo = _unique_t(ph.t.numpy(), hit)
    np.testing.assert_array_equal(ph.tri.numpy()[solo],
                                  np.asarray(ref.tri)[solo])
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(ph, f).numpy()[hit],
                                   np.asarray(getattr(ref, f))[hit],
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", params=[64, 32])
def scenes(request):
    jflat = jax_bake(sphere_and_plane("jax"), request.param)
    return request.param, jflat, to_port(jflat)


def test_subcluster_tables_match_the_jax_bake(scenes):
    """block, aabb, sub_aabb, sub_plane and root bit for bit (the
    reference's (8, NC8) grids cut to NCG columns); no block-level plane;
    every fitted plane covers its leaf's vertices (the exactness condition
    of the plane cull, tests/test_accel.py:589-613)."""
    csize, jflat, _ = scenes
    own = sphere_and_plane("torch").flatten(device="cpu", cluster_size=csize)
    jcl, pcl = jflat.clusters, own.clusters
    subk = 128 // csize
    ncg = pcl["block"].shape[0]
    # The walk's tables and the query layer's (the tiled query's leaf
    # tables, tri_block: test_torch_query.py); no block-level plane.
    assert sorted(pcl) == ["aabb", "block", "cluster_max", "cluster_min",
                           "root", "sub_aabb", "sub_plane", "tri_block",
                           "tri_e1", "tri_e2", "tri_id", "tri_mesh",
                           "tri_snormal", "tri_v1"]
    assert leaves_per_block(pcl) == subk and leaf_size(pcl) == csize
    np.testing.assert_array_equal(_bits(pcl["block"].numpy()),
                                  _bits(np.asarray(jcl["block"])))
    for k, rows in (("aabb", 6), ("sub_aabb", 6), ("sub_plane", 5)):
        ref = np.asarray(jcl[k]).reshape(-1, rows, 8 * jcl[k].shape[-1])
        np.testing.assert_array_equal(_bits(pcl[k].numpy()).reshape(
            ref.shape[0], rows, ncg), _bits(ref[:, :, :ncg]), err_msg=k)
    np.testing.assert_array_equal(_bits(pcl["root"].numpy()),
                                  _bits(np.asarray(jcl["root"])[0]))
    ids = pcl["block"][:, 16].contiguous().view(torch.int32).numpy()
    ids = ids.reshape(ncg, subk, csize)
    v1 = own.tri_shade[:, 0:3].numpy().astype(np.float64)
    e1 = own.tri_shade[:, 3:6].numpy().astype(np.float64)
    e2 = own.tri_shade[:, 6:9].numpy().astype(np.float64)
    sp = pcl["sub_plane"].numpy().astype(np.float64)
    for g in range(ncg):
        for h in range(subk):
            m = ids[g, h][ids[g, h] >= 0]
            if not m.size:
                continue
            pts = np.concatenate([v1[m], v1[m] + e1[m], v1[m] + e2[m]])
            assert np.abs(pts @ sp[h, 0:3, g] - sp[h, 3, g]).max() <= (
                sp[h, 4, g])


@pytest.mark.parametrize("any_hit", [False, True])
def test_subwalk_matches_interpret_kernel(scenes, any_hit):
    """tests/test_accel.py::TestSubclusterKernel: ``layout="t"`` with the
    leaf planes off and on and the gate off and on, 128 rays in tiles of
    32, against the reference's ``_tlane_kernel``."""
    _, jflat, pflat = scenes
    o, d = random_rays(20, 128)
    tmax = np.full((128,), 18.0, np.float32) if any_hit else None
    for plane, gate in ((False, False), (True, True)):
        kw = dict(tile_size=32, layout="t", plane=plane, gate=gate,
                  any_hit=any_hit)
        ref = jax_fused(jflat, jnp.asarray(o), jnp.asarray(d),
                        t_max=None if tmax is None else jnp.asarray(tmax),
                        interpret=True, **kw)
        ph = nearest_hit_fused(pflat, t(o), t(d),
                               t_max=None if tmax is None else t(tmax), **kw)
        if any_hit:
            np.testing.assert_array_equal(ph.hit.numpy(), np.asarray(ref.hit))
            assert ph.hit.any() and not ph.hit.all()
        else:
            _assert_nearest(ph, ref)


def test_subwalk_ignore_ids_and_nonfinite_rays(scenes):
    """Ignore ids and a NaN origin through the default routing (the
    subcluster walk) against the reference's brute-force query."""
    _, jflat, pflat = scenes
    o, d = random_rays(21, 32)
    o[3, 0] = np.nan
    brute = functools.partial(traverse.nearest_hit_brute, block=128)
    first = jax.jit(brute)(jflat, jnp.asarray(o), jnp.asarray(d))
    itri = np.where(np.arange(32) % 2 == 0, np.asarray(first.tri),
                    -1).astype(np.int32)
    ref = jax.jit(brute)(jflat, jnp.asarray(o), jnp.asarray(d),
                         ignore_tri=jnp.asarray(itri))
    ph = nearest_hit_fused(pflat, t(o), t(d), ignore_tri=t(itri),
                           tile_size=32)
    assert not bool(ph.hit[3])
    _assert_nearest(ph, ref, rtol=1e-5)


@pytest.mark.parametrize("layout,csize", [("row", 16), ("t", 32)])
def test_chunk_matches_interpret_kernel(layout, csize):
    """``chunk_k=2`` in the classic walk (``_fused_kernel``'s ``k_chunk``)
    and in the subcluster walk (``_tlane_kernel``'s ``kc``), nearest and
    any-hit, against the reference with the same chunk."""
    jflat = jax_bake(sphere_and_plane("jax"), csize)
    pflat = to_port(jflat)
    o, d = random_rays(22, 96)
    tmax = np.full((96,), 18.0, np.float32)
    for any_hit in (False, True):
        kw = dict(tile_size=32, layout=layout, chunk_k=2, any_hit=any_hit)
        ref = jax_fused(jflat, jnp.asarray(o), jnp.asarray(d),
                        t_max=jnp.asarray(tmax) if any_hit else None,
                        interpret=True, **kw)
        ph = nearest_hit_fused(pflat, t(o), t(d),
                               t_max=t(tmax) if any_hit else None, **kw)
        if any_hit:
            np.testing.assert_array_equal(ph.hit.numpy(), np.asarray(ref.hit))
        else:
            _assert_nearest(ph, ref)


def _coherent_rays(n_random=256):
    """A camera's rays over a terrain in 8x8 blocks (coherent tiles, where
    the gate and the chunks have work to do) and random rays."""
    o, d = camera_rays(Camera(position=(0.0, 28.0, 34.0)), 48, 48,
                       device="cpu")
    perm = block_order_perm(48, 48, 8, "cpu")
    ro, rd = random_rays(23, n_random)
    return torch.cat([o[perm], t(ro)]), torch.cat([d[perm], t(rd)])


def test_gate_and_chunks_change_only_the_counters():
    """On a terrain seen by a camera: the gate gives every output of the
    plain subcluster walk bit for bit with fewer ray tests; more picks per
    trip give the same hits at the same t with fewer trips, in both walks
    (exact-t ties between blocks of one trip may go to the earlier pick)."""
    flat = terrain("torch", divisions=32).flatten(device="cpu",
                                                  cluster_size=32)
    o, d = _coherent_rays()
    tmax = t(np.random.default_rng(4).uniform(5.0, 60.0, o.shape[0])
             .astype(np.float32))
    for any_hit in (False, True):
        q = fused.pack_query(o, d, t_max=tmax if any_hit else None,
                             tile_size=64)
        base = fused.subwalk_plain(flat.clusters, flat.tri_shade, q,
                                   cull=True, any_hit=any_hit)
        gated = fused.subwalk_plain(flat.clusters, flat.tri_shade, q,
                                    cull=True, any_hit=any_hit, gate=True)
        for f in ("t", "code", "u", "v", "tri", "rows", "resolved", "iters"):
            a, b = getattr(gated, f), getattr(base, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                                   else a, b.view(torch.int32)
                                   if b.is_floating_point() else b), f
        assert int(gated.ray_tests.sum()) < int(base.ray_tests.sum())
        assert bool((gated.tests <= base.tests).all())
        for walk in (fused.subwalk_plain, fused.walk_plain):
            one = walk(flat.clusters, flat.tri_shade, q, cull=True,
                       any_hit=any_hit)
            four = walk(flat.clusters, flat.tri_shade, q, cull=True,
                        any_hit=any_hit, chunk_k=4)
            hit = one.code >= 0
            assert torch.equal(hit, four.code >= 0)
            assert torch.equal(one.t[hit], four.t[hit])
            assert int(four.iters.sum()) < int(one.iters.sum())


def test_routing_and_its_errors(monkeypatch):
    """nearest_hit_fused's routing (raytpu/kernels/fused.py:1681-1714): on
    a subcluster bake the subcluster walk, any-hit included, unless the
    query asks for the pretest, the re-cull, the prepick walk or ``mxu``;
    on other bakes the classic walk unless ``layout="t"``.  ``layout="t"``
    with those settings and an unknown layout raise ``ValueError``, and so
    does ``mxu=True`` on a bake without ``gblock``."""
    calls = []
    for name in ("walk_plain", "subwalk_plain", "prepick_plain"):
        walk = getattr(fused, name)
        monkeypatch.setattr(fused, name, functools.partial(
            lambda w, n, *a, **k: (calls.append(n), w(*a, **k))[1], walk,
            name))
    sub = sphere_and_plane("torch").flatten(device="cpu", cluster_size=32)
    whole = sphere_and_plane("torch").flatten(device="cpu", cluster_size=16)
    sub_g = sphere_and_plane("torch").flatten(device="cpu", cluster_size=32,
                                              build_gblock=True)
    o, d = (t(a) for a in random_rays(24, 64))
    expect = [
        (sub, {}, "subwalk_plain"), (sub, {"any_hit": True}, "subwalk_plain"),
        (sub, {"pretest": True}, "walk_plain"),
        (sub, {"recull_every": 2}, "walk_plain"),
        (sub, {"prepick": 64}, "prepick_plain"),
        (sub, {"layout": "row"}, "walk_plain"),
        (sub_g, {"mxu": True}, "walk_plain"),
        (whole, {}, "walk_plain"), (whole, {"layout": "t"}, "subwalk_plain"),
        (whole, {"layout": "t", "gate": True}, "subwalk_plain")]
    base = nearest_hit_fused(sub, o, d)
    for scene, kw, walk in expect:
        calls.clear()
        h = nearest_hit_fused(scene, o, d, **kw)
        assert calls == [walk], (kw, calls)
        if scene is not whole and not kw.get("any_hit"):
            assert torch.equal(h.hit, base.hit)
    for kw in ({"layout": "t", "pretest": True},
               {"layout": "t", "recull_every": 6},
               {"layout": "t", "prepick": 8}, {"layout": "tlane"},
               {"prepick": 8, "chunk_k": 2}):
        with pytest.raises(ValueError):
            nearest_hit_fused(sub, o, d, **kw)
    with pytest.raises(ValueError, match="gblock"):
        nearest_hit_fused(sub, o, d, mxu=True)


def test_bridge_carries_a_jax_subcluster_bake():
    """The bridged JAX bake of the flagship scene at 32 equals the port's
    own bake field by field, and both walk to the same hits."""
    jflat = jax_bake(flagship("jax"), 32)
    bridged = to_port(jflat)
    own = flagship("torch").flatten(device="cpu", cluster_size=32)
    assert sorted(bridged.clusters) == sorted(own.clusters)
    for k, a in own.clusters.items():
        assert torch.equal(_bits_t(bridged.clusters[k]), _bits_t(a)), k
    o, d = (t(a) for a in random_rays(25, 64))
    a, b = nearest_hit_fused(bridged, o, d), nearest_hit_fused(own, o, d)
    assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t)


def _bits_t(x):
    return x.contiguous().view(torch.int32) if x.is_floating_point() else x


def test_rebuild_accel_keeps_the_leaf_size():
    """A re-bake of the flagship's cluster_size=32 bake keeps 32-triangle
    leaves, four to a block, as the reference's re-bake does
    (raytpu/diff/fit.py:180-188): the port's re-bake equals the JAX
    package's bit for bit, unpadded and with ``pad_clusters_to``, which
    counts leaves."""
    jflat = jax_bake(flagship("jax"), 32)
    flat = to_port(jflat)
    params = extract_params(flat, GEOMETRY)
    jparams = jax_extract_params(jflat, GEOMETRY)
    leaves = jflat.clusters["cluster_min"].shape[0]
    assert flat.clusters["block"].shape[0] * 4 == leaves
    for pad in (None, leaves + 5):
        ours = rebuild_accel(flat, params, pad_clusters_to=pad).clusters
        ref = jax_rebuild_accel(jflat, jparams, pad_clusters_to=pad).clusters
        assert leaf_size(ours) == 32 and leaves_per_block(ours) == 4
        ncg = ours["block"].shape[0]
        np.testing.assert_array_equal(_bits(ours["block"].numpy()),
                                      _bits(np.asarray(ref["block"])))
        for k, rows in (("sub_aabb", 6), ("sub_plane", 5)):
            np.testing.assert_array_equal(
                _bits(ours[k].numpy()),
                _bits(np.asarray(ref[k]).reshape(4, rows, -1)[:, :, :ncg]),
                err_msg=k)


def test_kernel_wrappers_refuse_what_they_cannot_launch():
    """subwalk_cuda refuses CPU tensors before any build or launch; the
    wrapper's checks refuse more picks per trip than the kernel takes and
    a key table and staged blocks that do not fit one block's shared
    memory."""
    flat = sphere_and_plane("torch").flatten(device="cpu", cluster_size=32)
    o, d = (t(a) for a in random_rays(26, 16))
    q = fused.pack_query(o, d)
    before = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fused.subwalk_cuda(flat.clusters, flat.tri_shade, q, cull=True,
                           any_hit=False)
    assert fused.LAUNCHES == before
    spec = fused._Walk(flat.clusters["sub_aabb"], flat.clusters["sub_plane"],
                       fused.MAX_CHUNK + 1)
    with pytest.raises(ValueError, match="picks per trip"):
        fused._validate(flat.clusters, flat.tri_shade, q, True, spec=spec,
                        group=True)
    ncg = 40000  # 4 * 40000 + 8 * 18 * 128 * 4 bytes > 227 KB
    big = {"block": torch.zeros((ncg, 24, 128)), "aabb": torch.zeros((6, ncg)),
           "sub_aabb": torch.zeros((4, 6, ncg)),
           "sub_plane": torch.zeros((4, 5, ncg)), "root": torch.zeros(8)}
    spec = fused._walk_spec(big, True, True, 8)
    with pytest.raises(ValueError, match="shared memory"):
        fused._validate(big, flat.tri_shade, q, True, spec=spec, group=True)
    # The bench bake at 32: three blocks of 256 threads fit an SM's 228 KB
    # (1 KB of each reserved).
    assert 3 * (fused._smem_bytes(7811, 128, chunk_k=1, subk=4)
                + 1024) <= 228 * 1024


def test_group_picks_follow_the_sorted_keys():
    """What the group kernel's pick and prologue rest on.  A subcluster
    walk never changes a key after the prologue, so a tile's picks
    (``_pick_group``, three a call) are its keys in (key, id) order, -0
    equal to +0, up to the first infeasible key: the kernel picks from
    each thread's least key without a scan.  Each block's cull box
    (``cull_boxes``) holds its sibling boxes, so a beam that cannot reach
    it reaches no sibling; a NaN sibling coordinate makes it the whole
    space."""
    # Two tiles of rays down onto two corners of the terrain: narrow beams
    # that reach some blocks and not others.
    rng = np.random.default_rng(27)
    o = rng.uniform(-3.0, 3.0, size=(2, 256, 3)).astype(np.float32)
    o[..., 1] = 6.0
    o[0, :, ::2] -= 12.0
    o[1, :, ::2] += 12.0
    d = rng.normal(scale=0.1, size=(2, 256, 3)).astype(np.float32)
    d[..., 1] = -1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = t(o), t(d)
    for csize in (64, 32):
        cl = terrain("torch", divisions=48).flatten(
            device="cpu", cluster_size=csize).clusters
        subk = leaves_per_block(cl)
        assert subk == 128 // csize
        tl = fused._prologue(cl["root"], o, d,
                             torch.full((2, 256), fused.INF))
        esub = [fused._entry_bounds(cl["sub_aabb"][h], cl["sub_plane"][h],
                                    tl.finite, tl.o3, tl.d3, tl.wcap)
                for h in range(subk)]
        keys = functools.reduce(torch.minimum, esub)
        ent, tiles, picks = keys.clone(), torch.arange(2), []
        while not picks or bool((picks[-1][0] < fused.INF).any()):
            picks.append(fused._pick_group(ent, tiles, 3))
        pv = torch.cat([v for v, _ in picks], 1)
        pk = torch.cat([k for _, k in picks], 1)
        for tile in range(2):
            vals, ids = torch.sort(keys[tile], stable=True)
            n = int((vals < fused.INF).sum())
            assert 0 < n < keys.shape[1]
            torch.testing.assert_close(pk[tile, :n], ids[:n], rtol=0, atol=0)
            assert torch.equal(pv[tile, :n], vals[:n])
            assert bool((pv[tile, n:] == fused.INF).all())

        cull = fused.cull_boxes(cl["sub_aabb"])
        sub = cl["sub_aabb"]
        assert bool((cull[:3] <= sub[:, :3]).all())
        assert bool((cull[3:] >= sub[:, 3:]).all())
        reach = fused._entry_bounds(cull, None, tl.finite, tl.o3, tl.d3,
                                    tl.wcap) < fused.INF
        assert bool((reach | (keys == fused.INF)).all())
        assert bool((~reach).any())
        bad = sub.clone()
        bad[subk - 1, 4, 0] = float("nan")
        whole = fused.cull_boxes(bad)[:, 0]
        inf = float("inf")
        assert whole.tolist() == [-inf] * 3 + [inf] * 3
        assert torch.equal(fused.cull_boxes(bad)[:, 1:], cull[:, 1:])
