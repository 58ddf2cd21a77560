"""The port's cluster walk (raytpu_torch/kernels/fused.py) against the JAX
package's fused Pallas kernel, run in interpret mode, and its brute-force
query.

On the CPU ``nearest_hit_fused`` runs the plain PyTorch walk, the version
the CUDA kernels are held to bit for bit on the card (chip_smoke.py).
Tolerances: hit and any-hit booleans exact; triangle ids exact where no
other triangle ties on t; t/u/v to rtol=1e-6, because the reference's
interpret-mode kernel lets XLA contract a*b+c into FMAs and the port's
walk does not; shade rows bit-exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.accel import traverse
from raytpu.kernels import fused as jfused
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.kernels import fused
from raytpu_torch.kernels.fused import nearest_hit_fused
from raytpu_torch.render.wavefront import block_order_perm
from tests.torch_scenes import jax_bake, random_rays, sphere_and_plane, t
from tests.torch_scenes import terrain, to_port

torch.set_num_threads(1)


# The reference queries run jitted, one program per call signature: eager
# jnp ops compile one program per op and shape, and an XLA CPU process
# crashes after ~150 compiles (run_tests.py).
def jax_fused(flat, o, d, **kw):
    return jax.jit(functools.partial(jfused.nearest_hit_fused, **kw))(
        flat, o, d)


def nearest_hit_brute(flat, o, d, **kw):
    return jax.jit(functools.partial(traverse.nearest_hit_brute, **kw))(
        flat, o, d)


def _unique_t(tvals, hit):
    """Hit lanes whose t no other hit lane of the same batch shares."""
    tv = np.where(hit, tvals, np.nan)
    _, inv, counts = np.unique(tv, return_inverse=True, return_counts=True)
    return hit & (counts[inv] == 1)


def _assert_nearest(ph, ref, rtol=1e-6):
    """Port Hit ``ph`` against a JAX Hit ``ref``."""
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(ph.hit.numpy(), hit)
    np.testing.assert_allclose(ph.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=rtol)
    assert np.all(ph.t.numpy()[~hit] == np.float32(3.4028235e38))
    solo = _unique_t(ph.t.numpy(), hit)
    np.testing.assert_array_equal(ph.tri.numpy()[solo],
                                  np.asarray(ref.tri)[solo])
    assert np.all(ph.tri.numpy()[~hit] == -1)


class TestFusedKernel:
    """tests/test_accel.py::TestFusedKernel's cases (csize 16)."""

    @pytest.fixture(scope="class")
    def scenes(self):
        jflat = jax_bake(sphere_and_plane("jax"), 16)
        return jflat, to_port(jflat)

    @pytest.mark.parametrize("cull", [True, False])
    def test_match_interpret_kernel_and_brute(self, scenes, cull):
        jflat, pflat = scenes
        o, d = random_rays(0, 128)
        ref = jax_fused(jflat, jnp.asarray(o), jnp.asarray(d), cull=cull,
                        tile_size=32, interpret=True)
        brute = nearest_hit_brute(jflat, jnp.asarray(o), jnp.asarray(d),
                                  cull=cull, block=128)
        ph = nearest_hit_fused(pflat, t(o), t(d), cull=cull, tile_size=32)
        _assert_nearest(ph, ref)
        _assert_nearest(ph, brute, rtol=1e-5)
        hit = ph.hit.numpy()
        np.testing.assert_allclose(ph.u.numpy()[hit], np.asarray(ref.u)[hit],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ph.v.numpy()[hit], np.asarray(ref.v)[hit],
                                   rtol=1e-6, atol=1e-6)

    def test_any_hit_occlusion_with_tmax(self, scenes):
        jflat, pflat = scenes
        o, d = random_rays(1, 64)
        tmax = np.full((64,), 18.0, np.float32)
        ref = jax_fused(jflat, jnp.asarray(o), jnp.asarray(d), tile_size=32,
                        t_max=jnp.asarray(tmax), any_hit=True,
                        interpret=True)
        ph = nearest_hit_fused(pflat, t(o), t(d), tile_size=32, t_max=t(tmax),
                               any_hit=True)
        np.testing.assert_array_equal(ph.hit.numpy(), np.asarray(ref.hit))
        assert ph.hit.any() and not ph.hit.all()
        np.testing.assert_array_equal(ph.t.numpy(), np.asarray(ref.t))
        np.testing.assert_array_equal(ph.tri.numpy(), np.asarray(ref.tri))

    def test_ignore_tri_and_nonfinite_rays(self, scenes):
        jflat, pflat = scenes
        o, d = random_rays(2, 32)
        o[3, 0] = np.nan
        first = nearest_hit_brute(jflat, jnp.asarray(o), jnp.asarray(d),
                                  block=128)
        itri = np.where(np.arange(32) % 2 == 0, np.asarray(first.tri),
                        -1).astype(np.int32)
        ref = nearest_hit_brute(jflat, jnp.asarray(o), jnp.asarray(d),
                                ignore_tri=jnp.asarray(itri), block=128)
        ph = nearest_hit_fused(pflat, t(o), t(d), ignore_tri=t(itri),
                               tile_size=32)
        assert not bool(ph.hit[3])
        _assert_nearest(ph, ref, rtol=1e-5)

    def test_ignore_mesh(self, scenes):
        jflat, pflat = scenes
        o, d = random_rays(3, 64)
        imesh = np.zeros(64, np.int32)  # mesh 0 is the sphere
        ref = nearest_hit_brute(jflat, jnp.asarray(o), jnp.asarray(d),
                                ignore_mesh=jnp.asarray(imesh), block=128)
        ph = nearest_hit_fused(pflat, t(o), t(d), ignore_mesh=t(imesh),
                               tile_size=32)
        _assert_nearest(ph, ref, rtol=1e-5)


def test_reverse_cull_segment_occlusion_matches_forward():
    """tests/test_accel.py::TestReverseCull: cast from the far end with
    cull="reverse", the any-hit query accepts exactly what the forward
    backface-culled segment test accepts."""
    jflat = jax_bake(sphere_and_plane("jax"), 16)
    pflat = to_port(jflat)
    rng = np.random.default_rng(21)
    n = 96
    a = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    a[:, 1] = np.abs(a[:, 1])
    b = np.tile(np.array([[0.0, 5.0, 20.0]], np.float32), (n, 1))
    seg = b - a
    dist = np.linalg.norm(seg, axis=1)
    fwd = (seg / dist[:, None]).astype(np.float32)
    h_fwd = nearest_hit_brute(jflat, jnp.asarray(a), jnp.asarray(fwd),
                              block=128, t_max=jnp.asarray(dist), cull=True)
    occ_fwd = np.asarray(h_fwd.hit) & (np.asarray(h_fwd.t) < dist)
    ph = nearest_hit_fused(pflat, t(b), t(-fwd), cull="reverse",
                           tile_size=32, t_max=t(dist), any_hit=True)
    np.testing.assert_array_equal(ph.hit.numpy(), occ_fwd)
    assert occ_fwd.any() and not occ_fwd.all()
    ref = jax_fused(jflat, jnp.asarray(b), jnp.asarray(-fwd), cull="reverse",
                    tile_size=32, t_max=jnp.asarray(dist), any_hit=True,
                    interpret=True)
    np.testing.assert_array_equal(ph.hit.numpy(), np.asarray(ref.hit))


class TestRows:
    """tests/test_accel.py::TestKernelRowResolve: the winners' shade rows
    are ``tri_shade[tri]`` bit for bit on channels 0-30, the mesh id as a
    value on channel 31, zeros on misses."""

    @pytest.fixture(scope="class")
    def scenes(self):
        jflat = jax_bake(sphere_and_plane("jax", textured=True), 128)
        return jflat, to_port(jflat)

    def test_rows_match_interpret_kernel(self, scenes):
        jflat, pflat = scenes
        o, d = random_rays(4, 256)
        ref, ref_rows = jax_fused(jflat, jnp.asarray(o), jnp.asarray(d),
                                  tile_size=64, layout="t", return_rows=True,
                                  interpret=True)
        ph, rows = nearest_hit_fused(pflat, t(o), t(d), tile_size=64,
                                     return_rows=True)
        _assert_nearest(ph, ref)
        hit = ph.hit.numpy()
        got = rows.numpy()
        shade = pflat.tri_shade.numpy()[np.maximum(ph.tri.numpy(), 0)]
        np.testing.assert_array_equal(got[hit][:, :31].view(np.int32),
                                      shade[hit][:, :31].view(np.int32))
        np.testing.assert_array_equal(got[hit][:, 31].astype(np.int32),
                                      shade[hit][:, 31].view(np.int32))
        assert np.all(got[~hit] == 0.0)
        solo = _unique_t(ph.t.numpy(), hit)
        np.testing.assert_array_equal(got[solo], np.asarray(ref_rows)[solo])

    def test_rows_keep_denormals(self, scenes):
        _, pflat = scenes
        o, d = random_rays(5, 64)
        denormal = np.float32(1e-40)
        scene = pflat.to("cpu")
        scene.tri_shade = scene.tri_shade.clone()
        scene.tri_shade[:, 30] = float(denormal)  # color alpha
        scene.tri_shade[:, 5] = -float(denormal)
        ph, rows = nearest_hit_fused(scene, t(o), t(d), return_rows=True)
        hit = ph.hit.numpy()
        assert hit.any()
        got = rows.numpy()[hit]
        assert np.all(got[:, 30].view(np.int32) == denormal.view(np.int32))
        assert np.all(got[:, 5].view(np.int32)
                      == (-denormal).view(np.int32))

    def test_any_hit_returns_no_rows(self, scenes):
        _, pflat = scenes
        o, d = random_rays(6, 16)
        h, rows = nearest_hit_fused(pflat, t(o), t(d), any_hit=True,
                                    return_rows=True)
        assert rows is None
        assert h.tri.dtype == torch.int32


def test_edge_grazing_shadow_ray_follows_brute_force():
    """A directional shadow ray that leaves the sphere exactly on a meridian
    edge at t = 0.  In IEEE float32 without FMA the neighbouring triangle's
    u*det is +1.2e-7 and the ray is clear, as the reference's brute-force
    query also finds; XLA's FMA contraction in the reference's
    interpret-mode kernel makes it -3.5e-8 there and reports a hit.  The
    port follows the unfused arithmetic that the CUDA kernel reproduces."""
    jflat = jax_bake(sphere_and_plane("jax", light="both"), 16)
    pflat = to_port(jflat)
    o = np.array([[-2.6469779601696886e-23, 2.781024932861328,
                   3.757530689239502]], np.float32)
    d = np.array([[-0.30000001192092896, 0.8999999761581421,
                   -0.10000000149011612]], np.float32)
    itri = np.array([90], np.int32)
    brute = nearest_hit_brute(jflat, jnp.asarray(o), jnp.asarray(d),
                              ignore_tri=jnp.asarray(itri), block=128)
    ph = nearest_hit_fused(pflat, t(o), t(d), ignore_tri=t(itri),
                           any_hit=True)
    assert not bool(np.asarray(brute.hit)[0])
    assert not bool(ph.hit[0])


def test_walk_cuda_refuses_cpu_tensors():
    """The kernel wrapper never takes the plain walk: CPU tensors raise
    before any build or launch."""
    jflat = jax_bake(sphere_and_plane("jax"), 16)
    pflat = to_port(jflat)
    o, d = random_rays(7, 8)
    q = fused.pack_query(t(o), t(d))
    before = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fused.walk_cuda(pflat.clusters, pflat.tri_shade, q, cull=True,
                        any_hit=False)
    assert fused.LAUNCHES == before


def test_kernel_wrapper_validates_inputs():
    """What the wrapper refuses before a launch: a non-contiguous table, and
    a scene whose entry table cannot fit one block's shared memory."""
    pflat = to_port(jax_bake(sphere_and_plane("jax"), 16))
    o, d = random_rays(9, 8)
    q = fused.pack_query(t(o), t(d))
    cl = dict(pflat.clusters, aabb=pflat.clusters["aabb"].t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        fused._validate(cl, pflat.tri_shade, q, True)
    ncg = 60000  # 4 * (60000 + 18) bytes > 227 KB
    big = {"block": torch.zeros((ncg, 24, 1)), "aabb": torch.zeros((6, ncg)),
           "plane": torch.zeros((5, ncg)), "root": torch.zeros(8)}
    with pytest.raises(ValueError, match="shared memory"):
        fused._validate(big, pflat.tri_shade, q, True)
    fused._validate(pflat.clusters, pflat.tri_shade, q, "reverse")
    with pytest.raises(ValueError, match="cull"):
        fused._validate(pflat.clusters, pflat.tri_shade, q, "forward")


def test_pack_query_pads_whole_tiles():
    o, d = random_rays(8, 70)
    q = fused.pack_query(t(o), t(d), tile_size=32)
    assert q.tile == 32 and q.origin.shape == (96, 3)
    assert torch.isnan(q.origin[70:]).all() and torch.isnan(q.direction[70:]).all()
    assert (q.t_max[70:] == 0).all() and (q.ignore_tri == -1).all()
    small = fused.pack_query(t(o[:5]), t(d[:5]), tile_size=32)
    assert small.tile == 5 and small.origin.shape == (5, 3)


def test_group_boxes_hold_their_clusters():
    """The classic walk kernel's group pre-cull (csrc/walk.cu): each box of
    32 consecutive clusters is the least min and greatest max of theirs,
    a NaN box left out and infinite bounds kept.  The block's shared
    memory grows by an epoch byte per entry with the re-cull, and three
    blocks of the bench bake (7,811 clusters of 128) still fit an SM's
    228 KB with their static shared memory and reserved KB (~3 KB)."""
    rng = np.random.default_rng(3)
    aabb = rng.normal(size=(6, 70)).astype(np.float32)
    aabb[:, 5] = np.nan
    aabb[3, 40], aabb[0, 41] = np.inf, -np.inf
    got = fused.group_boxes(t(aabb)).numpy()
    assert got.shape == (6, 3)
    for g in range(3):
        cols = aabb[:, 32 * g:32 * g + 32]
        np.testing.assert_array_equal(got[:3, g], np.nanmin(cols[:3], 1))
        np.testing.assert_array_equal(got[3:, g], np.nanmax(cols[3:], 1))
    assert got[3, 1] == np.inf and got[0, 1] == -np.inf
    need = fused._smem_bytes(7811, 128, recull=True)
    assert need == fused._smem_bytes(7811, 128) + 7811
    assert 3 * (need + 3 * 1024) <= 228 * 1024


class TestWalkOptIns:
    """The walk's slab pretest and re-cull (``pretest``, ``recull_every``),
    against tests/test_accel.py::TestFusedKernelFlags' reference: the
    interpret-mode ``_fused_kernel`` with the same flags, csize 16, 96 rays,
    tiles of 32.  Same tolerances as above."""

    @pytest.fixture(scope="class")
    def scenes(self):
        jflat = jax_bake(sphere_and_plane("jax"), 16)
        return jflat, to_port(jflat)

    @pytest.mark.parametrize("any_hit,pretest,recull", [
        (False, True, 6), (False, False, 2), (True, True, 2)])
    def test_match_interpret_kernel(self, scenes, any_hit, pretest, recull):
        jflat, pflat = scenes
        o, d = random_rays(11, 96)
        o[5, 1] = np.nan
        tmax = np.full((96,), 18.0, np.float32) if any_hit else None
        kw = dict(tile_size=32, any_hit=any_hit, pretest=pretest,
                  recull_every=recull)
        ref = jax_fused(jflat, jnp.asarray(o), jnp.asarray(d), interpret=True,
                        t_max=None if tmax is None else jnp.asarray(tmax),
                        **kw)
        ph, iters = nearest_hit_fused(pflat, t(o), t(d), return_iters=True,
                                      t_max=None if tmax is None else t(tmax),
                                      **kw)
        assert iters.dtype == torch.int32 and iters.shape == (3,)
        assert bool((iters > 0).all())
        if any_hit:
            np.testing.assert_array_equal(ph.hit.numpy(), np.asarray(ref.hit))
            assert ph.hit.any() and not ph.hit.all()
            np.testing.assert_array_equal(ph.t.numpy(), np.asarray(ref.t))
            return
        _assert_nearest(ph, ref)
        hit = ph.hit.numpy()
        for f in ("u", "v"):
            np.testing.assert_allclose(getattr(ph, f).numpy()[hit],
                                       np.asarray(getattr(ref, f))[hit],
                                       rtol=1e-6, atol=1e-6)

    def test_same_hits_with_and_without(self):
        """The opt-ins change the walk's shape (fewer tested clusters, fewer
        trips) and nothing else: every output of the plain walk bit for
        bit, on a terrain seen by a camera (coherent tiles, where the
        re-cull and the pretest have work to do) and on random rays."""
        flat = terrain("torch", divisions=32).flatten(device="cpu",
                                                      cluster_size=16)
        o, d = camera_rays(Camera(position=(0.0, 28.0, 34.0)), 48, 48,
                           device="cpu")
        perm = block_order_perm(48, 48, 8, "cpu")
        ro, rd = random_rays(12, 256)
        o = torch.cat([o[perm], t(ro)])
        d = torch.cat([d[perm], t(rd)])
        tmax = t(np.random.default_rng(3).uniform(5.0, 60.0, o.shape[0])
                 .astype(np.float32))
        shapes = []
        for any_hit in (False, True):
            q = fused.pack_query(o, d, t_max=tmax if any_hit else None,
                                 tile_size=64)
            walk = functools.partial(fused.walk_plain, flat.clusters,
                                     flat.tri_shade, q, cull=True,
                                     any_hit=any_hit)
            base = walk()
            for pretest, recull in ((True, 0), (False, 1), (False, 2),
                                    (True, 6)):
                out = walk(pretest=pretest, recull_every=recull)
                for f in ("t", "code", "u", "v", "tri", "rows"):
                    a, b = getattr(out, f), getattr(base, f)
                    assert (a is None) == (b is None), f
                    if a is not None:
                        assert torch.equal(a.view(torch.int32)
                                           if a.dtype == torch.float32
                                           else a,
                                           b.view(torch.int32)
                                           if b.dtype == torch.float32
                                           else b), (f, pretest, recull)
                assert bool((out.tests <= out.iters).all())
                # Every tested cluster has an unresolved ray of its tile.
                assert bool((out.tests <= out.ray_tests).all())
                assert bool((out.ray_tests <= out.tests * 64).all())
                shapes.append((int(out.iters.sum()), int(out.tests.sum()),
                               int(base.iters.sum())))
        # The pretest skips clusters and the re-cull cuts trips somewhere.
        assert any(tests < trips for trips, tests, _ in shapes)
        assert any(trips < base for trips, _, base in shapes)

    def test_recull_entries_never_drop(self):
        """A sub-beam's entry bounds are never below the beam's, in float
        arithmetic: a re-culled entry is never below the pick consumed
        before it, so picks stay in non-decreasing order."""
        flat = sphere_and_plane("torch").flatten(device="cpu",
                                                 cluster_size=16)
        cl = flat.clusters
        rng = np.random.default_rng(13)
        o, d = (t(a).reshape(16, 32, 3) for a in random_rays(13, 512))
        o3, d3 = o.unbind(-1), d.unbind(-1)
        full = torch.ones((16, 32), dtype=torch.bool)
        wcap = torch.full((16,), 1e4)
        ent = fused._entry_bounds(cl["aabb"], cl["plane"], full, o3, d3, wcap)
        assert bool((ent < fused.INF).any())
        for _ in range(8):
            sub = t(rng.random((16, 32)) < rng.uniform(0.05, 0.9))
            cap = t(rng.uniform(1.0, 1e4, 16).astype(np.float32))
            fresh = fused._entry_bounds(cl["aabb"], cl["plane"], sub, o3, d3,
                                        cap)
            assert bool((fresh >= ent).all())


def test_dead_ray_nan_bound_does_not_poison_its_tile():
    """A ray with a NaN t bound and a NaN direction (a dead lane of the
    instanced renderer's shadow queries) is resolved from the start; the
    other rays of its tile get the brute-force answer.  (The reference's
    fused kernel takes the tile's bound as a NaN-propagating max, so such a
    tile finds nothing there: ROADMAP.md queue 3.)"""
    jflat = jax_bake(sphere_and_plane("jax"), 16)
    pflat = to_port(jflat)
    o, d = random_rays(14, 32)
    tmax = np.full((32,), 30.0, np.float32)
    d[3] = np.nan
    tmax[3] = np.nan
    brute = nearest_hit_brute(jflat, jnp.asarray(o), jnp.asarray(d),
                              t_max=jnp.asarray(tmax), block=128)
    ph = nearest_hit_fused(pflat, t(o), t(d), t_max=t(tmax), tile_size=32,
                           pretest=True, recull_every=6)
    assert bool(np.asarray(brute.hit).sum() > 4) and not bool(ph.hit[3])
    _assert_nearest(ph, brute, rtol=1e-5)


def _lazy_prepick(ent, nt, picks):
    """The prepick kernel's picks of one tile's entries ``ent`` (ncg,)
    (csrc/walk.cu ``prepick_kernel``): thread t owns the entries t, t + nt,
    ... and keeps its least (entry, id); a pick is the least of the
    threads' by entry with -0 made +0, then id, consumed by its owner, who
    rescans its own.  Pick s + 1 is taken just before trip s settles, and
    only up to pick ``picks`` (the tail bound, not consumed).  Returns the
    walked picks' ids and the entry each settles against (INF where the
    picks ran out)."""
    ent = ent.clone()
    n = ent.shape[0]

    def least(th):
        own = ent[th::nt]
        if own.numel() == 0:
            return (float("inf"), n)
        i = int(own.argmin())  # the first of equal entries: the lowest id
        return (float(own[i]), th + nt * i)

    owners = [least(th) for th in range(nt)]
    ids, settle = [], []
    while True:
        v, k = min(owners, key=lambda p: (p[0] + 0.0, p[1]))
        if ids:
            settle.append(v + 0.0 if v < fused.INF else fused.INF)
        if not v < fused.INF or len(ids) == picks:
            return ids, settle
        ids.append(k)
        ent[k] = fused.CONSUMED
        owners[k % nt] = least(k % nt)


@pytest.mark.parametrize("nt", [32, 256])
def test_lazy_prepick_picks_match_the_drain(nt):
    """The prepick kernel takes each pick just before the trip that
    settles against it, from per-thread least entries: a plain emulation of
    that order gives exactly the picks and the settle entries (the next
    pick's, the tail bound after the last) of the plain walk's up-front
    drain (``_prepick_order``), at 2, 3 and 64 picks and beyond the
    feasible clusters; with every block twice (tied entries), entries of
    -0 and +0, and a tile with no feasible cluster."""
    flat = terrain("torch", 16).flatten(cluster_size=16, device="cpu")
    cl = flat.clusters
    o, d = camera_rays(Camera(position=(0.0, 6.0, 9.0), aspect=1.0), 16, 16,
                       device="cpu")
    ts = 32
    tl = fused._prologue(cl["root"], o.reshape(-1, ts, 3),
                         d.reshape(-1, ts, 3),
                         torch.full((o.shape[0] // ts, ts), fused.INF))
    ent = fused._entry_bounds(cl["aabb"], None, tl.finite, tl.o3, tl.d3,
                              tl.wcap)[:3]
    ent = torch.cat([ent, ent], 1)  # every block twice
    feasible = int((ent < fused.INF).sum(1).max())
    assert 8 < feasible < ent.shape[1]
    ent[0, :4] = torch.tensor([0.0, -0.0, 0.0, -0.0])
    ent[1, 7] = -0.0
    ent[2] = fused.INF
    for picks in (2, 3, 64, feasible + 5):
        pv, pk, v_next = fused._prepick_order(ent, picks)
        for tile in range(ent.shape[0]):
            m = int((pv[tile] < fused.INF).sum())
            ids, settle = _lazy_prepick(ent[tile], nt, picks)
            assert ids == pk[tile, :m].tolist(), (picks, tile)
            assert settle == (v_next[tile, :m] + 0.0).tolist(), (picks, tile)
    assert _lazy_prepick(ent[2], nt, 64) == ([], [])


@pytest.mark.parametrize("csize", [16, 32])
def test_gsplit_is_the_tf32_split_of_gblock(csize):
    """The bake's ``gsplit`` (the tensor-core walk's staged table) is, bit
    for bit, the ids and ``tf32`` hi and lo parts of ``gblock``'s
    coefficients in the kernel's B-fragment slots, with every coefficient
    outside them zero; the plain matmul walk over a ``gblock`` rebuilt
    from it (hi + lo in those slots, its ids) returns exactly what it
    returns from the bake's ``gblock``, at both precisions."""
    flat = sphere_and_plane("torch").flatten(cluster_size=csize, device="cpu",
                                             build_gblock=True)
    cl = flat.clusters
    g, split = cl["gblock"], cl["gsplit"]
    c = g.shape[2] // 4
    rows, cols = fused._split_slots(c)
    hi = fused.tf32(g[:, :16])
    lo = fused.tf32(g[:, :16] - hi)
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    assert split.shape == (g.shape[0], 50 * c)
    assert torch.equal(bits(split[:, :2 * c]), bits(g[:, 16, :2 * c]))
    assert torch.equal(bits(split[:, 2 * c:26 * c]), bits(hi[:, rows, cols]))
    assert torch.equal(bits(split[:, 26 * c:]), bits(lo[:, rows, cols]))
    assert bool((lo != 0).any())
    read = torch.zeros((16, 4 * c), dtype=torch.bool)
    read[rows, cols] = True
    assert int(read.sum()) == 24 * c and not bool(g[:, :16][:, ~read].any())
    bad = g.clone()
    bad[0, 10, 0] = 1.0  # a coefficient the kernel never reads
    with pytest.raises(ValueError, match="outside"):
        fused.mxu_table(bad)
    coef = torch.zeros_like(g[:, :16])
    coef[:, rows, cols] = split[:, 2 * c:26 * c] + split[:, 26 * c:]
    # Equal values (hi + lo of a -0 coefficient is +0).
    assert torch.equal(fused.tf32(coef), hi)
    assert torch.equal(fused.tf32(coef - hi), lo)
    rebuilt = g.clone()
    rebuilt[:, :16] = coef
    rebuilt[:, 16, :2 * c] = split[:, :2 * c]
    o, d = random_rays(5, 96)
    q = fused.pack_query(t(o), t(d), tile_size=32)
    other = dict(cl, gblock=rebuilt)
    for precision in fused.MXU_PRECISIONS:
        for any_hit in (False, True):
            a = fused.walk_plain(cl, flat.tri_shade, q, cull=True,
                                 any_hit=any_hit, mxu=precision)
            b = fused.walk_plain(other, flat.tri_shade, q, cull=True,
                                 any_hit=any_hit, mxu=precision)
            for name in a._fields:
                x, y = getattr(a, name), getattr(b, name)
                assert (x is None and y is None) or torch.equal(x, y), name
            assert bool((a.code >= 0).any())
