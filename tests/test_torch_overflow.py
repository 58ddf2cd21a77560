"""The port's bounded walks and their overflow strategies (raytpu_torch/kernels/
fused.py): the prepick walk with its rescue pass, and the classic walk on a
trip budget with the phase-1 compaction, against the JAX package's
``nearest_hit_fused(..., prepick=F / phase1_trips=N)`` run in interpret
mode, and against the port's own unbounded walk.

On the CPU the strategies run the plain walks, the versions the CUDA kernels
are held to bit for bit on the card (chip_smoke.py).  Tolerances as in
test_torch_kernels.py's brute-force comparisons: hit booleans exact, t to
rtol 1e-5 (the reference's interpret-mode kernel contracts a*b+c into FMAs
and the port does not; on these random rays that moves t by up to 1.2e-6
relative), triangle ids exact where no other hit shares the t; against
the port's unbounded walk, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels import fused as jfused
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.kernels import fused
from raytpu_torch.kernels.fused import nearest_hit_fused
from raytpu_torch.render.wavefront import block_order_perm
from tests.test_torch_kernels import _assert_nearest
from tests.torch_scenes import jax_bake, sphere_and_plane, t, terrain
from tests.torch_scenes import to_port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    jflat = jax_bake(sphere_and_plane("jax"), 16)
    return jflat, to_port(jflat)


def _rays(n, seed):
    """tests/test_accel.py::TestPrepickKernel's rays."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 8, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _jax_fused(flat, o, d, **kw):
    # One jitted program per call signature (run_tests.py: an XLA CPU
    # process crashes after ~150 compiles).
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    arrays = {k: v for k, v in kw.items() if isinstance(v, jax.Array)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    fn = functools.partial(jfused.nearest_hit_fused, tile_size=32,
                           interpret=True, **static)
    return jax.jit(lambda f, o, d, a: fn(f, o, d, **a))(
        flat, jnp.asarray(o), jnp.asarray(d), arrays)


# (strategy, budget, any_hit): each budget of each strategy once, the query
# kinds alternating; 2 and 3 overflow the scene's tiles, 64 does not.
CASES = [("prepick", 2, False), ("prepick", 3, True), ("prepick", 64, False),
         ("phase1_trips", 2, True), ("phase1_trips", 3, False),
         ("phase1_trips", 64, True)]


@pytest.mark.parametrize("strategy,budget,any_hit", CASES)
def test_strategies_match_interpret_kernel(scenes, strategy, budget, any_hit):
    jflat, pflat = scenes
    o, d = _rays(128, 7 + budget)
    tmax = np.full((128,), 18.0, np.float32) if any_hit else None
    kw = {strategy: budget, "any_hit": any_hit}
    ref = _jax_fused(jflat, o, d, t_max=tmax, **kw)
    ph, iters = nearest_hit_fused(pflat, t(o), t(d), tile_size=32,
                                  t_max=None if tmax is None else t(tmax),
                                  return_iters=True, **kw)
    assert bool((iters > 0).all())
    if any_hit:
        np.testing.assert_array_equal(ph.hit.numpy(), np.asarray(ref.hit))
        assert ph.hit.any() and not ph.hit.all()
        assert bool((ph.t[ph.hit] < 18.0).all())
        return
    _assert_nearest(ph, ref, rtol=1e-5)


@pytest.mark.parametrize("strategy", [{"prepick": 5}, {"phase1_trips": 2}])
def test_ignore_and_nonfinite_rays(scenes, strategy):
    """tests/test_accel.py:441: an ignored triangle id per ray, a NaN
    origin; the nearest query against the interpret-mode kernel."""
    jflat, pflat = scenes
    o, d = _rays(64, 3)
    o[5, 1] = np.nan
    first = nearest_hit_fused(pflat, t(o), t(d), tile_size=32)
    itri = np.where(np.arange(64) % 2 == 0, first.tri.numpy(),
                    -1).astype(np.int32)
    ref = _jax_fused(jflat, o, d, ignore_tri=itri, **strategy)
    ph = nearest_hit_fused(pflat, t(o), t(d), ignore_tri=t(itri),
                           tile_size=32, **strategy)
    assert not bool(ph.hit[5])
    _assert_nearest(ph, ref, rtol=1e-5)


@pytest.fixture(scope="module")
def terrain_query():
    """A terrain seen by a camera (coherent tiles, deep walks) plus random
    rays, NaN and dead lanes, t bounds and ignore ids."""
    flat = terrain("torch", divisions=32).flatten(device="cpu",
                                                  cluster_size=16)
    o, d = camera_rays(Camera(position=(0.0, 28.0, 34.0)), 48, 48,
                       device="cpu")
    perm = block_order_perm(48, 48, 8, "cpu")
    rng = np.random.default_rng(4)
    ro, rd = _rays(256, 5)
    o = torch.cat([o[perm], t(ro)])
    d = torch.cat([d[perm], t(rd)])
    d[100] = float("nan")
    o[200, 0] = float("inf")
    tmax = t(rng.uniform(5.0, 60.0, o.shape[0]).astype(np.float32))
    tmax[300] = float("nan")
    itri = t(rng.integers(-1, flat.num_tris, o.shape[0]).astype(np.int32))
    return flat, o, d, tmax, itri


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("any_hit", [False, True])
def test_strategies_give_the_unbounded_walks_hits(terrain_query, any_hit):
    """Every budget, overflowing or not, gives the unbounded classic walk's
    hits bit for bit (t, u, v and triangle ids), with and without the
    pretest and re-cull under phase 1."""
    flat, o, d, tmax, itri = terrain_query
    kw = dict(ignore_tri=itri, t_max=tmax if any_hit else None,
              any_hit=any_hit, tile_size=64)
    base = nearest_hit_fused(flat, o, d, **kw)
    for strategy in ({"prepick": 1}, {"prepick": 3}, {"prepick": 64},
                   {"phase1_trips": 1}, {"phase1_trips": 4},
                   {"phase1_trips": 2, "pretest": True, "recull_every": 2}):
        got = nearest_hit_fused(flat, o, d, **kw, **strategy)
        # The prepick walk visits clusters in slab-entry order: an exact-t
        # tie between clusters may go to the other triangle.
        tie = got.hit & (got.tri != base.tri)
        assert bool((got.t[tie] == base.t[tie]).all()), strategy
        for f in got._fields:
            a, b = getattr(got, f)[~tie], getattr(base, f)[~tie]
            assert torch.equal(_bits(a), _bits(b)), (f, strategy)


@pytest.mark.parametrize("any_hit", [False, True])
def test_bounded_walks_flags_and_counters(terrain_query, any_hit):
    """The resolved flag and the per-tile counters of the bounded walks: a
    budget that covers every tile leaves every ray resolved and equals the
    unbounded walk; a small one leaves unresolved rays holding a true
    candidate (never closer than the true hit); the prepick walk tests
    every cluster it walks and never walks more than its picks."""
    flat, o, d, tmax, itri = terrain_query
    q = fused.pack_query(o, d, ignore_tri=itri,
                         t_max=tmax if any_hit else None, tile_size=64)
    tables = (flat.clusters, flat.tri_shade)
    kind = dict(cull=True, any_hit=any_hit)
    full = fused.walk_plain(*tables, q, rows=False, **kind)
    assert bool((full.resolved == 1).all())
    deep = int(full.iters.max())
    for trips in (deep, deep + 5):
        out = fused.walk_plain(*tables, q, rows=False, max_trips=trips,
                               **kind)
        for f in out._fields:
            a, b = getattr(out, f), getattr(full, f)
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(_bits(a), _bits(b)), (f, trips)
    out = fused.walk_plain(*tables, q, rows=False, max_trips=2, **kind)
    assert bool((out.iters <= 2).all())
    unres = out.resolved == 0
    assert bool(unres.any())
    if not any_hit:
        # A candidate is a real hit or the ray's bound, never below the
        # true nearest hit.
        assert bool((out.t[unres] >= full.t[unres]).all())
    for picks in (2, 16, 10_000):
        out = fused.prepick_plain(*tables, q, picks=picks, **kind)
        assert torch.equal(out.iters, out.tests)
        assert bool((out.iters <= picks).all())
        assert bool((out.ray_tests <= out.tests * 64).all())
        if picks == 10_000:
            assert bool((out.resolved == 1).all())
        if picks == 2:
            assert bool((out.resolved == 0).any())


def test_compact_order_matches_reference():
    """``compact_order`` is ``_compact_order``: the stable partition with
    the unresolved rays first."""
    res = np.random.default_rng(8).random(300) < 0.6
    ref = jax.jit(jfused._compact_order)(jnp.asarray(res))
    np.testing.assert_array_equal(fused.compact_order(t(res)).numpy(),
                                  np.asarray(ref))


def test_incompatible_settings_raise(scenes):
    _, pflat = scenes
    o, d = _rays(32, 1)
    for bad in ({"prepick": 8, "pretest": True},
                {"prepick": 8, "recull_every": 2},
                {"prepick": 8, "phase1_trips": 2},
                {"prepick": -1}, {"phase1_trips": 1.5}, {"nbuf": 0}):
        with pytest.raises(ValueError):
            nearest_hit_fused(pflat, t(o), t(d), **bad)
    # cull_nbuf sets nothing on the card and never changes a result.
    a = nearest_hit_fused(pflat, t(o), t(d), prepick=8, nbuf=1)
    b = nearest_hit_fused(pflat, t(o), t(d), prepick=8, nbuf=7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_prepick_wrapper_validates_inputs(scenes):
    """The prepick kernel's wrapper refuses CPU tensors and bakes whose
    shared memory does not fit one block, before any build or launch.  The
    kernel takes each pick just before the trip that settles against it,
    so the picks take no shared memory: any number fits."""
    _, pflat = scenes
    o, d = _rays(8, 2)
    q = fused.pack_query(t(o), t(d))
    before = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fused.prepick_cuda(pflat.clusters, pflat.tri_shade, q, cull=True,
                           any_hit=False, picks=8)
    assert fused.LAUNCHES == before
    fused._validate(pflat.clusters, pflat.tri_shade, q, True, picks=8)
    fused._validate(pflat.clusters, pflat.tri_shade, q, True, picks=30_000)
    ncg = 60_000  # an entry table of 240 KB
    big = {"block": torch.zeros((ncg, 24, 4)), "aabb": torch.zeros((6, ncg)),
           "root": pflat.clusters["root"]}
    with pytest.raises(ValueError, match="shared memory"):
        fused._validate(big, pflat.tri_shade, fused.pack_query(t(o), t(d)),
                        True, picks=8)
    with pytest.raises(ValueError, match="picks"):
        fused._validate(pflat.clusters, pflat.tri_shade, q, True, picks=-2)
