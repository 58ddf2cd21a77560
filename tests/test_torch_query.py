"""The port's query layer against the JAX package's, on the CPU: the
brute-force sweep, the octree walk and the tiled query
(raytpu_torch/accel/), the ``AUTO`` dispatch, shadow clearance, the
bridged query tables, and the matmul pair test (``mxu``) of the cluster
walk through its plain version.

Inputs come from numpy seeds and go through both packages; every JAX call
runs jitted, once per backend and setting.  Tolerances:

- hits and triangles exact; t, u, v rtol 1e-6, with an absolute floor of
  1e-5 for u and v (barycentrics in [0, 1]): XLA contracts a*b+c into FMAs
  inside the reference and the port does not (ROADMAP.md, queue 3), and
  u = dot(p, o - v1) / det cancels on the terrain, whose coordinates reach
  20: the two packages' u differ there by up to 3.5e-6, with the float64
  value between them;
- colours atol 1e-5, as in test_torch_render.py;
- clearance tables rtol 1e-6 (the same FMA note; INF entries exact);
- ``mxu``: against the JAX package's interpret-mode kernel, whose matmul
  is exact float32 on the CPU.  ``"highest"`` (3xTF32) is held to the JAX
  test's own criterion (tests/test_accel.py:374-389): hits and triangles
  equal, t rtol 1e-5.  ``"default"`` is one TF32 pass (11 significant
  bits: 2^-11 = 4.9e-4 per product, more after cancellation in t*det):
  hits and triangles equal, t rtol 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.accel import shadowcull as jclear
from raytpu.accel.tiled import nearest_hit_tiled as jtiled
from raytpu.accel.traverse import nearest_hit as jnearest
from raytpu.accel.traverse import nearest_hit_brute as jbrute
from raytpu.accel.traverse import nearest_hit_octree as joctree
from raytpu.config import Intersector as JIntersector
from raytpu.config import Quantize as JQuantize
from raytpu.config import RenderConfig as JRenderConfig
from raytpu.core.camera import Camera as JCamera
from raytpu.core.camera import camera_rays as jax_camera_rays
from raytpu.diff.fit import rebuild_accel as jrebuild
from raytpu.diff.params import extract_params as jextract
from raytpu.kernels.fused import nearest_hit_fused as jfused
from raytpu.render.wavefront import render_rays as jax_render_rays
from raytpu_torch.accel import shadowcull as pclear
from raytpu_torch.accel.traverse import nearest_hit, resolve_intersector
from raytpu_torch.config import Intersector, RenderConfig
from raytpu_torch.diff.fit import rebuild_accel
from raytpu_torch.diff.params import GEOMETRY, extract_params
from raytpu_torch.kernels import fused
from raytpu_torch.kernels.fused import nearest_hit_fused
from raytpu_torch.render.wavefront import render_rays
from raytpu_torch.scene import types as ttypes
from raytpu.scene import types as jtypes
from tests.torch_scenes import (flagship, random_rays, sphere_and_plane, t,
                                terrain, to_port)

torch.set_num_threads(1)

CULLS = (True, False, "reverse")


def _jax_flat(build, csize, **kw):
    return build("jax").flatten(cluster_size=csize, **kw)


# The backend of each case, the scene it queries and renders (cluster
# size), and the camera: the sweep on the sphere over the plane, the octree
# walk on a 4,608-triangle terrain, the tiled query on the flagship twin
# (a subcluster bake: its leaf tables).
BACKENDS = {
    "brute": (lambda p: sphere_and_plane(p, textured=True, light="both"), 16,
              (3.0, 16.0, 32.0)),
    "octree": (lambda p: terrain(p, divisions=48), 128, (0.0, 28.0, 34.0)),
    "tiled": (flagship, 32, (0.0, 16.0, 32.0)),
}
JAX_BACKEND = {
    "brute": lambda s, o, d, **kw: jbrute(s, o, d, block=128, **kw),
    "octree": joctree,
    "tiled": lambda s, o, d, **kw: jtiled(s, o, d, tile_size=32, **kw),
}


def _query_args(o):
    """Per-ray ignore ids and t bounds shared by both packages: every other
    ray ignores triangle 7, every fifth mesh 0; bounds 25."""
    n = o.shape[0]
    i = np.arange(n)
    itri = np.where(i % 2 == 0, 7, -1).astype(np.int32)
    imesh = np.where(i % 5 == 0, 0, -1).astype(np.int32)
    return itri, imesh, np.full(n, 25.0, np.float32)


def _assert_hits(p, j, what):
    hit = np.asarray(j.hit)
    np.testing.assert_array_equal(p.hit.numpy(), hit, err_msg=what)
    assert hit.any() and not hit.all(), what
    np.testing.assert_array_equal(p.tri.numpy()[hit], np.asarray(j.tri)[hit],
                                  err_msg=what)
    np.testing.assert_allclose(p.t.numpy()[hit], np.asarray(j.t)[hit],
                               rtol=1e-6, err_msg=what)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(p, f).numpy()[hit],
                                   np.asarray(getattr(j, f))[hit], rtol=1e-6,
                                   atol=1e-5, err_msg=f"{what} {f}")


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_backend_matches_jax(backend):
    """Nearest queries with cull True/False/"reverse" and ignore ids, an
    any-hit query with t bounds, and a render (two reflections), through
    the backend in both packages."""
    build, csize, position = BACKENDS[backend]
    jflat = _jax_flat(build, csize)
    pflat = to_port(jflat)
    o, d = random_rays(5, 96)
    o[3, 0] = np.nan  # a dead ray
    itri, imesh, tmax = _query_args(o)
    jfn = JAX_BACKEND[backend]

    def jax_queries(s, o, d, itri, imesh, tmax):
        out = [jfn(s, o, d, ignore_tri=itri, ignore_mesh=imesh, cull=c)
               for c in CULLS]
        kw = {"any_hit": True} if backend == "tiled" else {}
        out.append(jfn(s, o, d, cull=True, t_max=tmax, **kw))
        return out

    ref = jax.jit(jax_queries)(jflat, o, d, itri, imesh, tmax)
    mode = Intersector[backend.upper()]
    q = dict(intersector=mode, cull_tile=32, block=128)
    for c, j in zip(CULLS, ref):
        p = nearest_hit(pflat, t(o), t(d), ignore_tri=t(itri),
                        ignore_mesh=t(imesh), cull=c, **q)
        _assert_hits(p, j, f"{backend} cull={c}")
    p = nearest_hit(pflat, t(o), t(d), cull=True, t_max=t(tmax),
                    any_hit=True, **q)
    occluded = np.asarray(ref[-1].hit) & (np.asarray(ref[-1].t) < 25.0)
    np.testing.assert_array_equal((p.hit & (p.t < 25.0)).numpy(), occluded)

    jcfg = JRenderConfig(width=16, height=16, max_reflections=2,
                         quantize=JQuantize.NONE, tile_pixels=256,
                         cull_tile=64, intersector=JIntersector[mode.name])
    ro, rd = jax.jit(lambda: jax_camera_rays(JCamera(position=position),
                                             16, 16))()
    img = np.asarray(jax.jit(lambda s, o, d: jax_render_rays(s, jcfg, o, d))(
        jflat, ro, rd))
    colors = render_rays(pflat, RenderConfig.from_json(jcfg.to_json()),
                         t(ro), t(rd))
    assert (img.max(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(colors.numpy(), img, rtol=0, atol=1e-5)


def test_auto_routes_as_the_jax_package():
    """``AUTO``: the sweep up to ``brute_force_max_tris`` triangles, then
    the walk when the scene has clusters, the octree walk when it has only
    an octree, the sweep last (raytpu/accel/traverse.py:275-291)."""
    small = sphere_and_plane("torch").flatten(device="cpu", cluster_size=16)
    big = terrain("torch", divisions=48).flatten(device="cpu")
    assert small.num_tris <= 4096 < big.num_tris
    auto = Intersector.AUTO
    assert resolve_intersector(small, auto) == Intersector.BRUTE
    assert resolve_intersector(small, "auto", 0) == Intersector.PALLAS
    assert resolve_intersector(big, auto) == Intersector.PALLAS
    assert resolve_intersector(big, "tiled") == Intersector.TILED
    no_clusters = dataclasses.replace(big, clusters=None)
    assert resolve_intersector(no_clusters, auto) == Intersector.OCTREE
    bare = dataclasses.replace(no_clusters, octree=None)
    assert resolve_intersector(bare, auto) == Intersector.BRUTE
    with pytest.raises(ValueError, match="build_octree"):
        nearest_hit(bare, *map(t, random_rays(1, 8)),
                    intersector=Intersector.OCTREE)


def _tie_scene(types):
    """Two coplanar triangles that both cover (3, 0, 3), with integer
    corners, so a ray straight down hits both at exactly t = 10: triangle 0
    and, with the lower centroid (first in the bake's Morton order),
    triangle 1."""
    verts = np.asarray([[[2, 0, 2], [10, 0, 2], [2, 0, 10]],
                        [[-6, 0, -6], [18, 0, -6], [-6, 0, 18]]], np.float32)
    return types.Scene(objects=[types.SceneObject(
        meshes=[types.Mesh(vertices=verts)])], lights=[])


def test_auto_settles_an_exact_tie_as_the_jax_package():
    """An exact-t tie between two triangles: the walk keeps the first in its
    visiting order (triangle 1), the sweep the lowest index (triangle 0).
    The JAX package's ``AUTO`` sweeps this scene; the port's ``AUTO`` used
    to walk it and now sweeps it too."""
    o = np.asarray([[3.0, 10.0, 3.0]], np.float32)
    d = np.asarray([[0.0, -1.0, 0.0]], np.float32)
    jflat = _tie_scene(jtypes).flatten(cluster_size=16)
    ref = jnearest(jflat, jnp.asarray(o), jnp.asarray(d), cull=False)
    assert int(ref.tri[0]) == 0 and float(ref.t[0]) == 10.0
    for pflat in (to_port(jflat),
                  _tie_scene(ttypes).flatten(device="cpu", cluster_size=16)):
        auto = nearest_hit(pflat, t(o), t(d), cull=False)
        walk = nearest_hit(pflat, t(o), t(d), cull=False,
                           intersector=Intersector.PALLAS)
        assert float(auto.t[0]) == float(walk.t[0]) == 10.0
        assert int(walk.tri[0]) == 1  # the port's AUTO before this change
        assert int(auto.tri[0]) == int(ref.tri[0]) == 0


def test_bridged_query_tables_are_the_port_bake():
    """The bridge carries the JAX bake's ``gblock``, ``tri_block``, the
    tiled query's leaf tables and its octree; the port's own bake gives
    them bit for bit (a 128-style bake and a subcluster bake), and a fit's
    re-bake keeps ``gblock`` (raytpu/diff/fit.py:189-195)."""
    for build, csize in ((sphere_and_plane, 16), (flagship, 32)):
        jflat = _jax_flat(build, csize, build_gblock=True)
        bridged = to_port(jflat)
        own = build("torch").flatten(device="cpu", cluster_size=csize,
                                     build_gblock=True)
        for k in ("gblock", "tri_block", "cluster_min", "cluster_max",
                  "tri_id", "tri_mesh", "tri_v1", "tri_e1", "tri_e2",
                  "tri_snormal"):
            a, b = own.clusters[k], bridged.clusters[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b), k
        assert set(own.octree) == set(bridged.octree) == set(jflat.octree)
        for k, a in own.octree.items():
            assert torch.equal(a, bridged.octree[k]), k
        plain = build("torch").flatten(device="cpu", cluster_size=csize,
                                       build_octree=False)
        assert plain.octree is None and "gblock" not in plain.clusters
        # A re-bake from moved geometry: the reference's gblock bit for bit.
        jp = {k: np.asarray(v) * np.float32(1.01) for k, v in
              jextract(jflat, GEOMETRY).items()}
        ref = jrebuild(jflat, {k: jnp.asarray(v) for k, v in jp.items()})
        got = rebuild_accel(bridged, {k: t(v) for k, v in jp.items()})
        np.testing.assert_array_equal(
            got.clusters["gblock"].numpy().view(np.int32),
            np.asarray(ref.clusters["gblock"]).view(np.int32))
        assert "gblock" not in rebuild_accel(
            plain, extract_params(plain, GEOMETRY)).clusters


def test_clearance_tables_match_jax():
    """Spot and directional clearance tables and own-block entry/exit, on a
    128-style bake and a subcluster bake."""
    lp, dl = (0.0, 30.0, 25.0), (-0.3, 0.9, -0.1)
    o, d = random_rays(9, 64)
    for build, csize in ((sphere_and_plane, 16), (flagship, 32)):
        jflat = _jax_flat(build, csize, build_octree=False)
        pcl = to_port(jflat).clusters
        hit_tri = np.arange(64, dtype=np.int32) * 3 - 5  # misses clamp
        ref = jax.jit(lambda cl, h, o, d: (
            jclear.clearance_spot(cl, lp, rows_per_chunk=8),
            jclear.clearance_directional(cl, dl, rows_per_chunk=8),
            jclear.own_block_entry_exit(cl, cl["tri_block"], h, o, d)))(
                jflat.clusters, hit_tri, o, d)
        got = (pclear.clearance_spot(pcl, lp, rows_per_chunk=8),
               pclear.clearance_directional(pcl, dl, rows_per_chunk=8),
               *pclear.own_block_entry_exit(pcl, pcl["tri_block"],
                                            t(hit_tri), t(o), t(d)))
        for i, (g, r) in enumerate(zip(got, (ref[0], ref[1], *ref[2]))):
            r = np.asarray(r)
            assert g.shape == r.shape
            if i == 0:  # a spot table that tells blocks apart
                assert len(np.unique(r)) > 1, csize
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-6)


@pytest.mark.parametrize("light", ["spot", "both"])
def test_shadow_clearance_render(light):
    """``shadow_clearance=True`` renders like the JAX package's render with
    it (whose tiled query is exact), and like the port's render without it,
    bit for bit: clearance only moves where an unoccluded shadow query
    starts or stops."""
    build = lambda p: sphere_and_plane(p, textured=True, light=light)  # noqa
    jflat = _jax_flat(build, 16, build_octree=False)
    pflat = to_port(jflat)
    jcfg = JRenderConfig(width=16, height=16, max_reflections=1,
                         quantize=JQuantize.NONE, tile_pixels=256,
                         cull_tile=64, intersector=JIntersector.TILED,
                         shadow_clearance=True)
    o, d = jax.jit(lambda: jax_camera_rays(
        JCamera(position=(3.0, 16.0, 32.0)), 16, 16))()
    ref = np.asarray(jax.jit(lambda s, o, d: jax_render_rays(s, jcfg, o, d))(
        jflat, o, d))
    cfg = dataclasses.replace(RenderConfig.from_json(jcfg.to_json()),
                              intersector=Intersector.PALLAS)
    on = render_rays(pflat, cfg, t(o), t(d))
    off = render_rays(pflat, dataclasses.replace(cfg, shadow_clearance=False),
                      t(o), t(d))
    assert (ref.max(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(on.numpy(), ref, rtol=0, atol=1e-5)
    assert torch.equal(on, off)


def _mxu_flat(build, csize):
    jflat = _jax_flat(build, csize, build_octree=False, build_gblock=True)
    return jflat, to_port(jflat)


MXU_RTOL = {"highest": 1e-5, "default": 5e-3}


def _assert_mxu(p, j, rtol, what):
    hit = np.asarray(j.hit)
    np.testing.assert_array_equal(p.hit.numpy(), hit, err_msg=what)
    assert hit.any() and not hit.all(), what
    np.testing.assert_array_equal(p.tri.numpy()[hit], np.asarray(j.tri)[hit],
                                  err_msg=what)
    np.testing.assert_allclose(p.t.numpy()[hit], np.asarray(j.t)[hit],
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize("chunk_k", [1, 2])
def test_mxu_matches_interpret_kernel(chunk_k):
    """The plain mxu walk at both precisions against the JAX package's
    kernel with ``mxu=True`` in interpret mode (tests/test_accel.py's
    TestFusedKernelFlags scene and rays)."""
    jflat, pflat = _mxu_flat(sphere_and_plane, 16)
    o, d = random_rays(11, 64)
    ref = jax.jit(lambda s, o, d: jfused(s, o, d, tile_size=32, mxu=True,
                                         chunk_k=chunk_k, interpret=True))(
        jflat, o, d)
    for precision, rtol in MXU_RTOL.items():
        p = nearest_hit_fused(pflat, t(o), t(d), tile_size=32, mxu=True,
                              mxu_precision=precision, chunk_k=chunk_k)
        _assert_mxu(p, ref, rtol, f"{precision} chunk_k={chunk_k}")


def test_mxu_walk_shapes_keep_the_hits():
    """``mxu`` with the pretest and re-cull, the phase-1 budget, two picks a
    trip, ignore ids and a dead ray finds the hits of the plain mxu walk;
    its any-hit query the exact walk's occlusion."""
    _, pflat = _mxu_flat(sphere_and_plane, 16)
    o, d = random_rays(11, 96)
    o[5, 1] = np.inf
    itri, imesh, tmax = _query_args(o)
    rays = dict(origin=t(o), direction=t(d), ignore_tri=t(itri),
                ignore_mesh=t(imesh), tile_size=32)
    base = nearest_hit_fused(pflat, mxu=True, **rays)
    for shape in (dict(pretest=True, recull_every=2), dict(phase1_trips=2),
                  dict(chunk_k=2, pretest=True),
                  dict(phase1_trips=1, recull_every=2, chunk_k=2)):
        got = nearest_hit_fused(pflat, mxu=True, **rays, **shape)
        assert torch.equal(got.hit, base.hit) and not bool(got.hit[5])
        assert torch.equal(got.tri[got.hit], base.tri[base.hit]), shape
        np.testing.assert_allclose(got.t.numpy(), base.t.numpy(), rtol=1e-6)
    exact = nearest_hit_fused(pflat, t_max=t(tmax), any_hit=True, **rays)
    for precision in MXU_RTOL:
        occ = nearest_hit_fused(pflat, t_max=t(tmax), any_hit=True, mxu=True,
                                mxu_precision=precision, pretest=True,
                                **rays)
        assert torch.equal(occ.hit, exact.hit), precision


def test_mxu_on_a_subcluster_bake_and_its_errors():
    """On a subcluster bake ``mxu`` is the block-granularity classic walk
    without planes, as in the JAX package; the JAX package's
    ``ValueError``s; what the tensor-core walk's wrapper refuses before a
    launch (a ``gblock`` of the wrong shape, a ``chunk_k`` whose staged
    blocks exceed the shared memory)."""
    jflat, pflat = _mxu_flat(flagship, 32)
    o, d = random_rays(4, 64)
    ref = jax.jit(lambda s, o, d: jfused(s, o, d, tile_size=32, mxu=True,
                                         interpret=True))(jflat, o, d)
    p = nearest_hit_fused(pflat, t(o), t(d), tile_size=32, mxu=True)
    _assert_mxu(p, ref, MXU_RTOL["highest"], "subcluster bake")
    plain = to_port(_jax_flat(flagship, 32, build_octree=False))
    o, d = t(o), t(d)
    with pytest.raises(ValueError, match="gblock"):
        nearest_hit_fused(plain, o, d, mxu=True)
    with pytest.raises(ValueError, match="layout='t'"):
        nearest_hit_fused(pflat, o, d, mxu=True, layout="t")
    with pytest.raises(ValueError, match="prepick"):
        nearest_hit_fused(pflat, o, d, mxu=True, prepick=8)
    with pytest.raises(ValueError, match="mxu_precision"):
        nearest_hit_fused(pflat, o, d, mxu=True, mxu_precision="high")
    assert nearest_hit_fused(pflat, o, d, mxu=None).hit.any()
    q = fused.pack_query(o, d, tile_size=32)
    spec = fused._walk_spec(pflat.clusters, False, True, 2, mxu="highest")
    fused._validate(pflat.clusters, pflat.tri_shade, q, True, spec=spec)
    cut = dict(pflat.clusters, gblock=pflat.clusters["gblock"][..., 1:])
    with pytest.raises(ValueError, match="gblock"):
        fused._validate(cut, pflat.tri_shade, q, True, spec=spec)
    # The bench terrain's bake (7,811 blocks of 128): 2 picks a trip fit
    # at "highest", 8 do not.
    assert (fused._smem_bytes(7811, 128, chunk_k=2, mxu="highest")
            <= fused.SMEM_LIMIT
            < fused._smem_bytes(7811, 128, chunk_k=8, mxu="highest"))
