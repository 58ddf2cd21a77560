"""The port's distribution (raytpu_torch/dist/, the sharded fit in
diff/fit.py, the CLI's ``--devices`` and ``--ring``) against the JAX
package's raytpu/dist/, on the CPU.

The port's meshes here are four entries of the CPU, against the JAX
package's mesh of four virtual CPU devices
(``make_mesh(devices=jax.devices()[:4])``); the scenes are bridged from the
JAX bake (tests/torch_scenes.py::to_port), so both packages cut the same
tables.  The JAX package's ring programs run under ``jax.jit``
(:func:`traced`): called eagerly, their ``shard_map`` bodies compile one
operation at a time, minutes a render on the CPU.

Tolerances: ring hits exact (hit, tri), t within rtol 1e-6 (XLA contracts
a*b+c into FMAs, the port does not); images atol 1e-5 as
tests/test_dist.py holds the JAX ring render to its replicated one; losses
and gradients rtol 1e-5, atol 5e-7 (tests/test_dist.py:252-262).  The
port's sharded renders are the port's single-device renders exactly: a
shard is a whole number of the render's tiles.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytpu.config import Intersector as JIntersector
from raytpu.config import Quantize as JQuantize
from raytpu.config import TextureFiltering as JFiltering
from raytpu.core.camera import Camera as JCamera
from raytpu.core.camera import camera_rays as jax_camera_rays
from raytpu.dist import bigscene as jbig
from raytpu.dist.mesh import make_mesh as jax_make_mesh
from raytpu_torch import Intersector, Quantize, RenderConfig
from raytpu_torch.cli import main as tcli
from raytpu_torch.core.camera import Camera
from raytpu_torch.diff import fit as pfit
from raytpu_torch.diff.params import GEOMETRY, extract_params
from raytpu_torch.dist import bigscene as pbig
from raytpu_torch.dist.mesh import (hierarchical_pmean, make_mesh,
                                    replicate_scene)
from raytpu_torch.dist.render import render_image_sharded
from raytpu_torch.kernels.fused import nearest_hit_fused
from raytpu_torch.render import wavefront
from raytpu_torch.render.supersample import render_image_multisampled
from tests.jax_traced import traced
from tests.torch_scenes import (jax_bake, random_rays, sphere_and_plane, t,
                                to_port)

jdiff = importlib.import_module("raytpu.diff.fit")
jparams = importlib.import_module("raytpu.diff.params")
torch.set_num_threads(1)

CPU4 = ["cpu"] * 4
# A camera off the scene's symmetry plane and off its pixel grid: an
# axis-aligned grid fires rays exactly down shared edges, where exact-t
# ties go to the shard visited first on the ring (tests/test_dist.py:210).
FIT_POSITION = (0.313, 16.17, 31.9)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def bake16():
    """The sphere-and-plane scene baked at 16 by the JAX package, and the
    port's scene of that bake (11 blocks)."""
    jflat = jax_bake(sphere_and_plane("jax"), 16)
    return jflat, to_port(jflat)


def test_mesh_devices_and_replicas():
    """Shapes and axes of 1-D and 2-D meshes, replicas shared by repeated
    entries; a CUDA mesh without a card raises, as does the default mesh
    (every CUDA device) here."""
    mesh = make_mesh(CPU4)
    assert mesh.size == 4 and mesh.shape == {"rays": 4}
    assert mesh.device_list == [torch.device("cpu")] * 4
    m2 = make_mesh(CPU4, axes=("hosts", "chips"), shape=(2, 2))
    assert m2.shape == {"hosts": 2, "chips": 2} and m2.devices.shape == (2, 2)
    assert make_mesh(CPU4, axes=("hosts", "chips")).shape == {
        "hosts": 1, "chips": 4}
    flat = sphere_and_plane("torch").flatten(cluster_size=16, device="cpu")
    reps = replicate_scene(flat, mesh)
    assert len(reps) == 4 and all(r is flat for r in reps)
    for devices in (None, ["cuda"] * 2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(devices)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_image_sharded(flat, RenderConfig(width=8, height=8))


def test_hierarchical_pmean_is_the_mean():
    """On a 2x2 ("hosts", "chips") mesh: leaves whose dim 0 tiles over the
    chips (reduce-scatter, host sum, gather), leaves that do not (the flat
    sum) and scalars; on a 1-D mesh the flat mean."""
    rng = np.random.default_rng(7)
    trees = [{"tiles": rng.normal(size=(6, 3)).astype(np.float32),
              "odd": rng.normal(size=(3, 5)).astype(np.float32),
              "scalar": np.float32(rng.normal())} for _ in range(4)]
    want = {k: np.mean([tr[k] for tr in trees], axis=0) for k in trees[0]}
    for mesh in (make_mesh(CPU4, axes=("hosts", "chips"), shape=(2, 2)),
                 make_mesh(CPU4)):
        got = hierarchical_pmean(
            [{k: torch.tensor(v) for k, v in tr.items()} for tr in trees],
            mesh)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    flat = hierarchical_pmean([torch.tensor(tr["tiles"]) for tr in trees],
                              make_mesh(CPU4))
    np.testing.assert_allclose(flat.numpy(), want["tiles"], rtol=1e-6)


def _same_hits(got, want, any_hit=False):
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    if any_hit:
        return
    m = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(got.tri)[m],
                                  np.asarray(want.tri)[m])
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(want.t)[m],
                               rtol=1e-6)


def test_ring_matches_reference(bake16, jax_mesh):
    """``nearest_hit_ring`` by the CPU sweep off the packed blocks in both
    packages: a ragged ray count (401 rays over 4 shards), ignore ids on
    every other ray (each ray's own nearest triangle) and a t bound; then
    an any-hit query cast from the light side (``cull="reverse"``)."""
    jflat, flat = bake16
    o, d = random_rays(5, 401)
    first = nearest_hit_fused(flat, t(o), t(d))
    itri = torch.where(torch.arange(401) % 2 == 0, first.tri, -1)
    tmax = np.full(401, 25.0, np.float32)
    jshards = jbig.shard_scene_clusters(jflat, jax_mesh)
    want = traced(jbig.nearest_hit_ring, jshards, o, d, jax_mesh,
                  ignore_tri=itri.numpy(), t_max=tmax)
    shards = pbig.shard_scene_clusters(flat, make_mesh(CPU4))
    assert shards["block"][0].shape[0] == jshards["block"].shape[1] == 3
    got = pbig.nearest_hit_ring(shards, t(o), t(d), make_mesh(CPU4),
                                ignore_tri=itri, t_max=t(tmax))
    assert got.hit.shape == (401,) and int(got.hit.sum()) > 40
    _same_hits(got, want)
    want = traced(jbig.nearest_hit_ring, jshards, o, d, jax_mesh,
                  any_hit=True, cull="reverse", t_max=tmax)
    got = pbig.nearest_hit_ring(shards, t(o), t(d), make_mesh(CPU4),
                                any_hit=True, cull="reverse", t_max=t(tmax))
    assert int(got.hit.sum()) > 0
    _same_hits(got, want, any_hit=True)


@pytest.mark.parametrize("size,entries", [(16, 4), (32, 3), (128, 9)])
def test_ring_walk_matches_whole_walk(size, entries):
    """The walk on the shards (``intersector="pallas"``, the plain walk
    here) against the walk on the whole bake: the same hits, and where
    the winners differ an exact-t tie between shards.  A subcluster bake
    (32) is walked at block granularity; at 128 the 2 blocks go to 9
    shards, 7 of them wholly padding."""
    flat = sphere_and_plane("torch").flatten(cluster_size=size, device="cpu",
                                             build_octree=False)
    mesh = make_mesh(["cpu"] * entries)
    shards = pbig.shard_scene_clusters(flat, mesh)
    nc = flat.clusters["block"].shape[0]
    assert shards["block"][-1].shape[0] == -(-nc // entries)
    o, d = (t(a) for a in random_rays(11, 200))
    for any_hit, cull in ((False, True), (True, "reverse")):
        want = nearest_hit_fused(flat, o, d, any_hit=any_hit, cull=cull)
        got = pbig.nearest_hit_ring(shards, o, d, mesh, any_hit=any_hit,
                                    cull=cull, intersector="pallas")
        assert torch.equal(got.hit, want.hit) and int(want.hit.sum()) > 0
        if not any_hit:
            # Winners differ only at exact-t ties.
            assert torch.equal(got.t, want.t)


def test_gather_rows_ring_forward_and_backward():
    """The forward is the table's rows (zero rows for negative ids); the
    differentiable twin's backward, the cotangents index-added on their
    owner shards."""
    flat = sphere_and_plane("torch").flatten(cluster_size=16, device="cpu")
    mesh = make_mesh(CPU4)
    shade = pbig.shard_scene_shade(flat, mesh)
    rows = flat.tri_shade.shape[0]
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        -1, rows, size=53).astype(np.int32))
    want = torch.where(ids[:, None] >= 0, flat.tri_shade[ids.clamp(min=0)],
                       0.0)
    assert torch.equal(pbig.gather_rows_ring(shade, ids, mesh), want)
    tables = [x.clone().requires_grad_() for x in shade["shade"]]
    out = pbig.gather_rows_ring(dict(shade, shade=tables), ids, mesh,
                                differentiable=True)
    assert torch.equal(out, want)
    ct = torch.from_numpy(np.random.default_rng(4).normal(
        size=tuple(out.shape)).astype(np.float32))
    out.backward(ct)
    live = ids >= 0
    ref = torch.zeros((4 * shade["rows_per_shard"], 32)).index_add_(
        0, ids[live].long(), ct[live])
    assert torch.equal(torch.cat([x.grad for x in tables]), ref)


def test_render_image_ring_matches_reference(jax_mesh, monkeypatch):
    """The ring render of a transparent scene with a textured ground,
    bilinear, at 24x16 with one reflection: the JAX package's ring render
    against the port's from a STRIPPED scene (no shade rows, cluster
    tables or atlas) with prebuilt geometry, shade and texture shards."""
    from raytpu.core.camera import Camera as JaxCamera
    from raytpu_torch.core import camera as pcamera
    from tests.torch_scenes import reference_camera_rays

    monkeypatch.setattr(pcamera, "camera_rays", reference_camera_rays)
    jflat = jax_bake(sphere_and_plane("jax", reflect=0.4, textured=True,
                                      transparent=True), 16)
    jcfg = dict(width=24, height=16, max_reflections=1, tile_pixels=384,
                quantize=JQuantize.NONE)
    want = np.asarray(traced(
        jbig.render_image_ring, jflat, dataclasses.replace(
            wavefront_cfg_jax(jcfg), filtering=JFiltering.BILINEAR),
        JaxCamera(aspect=1.5), jax_mesh))
    flat = to_port(jflat)
    mesh = make_mesh(CPU4)
    cfg = RenderConfig.from_json(dataclasses.replace(
        wavefront_cfg_jax(jcfg), filtering=JFiltering.BILINEAR).to_json())
    stripped = pbig.strip_for_ring(flat)
    assert stripped.tri_shade is None and stripped.textures is None
    got = pbig.render_image_ring(
        stripped, cfg, Camera(aspect=1.5), mesh,
        shards=pbig.shard_scene_clusters(flat, mesh),
        shade=pbig.shard_scene_shade(flat, mesh),
        texshards=pbig.shard_scene_textures(flat, mesh))
    assert (want.max(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="stripped of its atlas"):
        pbig.render_image_ring(
            stripped, cfg, Camera(aspect=1.5), mesh,
            shards=pbig.shard_scene_clusters(flat, mesh),
            shade=pbig.shard_scene_shade(flat, mesh))


def wavefront_cfg_jax(kw):
    from raytpu.config import RenderConfig as JRenderConfig

    return JRenderConfig(intersector=JIntersector.TILED, **kw)


SHARDED = {
    "1-D": (dict(width=32, height=24), lambda: make_mesh(CPU4)),
    "2x2": (dict(width=16, height=16),
            lambda: make_mesh(CPU4, axes=("hosts", "chips"), shape=(2, 2))),
    "ragged": (dict(width=19, height=13, tile_pixels=32),
               lambda: make_mesh(["cpu"] * 3)),
    "multisampled": (dict(width=16, height=12, use_multisampling=True,
                          multisample_quality=1), lambda: make_mesh(CPU4)),
}


@pytest.mark.parametrize("case", sorted(SHARDED))
def test_render_image_sharded_is_render_image(case):
    """``render_image_sharded`` against the port's ``render_image`` (held
    to the JAX package's in test_torch_render.py): the same image, bit
    for bit, over 1-D and 2x2 meshes, a ragged 19x13 frame and the
    supersampled branch."""
    change, mesh = SHARDED[case]
    flat = sphere_and_plane("torch", reflect=0.4, textured=True).flatten(
        cluster_size=16, device="cpu", build_octree=False)
    cfg = RenderConfig(max_reflections=1, quantize=Quantize.NONE,
                       intersector=Intersector.PALLAS, cull_tile=64,
                       **{"tile_pixels": 128, **change})
    cam = Camera(aspect=cfg.width / cfg.height)
    want = (render_image_multisampled(flat, cfg, cam) if
            cfg.use_multisampling else wavefront.render_image(flat, cfg, cam))
    got = render_image_sharded(flat, cfg, cam, mesh())
    assert got.shape == (cfg.height, cfg.width, 3)
    assert float(want.max()) > 0 and torch.equal(got, want)


def _fit_inputs():
    """A scene baked by the JAX package, its bridge, and the JAX camera's
    rays from FIT_POSITION at 16x16 (numpy)."""
    jflat = jax_bake(sphere_and_plane("jax", reflect=0.4, textured=True), 16)
    o, d = jax.jit(lambda: jax_camera_rays(JCamera(position=FIT_POSITION),
                                           16, 16))()
    return jflat, to_port(jflat), np.asarray(o), np.asarray(d)


FIT_CFG = dict(width=16, height=16, max_reflections=1, tile_pixels=64,
               quantize=JQuantize.NONE, differentiable=True)


def test_sharded_fit_step_matches_reference(jax_mesh):
    """One sharded SGD(1) step over the 4-entry mesh (64 rays a shard, the
    tiled query): the JAX package's ``make_fit_step(mesh=)``, whose update
    is minus the gradient, against the port's loss and ``.grad``."""
    jflat, flat, o, d = _fit_inputs()
    jcfg = wavefront_cfg_jax(FIT_CFG)
    target = np.full((256, 3), 0.2, np.float32)
    params = jparams.extract_params(jflat, GEOMETRY)
    opt = optax.sgd(1.0)
    step = jdiff.make_fit_step(jflat, jcfg, opt, mesh=jax_mesh,
                               fields=GEOMETRY)
    new, _, jloss = step(params, opt.init(params), o, d, jnp.asarray(target))
    cfg = RenderConfig.from_json(jcfg.to_json())
    pparams = extract_params(flat, GEOMETRY)
    pstep = pfit.make_fit_step(
        flat, cfg, torch.optim.SGD(list(pparams.values()), lr=1.0),
        mesh=make_mesh(CPU4), fields=GEOMETRY)
    loss = pstep(pparams, t(o), t(d), t(target))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for f in GEOMETRY:
        g = np.asarray(params[f]) - np.asarray(new[f])
        assert np.abs(g).max() > 1e-5, f
        np.testing.assert_allclose(pparams[f].grad.numpy(), g, rtol=1e-5,
                                   atol=5e-7, err_msg=f)


def test_ring_fit_step_matches_reference(jax_mesh):
    """One ring fit step (geometry sharded like the shade rows, SGD(1)) on
    stripped scenes with prebuilt shards: the JAX package's
    ``make_ring_fit_step`` against the port's, loss and gradients."""
    jflat, flat, o, d = _fit_inputs()
    jcfg = wavefront_cfg_jax(FIT_CFG)
    target = np.zeros((256, 3), np.float32)
    jparams_ = jbig.extract_ring_params(jflat, jax_mesh)
    opt = optax.sgd(1.0)
    jstep = jbig.make_ring_fit_step(
        jbig.strip_for_ring(jflat), jcfg, jax_mesh, opt,
        shards=jbig.shard_scene_clusters(jflat, jax_mesh),
        shade=jbig.shard_scene_shade(jflat, jax_mesh),
        texshards=jbig.shard_scene_textures(jflat, jax_mesh))
    new, _, jloss = jstep(jparams_, opt.init(jparams_), o, d,
                          jnp.asarray(target))
    mesh = make_mesh(CPU4)
    params = pbig.extract_ring_params(flat, mesh)
    step = pbig.make_ring_fit_step(
        pbig.strip_for_ring(flat), RenderConfig.from_json(jcfg.to_json()),
        mesh, torch.optim.SGD([x for f in sorted(params) for x in params[f]],
                              lr=1.0),
        shards=pbig.shard_scene_clusters(flat, mesh),
        shade=pbig.shard_scene_shade(flat, mesh),
        texshards=pbig.shard_scene_textures(flat, mesh))
    loss = step(params, t(o), t(d), t(target))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    rows = flat.tri_shade.shape[0]
    for f in GEOMETRY:
        want = (np.asarray(jparams_[f])
                - np.asarray(new[f])).reshape(-1, 3)[:rows]
        got = torch.cat([x.grad for x in params[f]])[:rows].numpy()
        assert np.abs(want).max() > 1e-5, f
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-7,
                                   err_msg=f)


def test_query_without_rows_renders_the_same():
    """The wavefront honours ``supports_rows``: a query that returns no
    shade rows has them gathered, and the image is the default query's,
    bit for bit (opaque and transparent scenes)."""
    for transparent in (False, True):
        flat = sphere_and_plane("torch", reflect=0.4, textured=True,
                                transparent=transparent).flatten(
            cluster_size=16, device="cpu", build_octree=False)
        cfg = RenderConfig(width=16, height=16, max_reflections=2,
                           tile_pixels=256, quantize=Quantize.NONE,
                           intersector=Intersector.PALLAS)
        default = wavefront._default_query(cfg)
        assert default.supports_rows
        asked = []

        def rowless(scene, origin, direction, **kw):
            asked.append(kw.get("with_rows", False))
            return default(scene, origin, direction, **kw)

        o, d = wavefront.camera_rays(Camera(), 16, 16, device="cpu")
        want = wavefront.trace_colors(flat, cfg, o, d)
        got = wavefront.trace_colors(flat, cfg, o, d, query=rowless)
        assert asked and not any(asked)
        assert float(want.max()) > 0 and torch.equal(got, want)


def test_cli_devices_and_ring(tmp_path):
    """``render --devices 4`` (four CPU shards) and ``--ring`` write the
    single-device PNG; ``fit --devices 3`` runs its sharded fit."""
    from PIL import Image

    base = ["render", "--scene", "spheres", "--width", "16", "--height",
            "16", "--max-reflections", "1", "--intersector", "pallas"]
    pngs = {}
    for name, extra in (("one", []), ("devices", ["--devices", "4"]),
                        ("ring", ["--devices", "4", "--ring"])):
        out = str(tmp_path / f"{name}.png")
        assert tcli.main(base + extra + ["--out", out], device="cpu") == 0
        pngs[name] = np.asarray(Image.open(out))
    assert pngs["one"].max() > 0
    np.testing.assert_array_equal(pngs["devices"], pngs["one"])
    np.testing.assert_array_equal(pngs["ring"], pngs["one"])
    assert tcli.main(["fit", "--scene", "crate", "--width", "8", "--height",
                      "8", "--max-reflections", "0", "--steps", "1",
                      "--devices", "3", "--out", str(tmp_path / "fit")],
                     device="cpu") == 0
    assert (tmp_path / "fit" / "final.png").exists()
