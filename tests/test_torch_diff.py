"""The port's differentiable render and fits (raytpu_torch/diff/,
render/wavefront.py's differentiable branches, io/checkpoint.py,
bridge.py::fit_state_from_numpy) against the JAX package's.

The same inputs, made with numpy from a seed, go through ``jax.grad`` of
the reference's ``render_loss`` (its PALLAS intersector in interpret mode,
``cull_tile=16`` on a ``cluster_size=16`` bake, as tests/test_diff.py:219
runs it) and through ``render_loss(...).backward()`` of the port.  Both
trace the reference camera's rays (the cameras differ by ~4e-6,
ROADMAP.md queue 3), from a camera off the scene's symmetry plane.

Tolerances: losses rtol 1e-5; gradients rtol 1e-4 and atol 1e-6 (the
reference contracts a*b+c into FMAs and sums its dots with ``jnp.sum``,
the port sums term by term: ~1e-9 apart on gradients of ~1e-3); fitted
parameters atol 1e-6 after SGD.  After Adam, rtol 1e-6 and atol 1e-5 where
the gradient is well above Adam's eps (sqrt(nu) > 1e-7), and atol 1e-3
(a tenth of one step) elsewhere: where a gradient cancels to ~1e-10 (the
ground plane's two 40-unit triangles) the packages' values differ even in
sign, and Adam's g / (|g| + eps) turns that noise into updates of up to
lr * |g| / eps.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytpu.config import Intersector as JIntersector
from raytpu.config import Quantize as JQuantize
from raytpu.config import RenderConfig as JRenderConfig
from raytpu.core.camera import Camera as JCamera
from raytpu.core.camera import camera_rays as jax_camera_rays
from raytpu.diff import params as jparams
from raytpu_torch import Intersector, Quantize, RenderConfig
from raytpu_torch.bridge import fit_state_from_numpy
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.diff import fit as pfit
from raytpu_torch.diff.params import (GEOMETRY, TEXTURE, apply_params,
                                      extract_params)
from raytpu_torch.io.checkpoint import FitCheckpointer
from raytpu_torch.render.wavefront import render_image, render_rays
from tests.torch_scenes import jax_bake, sphere_and_plane, t, to_port

jfit = importlib.import_module("raytpu.diff.fit")
torch.set_num_threads(1)

W = 16
POSITION = (3.0, 16.0, 32.0)
COMMON = dict(width=W, height=W, max_reflections=1, tile_pixels=W * W,
              cull_tile=16)
JCFG = JRenderConfig(intersector=JIntersector.PALLAS,
                     quantize=JQuantize.NONE, differentiable=True, **COMMON)
PCFG = RenderConfig(intersector=Intersector.PALLAS, quantize=Quantize.NONE,
                    differentiable=True, **COMMON)


@pytest.fixture(scope="module")
def scene():
    """The textured sphere-and-plane bake (cluster size 16) in both
    packages, the reference camera's rays and a seeded target."""
    jflat = jax_bake(sphere_and_plane("jax", textured=True), 16)
    o, d = jax.jit(lambda: jax_camera_rays(JCamera(position=POSITION), W,
                                           W))()
    target = np.random.default_rng(0).uniform(0, 1, (W * W, 3)).astype(
        np.float32)
    return jflat, to_port(jflat), np.asarray(o), np.asarray(d), target


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("fields,soft_tau", [(GEOMETRY + TEXTURE, 0.0),
                                             (GEOMETRY, 0.05)])
def test_gradients_match_reference(scene, fields, soft_tau):
    jflat, pflat, o, d, target = scene
    jcfg = dataclasses.replace(JCFG, soft_tau=soft_tau)
    jp = jparams.extract_params(jflat, fields)
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda p: jfit.render_loss(jflat, jcfg, p, o, d, target)))(jp)
    pp = extract_params(pflat, fields)
    assert all(x.is_leaf and x.requires_grad for x in pp.values())
    loss_p = pfit.render_loss(pflat, dataclasses.replace(
        PCFG, soft_tau=soft_tau), pp, t(o), t(d), t(target))
    loss_p.backward()
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j),
                               rtol=1e-5)
    for k in fields:
        g = pp[k].grad.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        np.testing.assert_allclose(g, np.asarray(grad_j[k]), rtol=1e-4,
                                   atol=1e-6)


def test_differentiable_forward_is_the_hard_forward():
    """tests/test_diff.py:39: ``differentiable=True`` keeps the image.  The
    recompute rounds u, v and t through the reference's Möller–Trumbore
    formula where the walk rounds them in det space, so the two agree to
    the render tests' atol 1e-5 rather than bit for bit."""
    flat = sphere_and_plane("torch", textured=True, light="both").flatten(
        device="cpu", cluster_size=16)
    cfg = RenderConfig(width=24, height=24, max_reflections=2,
                       quantize=Quantize.NONE, tile_pixels=24 * 24)
    cam = Camera(position=POSITION)
    hard = render_image(flat, cfg, cam)
    soft = render_image(flat, dataclasses.replace(cfg, differentiable=True,
                                                  soft_tau=0.1), cam)
    assert (hard.max(-1).values > 0).float().mean() > 0.3
    np.testing.assert_allclose(soft.detach().numpy(), hard.numpy(), rtol=0,
                               atol=1e-5)


def test_geometry_channels_equal_all_channels(scene):
    """``grad_channels="geometry"`` (the (T, 12) scatter-add) gives the
    gradients of ``"all"`` for GEOMETRY fields (tests/test_diff.py:293);
    the two scatter in different orders, hence the tolerance."""
    _, pflat, o, d, target = scene
    grads = {}
    for channels in ("all", "geometry"):
        pp = extract_params(pflat, GEOMETRY)
        pfit.render_loss(pflat, dataclasses.replace(
            PCFG, grad_channels=channels), pp, t(o), t(d),
            t(target)).backward()
        grads[channels] = {k: v.grad for k, v in pp.items()}
    for k in GEOMETRY:
        np.testing.assert_allclose(grads["geometry"][k].numpy(),
                                   grads["all"][k].numpy(), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("channels", ["all", "geometry"])
def test_misses_keep_gradients_finite(monkeypatch, channels):
    """A frame that is half sky: the miss lanes gather the last row (never
    index -1, which ``index_add_`` refuses) and their gradients stay
    finite; reflections and shadows of the hits included."""
    flat = sphere_and_plane("torch", textured=True, light="both").flatten(
        device="cpu", cluster_size=16)
    o, d = camera_rays(Camera(position=(2.0, 3.0, 30.0),
                              target=(0.0, 6.0, 0.0)), 24, 24, device="cpu")
    seen = []
    add = torch.Tensor.index_add_

    def spy(self, dim, index, source, **kw):
        seen.append(int(index.min()))
        return add(self, dim, index, source, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    cfg = RenderConfig(width=24, height=24, max_reflections=2,
                       quantize=Quantize.NONE, tile_pixels=24 * 24,
                       differentiable=True, grad_channels=channels)
    params = extract_params(flat, GEOMETRY)
    colors = render_rays(apply_params(flat, params), cfg, o, d)
    hit = colors.detach().max(-1).values > 0
    assert 0.2 < float(hit.float().mean()) < 0.9
    (colors ** 2).mean().backward()
    for v in params.values():
        assert bool(torch.isfinite(v.grad).all()) and bool(
            (v.grad != 0).any())
    if channels == "geometry":
        assert seen and min(seen) >= 0


def test_params_views_and_apply(scene):
    """``extract_params`` gives leaf copies of the ``tri_shade`` columns;
    ``apply_params`` rebuilds the rows as the reference's ``pack_shade``
    does (face normals recomputed when geometry moves; mesh ids kept as
    int32 bits)."""
    jflat, pflat, _, _, _ = scene
    fields = GEOMETRY + ("tri_color", "tri_mesh") + TEXTURE
    jp = jparams.extract_params(jflat, fields)
    pp = extract_params(pflat, fields)
    for k in fields:
        np.testing.assert_array_equal(pp[k].detach().numpy(),
                                      np.asarray(jp[k])[:pp[k].shape[0]])
    assert pp["tri_mesh"].dtype == torch.int32
    assert not pp["tri_mesh"].requires_grad
    shift = np.float32([0.25, -0.5, 0.125])
    jp["tri_v1"] = jp["tri_v1"] + shift
    jp["tri_e1"] = jp["tri_e1"] + shift
    with torch.no_grad():
        pp["tri_v1"] += t(shift)
        pp["tri_e1"] += t(shift)
    ref = np.asarray(jax.jit(lambda s, p: jparams.pack_shade(
        jparams.apply_params(s, p)))(jflat, jp))
    got = apply_params(pflat, pp).tri_shade.detach().numpy()
    np.testing.assert_array_equal(got[:, 31].view(np.int32),
                                  ref[:, 31].view(np.int32))
    np.testing.assert_allclose(got[:, :31], ref[:, :31], rtol=0, atol=1e-6)
    assert not np.allclose(got[:, 24:27],
                           pflat.tri_shade[:, 24:27].numpy(), atol=1e-3)
    untouched = apply_params(pflat, {"textures": pp["textures"]})
    assert untouched.tri_shade is pflat.tri_shade


def _assert_adam_close(got, ref, nu):
    for k, v in got.items():
        a, b = v.detach().numpy(), np.asarray(ref[k])
        sure = np.sqrt(np.asarray(nu[k])) > 1e-7
        assert sure.any()
        np.testing.assert_allclose(a[sure], b[sure], rtol=1e-6, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=k)


def _jax_run(jflat, cfg, optimizer, params, o, d, target, steps):
    """``steps`` reference fit steps; the params, optimizer state and loss
    after each."""
    step = jfit.make_fit_step(jflat, cfg, optimizer,
                              fields=tuple(params))
    state = optimizer.init(params)
    out = []
    for _ in range(steps):
        params, state, loss = step(params, state, o, d, target)
        out.append((params, state, float(loss)))
    return out


@pytest.fixture(scope="module")
def fit_case(scene):
    """The fit tests' inputs: GEOMETRY + TEXTURE (the reference fit's
    default fields) through the reference's exact TILED backend, whose
    hits the PALLAS backend shares."""
    jflat, pflat, o, d, target = scene
    jcfg = dataclasses.replace(JCFG, intersector=JIntersector.TILED)
    jp = jparams.extract_params(jflat, GEOMETRY + TEXTURE)
    return jflat, pflat, o, d, target, jcfg, jp


def _same_rays(monkeypatch, o, d):
    """The port's fit traces the reference camera's rays."""
    monkeypatch.setattr(pfit, "camera_rays",
                        lambda cam, w, h, device: (t(o), t(d)))


def test_fit_sgd_matches_reference(monkeypatch, fit_case):
    jflat, pflat, o, d, target, jcfg, jp = fit_case
    lr = 2.0
    _, jparams_fit, jhist = jfit.fit(jflat, jcfg, JCamera(position=POSITION),
                                     target, steps=3,
                                     optimizer=optax.sgd(lr))
    _same_rays(monkeypatch, o, d)
    seen = []
    _, pparams_fit, phist = pfit.fit(
        pflat, PCFG, Camera(position=POSITION), target, steps=3,
        optimizer=functools.partial(torch.optim.SGD, lr=lr),
        callback=lambda i, loss: seen.append(i))
    assert seen == [0, 1, 2]
    np.testing.assert_allclose(phist, jhist, rtol=1e-5)
    assert phist[-1] < phist[0]
    for k in GEOMETRY + TEXTURE:
        np.testing.assert_allclose(pparams_fit[k].detach().numpy(),
                                   np.asarray(jparams_fit[k]), rtol=0,
                                   atol=1e-6)


def test_fit_adam_and_resume_through_bridge(monkeypatch, tmp_path,
                                            fit_case):
    """Adam (optax's defaults, torch.optim.Adam's) over three steps; and
    the same fit begun in the reference, carried across after two steps
    (params and Adam moments through ``fit_state_from_numpy`` and a
    checkpoint), finished by the port."""
    jflat, pflat, o, d, target, jcfg, jp = fit_case
    lr = 1e-2
    runs = _jax_run(jflat, jcfg, optax.adam(lr), jp, o, d, target, 3)
    _same_rays(monkeypatch, o, d)
    _, pparams_fit, phist = pfit.fit(pflat, PCFG, Camera(position=POSITION),
                                     target, steps=3, learning_rate=lr)
    np.testing.assert_allclose(phist, [r[2] for r in runs], rtol=1e-5)
    _assert_adam_close(pparams_fit, runs[2][0], runs[2][1][0].nu)

    params2, (adam2, _) = runs[1][0], runs[1][1]
    bparams, state = fit_state_from_numpy(
        _np(params2), adam=(np.asarray(adam2.count), _np(adam2.mu),
                            _np(adam2.nu)), learning_rate=lr, device="cpu")
    assert state["state"][0]["step"] == 2
    FitCheckpointer(str(tmp_path)).save(2, (bparams, state))
    seen = []
    _, resumed, hist = pfit.fit(pflat, PCFG, Camera(position=POSITION),
                                target, steps=3, learning_rate=lr,
                                checkpoint_dir=str(tmp_path),
                                checkpoint_every=1,
                                callback=lambda i, loss: seen.append(i))
    assert seen == [2]
    np.testing.assert_allclose(hist, [runs[2][2]], rtol=1e-5)
    _assert_adam_close(resumed, runs[2][0], runs[2][1][0].nu)


def test_fit_checkpoint_resume_skips_finished_steps(tmp_path):
    """tests/test_diff.py:172, and the newest three saves are kept."""
    flat = sphere_and_plane("torch", textured=True).flatten(device="cpu",
                                                            cluster_size=16)
    cfg = RenderConfig(width=8, height=8, max_reflections=1,
                       quantize=Quantize.NONE, tile_pixels=64)
    cam = Camera(position=POSITION)
    target = render_image(flat, cfg, cam)
    kw = dict(fields=TEXTURE, steps=4, learning_rate=1.0,
              checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    seen = []
    pfit.fit(flat, cfg, cam, target, callback=lambda i, l: seen.append(i),
             **kw)
    assert seen == [0, 1, 2, 3]
    assert FitCheckpointer(str(tmp_path / "ck")).steps() == [2, 3, 4]
    seen.clear()
    pfit.fit(flat, cfg, cam, target, callback=lambda i, l: seen.append(i),
             **kw)
    assert seen == []


def _cut(clusters):
    """A reference bake's cluster tables in the port's layout."""
    ncg = clusters["block"].shape[0]
    return {"block": np.asarray(clusters["block"]),
            "aabb": np.asarray(clusters["aabb"]).reshape(6, -1)[:, :ncg],
            "plane": np.asarray(clusters["sub_plane"]).reshape(5, -1)[:, :ncg],
            "root": np.asarray(clusters["root"]).reshape(8)}


def test_rebuild_accel_matches_reference_rebake(scene):
    """Re-bakes from moved geometry with ``pad_clusters_to``: the same
    tables as the reference's re-bake, bit for bit, one shape across
    moves; a pad below the built count raises ``ValueError``."""
    jflat, pflat, _, _, _ = scene
    nc = pflat.clusters["block"].shape[0]
    rng = np.random.default_rng(2)
    shapes = set()
    for scale in (0.05, 0.3):
        jp = {k: np.asarray(v) + scale * rng.normal(size=v.shape).astype(
            np.float32) for k, v in jparams.extract_params(
                jflat, GEOMETRY).items()}
        ref = _cut(jfit.rebuild_accel(
            jflat, {k: jnp.asarray(v) for k, v in jp.items()},
            nc + 4).clusters)
        got = pfit.rebuild_accel(pflat, {k: t(v) for k, v in jp.items()},
                                 nc + 4).clusters
        for k, a in ref.items():
            np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                          a.view(np.int32), err_msg=k)
        shapes.add(tuple(tuple(v.shape) for v in got.values()))
    assert len(shapes) == 1
    assert got["block"].shape[0] == nc + 4
    with pytest.raises(ValueError, match="pad_clusters_to"):
        pfit.rebuild_accel(pflat, extract_params(pflat, GEOMETRY), nc - 1)


def test_fit_with_rebakes_keeps_shapes_and_descends():
    """tests/test_diff.py:238: a geometry fit that re-bakes the cluster
    tables every 3 steps; the tables keep one padded shape and the losses
    fall within each bake.  (Across a re-bake the loss may rise: the
    re-baked walk sees the cracks that per-triangle updates open.)"""
    flat = sphere_and_plane("torch").flatten(device="cpu", cluster_size=16)
    cfg = RenderConfig(width=16, height=16, max_reflections=0,
                       quantize=Quantize.NONE, tile_pixels=256, cull_tile=64)
    cam = Camera(position=POSITION)
    target = render_image(flat, cfg, cam)
    rng = np.random.default_rng(1)
    pert = {k: v + torch.from_numpy(0.05 * rng.normal(size=v.shape).astype(
        np.float32)) for k, v in extract_params(flat, GEOMETRY).items()}
    noisy = apply_params(flat, {k: v.detach() for k, v in pert.items()})
    fitted, _, losses = pfit.fit(noisy, cfg, cam, target, fields=GEOMETRY,
                                 steps=6, learning_rate=5e-3,
                                 rebuild_every=3)
    assert np.isfinite(losses).all()
    assert losses[1] < losses[0] and losses[4] < losses[3]
    nc = flat.clusters["block"].shape[0]
    assert fitted.clusters["block"].shape == (nc + 8, 24, 16)


def test_sharded_fit_raises():
    """A sharded step takes equal shards of rays (``fit`` pads them) and
    raises on others; a mesh of CUDA entries without a card raises."""
    from raytpu_torch.dist.mesh import make_mesh

    flat = sphere_and_plane("torch").flatten(device="cpu", cluster_size=16)
    params = extract_params(flat, GEOMETRY)
    opt = torch.optim.SGD(list(params.values()), lr=0.0)
    step = pfit.make_fit_step(flat, PCFG, opt, mesh=make_mesh(["cpu"] * 3),
                              fields=GEOMETRY)
    o, d = camera_rays(Camera(position=POSITION), W, W, device="cpu")
    with pytest.raises(ValueError, match="equal shards"):
        step(params, o, d, torch.zeros((W * W, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfit.fit(flat, PCFG, Camera(), np.zeros((W, W, 3)),
                 mesh=make_mesh(["cuda"] * 2))
