"""The port's two-level instanced path (raytpu_torch/accel/instanced.py,
raytpu_torch/render/instanced.py) against the JAX package's, on the CPU.

The scene is tests/test_instanced_render.py's: two instances of one sphere
mesh (moved, scaled, rotated) over a textured plane.  Both packages run
``Intersector.AUTO``, which takes the exact brute-force sweep for meshes
this small; the port's cluster walk (``Intersector.PALLAS``, with
``nearest_hit``'s defaults: the slab pretest and a re-cull every 6 trips)
is held to the same hits in test_nearest_hit_instanced_matches_jax.

Tolerances: hit, instance and triangle exact; world distances rtol 1e-5
(the JAX package transforms rays and hit points through XLA dots, which
contract a*b+c into FMAs; the port sums term by term so that the card and
the CPU round alike: ~4e-6 apart at most here).  Colors atol 1e-5, except
that at most 10 of the 1024 pixels of a frame (1%) may differ by up to
1e-4: the same last-bit differences in the world-space hit point reach the
spot light's ``surfaceDot^12`` term and the shadow-ray origins (6 and 3
pixels above 1e-5, 2.7e-5 at most, when this was written).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.accel import instanced as jinst
from raytpu.config import Quantize as JQuantize
from raytpu.config import RenderConfig as JRenderConfig
from raytpu.core.camera import Camera as JCamera
from raytpu.core.camera import camera_rays as jax_camera_rays
from raytpu.render import instanced as jrender
from raytpu_torch.accel import instanced as pinst
from raytpu_torch.config import Intersector, RenderConfig
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.render import instanced as prender
from raytpu_torch.render.wavefront import block_order_perm
from tests.torch_scenes import instanced_scene, t, to_port_instanced

torch.set_num_threads(1)

CAM = (0.0, 10.0, 24.0)


def _bakes(reflect=0.4, transparent=False):
    scene = lambda p: instanced_scene(p, reflect=reflect,  # noqa: E731
                                      transparent=transparent)
    jisc = jrender.flatten_instanced(scene("jax"), build_octree=False,
                                     cluster_size=16)
    return jisc, to_port_instanced(jisc), scene


@pytest.fixture(scope="module")
def opaque():
    return _bakes()


def _rays(n=96, seed=3):
    """tests/test_instanced.py's recipe: origins above the scene."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    o[:, 1] += 9.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _assert_same_hits(ph, ref):
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(ph.hit.numpy(), hit)
    assert hit.any() and not hit.all()
    for f in ("instance", "tri"):
        np.testing.assert_array_equal(getattr(ph, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(ph.t_world.numpy()[hit],
                               np.asarray(ref.t_world)[hit], rtol=1e-5)
    assert np.all(ph.t_world.numpy()[~hit] == np.float32(3.4028235e38))


def test_own_bake_is_the_bridged_bake(opaque):
    jisc, pisc, scene = opaque
    own = prender.flatten_instanced(scene("torch"), cluster_size=16,
                                    device="cpu")
    assert len(own.bakes) == 2 and own.bake_of_instance == (0, 0, 1)
    assert own.bake_of_instance == pisc.bake_of_instance
    for a, b in zip(own.bakes, pisc.bakes):
        assert torch.equal(a.tri_shade.view(torch.int32),
                           b.tri_shade.view(torch.int32))
        for k in a.clusters:
            assert torch.equal(a.clusters[k].view(torch.int32),
                               b.clusters[k].view(torch.int32)), k
        assert torch.equal(a.mat_transparent, b.mat_transparent)
        assert torch.equal(a.mat_refraction, b.mat_refraction)
    for k in ("worlds", "inv_t", "bake_index"):
        assert torch.equal(getattr(own, k), getattr(pisc, k)), k
    for k in own.lights:
        assert torch.equal(own.lights[k], pisc.lights[k]), k


@pytest.mark.parametrize("prune,order,ignore,skip_empty", [
    (True, None, False, True), (False, None, False, True),
    (True, "front_to_back", True, True), (True, None, False, False)])
def test_nearest_hit_instanced_matches_jax(opaque, prune, order, ignore,
                                           skip_empty):
    jisc, pisc, _ = opaque
    o, d = _rays()
    if not skip_empty:
        # Vertical rays beside both spheres (half down onto the plane, half
        # up into the sky): the two sphere passes have no live ray, and
        # run all the same.
        o[:, 0] = np.abs(o[:, 0]) + 9.0
        d[:] = 0.0
        d[:, 1] = np.where(np.arange(96) % 2 == 0, -1.0, 1.0)
    kw = dict(prune=prune, return_stats=True, skip_empty=skip_empty)
    if order:
        eye = (0.0, 3.0, -12.0)
        kw["order"] = pinst.order_front_to_back(list(pisc.instances),
                                                pisc.bakes, eye)
        assert kw["order"] == [int(i) for i in jinst.order_front_to_back(
            list(jisc.instances), jisc.bakes, eye)]
        assert kw["order"] != sorted(kw["order"])
    if ignore:
        first = pinst.nearest_hit_instanced(pisc.bakes, list(pisc.instances),
                                            t(o), t(d))
        itri, iinst = first.tri.numpy(), first.instance.numpy()
        itri = np.where(np.arange(96) % 2 == 0, itri, -1).astype(np.int32)
        kw.update(ignore_tri=itri, ignore_instance=iinst)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ref, jstats = jax.jit(lambda o, d: jinst.nearest_hit_instanced(
        jisc.bakes, list(jisc.instances), o, d, **jkw))(o, d)
    pkw = {k: t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ph, stats = pinst.nearest_hit_instanced(
        pisc.bakes, list(pisc.instances), t(o), t(d), **pkw)
    _assert_same_hits(ph, ref)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
    walk, _ = pinst.nearest_hit_instanced(
        pisc.bakes, list(pisc.instances), t(o), t(d),
        intersector=Intersector.PALLAS, **pkw)
    _assert_same_hits(walk, ref)
    if not skip_empty:
        assert stats.tolist() == [0, 0, 48]  # the plane: the down rays


def test_scan_matches_jax_with_t_max(opaque):
    jisc, pisc, _ = opaque
    o, d = _rays(seed=5)
    tmax = np.random.default_rng(5).uniform(4.0, 20.0, 96).astype(np.float32)
    ref, jstats = jax.jit(lambda o, d, tm: jinst.nearest_hit_instanced_scan(
        jisc.bakes, list(jisc.instances), o, d, t_max=tm,
        return_stats=True))(o, d, tmax)
    ph, stats = pinst.nearest_hit_instanced_scan(
        pisc.bakes, list(pisc.instances), t(o), t(d), t_max=t(tmax),
        return_stats=True)
    _assert_same_hits(ph, ref)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
    # The unrolled path finds the same hits.
    un = pinst.nearest_hit_instanced(pisc.bakes, list(pisc.instances), t(o),
                                     t(d), t_max=t(tmax))
    for f in ("hit", "instance", "tri", "t_world"):
        assert torch.equal(getattr(un, f), getattr(ph, f)), f


@pytest.mark.parametrize("case", ["opaque_reflection",
                                  "transparent_refraction"])
def test_render_matches_jax(opaque, case):
    """Both packages trace the reference camera's rays in square-block
    order (as ``render_image_instanced`` orders them), two reflection
    levels, refraction children in the transparent scene."""
    jisc, pisc, _ = (opaque if case == "opaque_reflection"
                     else _bakes(reflect=0.2, transparent=True))
    jcfg = JRenderConfig(width=32, height=32, max_reflections=2,
                         quantize=JQuantize.NONE)
    o, d = jax.jit(lambda: jax_camera_rays(JCamera(position=CAM), 32, 32))()
    perm = block_order_perm(32, 32, 16, "cpu").numpy()
    o, d = np.asarray(o)[perm], np.asarray(d)[perm]
    ref = np.asarray(jax.jit(lambda o, d: jrender.trace_colors_instanced(
        jisc, jcfg, o, d))(o, d))
    colors = prender.trace_colors_instanced(
        pisc, RenderConfig.from_json(jcfg.to_json()), t(o), t(d))
    assert colors.shape == (1024, 3) and not torch.isnan(colors).any()
    assert (ref.max(-1) > 0).mean() > 0.5
    diff = np.abs(colors.numpy() - ref).max(-1)
    assert (diff > 1e-5).sum() <= 10 and diff.max() < 1e-4, (
        (diff > 1e-5).sum(), diff.max())


def test_render_image_is_the_trace_in_block_order(opaque):
    _, pisc, _ = opaque
    cfg = RenderConfig(width=32, height=32, max_reflections=1,
                       tile_pixels=300)
    cam = Camera(position=CAM)
    img = prender.render_image_instanced(pisc, cfg, cam)
    o, d = camera_rays(cam, 32, 32, device="cpu")
    colors = prender.trace_colors_instanced(pisc, cfg, o, d)
    assert img.shape == (32, 32, 3)
    assert torch.equal(img.reshape(-1, 3), colors)
    opt = prender.render_image_instanced(
        pisc, dataclasses.replace(cfg, quantize=0), cam)
    assert not torch.equal(opt, img)  # FINAL rounds, NONE does not

