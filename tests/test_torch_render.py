"""The port's forward render (raytpu_torch/render/wavefront.py) against the
JAX package's renderer with ``Intersector.PALLAS`` (its fused kernel in
interpret mode), on the CPU.

Both trace the same primary rays, the reference camera's rays in
square-block order, as ``render_image`` orders them; the cameras are held
to each other in test_torch_core.py.  Tolerance atol=1e-5: the reference's
own PALLAS and TILED renders of these scenes differ by 1.7e-6, and the port
differs from it in the last bits of t/u/v because XLA contracts a*b+c into
FMAs inside the reference and the port does not.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytpu.config import Intersector, Quantize, RenderConfig, RenderMode
from raytpu.core.camera import Camera as JaxCamera
from raytpu.core.camera import camera_rays as jax_camera_rays
from raytpu.diff.fit import render_loss as jax_render_loss
from raytpu.diff.params import extract_params as jax_extract_params
from raytpu.render.wavefront import render_rays as jax_render_rays
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.core.xna import quantize_color
from raytpu_torch.diff.fit import render_loss
from raytpu_torch.diff.params import extract_params
from raytpu_torch.kernels.fused import nearest_hit_fused
from raytpu_torch.render.wavefront import (block_order_perm, render_image,
                                           render_rays)
from tests.torch_scenes import flagship, jax_bake, sphere_and_plane, t
from tests.torch_scenes import terrain, to_port

torch.set_num_threads(1)

CFG = RenderConfig(width=32, height=32, max_reflections=2,
                   quantize=Quantize.NONE, tile_pixels=32 * 32,
                   intersector=Intersector.PALLAS)

# (scene, cluster size, max_reflections, camera position).  The "both"
# camera sits off the scene's symmetry plane x = 0: a pixel column in that
# plane hits the sphere exactly on a meridian edge, where the reference's
# FMA-contracted arithmetic and the port's unfused arithmetic accept
# different triangles for the directional shadow ray
# (test_torch_kernels.py::test_edge_grazing_shadow_ray_follows_brute_force).
CASES = {
    "spot": (lambda p: sphere_and_plane(p, textured=True, light="spot"), 16,
             2, (0.0, 16.0, 32.0)),
    "both": (lambda p: sphere_and_plane(p, textured=True, light="both"), 128,
             2, (3.0, 16.0, 32.0)),
    "terrain": (lambda p: terrain(p), 128, 0, (0.0, 28.0, 34.0)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def rendered(request):
    build, csize, refl, position = CASES[request.param]
    cfg = dataclasses.replace(CFG, max_reflections=refl)
    jflat = jax_bake(build("jax"), csize)
    # One jitted program per reference call (an XLA CPU process crashes
    # after ~150 compiles, run_tests.py).
    o, d = jax.jit(lambda: jax_camera_rays(JaxCamera(position=position),
                                           32, 32))()
    perm = block_order_perm(32, 32, 16, "cpu").numpy()
    o, d = np.asarray(o)[perm], np.asarray(d)[perm]
    ref = np.asarray(jax.jit(lambda s, o, d: jax_render_rays(s, cfg, o, d))(
        jflat, o, d))
    colors = render_rays(to_port(jflat), cfg, t(o), t(d))
    return request.param, cfg, position, (t(o), t(d)), ref, colors


def test_render_matches_reference(rendered):
    _, _, _, _, ref, colors = rendered
    assert colors.shape == (32 * 32, 3) and colors.dtype == torch.float32
    assert not torch.isnan(colors).any()
    assert (ref.max(-1) > 0).mean() > 0.3  # a real image, not a black one
    np.testing.assert_allclose(colors.numpy(), ref, rtol=0, atol=1e-5)


def test_render_image_is_render_rays_in_block_order(rendered):
    name, cfg, position, _, _, _ = rendered
    build, csize, _, _ = CASES[name]
    flat = build("torch").flatten(device="cpu", cluster_size=csize)
    cam = Camera(position=position)
    img = render_image(flat, cfg, cam)
    o, d = camera_rays(cam, 32, 32, device="cpu")
    perm = block_order_perm(32, 32, 16, "cpu")
    colors = render_rays(flat, cfg, o[perm], d[perm])
    assert img.shape == (32, 32, 3)
    assert torch.equal(img.reshape(-1, 3)[perm], colors)


def test_own_bake_renders_like_bridge(rendered):
    """The port's own bake gives the bridged scene's colors bit for bit, and
    Quantize.FINAL rounds them."""
    name, cfg, _, (o, d), _, colors = rendered
    build, csize, _, _ = CASES[name]
    flat = build("torch").flatten(device="cpu", cluster_size=csize)
    assert torch.equal(render_rays(flat, cfg, o, d), colors)
    final = render_rays(flat, dataclasses.replace(cfg, quantize=Quantize.FINAL),
                        o, d)
    assert torch.equal(final, quantize_color(colors))


def test_walk_opt_ins_render_the_same_image(rendered):
    """``cull_pretest`` and ``cull_recull``, and ``cull_chunk`` (two
    clusters a trip, in the same pick order), change the walk's shape,
    never its hits: the same colors bit for bit."""
    name, cfg, _, (o, d), _, colors = rendered
    build, csize, _, _ = CASES[name]
    flat = build("torch").flatten(device="cpu", cluster_size=csize)
    for change in (dict(cull_pretest=True, cull_recull=2),
                   dict(cull_chunk=2)):
        opt = dataclasses.replace(cfg, **change)
        assert torch.equal(render_rays(flat, opt, o, d), colors), change


@pytest.mark.parametrize("change", [
    dict(use_multisampling=True),
    dict(render_mode=RenderMode.NORMALS),
    dict(render_mode=RenderMode.CONVEXFLAG),
])
def test_unported_config_raises(change):
    flat = sphere_and_plane("torch").flatten(device="cpu", cluster_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        render_image(flat, dataclasses.replace(CFG, **change))


def test_unported_scene_and_entry_points_raise():
    """What the renderer still refuses: ``render_image``'s progress and
    watch options."""
    flat = sphere_and_plane("torch").flatten(device="cpu", cluster_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        render_image(flat, CFG, progress=lambda done, total: None)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        render_image(flat, CFG, watch_path="frame.png")


@pytest.mark.parametrize("change", [dict(cull_prepick=8),
                                    dict(cull_phase1=2),
                                    dict(cull_phase1=2, cull_pretest=True,
                                         cull_recull=2),
                                    dict(cull_prepick=8, cull_nbuf=2)])
def test_render_with_overflow_strategies(change):
    """A render through the prepick walk or the phase-1 compaction
    (test_torch_overflow.py) is the default render; the settings the
    prepick walk refuses raise ``ValueError`` from the render too."""
    cfg = dataclasses.replace(CFG, width=24, height=24, tile_pixels=24 * 24,
                              cull_tile=64)
    flat = sphere_and_plane("torch", textured=True, light="both").flatten(
        device="cpu", cluster_size=16)
    cam = Camera(position=(3.0, 16.0, 32.0))
    base = render_image(flat, cfg, cam)
    img = render_image(flat, dataclasses.replace(cfg, **change), cam)
    assert (base.max(-1).values > 0).float().mean() > 0.3
    assert torch.equal(img, base)
    if "cull_prepick" in change:
        with pytest.raises(ValueError, match="prepick"):
            render_image(flat, dataclasses.replace(
                cfg, cull_pretest=True, **change), cam)


# Transparent scenes, baked at cluster_size 32 (subclusters): the merged
# layout (a transparent sphere that does not reflect over a reflective
# ground: at most one live child per parent) and the dual-branch flagship
# twin (its glass both reflects and refracts).  The point is the shading,
# so the reference renders with its exact XLA intersector (TILED, three
# times faster to compile than its Pallas kernel, which it agrees with to
# ~1e-6 here); the subcluster walk is held to the Pallas kernel in
# test_torch_subcluster.py.  Tolerance atol 1e-5, as above.
TRANSPARENT = {
    "merged": (lambda p: sphere_and_plane(p, reflect=0.0, transparent=True,
                                          plane_reflect=0.3, light="both"),
               (3.0, 16.0, 32.0)),
    "flagship": (flagship, (0.0, 16.0, 32.0)),
}
TCFG = dataclasses.replace(CFG, width=16, height=16, tile_pixels=16 * 16,
                           cull_tile=64, max_reflections=2)
JCFG = dataclasses.replace(TCFG, intersector=Intersector.TILED)


def _transparent_case(name, size):
    build, position = TRANSPARENT[name]
    jflat = jax_bake(build("jax"), 32)
    o, d = jax.jit(lambda: jax_camera_rays(JaxCamera(position=position),
                                           size, size))()
    perm = block_order_perm(size, size, 8, "cpu").numpy()
    return build, jflat, np.asarray(o)[perm], np.asarray(d)[perm]


@pytest.mark.parametrize("name", sorted(TRANSPARENT))
def test_transparent_render_matches_reference(name):
    """Baked transparency (queue 1 item 1): shadows through transparent
    occluders, the refraction children and the merged or dual-branch
    level layout, against the JAX render; the port's own bake renders the
    same colors bit for bit."""
    build, jflat, o, d = _transparent_case(name, 16)
    assert jflat.has_transparent
    assert jflat.has_dual_branch == (name == "flagship")
    ref = np.asarray(jax.jit(lambda s, o, d: jax_render_rays(s, JCFG, o, d))(
        jflat, o, d))
    colors = render_rays(to_port(jflat), TCFG, t(o), t(d))
    assert (ref.max(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(colors.numpy(), ref, rtol=0, atol=1e-5)
    own = build("torch").flatten(device="cpu", cluster_size=32)
    assert torch.equal(render_rays(own, TCFG, t(o), t(d)), colors)


def test_transparent_gradients_match_reference():
    """Gradients of the flagship twin's loss (the dryrun's fields and
    ``soft_tau``, one reflection) against the JAX package's, rtol 1e-4 and
    atol 1e-6 as in test_torch_diff.py.  The reference's vertex
    gradients are NaN where a ray that cannot hit (a dead lane, or the
    refraction child of a total internal reflection: NaN direction) meets
    a zero cotangent (ROADMAP.md queue 3); the port's are finite
    everywhere and are compared where the reference's are."""
    cfg = dataclasses.replace(TCFG, max_reflections=1, differentiable=True,
                              soft_tau=0.01)
    fields = ("tri_v1", "textures", "mat_reflect")
    _, jflat, o, d = _transparent_case("flagship", 16)
    target = np.random.default_rng(6).uniform(0, 1, (256, 3)).astype(
        np.float32)
    jcfg = dataclasses.replace(cfg, intersector=Intersector.TILED)
    jgrad = jax.jit(jax.grad(lambda p: jax_render_loss(
        jflat, jcfg, p, o, d, target)))(jax_extract_params(jflat, fields))
    params = extract_params(to_port(jflat), fields)
    render_loss(to_port(jflat), cfg, params, t(o), t(d), t(target)).backward()
    for k in fields:
        g, ref = params[k].grad.numpy(), np.asarray(jgrad[k])
        assert np.isfinite(g).all(), k
        sure = np.isfinite(ref)
        assert sure.mean() > 0.5
        np.testing.assert_allclose(g[sure], ref[sure], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
