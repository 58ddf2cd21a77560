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
from raytpu.render.wavefront import render_rays as jax_render_rays
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.core.xna import quantize_color
from raytpu_torch.render.wavefront import (block_order_perm, render_image,
                                           render_rays)
from tests.torch_scenes import jax_bake, sphere_and_plane, t, terrain
from tests.torch_scenes import to_port

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
    """``cull_pretest`` and ``cull_recull`` change the walk's shape, never
    its hits: the same colors bit for bit."""
    name, cfg, _, (o, d), _, colors = rendered
    build, csize, _, _ = CASES[name]
    flat = build("torch").flatten(device="cpu", cluster_size=csize)
    opt = dataclasses.replace(cfg, cull_pretest=True, cull_recull=2)
    assert torch.equal(render_rays(flat, opt, o, d), colors)


@pytest.mark.parametrize("change", [
    dict(use_multisampling=True),
    dict(render_mode=RenderMode.NORMALS),
    dict(differentiable=True),
    dict(shadow_clearance=True),
    dict(intersector=Intersector.BRUTE),
    dict(intersector=Intersector.TILED),
    dict(intersector=Intersector.OCTREE),
    dict(cull_nbuf=2),
    dict(cull_chunk=2),
    dict(cull_phase1=4),
    dict(cull_prepick=8),
    dict(tri_block=1024),
    dict(brute_force_max_tris=0),
])
def test_unported_config_raises(change):
    flat = sphere_and_plane("torch").flatten(device="cpu", cluster_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        render_image(flat, dataclasses.replace(CFG, **change))


def test_unported_scene_and_entry_points_raise():
    glass = sphere_and_plane("torch", transparent=True).flatten(
        device="cpu", cluster_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        render_image(glass, CFG)
    flat = sphere_and_plane("torch").flatten(device="cpu", cluster_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        render_image(flat, CFG, progress=lambda done, total: None)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sphere_and_plane("torch").flatten(device="cpu", cluster_size=64)
