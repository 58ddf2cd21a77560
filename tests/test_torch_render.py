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

from raytpu.config import (Intersector, Quantize, RenderConfig, RenderMode,
                           TextureFiltering, UVAddressMode)
from raytpu.core.camera import Camera as JaxCamera
from raytpu.core.camera import camera_rays as jax_camera_rays
from raytpu.diff.fit import render_loss as jax_render_loss
from raytpu.diff.params import extract_params as jax_extract_params
from raytpu.ref_oracle.tracer import render_image_oracle
from raytpu.render.wavefront import render_rays as jax_render_rays
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.core.xna import quantize_color
from raytpu_torch.diff.fit import render_loss
from raytpu_torch.diff.params import extract_params
from raytpu_torch.kernels.fused import nearest_hit_fused
from raytpu_torch.render.wavefront import (block_order_perm, render_image,
                                           render_rays)
from tests.torch_scenes import flagship, jax_bake, sphere_and_plane, t
from tests.scenes import (crate_scene, default_camera, small_cfg,
                          sphere_and_plane_scene)
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


OPTIONS_CFG = dict(width=16, height=16, max_reflections=2,
                   quantize=Quantize.NONE, intersector=Intersector.AUTO)


def _options_render(jcfg, monkeypatch, **kw):
    """The flagship (a convex glass sphere beside a crate, under 4,096
    triangles: both packages sweep it) rendered by the JAX package and by
    the port on the JAX camera's rays (tests/torch_scenes.py::
    reference_camera_rays), with ``render_image``'s keywords ``kw``."""
    from raytpu.render.wavefront import render_image as jax_render_image
    from raytpu_torch.render import supersample, wavefront
    from raytpu_torch.config import RenderConfig as TorchConfig
    from tests.torch_scenes import (reference_camera_rays,
                                    reference_screen_rays)

    monkeypatch.setattr(wavefront, "camera_rays", reference_camera_rays)
    monkeypatch.setattr(supersample, "rays_through_screen",
                        reference_screen_rays)
    jflat = jax_bake(flagship("jax"), 16)
    ref = np.asarray(jax_render_image(jflat, jcfg, JaxCamera(), **kw))
    cfg = TorchConfig.from_json(jcfg.to_json())
    return ref, cfg, to_port(jflat)


@pytest.mark.parametrize("change", [
    dict(use_multisampling=True),
    dict(render_mode=RenderMode.NORMALS),
    dict(render_mode=RenderMode.CONVEXFLAG),
])
def test_render_options_match_reference(change, monkeypatch):
    """Supersampling and the debug channels through ``render_image``, the
    JAX package's to atol 1e-5 (the flag colors exactly)."""
    jcfg = RenderConfig(**OPTIONS_CFG, **change)
    ref, cfg, flat = _options_render(jcfg, monkeypatch)
    img = render_image(flat, cfg)
    assert img.shape == (16, 16, 3) and (ref.max(-1) > 0).mean() > 0.3
    exact = cfg.render_mode.name == "CONVEXFLAG"
    np.testing.assert_allclose(img.numpy(), ref, rtol=0,
                               atol=0 if exact else 1e-5)
    if cfg.use_multisampling:
        # The supersampler reports no tiles: progress is ignored, aloud.
        with pytest.warns(UserWarning, match="ignored with use_multisampling"):
            again = render_image(flat, cfg, progress=lambda done, total: None)
        assert torch.equal(again, img)


def test_progress_and_watch_match_reference(monkeypatch, tmp_path):
    """``render_image``'s progress callback and partial frames: the same
    calls as the JAX package's, and the same partial images (written every
    second tile of 32 rays but the last), to atol 1e-5."""
    import raytpu.io.image as jimage
    import raytpu_torch.io.image as timage

    seen = {"jax": ([], []), "torch": ([], [])}
    for pkg, mod in (("jax", jimage), ("torch", timage)):
        write = mod.write_image

        def spy(path, img, pkg=pkg, write=write):
            arr = img.numpy() if isinstance(img, torch.Tensor) else img
            seen[pkg][1].append((path, np.array(arr)))
            write(path, img)

        monkeypatch.setattr(mod, "write_image", spy)

    def progress(pkg):
        return lambda done, total: seen[pkg][0].append((done, total))

    jcfg = RenderConfig(**OPTIONS_CFG, tile_pixels=32)
    kw = dict(watch_every=2)
    ref, cfg, flat = _options_render(
        jcfg, monkeypatch, progress=progress("jax"),
        watch_path=str(tmp_path / "jax.png"), **kw)
    img = render_image(flat, cfg, progress=progress("torch"),
                       watch_path=str(tmp_path / "torch.png"), **kw)
    assert seen["torch"][0] == seen["jax"][0] == [(i, 8) for i in range(1, 9)]
    parts, ref_parts = seen["torch"][1], seen["jax"][1]
    assert len(parts) == len(ref_parts) == 3
    for (_, got), (_, want) in zip(parts, ref_parts):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-5)
    assert torch.equal(img, render_image(flat, cfg))


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


# The NumPy oracle's cases (tests/test_oracle.py) at 16x16: the scene, the
# settings and the least share of pixels that must equal the oracle's
# exactly.  Held as test_oracle.py holds the JAX renderer: byte-quantized
# images, every other pixel within a few byte steps (silhouette pixels may
# flip hit or miss between float32 and the oracle's float64 scalar math;
# refraction bends more of them).
ORACLE_TEXTURE = lambda: crate_scene(uv_scale=2.5, uv_offset=-0.75)  # noqa: E731
ORACLE_CASES = {
    "primary": (sphere_and_plane_scene, dict(max_reflections=0), 0.99),
    "reflections": (lambda: sphere_and_plane_scene(reflect=0.6),
                    dict(max_reflections=2), 0.99),
    **{f"texture-{f.name.lower()}-{a.name.lower()}": (
        ORACLE_TEXTURE, dict(max_reflections=1, filtering=f,
                             address_mode=a), 0.99)
       for f in (TextureFiltering.POINT, TextureFiltering.BILINEAR)
       for a in (UVAddressMode.CLAMP, UVAddressMode.WRAP,
                 UVAddressMode.MIRROR)},
    "transparent": (lambda: sphere_and_plane_scene(transparent=True),
                    dict(max_reflections=2), 0.97),
    "directional": (lambda: sphere_and_plane_scene(light="directional"),
                    dict(max_reflections=1), 0.99),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_render_matches_oracle(case):
    """The port's CPU render of the oracle's scenes (the JAX bake, through
    the bridge) against ``render_image_oracle``."""
    build, change, min_exact = ORACLE_CASES[case]
    cfg = small_cfg(width=16, height=16, tile_pixels=256,
                    quantize=Quantize.BOUNCE, **change)
    flat = build().flatten(leaf_threshold=16, max_depth=8)
    want = render_image_oracle(flat, cfg, default_camera())
    got = render_image(to_port(flat), cfg,
                       Camera(position=(0.0, 16.0, 32.0))).numpy()
    assert got.shape == want.shape == (16, 16, 3)
    assert (want.max(-1) > 0).any()  # not a black image
    exact = np.all(np.abs(got - want) < 1e-6, axis=-1).mean()
    assert exact >= min_exact, f"only {exact:.3%} pixels exact"
    assert np.abs(got - want).max() <= 3.0 / 255.0 + 1e-6
