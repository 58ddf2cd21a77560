"""The port's adaptive supersampling (raytpu_torch/render/supersample.py),
debug channels and debug ray paths (render/debug.py) against the JAX
package's, on the CPU.

Both packages trace the same rays: the port's rays through the screen are
patched to the JAX camera's (tests/torch_scenes.py::reference_screen_rays),
since the two invert the camera with different LAPACK routines.  The
scenes stay under 4,096 triangles, so ``AUTO`` sweeps them by brute force
in both packages.

Tolerances: colors at ``Quantize.NONE`` to atol 1e-5, as
test_torch_render.py holds them (XLA contracts a*b+c into FMAs inside the
reference, the port does not).  Under the default quantization every pixel
that differs differs by one byte step, and the port's own values for that
pixel show why: an unquantized corner color or quadrant average within
1e-5 of a rounding boundary, or a corner's length deviation within 1e-5 of
the subdivision threshold.  Debug segments: ids, levels, kinds and hit
flags exactly, points to atol 1e-4 (rtol 1e-5).  Drawn pixels exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu.core.camera import Camera as JaxCamera
from raytpu.render import debug as jdebug
from raytpu.render import supersample as jsupersample
from raytpu.render import wavefront as jwavefront
from raytpu_torch.config import Quantize, RenderConfig, RenderMode
from raytpu_torch.core.camera import Camera
from raytpu_torch.core.xna import quantize_color
from raytpu_torch.render import debug as tdebug
from raytpu_torch.render import supersample as tsupersample
from raytpu_torch.render.supersample import (render_image_multisampled,
                                             supersample_colors)
from raytpu_torch.render.wavefront import (debug_mode_colors, render_image,
                                           trace_colors)
from tests.torch_scenes import (flagship, jax_bake, reference_screen_rays,
                                sphere_and_plane, t, to_port)

torch.set_num_threads(1)

CAMERA = (0.0, 16.0, 32.0)
# 12x10 pixels: neither quality's batch (tile_pixels // (4 * 4^q) = 28 and
# 7 quadrants) divides the 120 pixels, so the last batch has a padded tail.
BASE = dict(width=12, height=10, max_reflections=2, tile_pixels=448,
            use_multisampling=True, quantize="NONE")


def configs(**kw):
    """The same settings as the port's and the JAX package's RenderConfig."""
    kw = {**BASE, **kw}
    q = kw.pop("quantize")
    mode = kw.pop("render_mode", "SHADED")
    return (RenderConfig(quantize=Quantize[q], render_mode=RenderMode[mode],
                         **kw),
            jconfig.RenderConfig(quantize=jconfig.Quantize[q],
                                 render_mode=jconfig.RenderMode[mode], **kw))


@pytest.fixture(scope="module")
def scenes():
    """(JAX bake, the port's scene through the bridge) of the textured
    sphere scene, the glass one (a dual-branch material) and the
    flagship (a convex glass sphere beside a crate)."""
    built = {
        "opaque": sphere_and_plane("jax", reflect=0.5, textured=True),
        "glass": sphere_and_plane("jax", reflect=0.3, transparent=True),
        "flagship": flagship("jax"),
    }
    out = {}
    for name, scene in built.items():
        jflat = jax_bake(scene, 16)
        out[name] = (jflat, to_port(jflat))
    return out


@pytest.fixture
def same_rays(monkeypatch):
    """The port's screen rays are the JAX camera's."""
    monkeypatch.setattr(tsupersample, "rays_through_screen",
                        reference_screen_rays)
    monkeypatch.setattr(tdebug, "rays_through_screen", reference_screen_rays)


def _multisampled(scenes, name, **kw):
    cfg, jcfg = configs(**kw)
    jflat, flat = scenes[name]
    ref = np.asarray(jsupersample.render_image_multisampled(
        jflat, jcfg, JaxCamera(position=CAMERA)))
    return cfg, flat, ref, render_image(flat, cfg, Camera(position=CAMERA))


@pytest.mark.parametrize("quality,lr_bug", [(1, False), (1, True),
                                            (2, False), (2, True)])
def test_multisampled_matches_reference(scenes, same_rays, quality, lr_bug):
    cfg, flat, ref, img = _multisampled(
        scenes, "opaque", multisample_quality=quality,
        replicate_lr_bug=lr_bug)
    assert img.shape == (10, 12, 3) and not torch.isnan(img).any()
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-5)
    # Quadrants did subdivide: the image is not the four-corner average.
    flat0 = render_image(flat, dataclasses.replace(cfg, multisample_quality=0),
                         Camera(position=CAMERA))
    assert (img - flat0).abs().max() > 1e-3


def _explained(flat, cfg, px, py):
    """Whether the port's own values for pixel (px, py) at quality 1 lie
    within 1e-5 of a rounding boundary (corner colors, quadrant averages)
    or of the subdivision threshold (corner length deviations)."""
    none = dataclasses.replace(cfg, quantize=Quantize.NONE)
    off = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0], [1.0, 1.0]])
    c0 = torch.tensor([[float(px), float(py)]]) + 0.25 * off
    c1 = (c0[:, None, :] + 0.125 * off[None]).reshape(-1, 2)
    cam = Camera(position=CAMERA)

    def colors(c):
        o, d = reference_screen_rays(cam, cfg.width, cfg.height, c[:, 0],
                                     c[:, 1])
        return trace_colors(flat, none, o, d)

    u0, u1 = colors(c0), colors(c1)
    q0, q1 = quantize_color(u0), quantize_color(u1).reshape(4, 4, 3)
    lengths = torch.sqrt((q0 * q0).sum(-1))
    mean = q0.mean(0)
    dev = (torch.sqrt((mean * mean).sum()) - lengths).abs()
    child = quantize_color(q1.mean(1))
    used = dev > cfg.multisample_threshold
    combined = torch.where(used[:, None], child, q0).mean(0)
    values = torch.cat([u0.reshape(-1), u1.reshape(-1), q1.mean(1).reshape(-1),
                        combined])
    steps = values * 255.0
    near_round = ((steps - steps.floor() - 0.5).abs() < 255.0 * 1e-5).any()
    near_threshold = ((dev - cfg.multisample_threshold).abs() < 1e-5).any()
    return bool(near_round or near_threshold)


def test_quantized_multisampled_differs_only_at_rounding(scenes, same_rays):
    cfg, flat, ref, img = _multisampled(scenes, "opaque", quantize="FINAL",
                                        width=16, height=16)
    # Compared as bytes: XLA divides by 255 as a multiplication by its
    # rounded reciprocal, one ulp off the port's division.
    diff = np.abs(np.rint(img.numpy() * 255) - np.rint(ref * 255)).max(-1)
    assert diff.max() <= 1 and (ref.max(-1) > 0).mean() > 0.3
    for py, px in zip(*np.nonzero(diff)):
        assert _explained(flat, cfg, px, py), (px, py)


def test_supersample_colors_of_dead_quadrants(scenes, same_rays):
    """``supersample_colors`` on quadrant centers of its own choosing, some
    dead: the live ones are the reference's, the dead ones black."""
    cfg, jcfg = configs(width=16, height=16, multisample_quality=1)
    jflat, flat = scenes["glass"]
    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 16, 24).astype(np.float32)
    cy = rng.uniform(0, 16, 24).astype(np.float32)
    alive = rng.uniform(size=24) < 0.7
    ref = np.asarray(jax.jit(
        lambda x, y, a: jsupersample.supersample_colors(
            jflat, jcfg, JaxCamera(position=CAMERA), x, y, alive=a))(
                cx, cy, alive))
    got = supersample_colors(flat, cfg, Camera(position=CAMERA), t(cx), t(cy),
                             t(alive))
    np.testing.assert_allclose(got.numpy()[alive], ref[alive], rtol=0,
                               atol=1e-5)
    assert (got[~t(alive)] == 0).all()


def test_smooth_region_matches_single_sample(scenes):
    """The reference's own check (tests/test_debug_and_aa.py): where the
    four corners agree no quadrant subdivides, and the image stays close
    to the single-sample render."""
    cfg, _ = configs(width=16, height=16, max_reflections=0)
    flat = scenes["opaque"][1]
    cam = Camera(position=CAMERA)
    img1 = render_image(flat, dataclasses.replace(cfg, use_multisampling=False),
                        cam)
    img4 = render_image_multisampled(flat, cfg, cam)
    assert img4.shape == img1.shape
    assert float((img1 - img4).abs().amax(-1).median()) < 0.08


def test_quality_zero_is_the_four_corner_average(scenes):
    cfg, _ = configs(width=8, height=8, multisample_quality=0)
    flat = scenes["opaque"][1]
    cam = Camera(position=CAMERA)
    img = render_image(flat, cfg, cam)
    ys, xs = torch.meshgrid(torch.arange(8.0), torch.arange(8.0),
                            indexing="ij")
    off = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0], [1.0, 1.0]])
    sx = (xs.reshape(-1, 1) + 0.25 * off[:, 0]).reshape(-1)
    sy = (ys.reshape(-1, 1) + 0.25 * off[:, 1]).reshape(-1)
    o, d = tsupersample.rays_through_screen(cam, 8, 8, sx, sy)
    corners = trace_colors(flat, cfg, o, d).reshape(-1, 4, 3)
    assert torch.equal(img.reshape(-1, 3), corners.mean(1))


@pytest.mark.parametrize("mode", ["NORMALS", "CONVEXFLAG"])
def test_debug_mode_colors_match_reference(scenes, mode):
    cfg, jcfg = configs(render_mode=mode, use_multisampling=False)
    jflat, flat = scenes["flagship"]
    sx, sy = np.mgrid[0:16, 0:16][::-1].reshape(2, -1).astype(np.float32)
    o, d = jax.jit(jsupersample.rays_through_screen, static_argnums=(0, 1, 2))(
        JaxCamera(position=CAMERA), 16, 16, sx, sy)
    ref = np.asarray(jax.jit(
        lambda o, d: jwavefront.debug_mode_colors(jflat, jcfg, o, d))(o, d))
    got = debug_mode_colors(flat, cfg, t(o), t(d))
    assert (ref.max(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 if mode == "NORMALS" else 0)
    if mode == "CONVEXFLAG":
        hit = got.amax(-1) > 0
        green = (got == got.new_tensor([0.0, 128 / 255, 0.0])).all(-1)
        red = (got == got.new_tensor([1.0, 0.0, 0.0])).all(-1)
        assert green.any() and red.any() and torch.equal(hit, green | red)


@pytest.fixture
def jax_debug_levels(monkeypatch):
    """The JAX package's ``_trace_level`` jitted, one program a level,
    while its ``cast_ray_debug`` runs (eager JAX compiles one program an
    op)."""
    jitted = jax.jit(jwavefront._trace_level, static_argnums=(1, 3),
                     static_argnames=("capture_hits",))
    monkeypatch.setattr(
        jdebug, "_trace_level",
        lambda scene, cfg, rays, is_max, capture_hits=False: jitted(
            scene, cfg, rays, is_max, capture_hits=capture_hits))
    monkeypatch.setattr(jdebug, "rays_through_screen",
                        jax.jit(jdebug.rays_through_screen,
                                static_argnums=(0, 1, 2)))


def _same_path(got, ref):
    for f in ("ray", "level", "kind", "hit", "tri"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    for f in ("start", "end"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["opaque", "glass"])
def test_cast_ray_debug_matches_reference(scenes, same_rays,
                                          jax_debug_levels, name):
    """A 4x4 batch and the center pixel (``cast_screen_ray``); the glass
    scene's paths take both refraction branches."""
    cfg, jcfg = configs(use_multisampling=False, width=32, height=32)
    jflat, flat = scenes[name]
    jcam, cam = JaxCamera(position=CAMERA), Camera(position=CAMERA)
    sx, sy = np.mgrid[6:26:5, 6:26:5][::-1].reshape(2, -1).astype(np.float32)
    o, d = jdebug.rays_through_screen(jcam, 32, 32, sx, sy)
    _same_path(tdebug.cast_ray_debug(flat, cfg, t(o), t(d)),
               jdebug.cast_ray_debug(jflat, jcfg, o, d))
    ref = jdebug.cast_screen_ray(jflat, jcfg, jcam)
    got = tdebug.cast_screen_ray(flat, cfg, cam)
    _same_path(got, ref)
    assert got.hit[got.kind == tdebug.PRIMARY].all()
    if name == "glass":
        assert {tdebug.REFLECTION, tdebug.REFRACTION} <= set(got.kind.tolist())


def test_draw_aabbs_and_ray_path_match_reference(scenes, jax_debug_levels):
    """The same boxes (one of them partly behind the camera) and the same
    captured path drawn by both packages: the same pixels."""
    jflat, _ = scenes["glass"]
    jcfg = configs(use_multisampling=False, width=32, height=32)[1]
    jcam, cam = JaxCamera(position=CAMERA), Camera(position=CAMERA)
    rng = np.random.default_rng(1)
    image = rng.uniform(size=(24, 32, 3)).astype(np.float32)
    bmin = np.array([[-4.0, 0.0, -4.0], [-20.0, -0.1, -20.0],
                     [-2.0, 10.0, 25.0]], np.float32)
    bmax = np.array([[4.0, 8.0, 4.0], [20.0, 0.1, 20.0],
                     [2.0, 20.0, 40.0]], np.float32)
    ref = jdebug.draw_aabbs(image, jcam, bmin, bmax)
    got = tdebug.draw_aabbs(t(image), cam, bmin, bmax)
    assert (ref != image).any()
    np.testing.assert_array_equal(got, ref)
    path = jdebug.cast_screen_ray(jflat, jcfg, jcam)
    ref = jdebug.draw_ray_path(image, jcam, path)
    got = tdebug.draw_ray_path(image, cam, tdebug.RayPath(*path))
    assert (ref != image).any()
    np.testing.assert_array_equal(got, ref)
