"""The port's Whitted render of the reference engine's demo (a glass sphere,
a mirror torus, a textured ground: rtbench/configs/refdemo.json) against
the plain Whitted reference (rtbench/reference_whitted.py), on the CPU at
32x32 pixels and eight bounces, through the walk's plain PyTorch version
(``PALLAS``, the query the benchmark's cell takes on the card).

The scenes are the demo at a coarse tessellation, with the materials drawn
from a seed around the demo's.  In the demo a ray tree seldom runs past
six levels (every unlit hit ends its reflection), so the depth-8 cases
add eight panes of the sphere's glass in front of the objects, tilted to
face the camera: rays near their normal pass all eight, and the ninth hit
decides their colour.

Tolerances: a pixel is off when a channel differs by more than ``ATOL``
= 1e-4, and at most ``OFF_SHARE`` = 0.5% of the pixels may be off.  Both
compute in float32, but the port sums a pixel's terms (up to 2^9 of them)
from the deepest level up and the reference from the primary ray down,
and the walk finds t, u and v by other arithmetic than the reference's
Moller-Trumbore: on these scenes they differ by at most 2e-5.  The share
leaves room for rays that graze an edge shared by two triangles, which
either may take.  Each case also holds the reference with one part of
the mathematics left out (one bounce fewer, the refraction child dropped,
the texture ignored, opaque shadow occluders) to the same tolerances, and
requires it to fail them.
"""

import copy

import numpy as np
import pytest
import torch

from raytpu_torch import Intersector, Quantize, RenderConfig
from raytpu_torch.core.camera import Camera
from raytpu_torch.render import wavefront
from raytpu_torch.render.wavefront import render_image
from rtbench import reference, reference_whitted, workload

torch.set_num_threads(1)

W = 32
ATOL = 1e-4
OFF_SHARE = 0.005
POSE = ((0.0, 5.0, 13.0), (0.0, 1.5, 0.0))    # the demo's camera
SEEDS = [2**31 + 11, 7, 1234]


def demo(seed, panes=0, **material):
    """The demo's configuration, coarse, its materials drawn from ``seed``
    around the demo's; ``panes`` panes of the sphere's glass in front;
    ``material`` overrides the sphere's material."""
    rng = np.random.default_rng(seed)
    c = workload.load("configs", "refdemo")
    sphere, torus, ground = c["objects"]
    sphere["mesh"].update(stacks=8, slices=16)
    torus["mesh"].update(rings=12, sides=8)
    sphere["material"].update({
        "diffuse_color": [255, 0, 0, int(rng.integers(80, 121))],
        "reflectiveness": float(rng.uniform(0.6, 0.8)),
        "refraction_index": float(rng.uniform(1.25, 1.4)), **material})
    torus["material"]["reflectiveness"] = float(rng.uniform(0.6, 0.8))
    ground["material"]["reflectiveness"] = float(rng.uniform(0.4, 0.6))
    for k in range(panes):
        c["objects"].append(dict(
            copy.deepcopy(sphere), name=f"pane{k}", convex=False, scale=1.5,
            mesh={"kind": "plane", "size": [2.0, 2.0], "uv_scale": 1.0},
            position=[0.0, 2.5, 4.0 + 0.5 * k],
            rotation_degrees=[70.0, 0.0, 0.0]))
    return c


def render_both(config, depth=8):
    """(the port's image, the reference scene, its primary rays), the
    image (W*W, 3) float32 in the reference's raster order."""
    scenes = workload.scene_module(config)
    arrays = scenes.build(config)
    flat = scenes.program_scene(arrays, config, "cpu")
    cfg = RenderConfig(width=W, height=W, max_reflections=depth,
                       tile_pixels=W * W, quantize=Quantize.NONE,
                       intersector=Intersector.PALLAS)
    img = render_image(flat, cfg, Camera(position=POSE[0], target=POSE[1],
                                         aspect=1.0))
    ref = scenes.reference(arrays, "cpu")
    o, d = reference.camera_rays(*POSE, W, W, "cpu")
    return flat, img.reshape(-1, 3), ref, o, d


def off(a, b) -> int:
    return int(((a - b).abs().amax(-1) > ATOL).sum())


def check(img, ref, o, d, faults, depth=8):
    """The port within the tolerances; the reference with each fault
    outside them."""
    want = reference_whitted.trace(ref, o, d, depth)
    assert off(img, want) <= OFF_SHARE * W * W, off(img, want)
    for kw in faults:
        bad = reference_whitted.trace(ref, o, d, depth, **kw)
        assert off(bad, want) > OFF_SHARE * W * W, (kw, off(bad, want))


@pytest.mark.parametrize("seed", SEEDS)
def test_depth8_dual_branch(seed):
    flat, img, ref, o, d = render_both(demo(seed, panes=8))
    assert flat.has_dual_branch
    check(img, ref, o, d, [{"bounces": -1}, {"refraction": False}])


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_depth8_merged(seed):
    """The glass without reflection: one live child a parent, in the
    parent's slot."""
    c = demo(seed, panes=8, reflectiveness=0.0)
    flat, img, ref, o, d = render_both(c)
    assert flat.has_transparent and not flat.has_dual_branch
    check(img, ref, o, d, [{"bounces": -1}, {"refraction": False}])


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_transparent_shadow_occluders(seed):
    """The sphere's shadow on the ground lets 1 - alpha of the light
    through."""
    _, img, ref, o, d = render_both(demo(seed))
    check(img, ref, o, d, [{"transparent_shadows": False}])


def _total_internal_reflections(ref, o, d):
    """Primary rays whose refraction into the glass is totally reflected
    (the engine's ratio ior / 1 on entry)."""
    _, tri = reference_whitted.nearest(ref, o, d)
    glass = (tri >= 0) & ref.transparent[ref.mesh[tri.clamp(min=0)]]
    idx = glass.nonzero().squeeze(1)
    g = tri[idx]
    u, v = reference_whitted._barycentrics(ref, o[idx], d[idx], g,
                                           torch.float32)
    n = ref.normals[g]
    normal = reference.normalize(n[:, 0] + (n[:, 1] - n[:, 0]) * u[:, None]
                                 + (n[:, 2] - n[:, 0]) * v[:, None])
    cos1 = reference.dot(normal, -d[idx])
    ratio = ref.ior[ref.mesh[g]]
    return int((1.0 - ratio * ratio * (1.0 - cos1 * cos1) < 0.0).sum())


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_total_internal_reflection(seed):
    """Near the sphere's silhouette the refraction is totally reflected and
    its branch ends; the rest of the sphere refracts."""
    _, img, ref, o, d = render_both(demo(seed))
    assert _total_internal_reflections(ref, o, d) > 0
    check(img, ref, o, d, [{"refraction": False}])


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_point_sampled_wrap_texture(seed):
    """The checker on the ground at UVs up to 3, wrapped and point-sampled
    (the engine's ``(int)(u * (W - 1))``)."""
    c = demo(seed)
    c["objects"][2]["mesh"]["uv_scale"] = 3.0
    _, img, ref, o, d = render_both(c)
    check(img, ref, o, d, [{"texture": False}])


def test_level_spans_and_slot_counts():
    """Each level runs in its span, the selection of the live children and
    the combine in theirs, and the levels >= 1 count their slots and the
    live ones among them."""
    from torch.profiler import ProfilerActivity, profile

    c = demo(SEEDS[0], panes=8)
    before = wavefront.slot_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_both(c, depth=3)
    carried, live = (a - b for a, b in zip(wavefront.slot_counts(), before))
    names = {e.name for e in prof.events()}
    assert {f"wavefront.level.{i}" for i in range(4)} <= names
    assert {"wavefront.compact", "wavefront.combine"} <= names
    # Dual-branch doubling gives level l W * W * 2^l child slots, of which
    # it carries the live ones alone.
    assert 0 < live == carried <= W * W * (2 + 4 + 8)
