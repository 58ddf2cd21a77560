"""The dual-branch wavefront's compacted layout (``cfg.compact_wavefront``:
each level >= 1 carries only its live children, and the descent stops at
the first level with none) against the full-slot layout, which carries all
R * 2^l slots of level l.

The scenes are tests/test_torch_whitted.py's demo (a glass sphere, a mirror
torus, a textured ground) with eight panes of glass, at eight bounces, on
the CPU through the walk's plain PyTorch version.  A dead slot's colour is
exactly 0 in both layouts and its weight in the parent is 0, so frames are
equal bit for bit; gradients sum the same non-zero terms, in another order.
"""

import dataclasses

import pytest
import torch

from raytpu_torch import Intersector, Quantize, RenderConfig
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.diff.fit import render_loss
from raytpu_torch.diff.params import extract_params
from raytpu_torch.render import wavefront
from rtbench import workload
from tests.test_torch_whitted import POSE, SEEDS, demo

torch.set_num_threads(1)

W = 16
DEPTH = 8


def demo_flat(seed=SEEDS[0], panes=8):
    config = demo(seed, panes=panes)
    scenes = workload.scene_module(config)
    flat = scenes.program_scene(scenes.build(config), config, "cpu")
    assert flat.has_transparent and flat.has_dual_branch
    return flat


def layouts(quantize=Quantize.NONE, **kw):
    """RenderConfig with the compacted layout, and without."""
    cfg = RenderConfig(width=W, height=W, max_reflections=DEPTH,
                       tile_pixels=W * W, quantize=quantize,
                       intersector=Intersector.PALLAS, **kw)
    return cfg, dataclasses.replace(cfg, compact_wavefront=False)


def rays(position=POSE[0], target=POSE[1]):
    return camera_rays(Camera(position=position, target=target, aspect=1.0),
                       W, W, device="cpu")


@pytest.mark.parametrize("quantize", [Quantize.NONE, Quantize.BOUNCE,
                                      Quantize.FINAL])
def test_frame_bit_for_bit(quantize):
    flat = demo_flat()
    live, full = layouts(quantize)
    o, d = rays()
    before = wavefront.slot_counts()
    got = wavefront.render_rays(flat, live, o, d)
    carried, n_live = (a - b for a, b in zip(wavefront.slot_counts(), before))
    want = wavefront.render_rays(flat, full, o, d)
    assert torch.equal(got, want)
    assert got.abs().sum() > 0
    # The compacted levels carried their live rays alone.
    assert 0 < n_live == carried < W * W * (2 ** (DEPTH + 1) - 2)


def test_gradients_match():
    """The differentiable render: the same loss, and the same gradient of
    every field up to the order of the sums' zero terms."""
    flat = demo_flat()
    assert flat.has_textures
    fields = ("tri_v1", "textures", "mat_reflect")
    o, d = rays()
    target = torch.full((W * W, 3), 0.25)
    out = []
    for cfg in layouts():
        params = extract_params(flat, fields)
        loss = render_loss(flat, cfg, params, o, d, target)
        loss.backward()
        out.append((loss.detach(), {f: params[f].grad for f in fields}))
    (loss_a, grads_a), (loss_b, grads_b) = out
    assert torch.equal(loss_a, loss_b)
    for f in fields:
        assert grads_a[f].abs().sum() > 0, f
        torch.testing.assert_close(grads_a[f], grads_b[f], rtol=1e-6,
                                   atol=1e-7)


def test_descent_stops_without_live_rays():
    """The camera looks at the lit ground, away from the objects:
    every reflection leaves the scene, so level 1's rays all miss and no
    level after it runs, while the full-slot layout runs all nine."""
    from torch.profiler import ProfilerActivity, profile

    flat = demo_flat(panes=0)
    live, full = layouts()
    o, d = rays(position=(0.0, 3.0, 2.0), target=(0.0, 0.0, 6.0))
    sizes = []
    base = wavefront._default_query(live)

    def query(scene, origin, direction, **kw):
        sizes.append(origin.shape[0])
        return base(scene, origin, direction, **kw)

    query.supports_rows = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = wavefront.trace_colors(flat, live, o, d, query=query)
    names = {e.name for e in prof.events()}
    assert {"wavefront.level.0", "wavefront.level.1"} <= names
    assert not {f"wavefront.level.{i}" for i in range(2, DEPTH + 1)} & names
    # A nearest and a shadow query a level, none of them empty.
    assert len(sizes) == 4 and min(sizes) > 0, sizes
    assert torch.equal(got, wavefront.trace_colors(flat, full, o, d))
    assert got.abs().sum() > 0
