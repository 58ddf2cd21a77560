"""A run of each cell at a CPU test's size, the harness's look for a card
left out: sound, it comes out correct; with the timed path broken
underneath, or with the control (the reference in bfloat16) in the
program's place, it comes out not correct.

The limits are the cells' own (rtbench/limits/), set on the card at the
cells' sizes."""

import contextlib
import json
import time

import pytest
import torch

from rtbench import reference, scene, workload
from rtbench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 7
FRAME_CELLS = [("terrain1m.orbit1080", "terrain1m", "orbit1080"),
               ("inst2x2.reflect1024", "inst2x2", "reflect1024")]


def drive(cell, config, traffic, seconds=0.5):
    """run.py's run without the card: (correct, checks)."""
    run, arrays, _ = workload.run_cell(SPEC, cell, SEED, seconds, False,
                                       "cpu", time.perf_counter(),
                                       config=config, traffic=traffic)
    checks = workload.check(run, arrays, "cpu", workload.limits(cell))
    return run.items > 0 and all(v <= lim for v, lim in checks.values()), \
        checks


@contextlib.contextmanager
def patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _altered(render):
    """A block of each frame altered where the image is produced."""
    def fn(*a, **k):
        img = render(*a, **k).clone()
        img[4:12, 4:12] = 1.0 - img[4:12, 4:12]
        return img
    return fn


def _half_traced(render):
    """Half of each frame's rays left out: their pixels stay black."""
    def fn(*a, **k):
        img = render(*a, **k).clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    return fn


@pytest.mark.parametrize("cell,config,traffic", FRAME_CELLS)
@pytest.mark.parametrize("fault", [None, "altered", "half"])
def test_frame_cell(tiny, cell, config, traffic, fault):
    from raytpu_torch.render import instanced, wavefront

    c, t = tiny(config, traffic)
    mod, name = ((instanced, "render_image_instanced") if c["instances"]
                 else (wavefront, "render_image"))
    make = {None: lambda f: f, "altered": _altered, "half": _half_traced}
    with patched(mod, name, make[fault]):
        ok, checks = drive(cell, c, t)
    assert ok == (fault is None), checks


@pytest.mark.parametrize("cell,config,traffic", FRAME_CELLS)
def test_frame_control_fails(tiny, cell, config, traffic):
    c, t = tiny(config, traffic)
    arrays = scene.build(c)
    drv = workload.Frames(arrays, c, t, SEED, "cpu")
    drv.item()
    ref = reference.RefScene(arrays, "cpu", scene.world_matrix)
    nums = workload.compare_frames(drv.reference_frames(ref, torch.bfloat16),
                                   drv.reference_frames(ref))
    lim = workload.limits(cell)["bad_px_ppm"]["limit"]
    assert nums["bad_px_ppm"] > lim


def _no_update(step):
    return lambda self, closure=None: None


def _half_batch(render_loss):
    """The loss over the first half of the pixels alone, its mean taken
    over that half."""
    def fn(scene_, cfg, params, origin, direction, target, valid=None):
        h = origin.shape[0] // 2
        return render_loss(scene_, cfg, params, origin[:h], direction[:h],
                           target[:h])
    return fn


@pytest.mark.parametrize("fault", [None, "unchanged", "half"])
def test_fit_cell(tiny, fault):
    from raytpu_torch.diff import fit

    c, t = tiny("terrain1m", "fit512")
    if fault == "unchanged":
        ctx = patched(torch.optim.Adam, "step", _no_update)
    elif fault == "half":
        ctx = patched(fit, "render_loss", _half_batch)
    else:
        ctx = contextlib.nullcontext()
    arrays = scene.build(c)
    with ctx:
        drv = workload.Fit(arrays, c, t, SEED, "cpu")
        drv.warm_up()
    nums = drv.check(arrays, "cpu")
    lims = workload.limits("terrain1m.fit512")
    ok = all(v <= lims[k]["limit"] for k, v in nums.items())
    assert ok == (fault is None), nums


def test_fit_control_fails(tiny):
    c, t = tiny("terrain1m", "fit512")
    arrays = scene.build(c)
    drv = workload.Fit(arrays, c, t, SEED, "cpu")
    ref = reference.RefScene(arrays, "cpu", scene.world_matrix)
    want = drv.reference_steps(ref)
    nums = workload.compare_fit(drv.reference_steps(ref, torch.bfloat16),
                                want)
    lims = workload.limits("terrain1m.fit512")
    assert any(v > lims[k]["limit"] for k, v in nums.items()), nums
