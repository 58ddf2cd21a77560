"""The reference demo's cell (``refdemo.orbit512d8``): its scene and mix by
name, the scene's arrays pinned, the turntable's frames the same for every
seed, the Whitted reference's imports, the program's span and counter
readers, and a run of the cell at a CPU test's size: sound, it comes out
correct; with the control or with a planted fault in the program's place,
it does not."""

import ast
import hashlib
import json
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from rtbench import program_spans, workload
from rtbench.run import load_metric
from rtbench.tests.conftest import ROOT

HERE = ROOT / "rtbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL, CONFIG, TRAFFIC = "refdemo.orbit512d8", "refdemo", "orbit512d8"
SEED = 2**31 + 7
# Hash of the scene's arrays at the configuration's sizes (taken when the
# configuration was added).
PINNED = "7a819d7c898cc8549795b25aa8e28cd0b50b482c21259d1ccf513f64bf762264"


def small(width=48, height=48):
    """The cell cut to a CPU test's size: the meshes coarse (224 + 192 + 2
    triangles), 48x48 pixels, through the walk's plain PyTorch version."""
    c = workload.load("configs", CONFIG)
    c["objects"][0]["mesh"].update(stacks=8, slices=16)
    c["objects"][1]["mesh"].update(rings=12, sides=8)
    t = workload.load("traffic", TRAFFIC)
    t.update(width=width, height=height, tile_pixels=width * height)
    return c, t


def _digest(a):
    h = hashlib.sha256()
    for x in (a.vertices, a.normals, a.uvs, a.mesh, a.texture):
        h.update(x.tobytes())
    h.update(repr((a.materials, a.light)).encode())
    return h.hexdigest()


def test_scene_and_mix_resolve_by_name():
    c = workload.load("configs", CONFIG)
    t = workload.load("traffic", TRAFFIC)
    assert workload.scene_module(c).__file__.endswith(
        "rtbench/scenes/refdemo.py")
    mix = workload.mix_class(t)
    assert mix.__module__ == "rtbench_mixes_turntable"
    assert issubclass(mix, workload.Frames)
    cfg = workload.render_config(t)
    assert (cfg.width, cfg.height, cfg.max_reflections, cfg.tile_pixels) == \
        (512, 512, 8, 262144)
    assert cfg.filtering.name == "POINT" and cfg.address_mode.name == "WRAP"
    assert cfg.quantize.name == "FINAL" and cfg.compact_wavefront


def test_scene_arrays_are_pinned():
    c = workload.load("configs", CONFIG)
    a = workload.scene_module(c).build(c)
    # The reference's Sphere.fbx and torus.fbx counts, and the plane.
    assert np.bincount(a.mesh).tolist() == [960, 1152, 2]
    assert a.texture.shape == (256, 256, 3) and a.instances is None
    assert _digest(a) == PINNED


def test_scene_bakes_with_its_materials():
    c, _ = small()
    scenes = workload.scene_module(c)
    a = scenes.build(c)
    flat = scenes.program_scene(a, c, "cpu")
    assert flat.has_transparent and flat.has_dual_branch
    assert flat.has_textures and flat.num_tris == a.num_triangles
    assert flat.mesh_convex.tolist() == [True, False, False]
    # The sphere's alpha, 100/255, and the ground's checker.
    assert float(flat.tri_shade[0, 30]) == pytest.approx(100 / 255)
    assert sorted(set(flat.textures.flatten().tolist())) == [40.0, 220.0]


def _poses(seed, items=30):
    """The poses a window of ``items`` frames renders after its warm-up,
    and the poses it checks, the program's render left out."""
    c, t = small(8, 8)
    mix = workload.mix_class(t)(workload.scene_module(c).build(c), c, t,
                                seed, "cpu")
    seen = []
    mix.render = lambda k: seen.append(k) or np.zeros((8, 8, 3), np.uint8)
    mix.warm_up()
    seen.clear()
    for _ in range(items):
        mix.item()
    return [k % t["poses_per_turn"] for k in seen], sorted(
        k for _, k, _ in mix.keep)


def test_every_seed_renders_the_same_frames():
    runs = [_poses(s) for s in (SEED, 0, 12345, 2**32 + 5)]
    frames = runs[0][0]
    assert frames == [k % 12 for k in range(30)]
    assert all(f == frames for f, _ in runs)
    checked = [tuple(c) for _, c in runs]
    assert all(len(c) == 2 for c in checked)
    assert len(set(checked)) > 1     # the seed draws the checked frames


def _roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield from (f"{node.module}.{a.name}" if node.module == "rtbench"
                        else node.module for a in node.names)


def test_the_whitted_reference_imports_torch_and_the_plain_reference():
    mods = set(_roots(HERE / "reference_whitted.py"))
    assert {m.split(".")[0] for m in mods} <= {"__future__", "torch",
                                               "rtbench"}
    assert {m for m in mods if m.startswith("rtbench")} <= {
        "rtbench.reference"}


def test_span_and_counter_readers():
    spans = program_spans.Spans(2, {
        "wavefront.level.0": 9000.0, "wavefront.level.1": 3000.0,
        "wavefront.level.12": 1000.0, "wavefront.compact": 500.0,
        "wavefront.combine": 200.0}, (20000, 70))
    run = NS(kind="orbit", mix=NS(program_spans=spans))
    assert load_metric("secondary_ms.frame").read(run) == 2.0
    assert load_metric("compact_ms.frame").read(run) == 0.25
    assert load_metric("live_slot_pct.frame").read(run) == 0.35
    # A program without the spans and counters: nothing to read.
    bare = NS(kind="orbit", mix=NS(program_spans=program_spans.Spans(
        2, {}, None)))
    for name in ("secondary_ms.frame", "compact_ms.frame",
                 "live_slot_pct.frame"):
        assert load_metric(name).read(bare) is None
        assert load_metric(name).read(NS(kind="fit", mix=None)) is None


def test_span_device_time_is_the_busy_time_inside_each_window():
    from torch.autograd import DeviceType

    def ev(name, start, end, device=DeviceType.CUDA, note=False):
        return NS(name=name, device_type=device, is_user_annotation=note,
                  time_range=NS(start=start, end=end))

    events = [
        ev("wavefront.level.1", 0.0, 1e9, DeviceType.CPU),   # host side
        ev("wavefront.level.1", 10.0, 50.0, note=True),
        ev("wavefront.compact", 60.0, 70.0, note=True),
        ev("aten::where", 0.0, 15.0), ev("walk_kernel<false, 1, false>",
                                         20.0, 40.0),
        ev("elementwise", 30.0, 45.0), ev("gather", 62.0, 66.0),
        ev("rtbench.render", 0.0, 100.0, note=True)]
    # Level 1: [10, 15] + [20, 45] of its [10, 50]; the compaction 4.
    assert program_spans.span_device_us(events) == {
        "wavefront.level.1": 30.0, "wavefront.compact": 4.0}


def _drive(config, traffic):
    run, arrays, _ = workload.run_cell(SPEC, CELL, SEED, 0.2, False, "cpu",
                                       time.perf_counter(), config=config,
                                       traffic=traffic)
    return run, arrays


def test_cell_is_sound_and_the_control_and_faults_are_caught():
    """Sound, the cell comes out correct; the control (the reference in
    bfloat16) and each fault the limit was set from, in the reference put
    in the program's place, read above its limit.  One bounce fewer is not
    among them: no ray tree of the demo runs past seven levels, so it
    reads nothing (the calibration reports it)."""
    c, t = small()
    run, arrays = _drive(c, t)
    lim = workload.limits(CELL)["bad_px_ppm"]["limit"]
    mix = run.mix
    checks = workload.check(run, arrays, "cpu", workload.limits(CELL))
    assert run.items > 0 and checks["bad_px_ppm"][0] <= lim, checks
    ref = workload.scene_module(c).reference(arrays, "cpu")
    want = mix.reference_frames(ref)
    bad = {"control": mix.reference_frames(ref, torch.bfloat16)}
    for fault in ("no_refraction", "no_texture", "opaque_occluders"):
        bad[fault] = mix.reference_frames(ref, **mix.faults[fault])
    for name, frames in bad.items():
        nums = workload.compare_frames(frames, want)
        assert nums["bad_px_ppm"] > lim, (name, nums)


def _altered(render):
    """A block of each frame altered where the image is produced."""
    def fn(*a, **k):
        img = render(*a, **k).clone()
        img[4:12, 4:12] = 1.0 - img[4:12, 4:12]
        return img
    return fn


def test_cell_with_the_frames_altered_is_not_correct(monkeypatch):
    from raytpu_torch.render import wavefront

    monkeypatch.setattr(wavefront, "render_image",
                        _altered(wavefront.render_image))
    c, t = small()
    run, arrays = _drive(c, t)
    checks = workload.check(run, arrays, "cpu", workload.limits(CELL))
    assert checks["bad_px_ppm"][0] > checks["bad_px_ppm"][1], checks
