"""Every cell of BENCHMARK.json resolves by name to its configuration,
traffic, scene and mix, limits and metric files, and the file keeps to
its shapes."""

import json
import re
from pathlib import Path

import pytest

from rtbench import workload
from rtbench.run import cell_metrics, load_metric

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "rtbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_by_name(cell):
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    config = workload.load("configs", w["config"])
    traffic = workload.load("traffic", w["traffic"])
    assert config["name"] == w["config"]
    assert traffic["kind"] in workload.KINDS
    scenes = workload.scene_module(config)
    for fn in ("build", "program_scene", "reference"):
        assert callable(getattr(scenes, fn))
    mix = workload.mix_class(traffic)
    for fn in ("warm_up", "item", "release", "check"):
        assert callable(getattr(mix, fn))
    assert issubclass(mix, workload.KINDS[traffic["kind"]])
    limits = workload.limits(cell)
    assert limits and all(v["limit"] > 0 for v in limits.values())
    for traced in (False, True):
        names = [m["name"] for m in cell_metrics(SPEC, cell, traced)]
        assert names
        for n in names:
            assert callable(load_metric(n).read)
    assert "setup_s" in [m["name"] for m in cell_metrics(SPEC, cell, False)]


def test_benchmark_json_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for ns in ([x["name"] for x in SPEC["configs"]],
               [x["name"] for x in SPEC["workloads"]],
               [x["name"] for x in SPEC["end_to_end"] + SPEC["per_layer"]]):
        assert len(set(ns)) == len(ns)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"rtbench/configs/{c['name']}.json"
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"].startswith(f"{w['config']}.")
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock",
                                                         "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m["workloads"]:
            assert m["moves"] in [x["name"] for x in
                                  cell_metrics(SPEC, cell, False)]


def test_scene_and_mix_by_name_and_by_default():
    import numpy as np

    tex = workload.load("configs", "terrain1m-tex")
    assert workload.scene_module(tex).__file__.endswith(
        "rtbench/scenes/textured_terrain.py")
    assert workload.scene_module(
        workload.load("configs", "terrain1m")) is workload.HEIGHT_FIELD
    fit = workload.load("traffic", "fit512tex")
    assert workload.mix_class(fit).__module__ == "rtbench_mixes_fit_textured"
    assert workload.mix_class(workload.load("traffic", "orbit1080")) is \
        workload.Frames
    atlas = workload.scene_module(tex).checker(tex["texture"])
    assert atlas.shape == (128, 128, 3) and atlas.dtype == np.uint8
    # bench.py:45-51: R 180c + 40, G 120c + 60, B 90, c = 1 on odd squares.
    assert atlas[0, 0].tolist() == [40, 60, 90]
    assert atlas[0, 8].tolist() == atlas[8, 0].tolist() == [220, 180, 90]
    assert atlas[8, 8].tolist() == atlas[7, 7].tolist() == [40, 60, 90]


def test_render_settings_parse_as_from_json():
    from raytpu_torch.config import TextureFiltering, UVAddressMode

    plain = workload.load("traffic", "fit512")
    assert workload.render_config(plain).filtering == TextureFiltering.POINT
    cfg = workload.render_config(dict(plain, render={
        "filtering": "BILINEAR", "address_mode": "MIRROR",
        "cull_prepick": 64}))
    assert cfg.filtering == TextureFiltering.BILINEAR
    assert cfg.address_mode == UVAddressMode.MIRROR
    assert (cfg.cull_prepick, cfg.width, cfg.tile_pixels) == (64, 512,
                                                              262144)
