"""The port stands alone: no module of ``raytpu_torch`` (nor ``chip_smoke.py``)
imports the JAX package or JAX, its configuration is its own copy, and its
entry points put their tensors on the card unless the caller names the CPU.
"""

import ast
import dataclasses
import inspect
from pathlib import Path

import pytest
import torch

import raytpu.config as jconfig
import raytpu_torch.config as tconfig
from raytpu_torch.bridge import flat_scene_from_numpy
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.render.instanced import flatten_instanced
from raytpu_torch.scene.flatten import flatten_scene
from tests.torch_scenes import instanced_scene, jax_arrays, jax_bake
from tests.torch_scenes import sphere_and_plane

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"raytpu", "jax", "jaxlib", "flax", "optax"}


def _port_sources():
    return sorted((ROOT / "raytpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    bad = {f"{p.relative_to(ROOT)}: {m}" for p in sources
           for m in _imported_roots(p) if m in BANNED}
    assert not bad, sorted(bad)


def test_config_is_a_copy_with_the_same_json():
    """Same enums, fields, defaults and JSON form as ``raytpu.config``."""
    for name in ("TextureFiltering", "UVAddressMode", "Quantize",
                 "RenderMode", "Intersector"):
        jenum, tenum = getattr(jconfig, name), getattr(tconfig, name)
        assert tenum is not jenum
        assert [(m.name, m.value) for m in tenum] == [
            (m.name, m.value) for m in jenum]
    fields = lambda c: [(f.name, f.default)  # noqa: E731
                        for f in dataclasses.fields(c)]
    assert fields(tconfig.RenderConfig) == fields(jconfig.RenderConfig)
    jcfg = jconfig.RenderConfig(
        width=64, max_reflections=2, quantize=jconfig.Quantize.NONE,
        intersector=jconfig.Intersector.PALLAS, cull_pretest=True,
        filtering=jconfig.TextureFiltering.BILINEAR)
    tcfg = tconfig.RenderConfig.from_json(jcfg.to_json())
    assert tcfg.to_json() == jcfg.to_json()
    assert tcfg.quantize is tconfig.Quantize.NONE
    assert tconfig.RenderConfig.from_json(tcfg.to_json()) == tcfg
    with pytest.raises(ValueError, match="grad_channels"):
        tconfig.RenderConfig(grad_channels="some")


def test_entry_points_default_to_the_card():
    """Bakes, the bridge and the camera take ``device="cuda"`` unless the
    caller names another; with no card, a bake with no device named raises
    rather than carrying on on the CPU."""
    for fn in (flatten_scene, flatten_instanced, flat_scene_from_numpy,
               camera_rays):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    arrays, meta = jax_arrays(jax_bake(sphere_and_plane("jax"), 16))
    calls = [
        lambda: sphere_and_plane("torch").flatten(cluster_size=16).device,
        lambda: flatten_instanced(instanced_scene("torch"),
                                  cluster_size=16).device,
        lambda: flat_scene_from_numpy(arrays, meta).device,
        lambda: camera_rays(Camera(), 4, 4)[0].device,
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    scene = sphere_and_plane("torch").flatten(cluster_size=16, device="cpu")
    assert scene.device.type == "cpu"
