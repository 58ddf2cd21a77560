"""The scenes as the harness builds them: a configuration without a
``"scene"`` gives the height field's arrays, bit for bit those the
benchmark has always measured (hashes taken at commit dd647d7), and the
textured scene gives the same triangles with its UVs scaled and its
atlas."""

import hashlib

import numpy as np
import pytest

from rtbench import workload

PINNED = {
    "terrain1m":
        "c32d6b318fb4b286ac5ab43efb37298593782636e7a12317fd75fbeeec8afda4",
    "inst2x2":
        "bd7057b778f1c76cc62f0221128fb2573732c84aa9edfbf093c06537398ef441",
}


def _digest(a):
    h = hashlib.sha256()
    for x in (a.vertices, a.normals, a.uvs):
        h.update(x.tobytes())
    h.update(repr((a.color, a.reflectiveness, a.light,
                   a.instances)).encode())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(PINNED))
def test_height_field_arrays_are_pinned(config):
    c = workload.load("configs", config)
    assert _digest(workload.scene_module(c).build(c)) == PINNED[config]


def test_textured_scene_is_the_height_field_with_its_uvs_scaled():
    plain = workload.load("configs", "terrain1m")
    tex = workload.load("configs", "terrain1m-tex")
    for c in (plain, tex):
        c["terrain"]["triangles"] = 7938
    a = workload.scene_module(plain).build(plain)
    b = workload.scene_module(tex).build(tex)
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.normals, b.normals)
    assert np.allclose(b.uvs, a.uvs * 4.0, atol=1e-6)
    assert b.uvs.max() == pytest.approx(4.0) and b.uvs.min() == 0.0
    assert b.texture.shape == (128, 128, 3) and b.instances is None
