"""The port's host-side bake (raytpu_torch/scene/flatten.py) against the JAX
package's ``flatten_scene``, and the bridge that carries a JAX bake across.

The bake is the same NumPy arithmetic in both packages, so every array must
agree bit for bit.
"""

import numpy as np
import pytest
import torch

from raytpu_torch.bridge import META, TABLES, flat_scene_from_numpy
from raytpu_torch.scene.types import FlatScene
from tests.torch_scenes import jax_arrays, jax_bake, sphere_and_plane
from tests.torch_scenes import terrain, to_port

torch.set_num_threads(1)

SCENES = {
    "sphere_and_plane": (lambda p: sphere_and_plane(p, textured=True,
                                                    light="both"), 16),
    "terrain": (lambda p: terrain(p, divisions=24), 128),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def baked(request):
    build, csize = SCENES[request.param]
    jflat = jax_bake(build("jax"), csize)
    return jflat, build("torch").flatten(device="cpu", cluster_size=csize)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_tri_shade_bitexact(baked):
    jflat, pflat = baked
    np.testing.assert_array_equal(_bits(pflat.tri_shade.numpy()),
                                  _bits(np.asarray(jflat.tri_shade)))


def test_cluster_tables_bitexact(baked):
    jflat, pflat = baked
    jcl, pcl = jflat.clusters, pflat.clusters
    ncg = pcl["block"].shape[0]
    np.testing.assert_array_equal(_bits(pcl["block"].numpy()),
                                  _bits(np.asarray(jcl["block"])))
    np.testing.assert_array_equal(
        _bits(pcl["aabb"].numpy()),
        _bits(np.asarray(jcl["aabb"]).reshape(6, -1)[:, :ncg]))
    np.testing.assert_array_equal(
        _bits(pcl["plane"].numpy()),
        _bits(np.asarray(jcl["sub_plane"]).reshape(5, -1)[:, :ncg]))
    np.testing.assert_array_equal(_bits(pcl["root"].numpy()),
                                  _bits(np.asarray(jcl["root"])[0]))
    # Every real triangle sits in exactly one slot.
    ids = pcl["block"][:, 16].contiguous().view(torch.int32).reshape(-1)
    real = ids[ids >= 0].sort().values
    assert torch.equal(real, torch.arange(pflat.num_tris, dtype=torch.int32))


def test_tables_lights_and_flags(baked):
    jflat, pflat = baked
    for k in TABLES:
        np.testing.assert_array_equal(getattr(pflat, k).numpy(),
                                      np.asarray(getattr(jflat, k)), err_msg=k)
    assert set(pflat.lights) == set(jflat.lights)
    for k, v in jflat.lights.items():
        np.testing.assert_array_equal(pflat.lights[k].numpy(), np.asarray(v))
    for k in META:
        assert getattr(pflat, k) == getattr(jflat, k), k


def _same(a, b):
    """Bitwise equality (block rows 16/17 hold int32 bits, -1 is a NaN)."""
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def test_bridge_round_trip(baked):
    """The bridged JAX bake equals the port's own bake field by field."""
    jflat, pflat = baked
    bridged = to_port(jflat)
    for k in TABLES:
        assert _same(getattr(bridged, k), getattr(pflat, k)), k
    for k in pflat.clusters:
        assert _same(bridged.clusters[k], pflat.clusters[k]), k
    for k in pflat.lights:
        assert _same(bridged.lights[k], pflat.lights[k]), k
    for k in META:
        assert getattr(bridged, k) == getattr(pflat, k), k
    moved = bridged.to("cpu")
    assert isinstance(moved, FlatScene) and moved.device.type == "cpu"
    assert _same(moved.clusters["block"], bridged.clusters["block"])


def test_bridge_rejects_out_of_range_ids():
    """A triangle id past the scene's rows raises, in a cluster_size-16
    bake and in a subcluster bake (cluster size 64, which the bridge now
    carries across), and so does a bake without its fitted-plane rows."""
    for csize in (16, 64):
        jflat = jax_bake(sphere_and_plane("jax"), csize)
        arrays, meta = jax_arrays(jflat)
        flat_scene_from_numpy(arrays, meta, device="cpu")
        arrays["clusters"]["block"][0, 16, 0] = np.int32(
            jflat.num_tris).view(np.float32)
        with pytest.raises(ValueError, match="out of range"):
            flat_scene_from_numpy(arrays, meta, device="cpu")
    del arrays["clusters"]["sub_plane"]
    with pytest.raises(ValueError, match="sub_plane"):
        flat_scene_from_numpy(arrays, meta, device="cpu")


def test_aabb_table_is_block_rows_18_to_23(baked):
    """The walk's pretest reads a cluster's box from the ``aabb`` table; the
    reference's kernel reads it from block rows 18-23 of the staged block
    (the box broadcast across lanes).  The two are the same values, in the
    port's bake and in the bridged reference bake."""
    jflat, pflat = baked
    for scene in (pflat, to_port(jflat)):
        block, aabb = scene.clusters["block"], scene.clusters["aabb"]
        rows = block[:, 18:24, :]
        assert torch.equal(rows, aabb.t()[:, :, None].expand_as(rows))
