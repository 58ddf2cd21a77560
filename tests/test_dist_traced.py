"""The five slow tests of tests/test_dist.py (``SLOW_TESTS`` in the root
conftest.py), run with the JAX package's sharded render traced once under
``jax.jit`` (:func:`traced`).

Each case calls the original test, so the scenes, meshes, frame sizes,
assertions and tolerances are its own.  Only the call under test is
replaced: ``raytpu.dist.bigscene.render_image_ring``, which three of the
tests import inside their bodies, and the ``render_image_sharded`` that
test_dist.py imports at its top.  The references they compare against
(``render_image``, ``render_image_multisampled``) stay eager.  Eager, each
of the five takes 300-440 s on the CPU; they still run so under
``-m slow``.
"""

import functools

import pytest
import test_dist
from test_dist import flat  # noqa: F401 (the fixture two of the cases take)

from raytpu.dist import bigscene
from tests.jax_traced import traced


@pytest.mark.parametrize("run", [
    pytest.param(lambda flat: test_dist.TestRingRendering()
                 .test_ring_render_matches_replicated(False),
                 id="ring_render_matches_replicated-False"),
    pytest.param(lambda flat: test_dist.TestRingRendering()
                 .test_ring_render_matches_replicated(True),
                 id="ring_render_matches_replicated-True"),
    pytest.param(lambda flat: test_dist.TestRingDifferentiable()
                 .test_ring_render_differentiable_cfg_allowed(),
                 id="ring_render_differentiable_cfg_allowed"),
    pytest.param(test_dist.test_sharded_multisampled_matches_single_device,
                 id="sharded_multisampled_matches_single_device"),
    pytest.param(test_dist.test_ring_sharded_atlas_bilinear_parity,
                 id="ring_sharded_atlas_bilinear_parity"),
])
def test_slow_dist_test_traced(run, flat, monkeypatch):  # noqa: F811
    monkeypatch.setattr(bigscene, "render_image_ring", functools.partial(
        traced, bigscene.render_image_ring))
    monkeypatch.setattr(test_dist, "render_image_sharded", functools.partial(
        traced, test_dist.render_image_sharded))
    run(flat)
