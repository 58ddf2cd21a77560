"""The port's core math, camera, lights and texture sampling against the JAX
package's functions on the same seeded inputs, and the port's freedom from
JAX.

Tolerance rtol=1e-6 (plus an absolute floor for components near zero),
except where a comment states otherwise.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.config import TextureFiltering, UVAddressMode
from raytpu.core import camera as jcamera
from raytpu.core import intersect as jintersect
from raytpu.core import math3d as jmath
from raytpu.core import xna as jxna
from raytpu.scene import lights as jlights
from raytpu.scene import texture as jtexture
from raytpu_torch.core import camera as tcamera
from raytpu_torch.core import intersect as tintersect
from raytpu_torch.core import math3d as tmath
from raytpu_torch.core import xna as txna
from raytpu_torch.scene import lights as tlights
from raytpu_torch.scene import texture as ttexture
from tests.torch_scenes import t

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
# Each reference computation runs as one jitted program: eager jnp ops
# compile one program per op and shape, and an XLA CPU process crashes
# after ~150 compiles (run_tests.py).


def close(got, ref, rtol=1e-6, floor=1e-7):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=floor * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("position,size", [
    ((0.0, 16.0, 32.0), (24, 24)),
    ((3.0, 16.0, 32.0), (32, 16)),
    ((0.0, 28.0, 34.0), (16, 16)),
])
def test_camera_rays(position, size):
    w, h = size
    jc = jcamera.Camera(position=position, aspect=w / h)
    tc = tcamera.Camera(position=position, aspect=w / h)
    jview, jproj, (jo, jd) = jax.jit(
        lambda: (jc.view(), jc.projection(), jcamera.camera_rays(jc, w, h)))()
    np.testing.assert_array_equal(tc.view().numpy(), np.asarray(jview))
    np.testing.assert_array_equal(tc.projection().numpy(), np.asarray(jproj))
    to, td = tcamera.camera_rays(tc, w, h)
    close(to, jo)
    # Directions: both packages invert view @ proj in float32, through
    # different LAPACK/BLAS routines (getrf+trsm in JAX, getrf+getri in
    # torch), and the far-plane unprojection amplifies their last-bit
    # differences to ~4e-6 on unit vectors.
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(td.numpy(), axis=-1), 1.0,
                               rtol=1e-6)


def test_math3d_and_quantize():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    c = rng.uniform(-0.5, 1.5, size=(256, 3)).astype(np.float32)
    c[:4, 0] = np.array([0.5, 1.5, 2.5, 254.5], np.float32) / 255.0
    n = b / np.linalg.norm(b, axis=-1, keepdims=True)
    ref = jax.jit(lambda a, b, n: (
        jmath.dot(a, b), jmath.cross(a, b), jmath.normalize(a),
        jmath.reflect(a, n)))(a, b, n)
    close(tmath.dot(t(a), t(b)), ref[0])
    close(tmath.cross(t(a), t(b)), ref[1])
    close(tmath.normalize(t(a)), ref[2])
    close(tmath.reflect(t(a), t(n)), ref[3])
    # Eager: under jit XLA divides by 255 as a multiplication by 1/255.
    np.testing.assert_array_equal(txna.quantize_color(t(c)).numpy(),
                                  np.asarray(jxna.quantize_color(c)))


def test_compose_world_np_matches_reference():
    args = ((1.0, 2.0, 0.5), (0.3, -0.6, 1.1), (4.0, -2.0, 7.0))
    np.testing.assert_array_equal(txna.compose_world_np(*args),
                                  jxna.compose_world_np(*args))


@pytest.mark.parametrize("cull", [True, False, "reverse"])
def test_det_space_accept(cull):
    rng = np.random.default_rng(1)
    q = rng.choice(np.float32([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0]),
                   size=(5, 4096)).astype(np.float32)
    q[:, :64] *= rng.uniform(0.5, 2.0, size=(5, 64)).astype(np.float32)
    det, udet, vdet, tdet, tmax = q
    ref, ref_within = jax.jit(lambda q: (
        jintersect.det_space_accept(*q[:4], cull),
        jintersect.det_space_accept_within(*q, cull)))(q)
    got = tintersect.det_space_accept(*map(t, (det, udet, vdet, tdet)), cull)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got.all()
    got = tintersect.det_space_accept_within(
        *map(t, (det, udet, vdet, tdet, tmax)), cull)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_within))


def _packed_lights():
    lts = [tlights.SpotLight(position=(1.0, 6.0, 18.0),
                             direction=(0.1, -0.3, -0.95), spot_angle=1.4),
           tlights.DirectionalLight(direction=(0.3, -0.9, 0.1),
                                    color=(0.9, 0.8, 0.7), intensity=0.8)]
    jl = [jlights.SpotLight(position=(1.0, 6.0, 18.0),
                            direction=(0.1, -0.3, -0.95), spot_angle=1.4),
          jlights.DirectionalLight(direction=(0.3, -0.9, 0.1),
                                   color=(0.9, 0.8, 0.7), intensity=0.8)]
    tp = tlights.pack_lights(lts, max_lights=4)
    jp = jlights.pack_lights(jl, max_lights=4)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    return {k: t(v) for k, v in tp.items()}, {k: jnp.asarray(v)
                                             for k, v in jp.items()}


@pytest.mark.parametrize("i", [0, 1])
def test_light_contrib_and_shadow_query(i):
    tp, jp = _packed_lights()
    rng = np.random.default_rng(2)
    frag = rng.uniform(-10, 10, size=(512, 3)).astype(np.float32)
    frag[:, 1] = np.abs(frag[:, 1])
    normal = rng.normal(size=(512, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    # Eager (~20 compiles each): under jit XLA fuses a*b+c into FMAs and
    # the reference moves by up to 1.3e-6 relative.
    ref = np.asarray(jlights.light_contrib(jp, i, frag, normal))
    jd, jdist = jlights.light_shadow_query(jp, i, frag)
    got = tlights.light_contrib(tp, i, t(frag), t(normal)).numpy()
    assert (got != 0).any() and (got == 0).any()
    np.testing.assert_array_equal(got == 0, ref == 0)
    close(got, ref)
    sd, sdist = tlights.light_shadow_query(tp, i, t(frag))
    close(sd, jd)
    close(sdist, jdist)


@pytest.mark.parametrize("filtering", list(TextureFiltering))
@pytest.mark.parametrize("mode", list(UVAddressMode))
def test_texture_lookup(mode, filtering):
    rng = np.random.default_rng(3)
    images = np.zeros((2, 12, 16, 3), np.float32)
    images[0] = rng.integers(0, 256, size=(12, 16, 3))
    images[1, :8, :8] = rng.integers(0, 256, size=(8, 8, 3))
    hw = np.array([[12, 16], [8, 8]], np.int32)
    tex_id = rng.integers(0, 2, size=1024).astype(np.int32)
    uv = rng.uniform(-2.5, 3.5, size=(1024, 2)).astype(np.float32)
    uv[:16] = np.float32([0.0, 1.0, 0.5, -1.0, 2.0, 0.25, 0.125, -0.5])[
        np.arange(32) % 8].reshape(16, 2)
    got = ttexture.lookup_uv(t(images), t(tex_id), t(hw[tex_id, 0]),
                             t(hw[tex_id, 1]), t(uv), mode, filtering)
    ref = jax.jit(lambda *a: jtexture.lookup_uv(*a, mode, filtering))(
        images, tex_id, hw[tex_id, 0], hw[tex_id, 1], uv)
    close(got, ref)


def test_port_imports_no_jax():
    """Every module of the port imports with JAX and flax made
    unimportable."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "raytpu_torch").rglob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [m for m, v in sys.modules.items()\n"
        "       if v is not None and m.split('.')[0] in ('jax', 'jaxlib', 'flax')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 15
