"""The plain reference on hand-worked scenes of a few triangles."""

import math

import numpy as np
import pytest
import torch

from rtbench import reference, scene

INF = float("inf")


def _geo(tris):
    v = torch.tensor(tris, dtype=torch.float32)
    return v, reference.Geometry(v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])


# A unit right triangle in the plane z = h, facing +z (cross(e2, e1) = +z).
def _up(h):
    return [[0.0, 0.0, h], [0.0, 1.0, h], [1.0, 0.0, h]]


def _search(tris, o, d, **kw):
    v, geo = _geo(tris)
    o = torch.tensor([o], dtype=torch.float32)
    d = torch.tensor([d], dtype=torch.float32)
    for k in ("tmax", "ignore"):
        if k in kw:
            kw[k] = torch.tensor([kw[k]])
    t, tri = reference.search(reference.Boxes(v), geo, o, d, **kw)
    return float(t[0]), int(tri[0])


def test_hit_distance_and_barycentrics():
    # p = d x e2 = (0, -1, 0), det = -1; u = 0.25, v = 0.25, t = 5.
    v, geo = _geo([_up(0.0)])
    o = torch.tensor([[0.25, 0.25, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    det, u, vv, t = reference.moller_trumbore(o, d, geo.v0, geo.e1, geo.e2)
    assert (float(det), float(u), float(vv), float(t)) == (-1.0, 0.25, 0.25,
                                                           5.0)
    assert _search([_up(0.0)], (0.25, 0.25, 5.0), (0.0, 0.0, -1.0)) == (5.0, 0)


def test_back_faces_are_culled_and_reverse_takes_them():
    below = ((0.25, 0.25, -5.0), (0.0, 0.0, 1.0))
    assert _search([_up(0.0)], *below) == (INF, -1)
    assert _search([_up(0.0)], *below, cull="reverse") == (5.0, 0)


def test_nearest_ignore_ties_and_bound():
    tris = [_up(0.0), _up(1.0), _up(1.0)]
    ray = ((0.25, 0.25, 5.0), (0.0, 0.0, -1.0))
    assert _search(tris, *ray) == (4.0, 1)             # tie: the lower id
    assert _search(tris, *ray, ignore=1) == (4.0, 2)
    assert _search(tris[:2], *ray, ignore=1) == (5.0, 0)
    assert _search(tris, *ray, tmax=4.0) == (INF, -1)  # t < tmax, strictly
    assert _search(tris, *ray, tmax=4.5) == (4.0, 1)
    assert _search(tris, (3.0, 3.0, 5.0), (0.0, 0.0, -1.0)) == (INF, -1)


def _arrays(tris, light_pos):
    v = np.asarray(tris, np.float32)
    n = np.tile(np.asarray([0, 0, 1], np.float32), (len(tris), 3, 1))
    return scene.SceneArrays(
        vertices=v, normals=n, uvs=np.zeros((len(tris), 3, 2), np.float32),
        color=(0.7, 0.6, 0.5, 1.0), reflectiveness=0.0,
        light={"position": light_pos, "direction": [0.0, 0.0, -1.0]})


# An occluder at z = 5 above the unit triangle, facing down toward it.
OCCLUDER = [[-1.0, -1.0, 5.0], [3.0, -1.0, 5.0], [-1.0, 3.0, 5.0]]


@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("occluder", [None, "down", "up"])
def test_spot_shading_and_shadow(placed, occluder):
    tris = [_up(0.0)]
    if occluder == "down":
        tris.append(OCCLUDER)
    elif occluder == "up":   # facing the light: a back face from the ground
        tris.append([OCCLUDER[0], OCCLUDER[2], OCCLUDER[1]])
    arrays = _arrays(tris, [0.25, 0.25, 10.0])
    if placed:   # one placement, a quarter turn about y then back: the
        # scene as it was, searched through the instanced path
        arrays.instances = [(0.0, 0.0, 4)]
    ref = reference.RefScene(arrays, "cpu", scene.world_matrix)
    o = torch.tensor([[0.25, 0.25, 20.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    got = reference.trace(ref, o, d, 0)[0]
    # surfaceDot = lightDot = 1: I (1 - cosA) / (1 - cosA)^1.3 + 1^12.
    cos_a = float(np.float32(math.cos(math.pi / 4)))
    light = (1.0 - cos_a) / (1.0 - cos_a) ** 1.3 + 1.0
    want = 0.0 if occluder == "down" else light
    assert torch.allclose(got, torch.tensor([0.7, 0.6, 0.5]) * want,
                          rtol=1e-5, atol=1e-6)


def test_bytes_round_half_to_even():
    c = torch.tensor([[0.5 / 255, 1.5 / 255, 2.0]])
    assert reference.to_bytes(c).tolist() == [[0, 2, 255]]


def test_camera_rays_match_the_programs():
    from raytpu_torch.core.camera import Camera, camera_rays

    pos, w, h = scene.orbit_pose((0.0, 28.0, 34.0), 60, 7), 24, 16
    o, d = camera_rays(Camera(position=pos, aspect=w / h), w, h,
                       device="cpu")
    ro, rd = reference.camera_rays(pos, (0.0, 0.0, 0.0), w, h, "cpu")
    assert (ro - o).abs().max() < 1e-4 and (rd - d).abs().max() < 1e-5


def test_frame_bytes_are_to_uint8s():
    from raytpu_torch.io.image import to_uint8

    from rtbench.workload import to_bytes

    x = torch.rand(32, 48, 3) * 1.2 - 0.1
    x[0, 0] = torch.tensor([0.5, 1.5, 127.5]) / 255.0
    assert np.array_equal(to_bytes(x).numpy(), to_uint8(x))


def _atlas():
    """A 4x4 atlas whose texel (y, x) holds 10 y + x in red, 100 more in
    green and 200 more in blue."""
    y, x = torch.meshgrid(torch.arange(4.0), torch.arange(4.0),
                          indexing="ij")
    base = 10.0 * y + x
    return torch.stack([base, base + 100.0, base + 200.0], -1)


def test_bilinear_at_the_wrap_edges_blends_four_texels():
    from rtbench import reference_textured as rt

    atlas = _atlas().requires_grad_()
    uv = torch.tensor([[-0.4, 2.35], [1.375, -0.875]])
    got = rt.bilinear(atlas, rt.wrap(uv))
    # (-0.4, 2.35) wraps to (0.6, 0.35).  Texel size 1/4: u / 0.25 = 2.4
    # rounds to 2, remainder 0.1, snapped 0.5, texels trunc(0.5 * 3) = 1
    # and trunc(0.75 * 3) = 2, neighbour weight 0.1 * 4 + 0.5 = 0.9; v /
    # 0.25 = 1.4 rounds to 1, remainder 0.1, snapped 0.25, texels
    # trunc(0.75) = 0 and trunc(1.5) = 1, weight 0.9.
    want = (0.1 * 0.1 * 1 + 0.1 * 0.9 * 11 + 0.9 * 0.1 * 2
            + 0.9 * 0.9 * 12)                           # = 10.9
    assert torch.allclose(got[0] * 255.0, torch.tensor(
        [want, want + 100.0, want + 200.0]), rtol=1e-5)
    # (1.375, -0.875) wraps to (0.375, 0.125), both on a half texel: u /
    # 0.25 = 1.5 rounds (half to even) to 2, remainder -0.125, snapped
    # 0.5, texels 1 and 2, weight 0; v / 0.25 = 0.5 rounds to 0, remainder
    # 0.125, snapped 0, texels trunc(0) = 0 and trunc(0.75) = 0, weight 1:
    # texel (0, 1) alone.
    assert (got[1] * 255.0).tolist() == pytest.approx([1.0, 101.0, 201.0])
    # Texel gradients through plain indexing: the blend's weights / 255.
    got[0, 0].backward()
    g = atlas.grad[..., 0] * 255.0
    assert torch.allclose(g[0:2, 1:3], torch.tensor([[0.01, 0.09],
                                                     [0.09, 0.81]]),
                          atol=1e-6)
    assert float(g.sum()) == pytest.approx(1.0)


def test_wrap_is_the_engines():
    from rtbench import reference_textured as rt

    c = torch.tensor([0.0, 0.5, 1.0, 1.25, 3.0, -0.25, -1.0, -2.5])
    # Above 1: the remainder; below 0: one plus it (C#'s %, sign of the
    # dividend); 1 itself stays, as -1 becomes.
    assert rt.wrap(c).tolist() == [0.0, 0.5, 1.0, 0.25, 0.0, 0.75, 1.0, 0.5]
