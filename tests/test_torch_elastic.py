"""The port's elastic re-dispatch (raytpu_torch/dist/elastic.py, its own
copy of raytpu/dist/elastic.py) on the JAX package's cases
(tests/test_elastic.py), rendering with the port."""

import torch

from raytpu_torch.dist.elastic import failed_units, render_units


def test_all_units_succeed():
    res = render_units(range(5), lambda u: u * u)
    assert all(r.ok for r in res)
    assert [r.result for r in res] == [0, 1, 4, 9, 16]
    assert failed_units(res) == []


def test_injected_failure_retried_and_recovered():
    # Unit 2 fails on its first two attempts, succeeds on the third.
    res = render_units(
        range(4), lambda u: u,
        inject_failure=lambda i, attempt: i == 2 and attempt < 3,
        backoff_s=0.0,
    )
    assert all(r.ok for r in res)
    assert res[2].attempts == 3
    assert res[0].attempts == 1


def test_permanent_failure_reported_not_raised():
    res = render_units(
        range(3), lambda u: u,
        inject_failure=lambda i, attempt: i == 1,
        max_attempts=2, backoff_s=0.0,
    )
    assert [r.ok for r in res] == [True, False, True]
    assert failed_units(res) == [1]
    assert "injected" in res[1].error


def test_redispatch_loop_drains_failures():
    # First pass: units 1 and 3 fail every attempt.  Second pass (the
    # elastic re-dispatch) succeeds because the "host came back".
    flaky = {1, 3}
    res1 = render_units(
        range(5), lambda u: u,
        inject_failure=lambda i, a: i in flaky,
        max_attempts=1,
    )
    todo = failed_units(res1)
    assert todo == [1, 3]
    flaky.clear()
    res2 = render_units(
        todo, lambda u: u, inject_failure=lambda i, a: False
    )
    assert all(r.ok for r in res2)
    assert [r.result for r in res2] == [1, 3]


def test_render_tiles_end_to_end():
    """Real use: tile units through the port's renderer with one injected
    fault."""
    import dataclasses

    from raytpu_torch.config import RenderConfig
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.render.wavefront import trace_colors
    from tests.scenes import default_camera, small_cfg
    from tests.torch_scenes import sphere_and_plane

    flat = sphere_and_plane("torch").flatten(cluster_size=16, device="cpu")
    cfg = RenderConfig.from_json(
        small_cfg(width=16, height=16, max_reflections=0).to_json())
    cam = Camera(**dataclasses.asdict(default_camera()))
    o, d = camera_rays(cam, 16, 16, device="cpu")
    tiles = [(o[i:i + 64], d[i:i + 64]) for i in range(0, 256, 64)]

    def render_tile(unit):
        to, td = unit
        return trace_colors(flat, cfg, to, td)

    res = render_units(tiles, render_tile, backoff_s=0.0,
                       inject_failure=lambda i, a: i == 1 and a == 1)
    assert all(r.ok for r in res) and res[1].attempts == 2
    img = torch.cat([r.result for r in res])
    ref = trace_colors(flat, cfg, o, d)
    assert float(ref.max()) > 0
    torch.testing.assert_close(img, ref, rtol=0, atol=1e-6)


def test_sharded_quarters_redispatched():
    """A frame's four quarters as units of the ray-sharded render over a
    mesh of two CPU entries; a unit whose device call raises a runtime
    error is re-dispatched, and the frame reassembles to the
    single-device render bit for bit."""
    from raytpu_torch.config import Quantize, RenderConfig
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.dist.mesh import make_mesh, replicate_scene
    from raytpu_torch.dist.render import render_rays_sharded
    from raytpu_torch.render.wavefront import render_rays
    from tests.torch_scenes import sphere_and_plane

    flat = sphere_and_plane("torch", reflect=0.4).flatten(cluster_size=16,
                                                          device="cpu")
    cfg = RenderConfig(width=16, height=16, max_reflections=1,
                       tile_pixels=32, quantize=Quantize.NONE)
    o, d = camera_rays(Camera(), 16, 16, device="cpu")
    mesh = make_mesh(["cpu"] * 2)
    rep = replicate_scene(flat, mesh)
    calls = []

    def render_quarter(q):
        calls.append(q)
        if calls.count(q) == 1 and q == 2:
            raise RuntimeError("CUDA error: an illegal memory access")
        s = slice(q * 64, (q + 1) * 64)
        return render_rays_sharded(rep, cfg, o[s], d[s], mesh)

    res = render_units(range(4), render_quarter, backoff_s=0.0)
    assert [r.attempts for r in res] == [1, 1, 2, 1]
    assert calls == [0, 1, 2, 2, 3]
    img = torch.cat([r.result for r in res])
    assert torch.equal(img, render_rays(flat, cfg, o, d))


def test_watchdog_interrupts_hung_call():
    """A hung device call no longer hangs the dispatch loop: the watchdog
    abandons it at timeout_s and the unit is retried / reported failed
    fast."""
    import time

    from raytpu_torch.dist.elastic import render_units

    hang_first = {"done": False}

    def render_one(unit):
        if unit == "hang" and not hang_first["done"]:
            hang_first["done"] = True
            time.sleep(30.0)  # simulated silent hang
        return f"ok:{unit}"

    t0 = time.perf_counter()
    results = render_units(["a", "hang", "b"], render_one,
                           max_attempts=2, timeout_s=0.3, backoff_s=0.01)
    elapsed = time.perf_counter() - t0
    assert elapsed < 5.0  # the loop returned long before the 30s hang
    assert [r.ok for r in results] == [True, True, True]
    # The hung attempt was detected and retried.
    assert results[1].attempts == 2
    assert results[1].result == "ok:hang"


def test_watchdog_reports_unrecovered_hang():
    import time

    from raytpu_torch.dist.elastic import failed_units, render_units

    def render_one(unit):
        time.sleep(10.0)
        return unit

    t0 = time.perf_counter()
    results = render_units([0], render_one, max_attempts=2, timeout_s=0.2,
                           backoff_s=0.01)
    assert time.perf_counter() - t0 < 5.0
    assert failed_units(results) == [0]
    assert "watchdog" in results[0].error
