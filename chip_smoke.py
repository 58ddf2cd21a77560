"""Drive the PyTorch/CUDA port's forward render path on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing its lines:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: compile the walk kernels (``raytpu_torch/kernels/csrc/walk.cu``);
3. small scenes: each kernel against its plain PyTorch version on the card,
   bit for bit, and a small render on the card against the CPU render;
4. frame: bench.py's ~1M-triangle terrain at 1024x1024 through
   ``render_rays`` with both launch counters checked, then the frame's
   primary and shadow queries through the kernels and the plain walk;
5. times: ms per frame and rays/s (2 * 1024^2 rays per frame: primary +
   shadow) and ms per query, kernels against the plain walk;
6. profile: the spread of frame times, and a torch.profiler breakdown of
   device time per frame (each walk kernel, everything else) with the
   device's busy share.

Then one JSON line with the kernels and, last, the device line.  Any
failure raises and the script exits nonzero; without a CUDA device it
exits nonzero before printing a result.  The compiler log and every
comparison and time go to ``--out`` (default ``build/chip_smoke``).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

RAYS_PER_TILE = 256
# The frame of bench.py (BENCH_RES, BENCH_TRIS, BENCH_CSIZE, BENCH_REPS).
RES = 1024
TRIS = 1e6
CLUSTER_SIZE = 128
REPS = 4
SPREAD_FRAMES = 30    # frames timed one by one for the spread
PROFILED_FRAMES = 5   # frames under torch.profiler


def _bits_equal(a, b):
    """Bitwise equality (NaN payloads aside: NaN matches NaN)."""
    if a.dtype == torch.float32:
        nan = torch.isnan(a) & torch.isnan(b)
        same = a.view(torch.int32) == b.view(torch.int32)
        return bool((same | nan).all())
    return torch.equal(a, b)


def _max_abs_err(a, b):
    if a.dtype != torch.float32:
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def compare_walks(scene, q, cull, any_hit, what, record):
    """The kernel and the plain walk on the same padded query; raises unless
    every output agrees bit for bit.  Returns the max abs difference."""
    from raytpu_torch.kernels.fused import walk_cuda, walk_plain

    got = walk_cuda(scene.clusters, scene.tri_shade, q, cull=cull,
                    any_hit=any_hit)
    ref = walk_plain(scene.clusters, scene.tri_shade, q, cull=cull,
                     any_hit=any_hit)
    torch.cuda.synchronize()
    err, bad = 0.0, []
    for field in got._fields:
        a, b = getattr(got, field), getattr(ref, field)
        if a is None:
            continue
        err = max(err, _max_abs_err(a, b))
        if not _bits_equal(a, b):
            diff = (a != b) if a.dtype != torch.float32 else ~(
                (a.view(torch.int32) == b.view(torch.int32))
                | (torch.isnan(a) & torch.isnan(b)))
            rows = diff.reshape(diff.shape[0], -1).any(-1).nonzero()[:5, 0]
            bad.append(f"{field}: {int(diff.sum())} differ, first rays "
                       f"{rows.tolist()}")
    record.append({"what": what, "cull": str(cull), "any_hit": any_hit,
                   "rays": int(q.origin.shape[0]),
                   "hits": int((got.code >= 0).sum()), "max_abs_err": err,
                   "mismatch": bad})
    print(f"  {what}: cull={cull} any_hit={any_hit} rays="
          f"{q.origin.shape[0]} hits={int((got.code >= 0).sum())} "
          f"{'bitwise equal' if not bad else 'MISMATCH ' + '; '.join(bad)}")
    if bad:
        raise AssertionError(f"kernel and plain walk disagree on {what}")
    return err


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "need one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}")
    print(card)
    return card


def phase_build(out_dir):
    from raytpu_torch.kernels.build import build_library, load_library

    path, seconds, log = build_library()
    load_library()
    (out_dir / "ptxas.txt").write_text(log)
    print(f"[build] {path.name} in {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    return seconds


def _small_scene(cluster_size, light="both"):
    from raytpu_torch.scene.lights import DirectionalLight, SpotLight
    from raytpu_torch.scene.procedural import plane, uv_sphere
    from raytpu_torch.scene.types import Material, Scene, SceneObject

    mat_s = Material(reflectiveness=0.3, diffuse_color=(0.9, 0.2, 0.2, 1.0))
    mat_p = Material(reflectiveness=0.0, diffuse_color=(0.4, 0.45, 0.5, 1.0))
    spot = SpotLight(position=(0, 5, 20),
                     direction=(0.0, -0.2425356, -0.9701425))
    lights = {"spot": [spot],
              "both": [spot, DirectionalLight(direction=(0.3, -0.9, 0.1))]}
    return Scene(
        objects=[SceneObject(meshes=[uv_sphere(radius=4.0, stacks=8,
                                               slices=12, material=mat_s)],
                             position=(0.0, 4.0, 0.0)),
                 SceneObject(meshes=[plane(size=(40.0, 40.0),
                                           material=mat_p)])],
        lights=lights[light]).flatten(cluster_size=cluster_size)


def phase_small(dev, record):
    from raytpu_torch import Quantize, RenderConfig
    from raytpu_torch.kernels.fused import pack_query
    from raytpu_torch.render.wavefront import render_image

    err = {"nearest": 0.0, "any_hit": 0.0}
    rng = np.random.default_rng(0)
    n = 4096
    print("[small] kernel vs plain walk on the card, sphere over plane")
    for csize in (16, 128):
        scene = _small_scene(csize).to(dev)
        o = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
        o[:, 1] = np.abs(o[:, 1]) + 0.5
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o[7, 0] = np.nan
        d[11, 2] = np.inf
        o_t = torch.from_numpy(o).to(dev)
        d_t = torch.from_numpy(d).to(dev)
        itri = torch.from_numpy(
            rng.integers(-1, scene.num_tris, size=n).astype(np.int32)).to(dev)
        tmax = torch.from_numpy(
            rng.uniform(2.0, 30.0, size=n).astype(np.float32)).to(dev)
        what = f"csize {csize}"
        for cull in (True, False):
            q = pack_query(o_t, d_t, tile_size=RAYS_PER_TILE)
            err["nearest"] = max(err["nearest"], compare_walks(
                scene, q, cull, False, what, record))
        q = pack_query(o_t, d_t, ignore_tri=itri, tile_size=RAYS_PER_TILE)
        err["nearest"] = max(err["nearest"], compare_walks(
            scene, q, True, False, what + " ignore_tri", record))
        for cull in (True, "reverse"):
            q = pack_query(o_t, d_t, ignore_tri=itri, t_max=tmax,
                           tile_size=RAYS_PER_TILE)
            err["any_hit"] = max(err["any_hit"], compare_walks(
                scene, q, cull, True, what + " t_max", record))

    cfg = RenderConfig(width=64, height=64, max_reflections=2,
                       quantize=Quantize.NONE, tile_pixels=64 * 64)
    scene = _small_scene(16)
    cpu = render_image(scene, cfg)
    gpu = render_image(scene.to(dev), cfg).cpu()
    diff = float((gpu - cpu).abs().max())
    print(f"  64x64 render, 2 reflections, card vs CPU: max abs diff "
          f"{diff:.3g}, NaN {bool(torch.isnan(gpu).any())}")
    if torch.isnan(gpu).any() or diff > 1e-5:
        raise AssertionError("the render on the card differs from the CPU's")
    record.append({"what": "small render card vs cpu", "max_abs_diff": diff})
    return err


def bench_scene(n_tris):
    """bench.py::build_scene with the port's bake (same mesh and light)."""
    from raytpu_torch.scene.lights import SpotLight
    from raytpu_torch.scene.procedural import subdivided_plane
    from raytpu_torch.scene.types import Material, Scene, SceneObject

    mat = Material(reflectiveness=0.0, diffuse_color=(0.7, 0.6, 0.5, 1.0))
    divisions = max(8, int(round((n_tris / 2) ** 0.5)))
    mesh = subdivided_plane(
        size=(40.0, 40.0), divisions=divisions, material=mat,
        height_fn=lambda x, z: 2.0 * np.sin(x * 0.7) * np.cos(z * 0.7)
        + 0.5 * np.sin(x * 3.1) * np.sin(z * 2.3))
    return Scene(objects=[SceneObject(meshes=[mesh])],
                 lights=[SpotLight(position=(0.0, 30.0, 25.0),
                                   direction=(0.0, -0.7682213, -0.6401844))])


def _frame_rays(res, dev):
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.render.wavefront import block_order_perm

    camera = Camera(position=(0.0, 28.0, 34.0), target=(0.0, 0.0, 0.0),
                    aspect=1.0)
    o, d = camera_rays(camera, res, res, device=dev)
    perm = torch.as_tensor(block_order_perm(res, res, 16), device=dev)
    return o[perm].contiguous(), d[perm].contiguous()


def plain_query(cfg):
    """The render's query through the plain walk, on any device."""
    from raytpu_torch.kernels.fused import assemble_hit, pack_query, walk_plain

    def query(scene, origin, direction, *, ignore_tri=None, ignore_mesh=None,
              t_max=None, any_hit=False, cull=True, with_rows=False):
        q = pack_query(origin, direction, ignore_tri, ignore_mesh, t_max,
                       cfg.cull_tile)
        out = walk_plain(scene.clusters, scene.tri_shade, q, cull=cull,
                         any_hit=any_hit)
        hit, rows = assemble_hit(out, origin.shape[0], any_hit)
        return (hit, rows) if with_rows else hit

    return query


def recording_query(cfg, log):
    """The render's default query, logging each call's inputs."""
    from raytpu_torch.accel.traverse import nearest_hit

    def query(scene, origin, direction, **kw):
        log.append((origin, direction, dict(kw)))
        return nearest_hit(scene, origin, direction,
                           intersector=cfg.intersector,
                           cull_tile=cfg.cull_tile, **kw)

    return query


def phase_frame(dev, record):
    from raytpu_torch import Quantize, RenderConfig
    from raytpu_torch.kernels import fused
    from raytpu_torch.kernels.fused import pack_query
    from raytpu_torch.render.wavefront import render_rays, trace_colors

    t0 = time.perf_counter()
    host = bench_scene(TRIS)
    flat = host.flatten(cluster_size=CLUSTER_SIZE)
    scene = flat.to(dev)
    bake_s = time.perf_counter() - t0
    ncg = scene.clusters["block"].shape[0]
    print(f"[frame] terrain {flat.num_tris} triangles, {ncg} clusters of "
          f"{CLUSTER_SIZE}, baked in {bake_s:.1f} s; {RES}x{RES}, "
          f"max_reflections=0")
    cfg = RenderConfig(width=RES, height=RES, max_reflections=0,
                       tile_pixels=RES ** 2, quantize=Quantize.NONE)
    o, d = _frame_rays(RES, dev)

    for k in fused.LAUNCHES:
        fused.LAUNCHES[k] = 0
    img = render_rays(scene, cfg, o, d)
    torch.cuda.synchronize()
    launches = dict(fused.LAUNCHES)
    print(f"  render_rays: launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a walk kernel did not run: {launches}")
    if img.shape != (RES ** 2, 3) or torch.isnan(img).any():
        raise AssertionError("frame has the wrong shape or NaN")
    nonblack = float((img.max(-1).values > 0).float().mean())
    print(f"  image: no NaN, nonblack fraction {nonblack:.4f}, mean "
          f"{float(img.mean()):.5f}")
    if nonblack < 0.5:
        raise AssertionError("frame is mostly black")

    log = []
    trace_colors(scene, cfg, o, d, query=recording_query(cfg, log))
    errs = {"nearest": 0.0, "any_hit": 0.0}
    queries = {}
    for origin, direction, kw in log:
        any_hit = kw.get("any_hit", False)
        q = pack_query(origin, direction, kw.get("ignore_tri"),
                       kw.get("ignore_mesh"), kw.get("t_max"), cfg.cull_tile)
        name = "any_hit" if any_hit else "nearest"
        errs[name] = max(errs[name], compare_walks(
            scene, q, kw["cull"], any_hit, f"frame {name} query", record))
        queries[name] = (q, kw["cull"], any_hit)
    record.append({"what": "frame", "tris": flat.num_tris, "clusters": ncg,
                   "launches": launches, "nonblack": nonblack})
    return scene, cfg, (o, d), queries, launches, errs, nonblack


def _cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_times(card, scene, cfg, rays, queries, record):
    from raytpu_torch.kernels.fused import walk_cuda, walk_plain
    from raytpu_torch.render.wavefront import render_rays, trace_colors

    o, d = rays
    frame_rays = 2 * RES ** 2
    kernel_frame = _cuda_ms(lambda: render_rays(scene, cfg, o, d), REPS)
    plain_frame = _cuda_ms(
        lambda: trace_colors(scene, cfg, o, d, query=plain_query(cfg)),
        REPS // 2)
    out = {"frame": {"kernel_ms": kernel_frame, "plain_ms": plain_frame,
                     "kernel_rays_per_s": frame_rays / kernel_frame * 1e3,
                     "plain_rays_per_s": frame_rays / plain_frame * 1e3}}
    print(f"[times] {card}")
    print(f"  frame {RES}x{RES} ({frame_rays} rays): kernels "
          f"{kernel_frame:.3f} ms ({out['frame']['kernel_rays_per_s']:.4g} "
          f"rays/s); plain walk {plain_frame:.3f} ms "
          f"({out['frame']['plain_rays_per_s']:.4g} rays/s)")
    for name, (q, cull, any_hit) in queries.items():
        k_ms = _cuda_ms(lambda: walk_cuda(scene.clusters, scene.tri_shade, q,
                                          cull=cull, any_hit=any_hit),
                        REPS * 4)
        p_ms = _cuda_ms(lambda: walk_plain(scene.clusters, scene.tri_shade, q,
                                           cull=cull, any_hit=any_hit),
                        REPS // 2)
        out[name] = {"kernel_ms": k_ms, "plain_ms": p_ms,
                     "rays": int(q.origin.shape[0])}
        print(f"  {name} query ({q.origin.shape[0]} rays, cull={cull}): "
              f"kernel {k_ms:.3f} ms, plain walk {p_ms:.3f} ms")
    record.append({"what": "times", "card": card, **out})
    return out


def _merged_span(intervals):
    """Total length covered by (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def phase_profile(card, scene, cfg, rays, record):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raytpu_torch.render.wavefront import render_rays

    o, d = rays

    def frame():
        render_rays(scene, cfg, o, d)

    ms = [_cuda_ms(frame, 1) for _ in range(SPREAD_FRAMES)]
    q1, med, q3 = statistics.quantiles(ms, n=4)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] {card}")
    print(f"  frame over {SPREAD_FRAMES} frames (CUDA events): median "
          f"{med:.3f} ms, quartiles {q1:.3f} / {q3:.3f}, min {min(ms):.3f}, "
          f"max {max(ms):.3f}; host clock with synchronize, median of 10: "
          f"{statistics.median(host):.3f} ms")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_FRAMES):
            frame()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in dev_events]
    groups = {"nearest walk": 0.0, "any-hit walk": 0.0, "other": 0.0}
    for e in dev_events:
        name = ("nearest walk" if "walk_kernel<false" in e.name else
                "any-hit walk" if "walk_kernel<true" in e.name else "other")
        groups[name] += e.time_range.end - e.time_range.start
    total = sum(groups.values())
    out = {"frames": ms, "median_ms": med, "host_median_ms":
           statistics.median(host), "device_events": len(dev_events)}
    if total > 0:
        window = max(s[1] for s in spans) - min(s[0] for s in spans)
        out["busy_share"] = _merged_span(spans) / window
        out["per_frame_ms"] = {k: v / PROFILED_FRAMES / 1e3
                               for k, v in groups.items()}
        print(f"  torch.profiler over {PROFILED_FRAMES} frames, device ms "
              "per frame: " + ", ".join(
                  f"{k} {v / PROFILED_FRAMES / 1e3:.3f} "
                  f"({v / total:.1%})" for k, v in groups.items())
              + f"; device busy {out['busy_share']:.1%} of the window")
    else:
        print("  torch.profiler recorded no device time: breakdown not "
              "measured")
    record.append({"what": "profile", "card": card, **out})


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path,
                        default=Path(__file__).resolve().parent / "build"
                        / "chip_smoke")
    args = parser.parse_args()

    card = phase_device()
    args.out.mkdir(parents=True, exist_ok=True)
    record = []
    build_s = phase_build(args.out)
    dev = torch.device("cuda")
    small_err = phase_small(dev, record)
    scene, cfg, rays, queries, launches, frame_err, _ = phase_frame(
        dev, record)
    times = phase_times(card, scene, cfg, rays, queries, record)
    phase_profile(card, scene, cfg, rays, record)
    (args.out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "records": record}, indent=1))

    source = "raytpu_torch/kernels/csrc/walk.cu"
    kernels = [
        {"name": "walk_kernel<nearest>", "route": "cuda", "source": source,
         "replaces": "raytpu/kernels/fused.py:959",
         "launches": launches["nearest"],
         "max_abs_err": max(small_err["nearest"], frame_err["nearest"]),
         "ms": times["nearest"]["kernel_ms"],
         "plain_ms": times["nearest"]["plain_ms"]},
        {"name": "walk_kernel<any_hit>", "route": "cuda", "source": source,
         "replaces": "raytpu/kernels/fused.py:299",
         "launches": launches["any_hit"],
         "max_abs_err": max(small_err["any_hit"], frame_err["any_hit"]),
         "ms": times["any_hit"]["kernel_ms"],
         "plain_ms": times["any_hit"]["plain_ms"]},
    ]
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("a kernel time is not finite")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
