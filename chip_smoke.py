"""Drive the PyTorch/CUDA port's render paths on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing its lines:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: compile the walk kernels (``raytpu_torch/kernels/csrc/walk.cu``);
3. small: every walk kernel variant against the plain PyTorch walk, bit for
   bit, trip counts included (nearest and any-hit; pretest on and off;
   re-cull every 0, 2 and 6 trips; cluster sizes 16 and 128; ignore ids,
   t bounds, NaN bounds and non-finite rays), and small renders, baked and
   instanced, on the card against the CPU;
4. frame: bench.py's ~1M-triangle terrain at 1024x1024 through
   ``render_rays`` with its launch counters checked, then the frame's
   queries through the kernels and the plain walk;
5. instanced: one bake of that terrain instanced 4 times (2x2, rotated by
   multiples of 90 degrees, ~4M triangles in the world) through
   ``render_image_instanced`` at 1024x1024 with one reflection, the
   pretest variant's launch counter checked; every walk call of the frame
   held against the plain walk;
6. pretest frame: the bench frame with ``cull_pretest=True,
   cull_recull=6``, counters checked, the image equal to the default
   frame's, its queries through the kernels and the plain walk;
7. times: ms per frame and rays/s (bench frame, default and pretest, in
   turns; instanced frame, counting every query's live rays, with the
   walk's defaults and with the re-cull, the pretest or both turned off)
   and ms per walk call, kernels against the plain walk;
8. profile: the bench frame's spread and torch.profiler breakdown, and the
   instanced frame's device ms per kernel variant, busy share and the host
   syncs of its per-instance pass skips.

Then one JSON line with the kernels (time, plain time, launches, trips per
tile and the least time the card could take for the same work) and, last,
the device line.  Any failure raises and the script exits nonzero; without
a CUDA device it exits nonzero before printing a result.  The compiler log
and every comparison and time go to ``--out`` (default
``build/chip_smoke``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
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
RECULL = 6            # nearest_hit's default re-cull period
# The instanced frame: 2x2 instances of the terrain (each 40x40 units)
# covering 80x80, rotated by multiples of 90 degrees about y.
INSTANCES = ((-20.0, -20.0), (20.0, -20.0), (20.0, 20.0), (-20.0, 20.0))
INSTANCED_CAMERA = (0.0, 64.0, 56.0)

# The least time the card could take (PERF.md, the kernel table): FP32
# lane instructions at 132 SMs x 128 lanes x ~1.98 GHz (one instruction
# per operation: the kernels are built with -fmad=false), bytes at the HBM
# rate of the H100 SXM.
PEAK_OPS = 33.5e12
PEAK_BYTES = 3.35e12
# Operations read off walk.cu per ray-triangle pair: the det-space values
# (det 5, udet 11, vdet 11, tdet 6), the acceptance (5 compares, 1 add),
# two id compares and the best-t select and compare (nearest), or the
# t-bound product and compare and the hit flag (any-hit).  The bound counts
# these alone.
OPS_PAIR = {False: 43, True: 44}
# The walk's own overheads, printed beside the bound and not part of it:
# per entry bound (prologue and each re-cull, per cluster) ~80; per pick,
# 3 per entry scanned; per pretest, 27 per ray.
OPS_ENTRY = 80
OPS_PICK = 3
OPS_PRETEST = 27
# Walk settings of the instanced frame's extra timings: nearest_hit's
# defaults (pretest on, re-cull 6) with one or both turned off.
INSTANCED_WALKS = (("cull_recull=0", {"cull_recull": 0}),
                   ("cull_pretest=False", {"cull_pretest": False}),
                   ("both off", {"cull_pretest": False, "cull_recull": 0}))


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


def _once_ms(fn):
    """One timed call (no warm-up): for the plain walk, whose every trip
    ends in a host synchronisation anyway."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def reset_launches():
    from raytpu_torch.kernels import fused

    for k in fused.LAUNCHES:
        fused.LAUNCHES[k] = 0


def read_launches():
    from raytpu_torch.kernels import fused

    torch.cuda.synchronize()
    return dict(fused.LAUNCHES)


def compare_walks(clusters, tri_shade, q, what, record, got=None, **walk):
    """The kernel (``got``, or a fresh launch) and the plain walk on the
    same padded query; raises unless every output, trip counts included,
    agrees bit for bit.  Returns (max abs difference, plain walk ms)."""
    from raytpu_torch.kernels.fused import walk_cuda, walk_plain

    if got is None:
        got = walk_cuda(clusters, tri_shade, q, **walk)
    ref, plain_ms = _once_ms(lambda: walk_plain(clusters, tri_shade, q,
                                                **walk))
    err, bad = 0.0, []
    for field in got._fields:
        a, b = getattr(got, field), getattr(ref, field)
        if a is None and b is None:
            continue
        if (a is None) != (b is None):
            bad.append(f"{field}: only one walk returned it")
            continue
        err = max(err, _max_abs_err(a, b))
        if not _bits_equal(a, b):
            diff = (a != b) if a.dtype != torch.float32 else ~(
                (a.view(torch.int32) == b.view(torch.int32))
                | (torch.isnan(a) & torch.isnan(b)))
            rows = diff.reshape(diff.shape[0], -1).any(-1).nonzero()[:5, 0]
            bad.append(f"{field}: {int(diff.sum())} differ, first "
                       f"{rows.tolist()}")
    hits = int((got.code >= 0).sum())
    trips = got.iters.float()
    rec = {"what": what, "walk": {k: str(v) for k, v in walk.items()},
           "rays": int(q.origin.shape[0]), "hits": hits, "max_abs_err": err,
           "trips_mean": float(trips.mean()), "trips_max": int(trips.max()),
           "tests_mean": float(got.tests.float().mean()),
           "ray_tests_mean": float(got.ray_tests.float().mean()),
           "plain_ms": plain_ms, "mismatch": bad}
    record.append(rec)
    print(f"  {what}: {walk} rays={q.origin.shape[0]} hits={hits} trips "
          f"mean {rec['trips_mean']:.2f} max {rec['trips_max']} tested "
          f"{rec['tests_mean']:.2f} ray tests {rec['ray_tests_mean']:.1f}, "
          f"plain walk {plain_ms:.0f} ms, "
          f"{'bitwise equal' if not bad else 'MISMATCH ' + '; '.join(bad)}")
    if bad:
        raise AssertionError(f"kernel and plain walk disagree on {what}")
    return err, plain_ms


def walk_bound(q, out, ncg, csize, walk):
    """The least time the card could take for one walk call: the
    ray-triangle pairs the function needs (each tested cluster's unresolved
    rays, the walk's ``ray_tests``, times its triangles) at OPS_PAIR
    operations each; bytes from each input read once and each output
    written once (the 18 used rows of every cluster block counted once).
    The walk's own overheads (entry bounds of the prologue and of each
    re-cull, the per-trip pick, the pretest) are counted apart in
    ``overhead_ops`` and are not part of the bound."""
    any_hit, pretest = walk["any_hit"], walk.get("pretest", False)
    recull = walk.get("recull_every", 0)
    rows = walk.get("rows", True) and not any_hit
    ts = q.tile
    r, nt = q.origin.shape[0], q.origin.shape[0] // ts
    live = (torch.isfinite(q.origin).all(-1)
            & torch.isfinite(q.direction).all(-1)).reshape(nt, ts)
    live = live.sum(1).double()
    trips = out.iters.double()
    reculls = ((trips - 1).clamp(min=0) // recull if recull
               else torch.zeros_like(trips))
    ops = float(out.ray_tests.double().sum()) * csize * OPS_PAIR[any_hit]
    overhead = float((trips * ncg * OPS_PICK
                      + (live > 0) * (1 + reculls) * ncg * OPS_ENTRY
                      + (trips * live * OPS_PRETEST if pretest else 0)).sum())
    nbytes = (r * 36 + ncg * (6 + 5 + 18 * csize) * 4 + 32 + nt * 8
              + r * (8 if any_hit else 20))
    if rows:
        nbytes += r * 128 + int((out.code >= 0).sum()) * 128
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes, "overhead_ops": overhead}


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


def _small_scene(cluster_size, device, light="both"):
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
        lights=lights[light]).flatten(cluster_size=cluster_size,
                                      device=device)


def _small_instanced_scene(reflect, transparent):
    """tests/test_instanced_render.py's scene: two instances of one sphere
    mesh over a checkered plane."""
    from raytpu_torch.scene.lights import SpotLight
    from raytpu_torch.scene.procedural import plane, uv_sphere
    from raytpu_torch.scene.types import Material, Scene, SceneObject

    even = (np.mgrid[0:32, 0:32] // 4).sum(0) % 2 == 0
    checker = np.where(even[..., None], 255, 40).repeat(3, -1).astype(
        np.uint8)
    mat = Material(reflectiveness=reflect, transparent=transparent,
                   refraction_index=1.32,
                   diffuse_color=(0.8, 0.2, 0.2, 0.6 if transparent else 1.0))
    sphere = uv_sphere(radius=2.0, stacks=8, slices=12, material=mat)
    ground = Material(use_texture=True, texture=checker, reflectiveness=0.0)
    return Scene(
        objects=[SceneObject(meshes=[sphere], position=(-3.0, 2.0, 0.0)),
                 SceneObject(meshes=[sphere], position=(3.5, 3.0, -2.0),
                             scale=(1.5, 1.5, 1.5), rotation=(0.0, 0.8, 0.0)),
                 SceneObject(meshes=[plane(size=(40.0, 40.0),
                                           material=ground)])],
        lights=[SpotLight(position=(0.0, 5.0, 20.0),
                          direction=(0.0, -0.2425356, -0.9701425))])


# (any_hit, pretest, recull_every) of the small comparisons.
SMALL_WALKS = [(a, p, r) for a in (False, True)
               for p, r in ((False, 0), (True, 0), (False, 2), (True, 2),
                            (True, 6))]


def phase_small(dev, record):
    from raytpu_torch import Quantize, RenderConfig
    from raytpu_torch.core.camera import Camera
    from raytpu_torch.kernels.fused import kernel_name, pack_query
    from raytpu_torch.render.instanced import (flatten_instanced,
                                               render_image_instanced)
    from raytpu_torch.render.wavefront import render_image

    err = {}

    def note(any_hit, pretest, e):
        name = kernel_name(any_hit, pretest)
        err[name] = max(err.get(name, 0.0), e)

    rng = np.random.default_rng(0)
    n = 4096
    print("[small] kernel vs plain walk on the card, sphere over plane")
    for csize in (16, 128):
        scene = _small_scene(csize, dev)
        tables = (scene.clusters, scene.tri_shade)
        o = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
        o[:, 1] = np.abs(o[:, 1]) + 0.5
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o[7, 0] = np.nan
        d[11, 2] = np.inf
        d[300, :] = np.nan
        tm = rng.uniform(2.0, 30.0, size=n).astype(np.float32)
        tm[300] = np.nan  # a dead lane's NaN bound, as in instanced shadows
        o_t = torch.from_numpy(o).to(dev)
        d_t = torch.from_numpy(d).to(dev)
        itri = torch.from_numpy(
            rng.integers(-1, scene.num_tris, size=n).astype(np.int32)).to(dev)
        tmax = torch.from_numpy(tm).to(dev)
        what = f"csize {csize}"
        for cull in (True, False):
            q = pack_query(o_t, d_t, tile_size=RAYS_PER_TILE)
            note(False, False, compare_walks(
                *tables, q, what, record, cull=cull, any_hit=False)[0])
        q = pack_query(o_t, d_t, ignore_tri=itri, tile_size=RAYS_PER_TILE)
        note(False, False, compare_walks(
            *tables, q, what + " ignore_tri", record, cull=True,
            any_hit=False)[0])
        for cull in (True, "reverse"):
            q = pack_query(o_t, d_t, ignore_tri=itri, t_max=tmax,
                           tile_size=RAYS_PER_TILE)
            note(True, False, compare_walks(
                *tables, q, what + " t_max", record, cull=cull,
                any_hit=True)[0])
        for any_hit, pretest, recull in SMALL_WALKS:
            q = pack_query(o_t, d_t, ignore_tri=itri, t_max=tmax,
                           tile_size=RAYS_PER_TILE)
            note(any_hit, pretest, compare_walks(
                *tables, q, what + " ignore_tri t_max", record, cull=True,
                any_hit=any_hit, pretest=pretest, recull_every=recull)[0])

    cfg = RenderConfig(width=64, height=64, max_reflections=2,
                       quantize=Quantize.NONE, tile_pixels=64 * 64)
    cpu = render_image(_small_scene(16, "cpu"), cfg)
    gpu = render_image(_small_scene(16, dev), cfg).cpu()
    _card_vs_cpu("64x64 render, 2 reflections", gpu, cpu, record)
    cam = Camera(position=(0.0, 10.0, 24.0))
    for reflect, transparent in ((0.4, False), (0.2, True)):
        host = _small_instanced_scene(reflect, transparent)
        cpu = render_image_instanced(
            flatten_instanced(host, cluster_size=16, device="cpu"), cfg, cam)
        gpu = render_image_instanced(
            flatten_instanced(host, cluster_size=16, device=dev), cfg,
            cam).cpu()
        _card_vs_cpu(f"64x64 instanced render, transparent={transparent}",
                     gpu, cpu, record)
    return err


def _card_vs_cpu(what, gpu, cpu, record):
    diff = float((gpu - cpu).abs().max())
    nonblack = float((cpu.max(-1).values > 0).float().mean())
    print(f"  {what}, card vs CPU: max abs diff {diff:.3g}, NaN "
          f"{bool(torch.isnan(gpu).any())}, nonblack {nonblack:.3f}")
    if torch.isnan(gpu).any() or diff > 1e-5 or nonblack < 0.3:
        raise AssertionError(f"{what}: the card differs from the CPU")
    record.append({"what": what + " card vs cpu", "max_abs_diff": diff})


def bench_scene(n_tris, reflect=0.0):
    """bench.py::build_scene with the port's bake (same mesh and light)."""
    from raytpu_torch.scene.lights import SpotLight
    from raytpu_torch.scene.procedural import subdivided_plane
    from raytpu_torch.scene.types import Material, Scene, SceneObject

    mat = Material(reflectiveness=reflect,
                   diffuse_color=(0.7, 0.6, 0.5, 1.0))
    divisions = max(8, int(round((n_tris / 2) ** 0.5)))
    mesh = subdivided_plane(
        size=(40.0, 40.0), divisions=divisions, material=mat,
        height_fn=lambda x, z: 2.0 * np.sin(x * 0.7) * np.cos(z * 0.7)
        + 0.5 * np.sin(x * 3.1) * np.sin(z * 2.3))
    return Scene(objects=[SceneObject(meshes=[mesh])],
                 lights=[SpotLight(position=(0.0, 30.0, 25.0),
                                   direction=(0.0, -0.7682213, -0.6401844))])


def instanced_frame_scene(n_tris):
    """The bench terrain (reflectiveness 0.3) instanced 2x2 over 80x80
    units, each instance rotated by a further 90 degrees; bench's light."""
    from raytpu_torch.scene.types import Scene, SceneObject

    terrain = bench_scene(n_tris, reflect=0.3)
    meshes = terrain.objects[0].meshes
    return Scene(objects=[
        SceneObject(meshes=meshes, position=(x, 0.0, z),
                    rotation=(0.0, k * math.pi / 2, 0.0))
        for k, (x, z) in enumerate(INSTANCES)], lights=terrain.lights)


def _frame_rays(res, dev):
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.render.wavefront import block_order_perm

    camera = Camera(position=(0.0, 28.0, 34.0), target=(0.0, 0.0, 0.0),
                    aspect=1.0)
    o, d = camera_rays(camera, res, res, device=dev)
    perm = block_order_perm(res, res, 16, dev)
    return o[perm].contiguous(), d[perm].contiguous()


def plain_query(cfg):
    """The render's query through the plain walk, on any device."""
    from raytpu_torch.kernels.fused import assemble_hit, pack_query, walk_plain

    def query(scene, origin, direction, *, ignore_tri=None, ignore_mesh=None,
              t_max=None, any_hit=False, cull=True, with_rows=False):
        q = pack_query(origin, direction, ignore_tri, ignore_mesh, t_max,
                       cfg.cull_tile)
        out = walk_plain(scene.clusters, scene.tri_shade, q, cull=cull,
                         any_hit=any_hit, pretest=cfg.cull_pretest,
                         recull_every=cfg.cull_recull, rows=with_rows)
        hit, rows = assemble_hit(out, origin.shape[0], any_hit)
        return (hit, rows) if with_rows else hit

    return query


@contextlib.contextmanager
def recording_walks():
    """Every ``walk_cuda`` call made inside: (clusters, tri_shade, query,
    options, output)."""
    from raytpu_torch.kernels import fused

    calls, launch = [], fused.walk_cuda

    def walk(clusters, tri_shade, q, **kw):
        out = launch(clusters, tri_shade, q, **kw)
        calls.append((clusters, tri_shade, q, kw, out))
        return out

    fused.walk_cuda = walk
    try:
        yield calls
    finally:
        fused.walk_cuda = launch


def check_recorded(calls, what, record):
    """Hold every recorded walk call against the plain walk.  Returns the
    per-call rows (options, max abs err, plain ms, trips, bound)."""
    out = []
    for i, (clusters, tri_shade, q, kw, got) in enumerate(calls):
        err, plain_ms = compare_walks(clusters, tri_shade, q,
                                      f"{what} call {i}", record, got=got,
                                      **kw)
        ncg, _, csize = clusters["block"].shape
        out.append({"kw": kw, "err": err, "plain_ms": plain_ms,
                    "iters": got.iters, "out": got, "q": q,
                    "clusters": clusters,
                    "tri_shade": tri_shade,
                    **walk_bound(q, got, ncg, csize, kw)})
    return out


def phase_frame(dev, record):
    from raytpu_torch import Quantize, RenderConfig
    from raytpu_torch.render.wavefront import render_rays

    t0 = time.perf_counter()
    flat = bench_scene(TRIS).flatten(cluster_size=CLUSTER_SIZE, device=dev)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    ncg = flat.clusters["block"].shape[0]
    print(f"[frame] terrain {flat.num_tris} triangles, {ncg} clusters of "
          f"{CLUSTER_SIZE}, baked in {bake_s:.1f} s; {RES}x{RES}, "
          f"max_reflections=0")
    cfg = RenderConfig(width=RES, height=RES, max_reflections=0,
                       tile_pixels=RES ** 2, quantize=Quantize.NONE)
    o, d = _frame_rays(RES, dev)

    reset_launches()
    img = render_rays(flat, cfg, o, d)
    launches = read_launches()
    print(f"  render_rays: launches {launches}")
    if not (launches["nearest"] > 0 and launches["any_hit"] > 0):
        raise AssertionError(f"a walk kernel did not run: {launches}")
    nonblack = _check_image(img, "frame")
    with recording_walks() as calls:
        render_rays(flat, cfg, o, d)
    checked = check_recorded(calls, "frame", record)
    record.append({"what": "frame", "tris": flat.num_tris, "clusters": ncg,
                   "launches": launches, "nonblack": nonblack})
    return flat, cfg, (o, d), img, checked, launches


def _check_image(img, what):
    if torch.isnan(img).any():
        raise AssertionError(f"{what} has NaN")
    nonblack = float((img.reshape(-1, 3).max(-1).values > 0).float().mean())
    print(f"  image: no NaN, nonblack fraction {nonblack:.4f}, mean "
          f"{float(img.mean()):.5f}")
    if nonblack < 0.5:
        raise AssertionError(f"{what} is mostly black")
    return nonblack


def phase_instanced(dev, record):
    from raytpu_torch import Quantize, RenderConfig
    from raytpu_torch.core.camera import Camera
    from raytpu_torch.render import instanced as prender

    t0 = time.perf_counter()
    iscene = prender.flatten_instanced(instanced_frame_scene(TRIS),
                                       cluster_size=CLUSTER_SIZE, device=dev)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    bake = iscene.bakes[0]
    world_tris = bake.num_tris * len(iscene.instances)
    print(f"[instanced] {len(iscene.bakes)} bake of {bake.num_tris} "
          f"triangles ({bake.clusters['block'].shape[0]} clusters), "
          f"{len(iscene.instances)} instances = {world_tris} triangles in "
          f"the world, baked in {bake_s:.1f} s; {RES}x{RES}, "
          "max_reflections=1")
    if len(iscene.bakes) != 1:
        raise AssertionError("the instances do not share one bake")
    cfg = RenderConfig(width=RES, height=RES, max_reflections=1,
                       tile_pixels=RES ** 2, quantize=Quantize.NONE)
    camera = Camera(position=INSTANCED_CAMERA, aspect=1.0)

    reset_launches()
    img = prender.render_image_instanced(iscene, cfg, camera)
    launches = read_launches()
    print(f"  render_image_instanced: launches {launches}")
    if launches["nearest_pretest"] <= 0:
        raise AssertionError(f"the pretest walk did not run: {launches}")
    if img.shape != (RES, RES, 3):
        raise AssertionError(f"instanced frame has shape {img.shape}")
    nonblack = _check_image(img, "instanced frame")

    live = []
    query = prender.nearest_hit_instanced

    def counted(bakes, instances, origin, direction, **kw):
        live.append(torch.isfinite(direction).all(-1).sum())
        return query(bakes, instances, origin, direction, **kw)

    prender.nearest_hit_instanced = counted
    try:
        with recording_walks() as calls:
            again = prender.render_image_instanced(iscene, cfg, camera)
    finally:
        prender.nearest_hit_instanced = query
    if not torch.equal(again, img):
        raise AssertionError("two instanced renders differ")
    live_rays = int(sum(int(x) for x in live))
    print(f"  {len(calls)} walk calls, {len(live)} instanced queries, "
          f"{live_rays} live rays")
    checked = check_recorded(calls, "instanced", record)
    record.append({"what": "instanced frame", "world_tris": world_tris,
                   "launches": launches, "walk_calls": len(calls),
                   "live_rays": live_rays, "nonblack": nonblack})
    return iscene, cfg, camera, checked, launches, live_rays


def phase_pretest_frame(flat, cfg, rays, img_default, frame_rows, record):
    """The bench frame with the walk's opt-ins.  They change the order in
    which clusters are visited, never a hit: the same hits at the same t,
    bit for bit; where two triangles of different clusters give a ray the
    very same t (an exact tie), the one visited first wins, so only such
    pixels may differ from the default frame."""
    import dataclasses

    from raytpu_torch.render.wavefront import render_rays

    o, d = rays
    pcfg = dataclasses.replace(cfg, cull_pretest=True, cull_recull=RECULL)
    print(f"[pretest frame] the bench frame with cull_pretest=True, "
          f"cull_recull={RECULL}")
    reset_launches()
    img = render_rays(flat, pcfg, o, d)
    launches = read_launches()
    print(f"  render_rays: launches {launches}")
    if not (launches["nearest_pretest"] > 0
            and launches["any_hit_pretest"] > 0):
        raise AssertionError(f"a pretest walk did not run: {launches}")
    _check_image(img, "pretest frame")
    with recording_walks() as calls:
        render_rays(flat, pcfg, o, d)
    checked = check_recorded(calls, "pretest frame", record)
    base = [r["out"] for r in frame_rows if not r["kw"]["any_hit"]][0]
    got = [r["out"] for r in checked if not r["kw"]["any_hit"]][0]
    r = o.shape[0]
    hit = base.code[:r] >= 0
    same = (torch.equal(hit, got.code[:r] >= 0)
            and _bits_equal(base.t[:r][hit], got.t[:r][hit]))
    ties = hit & (base.tri[:r] != got.tri[:r])
    differ = (img != img_default).any(-1)
    print(f"  primary hits and t bit for bit the default's: {same}; "
          f"exact-t ties won by another triangle: {int(ties.sum())}; pixels "
          f"that differ from the default frame: {int(differ.sum())}, max "
          f"{float((img - img_default).abs().max()):.3g}")
    if not same or bool((differ & ~ties).any()):
        raise AssertionError("the pretest frame differs from the default "
                             "beyond exact-t ties")
    record.append({"what": "pretest frame", "launches": launches,
                   "ties": int(ties.sum()),
                   "pixels_differ": int(differ.sum())})
    return pcfg, checked, launches


def _kernel_ms(row, reps):
    from raytpu_torch.kernels.fused import walk_cuda

    return _cuda_ms(lambda: walk_cuda(row["clusters"], row["tri_shade"],
                                      row["q"], **row["kw"]), reps)


def _instanced_ms(iscene, cfg, camera, walk):
    """One instanced frame in ms with ``walk`` (``nearest_hit`` walk
    settings) given to every instanced query."""
    from raytpu_torch.render import instanced as prender

    query = prender.nearest_hit_instanced
    prender.nearest_hit_instanced = functools.partial(query, **walk)
    try:
        return _cuda_ms(
            lambda: prender.render_image_instanced(iscene, cfg, camera), 1)
    finally:
        prender.nearest_hit_instanced = query


def phase_times(card, flat, cfg, pcfg, rays, frame_rows, pre_rows, inst,
                record):
    from raytpu_torch.render.instanced import render_image_instanced
    from raytpu_torch.render.wavefront import render_rays, trace_colors

    o, d = rays
    frame_rays = 2 * RES ** 2
    print(f"[times] {card}")
    default = lambda: render_rays(flat, cfg, o, d)  # noqa: E731
    pretest = lambda: render_rays(flat, pcfg, o, d)  # noqa: E731
    turns = [("default", default), ("pretest", pretest),
             ("pretest", pretest), ("default", default)]
    ms = {"default": [], "pretest": []}
    for name, fn in turns:
        ms[name].append(_cuda_ms(fn, REPS))
    plain_frame = _cuda_ms(
        lambda: trace_colors(flat, cfg, o, d, query=plain_query(cfg)), 1)
    out = {"frame": {"kernel_ms": statistics.mean(ms["default"]),
                     "turns_ms": ms["default"], "plain_ms": plain_frame},
           "pretest_frame": {"kernel_ms": statistics.mean(ms["pretest"]),
                             "turns_ms": ms["pretest"]}}
    for k in ("frame", "pretest_frame"):
        out[k]["rays_per_s"] = frame_rays / out[k]["kernel_ms"] * 1e3
    print(f"  bench frame {RES}x{RES} ({frame_rays} rays), turns default/"
          f"pretest/pretest/default: {[round(m, 3) for m in ms['default']]}"
          f" / {[round(m, 3) for m in ms['pretest']]} ms; default "
          f"{out['frame']['kernel_ms']:.3f} ms "
          f"({out['frame']['rays_per_s']:.4g} rays/s), cull_pretest + "
          f"cull_recull={RECULL} {out['pretest_frame']['kernel_ms']:.3f} ms "
          f"({out['pretest_frame']['rays_per_s']:.4g} rays/s); plain walk "
          f"{plain_frame:.3f} ms")
    for label, rows in (("bench", frame_rows), ("bench pretest", pre_rows)):
        for row in rows:
            kw = row["kw"]
            row["kernel_ms"] = _kernel_ms(row, REPS * 4)
            name = ("any_hit" if kw["any_hit"] else "nearest")
            print(f"  {label} {name} query ({row['q'].origin.shape[0]} rays, "
                  f"pretest={kw.get('pretest', False)}, recull_every="
                  f"{kw.get('recull_every', 0)}): kernel "
                  f"{row['kernel_ms']:.3f} ms, plain walk "
                  f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
                  f"({row['bound_by']}: {row['ops']:.4g} ops, "
                  f"{row['bytes']:.4g} bytes; overhead {row['overhead_ops']:.4g}"
                  f" ops), trips mean "
                  f"{float(row['iters'].float().mean()):.2f} max "
                  f"{int(row['iters'].max())}")

    iscene, icfg, camera, irows, live_rays = inst
    inst_ms = _cuda_ms(lambda: render_image_instanced(iscene, icfg, camera),
                       REPS)
    for row in irows:
        row["kernel_ms"] = _kernel_ms(row, REPS)
    k_sum = sum(r["kernel_ms"] for r in irows)
    p_sum = sum(r["plain_ms"] for r in irows)
    b_sum = sum(r["bound_ms"] for r in irows)
    calls = [{"rays": int(r["q"].origin.shape[0]),
              "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
              "bound_ms": r["bound_ms"], "ops": r["ops"],
              "overhead_ops": r["overhead_ops"],
              "trips_mean": float(r["iters"].float().mean()),
              "trips_max": int(r["iters"].max()),
              "tests_mean": float(r["out"].tests.float().mean()),
              "ray_tests_mean": float(r["out"].ray_tests.float().mean())}
             for r in irows]
    out["instanced_frame"] = {
        "ms": inst_ms, "live_rays": live_rays,
        "rays_per_s": live_rays / inst_ms * 1e3, "walk_calls": len(irows),
        "walk_kernel_ms": k_sum, "walk_plain_ms": p_sum,
        "walk_bound_ms": b_sum, "calls": calls}
    print(f"  instanced frame {RES}x{RES}: {inst_ms:.3f} ms, {live_rays} "
          f"live rays ({live_rays / inst_ms * 1e3:.4g} rays/s); its "
          f"{len(irows)} walk calls: kernel {k_sum:.3f} ms, plain walk "
          f"{p_sum:.3f} ms, bound {b_sum:.3f} ms in all")
    for i, c in enumerate(calls):
        print(f"    call {i}: kernel {c['kernel_ms']:.3f} ms, bound "
              f"{c['bound_ms']:.3f} ms ({c['ops']:.4g} ops; overhead "
              f"{c['overhead_ops']:.4g} ops), trips mean "
              f"{c['trips_mean']:.2f} max {c['trips_max']}, tested "
              f"{c['tests_mean']:.2f}, ray tests {c['ray_tests_mean']:.1f}")
    # The same frame with the walk's opt-ins turned off, between two turns
    # of the defaults.
    walks = {"defaults": [], **{name: [] for name, _ in INSTANCED_WALKS}}
    for name, kw in (("defaults", {}),) + INSTANCED_WALKS + (
            ("defaults", {}),):
        walks[name].append(_instanced_ms(iscene, icfg, camera, kw))
    out["instanced_walks_ms"] = walks
    print("  instanced frame by walk setting (turns of 1 frame after a "
          "warm-up): " + "; ".join(f"{k} {[round(m, 3) for m in v]} ms"
                                   for k, v in walks.items()))
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


_VARIANT = re.compile(r"walk_kernel<(\w+), (\d), (\w+)>")


def _variant(name):
    from raytpu_torch.kernels.fused import kernel_name

    m = _VARIANT.search(name)
    if not m:
        return "other"
    return kernel_name(m.group(1) == "true", m.group(3) == "true")


def _profile(frame, frames):
    """torch.profiler over ``frames`` calls of ``frame``: device ms per
    frame by walk kernel variant, busy share of the window, and the host's
    blocking reads of device values (aten::_local_scalar_dense)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
    events = prof.events()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    syncs = [e for e in events if e.device_type == DeviceType.CPU
             and e.name == "aten::_local_scalar_dense"]
    groups = {}
    for e in dev_events:
        g = _variant(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.end - e.time_range.start
    total = sum(groups.values())
    out = {"device_events": len(dev_events),
           "host_syncs_per_frame": len(syncs) / frames,
           "host_sync_ms_per_frame": sum(
               e.time_range.end - e.time_range.start for e in syncs)
           / frames / 1e3}
    if total > 0:
        spans = [(e.time_range.start, e.time_range.end) for e in dev_events]
        window = max(s[1] for s in spans) - min(s[0] for s in spans)
        busy = _merged_span(spans)
        out["busy_share"] = busy / window
        out["idle_ms_per_frame"] = (window - busy) / frames / 1e3
        out["per_frame_ms"] = {k: v / frames / 1e3 for k, v in groups.items()}
        out["shares"] = {k: v / total for k, v in groups.items()}
    return out


def _print_profile(p, frames):
    if "busy_share" not in p:
        print("  torch.profiler recorded no device time: breakdown not "
              "measured")
        return
    print(f"  torch.profiler over {frames} frames, device ms per frame: "
          + ", ".join(f"{k} {v:.3f} ({p['shares'][k]:.1%})"
                      for k, v in sorted(p["per_frame_ms"].items()))
          + f"; device busy {p['busy_share']:.1%} of the window, idle "
          f"{p['idle_ms_per_frame']:.3f} ms per frame; host syncs "
          f"{p['host_syncs_per_frame']:.0f} per frame, "
          f"{p['host_sync_ms_per_frame']:.3f} ms blocked in them")


def phase_profile(card, flat, cfg, rays, inst, record):
    from raytpu_torch.render.instanced import render_image_instanced
    from raytpu_torch.render.wavefront import render_rays

    o, d = rays

    def frame():
        render_rays(flat, cfg, o, d)

    ms = [_cuda_ms(frame, 1) for _ in range(SPREAD_FRAMES)]
    q1, med, q3 = statistics.quantiles(ms, n=4)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] {card}")
    print(f"  bench frame over {SPREAD_FRAMES} frames (CUDA events): median "
          f"{med:.3f} ms, quartiles {q1:.3f} / {q3:.3f}, min {min(ms):.3f}, "
          f"max {max(ms):.3f}; host clock with synchronize, median of 10: "
          f"{statistics.median(host):.3f} ms")
    bench = _profile(frame, PROFILED_FRAMES)
    _print_profile(bench, PROFILED_FRAMES)
    iscene, icfg, camera = inst
    print("  instanced frame:")
    instanced = _profile(
        lambda: render_image_instanced(iscene, icfg, camera), 3)
    _print_profile(instanced, 3)
    record.append({"what": "profile", "card": card, "frames": ms,
                   "median_ms": med, "host_median_ms": statistics.median(host),
                   "bench": bench, "instanced": instanced})


def _kernel_entry(name, replaces, launches, err, rows):
    """One kernel's line: times, bound and trips summed or averaged over
    the walk calls ``rows`` it was measured on."""
    iters = torch.cat([r["iters"].float() for r in rows])
    n = len(rows)
    bound_by = {r["bound_by"] for r in rows}
    return {"name": name, "route": "cuda",
            "source": "raytpu_torch/kernels/csrc/walk.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": sum(r["kernel_ms"] for r in rows) / n,
            "plain_ms": sum(r["plain_ms"] for r in rows) / n,
            "bound_ms": sum(r["bound_ms"] for r in rows) / n,
            "bound_by": bound_by.pop() if len(bound_by) == 1 else "operations",
            "library_ms": None,
            "trips": {"mean": float(iters.mean()), "max": int(iters.max())},
            "calls": n}


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
    flat, cfg, rays, img, frame_rows, launches = phase_frame(dev, record)
    iscene, icfg, camera, inst_rows, inst_launches, live_rays = \
        phase_instanced(dev, record)
    pcfg, pre_rows, pre_launches = phase_pretest_frame(
        flat, cfg, rays, img, frame_rows, record)
    phase_times(card, flat, cfg, pcfg, rays, frame_rows, pre_rows,
                (iscene, icfg, camera, inst_rows, live_rays), record)
    phase_profile(card, flat, cfg, rays, (iscene, icfg, camera), record)

    def rows_of(rows, any_hit, pretest):
        return [r for r in rows if r["kw"]["any_hit"] == any_hit
                and r["kw"].get("pretest", False) == pretest]

    def err_of(name, *row_sets):
        return max([small_err.get(name, 0.0)]
                   + [r["err"] for rows in row_sets for r in rows])

    variant = "raytpu/kernels/fused.py:299 (pretest, recull_every)"
    kernels = [
        _kernel_entry("walk_kernel<nearest>", "raytpu/kernels/fused.py:959",
                      launches["nearest"],
                      err_of("nearest", rows_of(frame_rows, False, False)),
                      rows_of(frame_rows, False, False)),
        _kernel_entry("walk_kernel<any_hit>", "raytpu/kernels/fused.py:299",
                      launches["any_hit"],
                      err_of("any_hit", rows_of(frame_rows, True, False)),
                      rows_of(frame_rows, True, False)),
        _kernel_entry(f"walk_kernel<nearest, pretest> recull_every={RECULL}",
                      variant, inst_launches["nearest_pretest"],
                      err_of("nearest_pretest", inst_rows,
                             rows_of(pre_rows, False, True)),
                      inst_rows),
        _kernel_entry(f"walk_kernel<any_hit, pretest> recull_every={RECULL}",
                      variant, pre_launches["any_hit_pretest"],
                      err_of("any_hit_pretest", rows_of(pre_rows, True, True)),
                      rows_of(pre_rows, True, True)),
    ]
    for k in kernels:
        if not (math.isfinite(k["ms"]) and k["launches"] > 0):
            raise AssertionError(f"{k['name']}: no time or no launch")
    (args.out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernels": kernels,
         "records": record}, indent=1, default=str))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
