"""Drive the PyTorch/CUDA port's render and fit paths on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing its lines:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: compile the walk kernels (``raytpu_torch/kernels/csrc/walk.cu``,
   ``subwalk.cu`` and ``mxuwalk.cu``, one ``nvcc`` each, started
   together);
3. small: every walk kernel variant against its plain PyTorch version, bit
   for bit, trip counts and resolved flags included (nearest and any-hit;
   pretest on and off; re-cull every 0, 1, 2 and 6 trips; the prepick walk
   with 2, 3 and 64 picks, with tiles that settle on their first trip and
   tiles that use up their picks, every block twice and origins on the
   ground; trip budgets 1 and 4; cluster sizes 10 (the
   classic walk's scalar pair test), 16 and 128;
   the subcluster walk at cluster sizes 64 and 32 with cull True, False
   and "reverse", planes on and off, the gate on and off, 1, 2 and 3 picks
   a trip and trip budgets 1 and 4, every block twice (tied keys) and rays
   starting on the ground (zero keys, +0 and -0 hit distances); the
   classic walk with 2 and 3 picks a
   trip; ignore ids, t bounds, NaN bounds and non-finite rays), the routing
   on a subcluster bake, the overflow strategies on the card against the
   CPU, and small renders, baked and instanced, on the card against the
   CPU;
4. frame: bench.py's ~1M-triangle terrain at 1024x1024 through
   ``render_rays`` with its launch counters checked, then the frame's
   queries through the kernels and the plain walk;
4a. mxu: the tensor-core walk (``mxu_walk_kernel``, the matmul pair test
   on a ``gblock`` bake) against its plain version at both precisions on
   small scenes (cluster sizes 128, 32 and 16; nearest and any-hit; cull
   True, False and "reverse"; pretest and re-cull; a budget of 8 trips
   and the phase-1 compaction, card against CPU; chunk_k 2, alone and with
   pretest and re-cull; ignore ids; whole warps of every tile dead and
   only a few live rays a tile, the rows the kernel lists),
   every ray whose winner differs traced to a margin below MXU_EPS or an
   exact-t tie within MXU_RTOL, at most one in 10^4 rays; then the bench
   frame baked with ``gblock`` through ``nearest_hit_fused(mxu=True)`` at
   both precisions, its launch counters checked, every walk call against
   the plain version, timed, with its bound; and the "highest" frame
   against the exact walk's frame, every pixel that differs traced;
4b. query: the flagship at 1024x1024 with three bounces through ``AUTO``
   (the brute-force sweep: no walk launched) against the walk at the 32
   and 128 bakes: each of AUTO's queries through the walk, its differing
   rays traced, and the two frames slot by slot over their ray trees,
   every pixel that differs before the framebuffer's rounding traced to a
   query, light threshold or texel edge of its tree; the bench frame's
   queries through the tiled and octree backends against the walk's hits,
   timed (octree steps and host reads); the bench frame with
   ``shadow_clearance=True`` against the default frame;
5. instanced: one bake of that terrain instanced 4 times (2x2, rotated by
   multiples of 90 degrees, ~4M triangles in the world) through
   ``render_image_instanced`` at 1024x1024 with one reflection, the
   pretest variant's launch counter checked; every walk call of the frame
   held against the plain walk on every 128th whole tile and the 4 tiles
   with the most trips;
6. subcluster frame: the bench frame baked at cluster sizes 64 and 32
   (bench.py's BENCH_CSIZE): the defaults take the subcluster walk, every
   walk call against the plain walk, the image the 128 frame's up to
   exact-t ties; the gate and 2 and 4 picks a trip on the frame's queries;
   the gated and ``cull_chunk=4`` renders at 32 and the ``cull_chunk=2``
   render at 128 (the classic walk's group kernel), each counted and the
   same image;
7. flagship: ``__graft_entry__.py``'s flagship scene (transparent,
   textured, two lights) at 1024x1024 with entry()'s three bounces, baked
   at 32 and 128: every query through both bakes (the same hits, exact-t
   ties counted), every walk call against the plain walk, frame ms and live
   rays/s with the slots and live rays per level; one step of the dryrun's
   fit on the 32 bake at 512x512; card against CPU gradients at 32x32;
8. instanced 32: the instanced frame from a cluster_size=32 bake with the
   defaults (the block walk) and with the pretest and re-cull off (the
   subcluster walk), gate off and on, calls against the plain walk on every
   128th tile and, the subcluster walk's, on the 4 tiles with the most
   trips (of the calls whose longest tile walks over 1,000 trips, every
   eighth one, the gate off and on taking turns; the gated walk's other
   such calls against the ungated walk's outputs on every tile, bit for
   bit but for the counters), those calls timed with
   their bounds, frame ms in turns against the 128 bake (and both bakes'
   block walks with the re-cull off);
9. pretest frame: the bench frame with ``cull_pretest=True,
   cull_recull=6``, counters checked, the image equal to the default
   frame's, its queries through the kernels and the plain walk;
10. overflow: the bench frame with ``cull_prepick`` 64 and 8 and
    ``cull_phase1`` 2 and 8: the bounded walk's counter and, where the
    budget overflows, the finishing walk's (the rescue, phase 2) checked,
    the image equal to the default frame's, every walk call against its
    plain version;
11. fit: bench.py's backward workload (512x512 gradient steps on the
    terrain, geometry, then the textured terrain's atlas, bilinear) with
    step times, backward rays/s and a step's split; a 6-step Adam fit with
    re-bakes from a height-scaled terrain; card against CPU gradients on a
    small scene;
12. times: ms per frame and rays/s (bench frame by walk setting, in turns;
    instanced frame, counting every query's live rays, with the walk's
    defaults, with the re-cull, the pretest or both turned off, and with
    the overflow strategies), ms per walk call, kernels against the plain
    walk, and the overflow strategies' calls with their bounds and overflow
    shares; then the subcluster and chunked bench frames in turns and their
    calls;
13. profile: the bench frame's spread and torch.profiler breakdown, the
    instanced frame's device ms per kernel variant, busy share and the
    host syncs of its per-instance pass skips, and the flagship frame's
    (32 bake) device ms: the walks against the shading's kernels;
14. cli: the user-facing render path: the bench frame supersampled
    (quality 1, a padded tail of dead quadrants in its last batch) and
    ``python -m raytpu_torch render`` of ``assets/demo.toml`` at 1024x1024
    supersampled with eight reflections, in process, each with its ms,
    live corner rays, rays/s, walk launches and device busy share, the
    first and last of their walk calls and a spread of the rest held
    against the plain walk (dead quadrants and level-1 batches among
    them), the demo's PNG read back as the returned image; its normals and
    convex channels; ``animate`` into a DIB AVI and, where Pillow imports,
    an MJPG one, read back, and ``--resume`` re-rendering one deleted
    frame into the same AVI; ``fit --steps 2`` on ``assets/crate.toml``;
    ``cast_screen_ray`` card against CPU; a scripted viewer session.

Each phase prints its seconds (``[clock]``).  Then one JSON line with the
kernels (time, plain time, launches, trips per tile, the least time the
card could take for the same work and its share of the time) and, last,
the device line.  Any failure raises and the script exits nonzero; without
a CUDA device it exits nonzero before printing a result.  The compiler log
and every comparison and time go to ``--out`` (default
``build/chip_smoke``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
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
GEO_ROWS_USED = 9  # block rows the det and u*det of a pair read
# What a pair needs by how far the tests' early-outs take it (walk_common.cuh
# test4): det and its sign test, OPS_DET; with a det that passes its cull's
# sign test, u*det and its sign test too, OPS_U more; with both passing,
# the rest of OPS_PAIR.  The bound counts these per pair (``sign_pairs``).
OPS_DET = 6
OPS_U = 12
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
# The overflow strategies' settings: picks per tile (7,811 = every cluster of
# the bench bake) and phase-1 trip budgets.  The prepick walk refuses the
# pretest and the re-cull, so its instanced turns turn them off.
OVERFLOW_SETTINGS = (("cull_prepick=64", {"cull_prepick": 64}),
                     ("cull_prepick=8", {"cull_prepick": 8}),
                     ("cull_phase1=2", {"cull_phase1": 2}),
                     ("cull_phase1=8", {"cull_phase1": 8}))
# Settings whose finishing walk (the rescue or phase 2) must run on the
# bench frame: 8 picks and 2 or 8 trips are below its tiles' deepest walks.
MUST_FINISH = ("cull_prepick=8", "cull_phase1=2", "cull_phase1=8")
TIMED_OVERFLOW = (("cull_prepick=64", {"cull_prepick": 64}),
                  ("cull_prepick=7811", {"cull_prepick": 7811}),
                  ("cull_phase1=2", {"cull_phase1": 2}),
                  ("cull_phase1=8", {"cull_phase1": 8}))
NO_OPT_INS = {"cull_pretest": False, "cull_recull": 0}
# The instanced frames' walk calls are held against the plain walk on every
# INSTANCED_TILE_STRIDE-th whole tile (tiles walk independently; the full
# plain walk of the frame's reflection calls takes ~500 s).
INSTANCED_TILE_STRIDE = 128
# ... and on the tiles with the most trips (thousands in the reflection
# walks: hundreds of re-culls, the lazy re-cull's epochs wrapping).
INSTANCED_LONGEST = 4
# [instanced 32]: calls whose longest tile walks more trips than this are
# deep; the two subcluster settings hold every eighth one's longest tiles.
INSTANCED_DEEP = 1000
# bench.py's BENCH_CSIZE settings of the subcluster frames, and the
# subcluster walk's shapes run on their queries: the gate and multi-block
# trips.
SUB_FRAME_SIZES = (64, 32)
SUB_FRAME_WALKS = (("gate", {"gate": True}), ("chunk_k=2", {"chunk_k": 2}),
                   ("chunk_k=4", {"chunk_k": 4}))
# What the gate keeps: every output but the counters, bit for bit.  More
# picks a trip keep the hits and their t (an exact-t tie between blocks of
# one trip may go to the earlier pick).
GATE_KEEPS = ("t", "code", "u", "v", "tri", "rows", "resolved")
# cull_chunk of the chunked bench renders: the classic walk at 128 and the
# subcluster walk at 32.
CHUNK_CLASSIC = 2
CHUNK_SUB = 4
# The flagship: __graft_entry__.py's scene and entry()'s camera and three
# bounces at full size, baked at cluster sizes 32 (the dryrun's bake) and
# 128; one step of the dryrun's fit (its fields, Adam 1e-2, soft_tau 0.01,
# one reflection) at 512x512; card against CPU gradients at 32x32.
FLAGSHIP_RES = 1024
FLAGSHIP_REFLECTIONS = 3
FLAGSHIP_CAMERA = (0.0, 16.0, 32.0)
FLAGSHIP_SIZES = (32, 128)
FLAGSHIP_FIT_RES = 512
FLAGSHIP_GRAD_RES = 32
FLAGSHIP_FIELDS = ("tri_v1", "textures", "mat_reflect")
# The fit workload: bench.py's backward resolution and timed steps; the
# Adam fit's steps, re-bake period, height scale and learning rate.
FIT_RES = 512
FIT_STEPS = 3
FIT_ADAM_STEPS = 6
FIT_REBUILD = 3
FIT_HEIGHT_SCALE = 1.03
FIT_LR = 1e-4
# Card against CPU gradients: index_add_ sums a row's cotangents in another
# order on the card (atomics), so they agree to rounding, not bit for bit.
FIT_RTOL = 1e-4
FIT_ATOL = 1e-6


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


def _walks(walk):
    """The kernel and the plain version of the walk that the options
    ``walk`` name: the prepick walk when they give ``picks``, the
    subcluster walk when they give ``gate`` (``nearest_hit_fused`` always
    passes it to that walk), else the classic walk."""
    from raytpu_torch.kernels import fused

    if "picks" in walk:
        return fused.prepick_cuda, fused.prepick_plain
    if "gate" in walk:
        return fused.subwalk_cuda, fused.subwalk_plain
    return fused.walk_cuda, fused.walk_plain


def reset_launches():
    from raytpu_torch.kernels import fused

    for k in fused.LAUNCHES:
        fused.LAUNCHES[k] = 0


def read_launches():
    from raytpu_torch.kernels import fused

    torch.cuda.synchronize()
    return dict(fused.LAUNCHES)


def _ran(launches):
    """The launch counts that are not 0."""
    return {k: v for k, v in launches.items() if v}


def compare_walks(clusters, tri_shade, q, what, record, got=None, **walk):
    """The kernel (``got``, or a fresh launch) and the plain walk on the
    same padded query; raises unless every output, trip counts and
    resolved flags included, agrees bit for bit.  Returns (max abs
    difference, plain walk ms)."""
    kernel, plain = _walks(walk)
    if got is None:
        got = kernel(clusters, tri_shade, q, **walk)
    ref, plain_ms = _once_ms(lambda: plain(clusters, tri_shade, q, **walk))
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
    unresolved = int((got.resolved == 0).sum())
    trips = got.iters.float()
    rec = {"what": what, "walk": {k: str(v) for k, v in walk.items()},
           "rays": int(q.origin.shape[0]), "hits": hits,
           "unresolved": unresolved, "max_abs_err": err,
           "trips_mean": float(trips.mean()), "trips_max": int(trips.max()),
           "tests_mean": float(got.tests.float().mean()),
           "ray_tests_mean": float(got.ray_tests.float().mean()),
           "plain_ms": plain_ms, "mismatch": bad}
    record.append(rec)
    print(f"  {what}: {walk} rays={q.origin.shape[0]} hits={hits} "
          f"unresolved={unresolved} trips "
          f"mean {rec['trips_mean']:.2f} max {rec['trips_max']} tested "
          f"{rec['tests_mean']:.2f} ray tests {rec['ray_tests_mean']:.1f}, "
          f"plain walk {plain_ms:.0f} ms, "
          f"{'bitwise equal' if not bad else 'MISMATCH ' + '; '.join(bad)}")
    if bad:
        raise AssertionError(f"kernel and plain walk disagree on {what}")
    return err, plain_ms


def _group_kernel(walk):
    """Whether the walk options ``walk`` launch the group kernel
    (csrc/subwalk.cu): the subcluster walk, or more than one pick a trip
    without the matmul pair test."""
    return ("gate" in walk or walk.get("chunk_k", 1) > 1) and not walk.get(
        "mxu")


@contextlib.contextmanager
def _counting(count, on_test):
    """Inside, the plain walks call ``on_test(walk, idx, k, o3, d3, w3,
    tmax0, cull, any_hit, state, block, lo, hi)`` before each cluster test,
    ``walk`` holding the chunk's prologue (``tiles``) and its first tile in
    the query (``base``; the plain walk takes the tiles in chunks).  Yields
    ``count``."""
    from raytpu_torch.kernels import fused

    walk = {}
    prologue, test_cluster = fused._prologue, fused._test_cluster

    def prologue_hook(root, o, *args):
        walk["base"] = walk.get("next", 0)
        walk["next"] = walk["base"] + o.shape[0]
        walk["tiles"] = prologue(root, o, *args)
        return walk["tiles"]

    def test_hook(block, idx, k, o3, d3, w3, itri, imesh, tmax0, cull,
                  any_hit, state, lo=0, hi=None, **mxu):
        on_test(walk, idx, k, o3, d3, w3, tmax0, cull, any_hit, state, block,
                lo, hi)
        return test_cluster(block, idx, k, o3, d3, w3, itri, imesh, tmax0,
                            cull, any_hit, state, lo, hi, **mxu)

    fused._prologue, fused._test_cluster = prologue_hook, test_hook
    try:
        yield count
    finally:
        fused._prologue, fused._test_cluster = prologue, test_cluster


@contextlib.contextmanager
def reached_pairs(clusters, sampled=None):
    """Inside, the plain walks on ``clusters`` count the pairs the group
    kernel must test: for every sibling pass a trip runs, its lanes times
    the rays of its tiles that are unresolved at the trip's start and
    reach the sibling's box (widened by the root margin) before their best
    so far (any-hit: their t bound, until a hit).  The kernel skips only
    the other rays' pairs, and its warps test no fewer, so the count bounds
    its pair tests from below.  ``sampled``: count those tiles only (a
    pass none of them runs costs one look).  Yields a one-element list:
    the count."""
    from raytpu_torch.kernels import fused

    boxes = clusters.get("sub_aabb", clusters["aabb"][None])
    margin = clusters["root"][6]

    def on_test(walk, idx, k, o3, d3, w3, tmax0, cull, any_hit, state,
                block, lo, hi):
        keep = None if sampled is None else sampled[walk["base"] + idx]
        if keep is not None and not bool(keep.any()):
            return
        lanes = (block.shape[2] if hi is None else hi) - lo
        box = boxes[lo // lanes][:, k, None]  # (6, m, 1)
        if any_hit:
            cap = torch.where(state["bc"][idx] >= 0, -fused.INF, tmax0[idx])
        else:
            cap = torch.minimum(state["bt"][idx], tmax0[idx])
        s_en = torch.full_like(cap, -fused.INF)
        s_ex = torch.full_like(cap, fused.INF)
        for c in range(3):
            dc = d3[c][idx]
            inv = 1.0 / torch.where(dc == 0.0, fused._TINY_DIR, dc)
            t1 = (box[c] - margin - o3[c][idx]) * inv
            t2 = (box[3 + c] + margin - o3[c][idx]) * inv
            s_en = torch.maximum(s_en, torch.minimum(t1, t2))
            s_ex = torch.minimum(s_ex, torch.maximum(t1, t2))
        reach = ((s_en <= s_ex) & (s_ex >= 0.0) & (s_en < cap)
                 & ~walk["tiles"].resolved[idx])
        if keep is not None:
            reach &= keep[:, None]
        count[0] = count[0] + reach.sum() * lanes

    count = [0]
    with _counting(count, on_test):
        yield count
    count[0] = float(count[0])


@contextlib.contextmanager
def sign_pairs(mxu=None):
    """Inside, the plain classic and prepick walks count the pairs of the
    rays unresolved at each test (any-hit: without a hit yet) by how far
    the early-outs of the pair test take them: all of them, those whose det
    passes its cull's sign test, and those whose det and u*det pass it
    (walk_common.cuh ``det_ok``, ``u_ok``).  ``mxu``: the plain tensor-core
    walk at that precision instead, whose tests take every ray that is not
    dead (any-hit: without a hit yet), with det and u*det as its product
    rounds them.  Yields the three counts."""
    from raytpu_torch.kernels import fused

    def on_test(walk, idx, k, o3, d3, w3, tmax0, cull, any_hit, state,
                block, lo, hi):
        if mxu:
            det, udet = fused._pair_values(block, idx, k, o3, d3, w3, lo, hi,
                                           mxu)[:2]
            live = walk["tiles"].finite[idx] & (tmax0[idx] > 0.0)
        else:
            g = block[k, :GEO_ROWS_USED, lo:hi]
            col = lambda x: x[idx][:, :, None]  # noqa: E731
            row = lambda i: g[:, i, None, :]  # noqa: E731
            det = (col(d3[0]) * row(0) + col(d3[1]) * row(1)
                   + col(d3[2]) * row(2))
            udet = (col(w3[0]) * row(6) + col(w3[1]) * row(7)
                    + col(w3[2]) * row(8) + col(d3[0]) * row(3)
                    + col(d3[1]) * row(4) + col(d3[2]) * row(5))
            live = ~walk["tiles"].resolved[idx]
        if any_hit:
            live &= state["bc"][idx] < 0
        live = live[:, :, None].expand_as(det)
        if cull is True:
            d_ok, u_ok = det < 0, (udet <= 0) & (det < 0)
        elif cull == "reverse":
            d_ok, u_ok = det > 0, (udet >= 0) & (det > 0)
        else:
            sgn = torch.where(det < 0, -1.0, 1.0)
            d_ok, u_ok = det != 0, (udet * sgn >= 0) & (det * sgn > 0)
        count[0] += int(live.sum())
        count[1] += int((live & d_ok).sum())
        count[2] += int((live & u_ok).sum())

    count = [0, 0, 0]
    with _counting(count, on_test):
        yield count


def compare_counted(clusters, tri_shade, q, what, record, got, whole,
                    sampled, **walk):
    """compare_walks on the query ``q``, and what the bound counts: for the
    group kernel, the pairs it must test (``reached_pairs``), otherwise,
    on a whole query, the pairs by early-out stage (``sign_pairs``): (max
    abs err, plain ms, pairs or None, signs or None).  ``q`` may hold a
    subset of the call ``whole``'s tiles; ``sampled`` (None: all) are
    those counted, and the count is scaled by the call's ray tests over
    theirs."""
    counted = got.ray_tests if sampled is None else got.ray_tests[sampled]
    scale = (float(whole.ray_tests.double().sum())
             / max(float(counted.double().sum()), 1.0))
    if not _group_kernel(walk):
        if sampled is not None:
            return (*compare_walks(clusters, tri_shade, q, what, record,
                                   got=got, **walk), None, None)
        with sign_pairs() as signs:
            err, plain_ms = compare_walks(clusters, tri_shade, q, what,
                                          record, got=got, **walk)
        return err, plain_ms, None, signs
    with reached_pairs(clusters, sampled) as count:
        err, plain_ms = compare_walks(clusters, tri_shade, q, what, record,
                                      got=got, **walk)
    return err, plain_ms, count[0] * scale, None


def walk_bound(q, out, clusters, walk, pairs=None, signs=None):
    """The least time the card could take for one walk call: the
    ray-triangle pairs the function needs (each tested cluster's or, in the
    subcluster walk, each sibling pass's unresolved rays, the walk's
    ``ray_tests``, times the triangles of a cluster or a pass) at OPS_PAIR
    operations each; bytes from each input read once and each output
    written once (the 18 used rows of every cluster block and the cull
    tables counted once).  ``signs``: those pairs by early-out stage
    (``sign_pairs``), each at what it needs: OPS_DET, OPS_DET + OPS_U or
    OPS_PAIR (without them, from calls timed without their plain walk,
    every pair at OPS_PAIR).  ``pairs``: the group kernel's, which tests a
    ray's pass only when the ray reaches the pass's box (``reached_pairs``):
    those pairs at OPS_PAIR each and a box test (OPS_PRETEST) for each of
    ``ray_tests``.  The walk's own overheads (entry bounds of the prologue
    and of each re-cull, the per-trip pick, the pretest) are counted apart
    in ``overhead_ops`` and are not part of the bound."""
    from raytpu_torch.accel.clusters import leaves_per_block

    any_hit, pretest = walk["any_hit"], walk.get("pretest", False)
    recull = walk.get("recull_every", 0)
    rows = walk.get("rows", "picks" not in walk) and not any_hit
    ncg, _, csize = clusters["block"].shape
    subk = leaves_per_block(clusters) if "gate" in walk else 1
    lanes = csize // subk  # triangles per tested cluster or pass
    ts = q.tile
    r, nt = q.origin.shape[0], q.origin.shape[0] // ts
    live = (torch.isfinite(q.origin).all(-1)
            & torch.isfinite(q.direction).all(-1)).reshape(nt, ts)
    live = live.sum(1).double()
    trips = out.iters.double()
    reculls = ((trips - 1).clamp(min=0) // recull if recull
               else torch.zeros_like(trips))
    ops = float(out.ray_tests.double().sum()) * lanes * OPS_PAIR[any_hit]
    if signs is not None:
        n, n_det, n_u = signs
        ops = (n * OPS_DET + n_det * OPS_U
               + n_u * (OPS_PAIR[any_hit] - OPS_DET - OPS_U))
    if pairs is not None:
        ops = (pairs * OPS_PAIR[any_hit]
               + float(out.ray_tests.double().sum()) * OPS_PRETEST)
    overhead = float((trips * ncg * OPS_PICK
                      + (live > 0) * (1 + reculls) * ncg * subk * OPS_ENTRY
                      + (trips * live * OPS_PRETEST if pretest else 0)).sum())
    nbytes = (r * 36 + ncg * (6 + 11 * subk + 18 * csize) * 4 + 32 + nt * 12
              + r * (12 if any_hit else 24))
    if rows:
        nbytes += r * 128 + int((out.code >= 0).sum()) * 128
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "pairs": pairs, "bytes": nbytes,
            "overhead_ops": overhead,
            "counted": "by stage" if signs is not None else "every pair"}


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


def _small_scene(cluster_size, device, light="both", **flatten_kw):
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
                                      device=device, **flatten_kw)


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
                            (True, 6), (True, 1))]
# Cluster sizes of the small comparisons: 10 takes the classic walk's
# scalar pair test (not a multiple of 4 lanes).
SMALL_SIZES = (10, 16, 128)
# Budgets of the small overflow comparisons: the prepick walk's picks and
# the classic walk's trip budget, small enough to overflow and not.
SMALL_PICKS = (2, 3, 64)
SMALL_TRIPS = (1, 4)
# The small subcluster comparisons: cluster sizes, picks per trip, trip
# budgets; and the classic walk's chunked shapes (chunk_k, pretest,
# re-cull).
SUB_SIZES = (64, 32)
SMALL_CHUNKS = (1, 2, 3)
SMALL_CLASSIC_CHUNKS = ((2, False, 0), (3, False, 0), (2, True, 2),
                        (3, True, 6))


def _small_rays(rng, n, scene, dev):
    """The small comparisons' rays: origins above the plane, unit
    directions, a NaN origin, an infinite and a NaN direction (with a NaN t
    bound, as instanced shadow queries give dead lanes), random ignore ids
    and t bounds."""
    o = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[7, 0] = np.nan
    d[11, 2] = np.inf
    d[300, :] = np.nan
    tm = rng.uniform(2.0, 30.0, size=n).astype(np.float32)
    tm[300] = np.nan
    itri = rng.integers(-1, scene.num_tris, size=n).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (o, d, itri, tm))


def _prepick_shapes(scene, q, what, record, any_hit):
    """The prepick walk's two ends against its plain version: tiles that
    settle on their first trip (rays straight down onto one of the plane's
    two triangles from just above it, beside the sphere: an any-hit query
    settles at its hits in the first block) and tiles that use up all their
    picks and hold rays unresolved (2 picks, the query ``q``); every block
    twice (tied entries) and origins on the ground (entries of -0 and +0).
    Returns the largest abs difference and which of the two ends
    occurred."""
    from raytpu_torch.kernels.fused import pack_query, prepick_cuda

    dev = q.origin.device
    n = q.origin.shape[0]
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.uniform(-2, 2, size=(n, 3)).astype(
        np.float32)).to(dev)
    o[:, 0] -= 10.0
    o[:, 2] += 10.0
    o[:, 1] = 0.5
    d = torch.tensor([0.0, -1.0, 0.0], device=dev).expand(n, 3).contiguous()
    down = pack_query(o, d, t_max=torch.full((n,), 2.0, device=dev),
                      tile_size=RAYS_PER_TILE)
    tables = (scene.clusters, scene.tri_shade)
    err, shown = 0.0, []
    for label, qq, picks in ((" prepick settles first trip", down, 64),
                             (" prepick picks used up", q, 2)):
        got = prepick_cuda(*tables, qq, cull=True, any_hit=any_hit,
                           picks=picks)
        if label.endswith("trip"):
            shown.append(bool((got.iters == 1).any()
                              & (got.code >= 0).any()))
        else:
            shown.append(bool((got.iters == picks).any()
                              & (got.resolved == 0).any()))
        err = max(err, compare_walks(*tables, qq, what + label, record,
                                     got=got, cull=True, any_hit=any_hit,
                                     picks=picks)[0])
    o0 = q.origin.clone()
    o0[:, 1] = 0.0
    for label, tabs, qq in (
            (" prepick duplicated blocks",
             (_duplicated(scene.clusters), scene.tri_shade), q),
            (" prepick origins on the ground", tables, q._replace(origin=o0))):
        for picks in SMALL_PICKS:
            err = max(err, compare_walks(*tabs, qq, what + label, record,
                                         cull=False, any_hit=any_hit,
                                         picks=picks)[0])
    return err, shown


def _duplicated(clusters):
    """The walk tables of ``clusters`` with every block twice (ids k and
    k + ncg): every key is tied, and the walks must take the lower id."""
    tables = {"block": 0, "aabb": 1, "sub_aabb": 2, "sub_plane": 2}
    out = {k: torch.cat([clusters[k], clusters[k]], dim).contiguous()
           for k, dim in tables.items() if k in clusters}
    out["root"] = clusters["root"]
    return out


def _small_subcluster(dev, record, note):
    """The subcluster walk at cluster sizes 64 and 32 against its plain
    version (nearest and any-hit; cull True, False and "reverse"; planes
    on and off; the gate on and off; 1, 2 and 3 picks a trip; trip budgets
    1 and 4; every block twice, so that every key is tied; rays that start
    on the ground plane, with zero keys and +0 and -0 hit distances), the
    classic walk's chunked shapes, and the routing on a subcluster
    bake."""
    from raytpu_torch.kernels.fused import nearest_hit_fused, pack_query

    rng = np.random.default_rng(1)
    print("[small] subcluster and chunked walks vs their plain versions")
    for csize in SUB_SIZES:
        scene = _small_scene(csize, dev)
        tables = (scene.clusters, scene.tri_shade)
        o, d, itri, tmax = _small_rays(rng, 4096, scene, dev)
        what = f"csize {csize}"
        for any_hit in (False, True):
            q = pack_query(o, d, ignore_tri=itri,
                           t_max=tmax if any_hit else None,
                           tile_size=RAYS_PER_TILE)
            for cull in (True, False, "reverse"):
                for plane in (True, False):
                    for gate in (False, True):
                        for chunk in SMALL_CHUNKS:
                            note(any_hit, False, compare_walks(
                                *tables, q, what, record, cull=cull,
                                any_hit=any_hit, plane=plane, gate=gate,
                                chunk_k=chunk)[0], sub=True, gate=gate,
                                chunk=chunk > 1)
            for trips in SMALL_TRIPS:
                for gate, chunk in ((False, 1), (True, 3)):
                    note(any_hit, False, compare_walks(
                        *tables, q, what + " max_trips", record, cull=True,
                        any_hit=any_hit, gate=gate, chunk_k=chunk,
                        max_trips=trips)[0], budget=True, sub=True,
                        gate=gate, chunk=chunk > 1)
            # Ties: every block twice.  Zero keys and signed zeros: origins
            # on the ground plane (y = 0), inside its blocks' boxes.
            o0 = o.clone()
            o0[:, 1] = 0.0
            q0 = pack_query(o0, d, ignore_tri=itri,
                            t_max=tmax if any_hit else None,
                            tile_size=RAYS_PER_TILE)
            for label, tabs, qq in (
                    (" duplicated blocks", (_duplicated(scene.clusters),
                                            scene.tri_shade), q),
                    (" origins on the ground", tables, q0)):
                for cull in (True, False):
                    for gate, chunk in ((False, 1), (True, 1), (True, 2)):
                        note(any_hit, False, compare_walks(
                            *tabs, qq, what + label, record, cull=cull,
                            any_hit=any_hit, gate=gate, chunk_k=chunk)[0],
                            sub=True, gate=gate, chunk=chunk > 1)
        # The routing on a subcluster bake: the pretest, the re-cull and
        # the prepick walk take the block walk, without planes.
        for opts, want in (({}, "nearest_sub"), ({"pretest": True},
                                                 "nearest_pretest"),
                           ({"recull_every": 6}, "nearest"),
                           ({"prepick": 64}, "nearest_prepick"),
                           ({"any_hit": True}, "any_hit_sub")):
            reset_launches()
            nearest_hit_fused(scene, o, d, tile_size=RAYS_PER_TILE, **opts)
            ran = _ran(read_launches())
            print(f"  {what} routing {opts}: launches {ran}")
            if set(ran) != {want}:
                raise AssertionError(f"routing {opts} launched {ran}")
    for csize in (16, 128):
        scene = _small_scene(csize, dev)
        tables = (scene.clusters, scene.tri_shade)
        o, d, itri, tmax = _small_rays(rng, 4096, scene, dev)
        for any_hit in (False, True):
            q = pack_query(o, d, ignore_tri=itri,
                           t_max=tmax if any_hit else None,
                           tile_size=RAYS_PER_TILE)
            for chunk, pretest, recull in SMALL_CLASSIC_CHUNKS:
                note(any_hit, pretest, compare_walks(
                    *tables, q, f"csize {csize} chunk", record, cull=True,
                    any_hit=any_hit, chunk_k=chunk, pretest=pretest,
                    recull_every=recull)[0], chunk=True)
            note(any_hit, False, compare_walks(
                *tables, q, f"csize {csize} no planes", record, cull=True,
                any_hit=any_hit, plane=False)[0])
            # The subcluster walk on a bake of one leaf per block (the
            # reference's tlane walk at subk 1), gate on.
            note(any_hit, False, compare_walks(
                *tables, q, f"csize {csize} layout t", record, cull=True,
                any_hit=any_hit, gate=True, chunk_k=2)[0], sub=True,
                gate=True, chunk=True)


def phase_small(dev, record):
    from raytpu_torch import Intersector, Quantize, RenderConfig
    from raytpu_torch.core.camera import Camera
    from raytpu_torch.kernels.fused import (kernel_name, nearest_hit_fused,
                                            pack_query)
    from raytpu_torch.render.instanced import (flatten_instanced,
                                               render_image_instanced)
    from raytpu_torch.render.wavefront import render_image

    err = {}

    def note(any_hit, pretest, e, budget=False, prepick=False, **kind):
        name = kernel_name(any_hit, pretest, budget, prepick, **kind)
        err[name] = max(err.get(name, 0.0), e)

    rng = np.random.default_rng(0)
    prepick_ends = [False, False]
    print("[small] kernel vs plain walk on the card, sphere over plane")
    for csize in SMALL_SIZES:
        scene = _small_scene(csize, dev)
        tables = (scene.clusters, scene.tri_shade)
        o_t, d_t, itri, tmax = _small_rays(rng, 4096, scene, dev)
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
        # The bounded walks, flags included: the prepick walk and the
        # classic walk on a trip budget.
        for any_hit in (False, True):
            q = pack_query(o_t, d_t, ignore_tri=itri,
                           t_max=tmax if any_hit else None,
                           tile_size=RAYS_PER_TILE)
            for picks in SMALL_PICKS:
                note(any_hit, False, compare_walks(
                    *tables, q, what + " prepick", record, cull=True,
                    any_hit=any_hit, picks=picks)[0], prepick=True)
            e, shown = _prepick_shapes(scene, q, what, record, any_hit)
            note(any_hit, False, e, prepick=True)
            prepick_ends = [a or b for a, b in zip(prepick_ends, shown)]
            for trips in SMALL_TRIPS:
                for pretest, recull in ((False, 0), (True, 2)):
                    note(any_hit, pretest, compare_walks(
                        *tables, q, what + " max_trips", record, cull=True,
                        any_hit=any_hit, pretest=pretest,
                        recull_every=recull, max_trips=trips)[0],
                        budget=True)
        # The overflow strategies (rescue pass, phase 1 and 2) on the card against the
        # CPU: the same hits bit for bit.
        cpu = scene.to("cpu")
        for any_hit in (False, True):
            args = dict(ignore_tri=itri, t_max=tmax if any_hit else None,
                        any_hit=any_hit, tile_size=RAYS_PER_TILE)
            for strategy in ({"prepick": 2}, {"prepick": 64},
                           {"phase1_trips": 1}, {"phase1_trips": 4}):
                got, it = nearest_hit_fused(scene, o_t, d_t, **args, **strategy,
                                            return_iters=True)
                ref, it_ref = nearest_hit_fused(
                    cpu, o_t.cpu(), d_t.cpu(), return_iters=True, **strategy,
                    **{k: v.cpu() if torch.is_tensor(v) else v
                       for k, v in args.items()})
                same = all(_bits_equal(getattr(got, f).cpu(),
                                       getattr(ref, f)) for f in got._fields)
                print(f"  {what} {strategy} any_hit={any_hit}: hits "
                      f"{int(got.hit.sum())}, trips {int(it.sum())}, card "
                      f"and CPU {'bitwise equal' if same else 'DIFFER'}")
                if not same or not torch.equal(it.cpu(), it_ref):
                    raise AssertionError(f"{what} {strategy}: the card "
                                         "differs from the CPU")

    if not all(prepick_ends):
        raise AssertionError("the prepick walk's tiles never settled on "
                             "their first trip or never used up their "
                             f"picks: {prepick_ends}")
    _small_subcluster(dev, record, note)
    # The walk on the card against the CPU: small scenes take the sweep
    # under AUTO, so the walk is named.
    cfg = RenderConfig(width=64, height=64, max_reflections=2,
                       quantize=Quantize.NONE, tile_pixels=64 * 64,
                       intersector=Intersector.PALLAS)
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


def bench_scene(n_tris, reflect=0.0, textured=False, height_scale=1.0):
    """bench.py::build_scene with the port's bake (same mesh and light;
    ``textured``: its 128x128 checker atlas with uv_scale 4).
    ``height_scale`` scales the height field."""
    from raytpu_torch.scene.lights import SpotLight
    from raytpu_torch.scene.procedural import subdivided_plane
    from raytpu_torch.scene.types import Material, Scene, SceneObject

    tex = None
    if textured:
        yy, xx = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
        checker = (((xx // 8) + (yy // 8)) % 2).astype(np.uint8)
        tex = np.stack([checker * 180 + 40, checker * 120 + 60,
                        np.full_like(checker, 90)], axis=-1).astype(np.uint8)
    mat = Material(reflectiveness=reflect, use_texture=textured, texture=tex,
                   diffuse_color=(0.7, 0.6, 0.5, 1.0))
    divisions = max(8, int(round((n_tris / 2) ** 0.5)))
    mesh = subdivided_plane(
        size=(40.0, 40.0), divisions=divisions, material=mat,
        uv_scale=4.0 if textured else 1.0,
        height_fn=lambda x, z: height_scale * (
            2.0 * np.sin(x * 0.7) * np.cos(z * 0.7)
            + 0.5 * np.sin(x * 3.1) * np.sin(z * 2.3)))
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

    query.supports_rows = True
    return query


@contextlib.contextmanager
def recording_walks(calls=None):
    """Every ``walk_cuda``, ``subwalk_cuda`` and ``prepick_cuda`` call made
    inside: (clusters, tri_shade, query, options, output), in launch
    order, appended to ``calls`` (default: a new list)."""
    from raytpu_torch.kernels import fused

    calls = [] if calls is None else calls
    launchers = {"walk_cuda": fused.walk_cuda,
                 "subwalk_cuda": fused.subwalk_cuda,
                 "prepick_cuda": fused.prepick_cuda}

    def recorder(launch):
        def walk(clusters, tri_shade, q, **kw):
            out = launch(clusters, tri_shade, q, **kw)
            calls.append((clusters, tri_shade, q, kw, out))
            return out
        return walk

    for name, launch in launchers.items():
        setattr(fused, name, recorder(launch))
    try:
        yield calls
    finally:
        for name, launch in launchers.items():
            setattr(fused, name, launch)


def tile_subset(q, out, stride, longest=0):
    """Every ``stride``-th whole tile of the walk call ``q`` and its
    kernel output ``out``, and the ``longest`` tiles with the most trips:
    tiles walk independently, so the plain walk on those tiles alone must
    give their outputs and counters bit for bit.  Also which of the
    subset's tiles are the ``stride``-th ones."""
    from raytpu_torch.kernels.fused import _PER_TILE, Query

    ts = q.tile
    nt = q.origin.shape[0] // ts
    tiles = torch.arange(0, nt, stride, device=q.origin.device)
    if longest:
        most = out.iters.argsort(descending=True, stable=True)[:longest]
        tiles = torch.unique(torch.cat([tiles, most.to(tiles.dtype)]))
    rays = (tiles[:, None] * ts + torch.arange(
        ts, device=q.origin.device)).reshape(-1)
    sub = Query(*(a[rays] for a in q[:5]), ts)
    part = out._replace(**{f: getattr(out, f)[tiles if f in _PER_TILE
                                              else rays]
                           for f in out._fields
                           if getattr(out, f) is not None})
    return sub, part, tiles % stride == 0


def check_recorded(calls, what, record, tile_stride=1, longest=0,
                   longest_calls=None, against=None):
    """Hold every recorded walk call against the plain walk, on every
    ``tile_stride``-th whole tile (1: all of them) and the ``longest``
    tiles with the most trips (of the calls ``longest_calls``; None: of
    every call); the calls ``against`` names (index: the row of the same
    query through another setting of the same kernel, which tests the
    same pairs) against that row's output instead, every GATE_KEEPS field
    of every tile bit for bit, their bound counting that row's pairs.
    Returns the per-call rows (options, max abs err, plain ms, trips,
    bound of the whole call)."""
    out = []
    for i, (clusters, tri_shade, q, kw, got) in enumerate(calls):
        if against is not None and i in against:
            ref = against[i]["out"]
            same = all(getattr(got, f) is None
                       or _bits_equal(getattr(got, f), getattr(ref, f))
                       for f in GATE_KEEPS)
            print(f"  {what} call {i}: {kw} against the same query's "
                  f"other setting: {'bitwise equal' if same else 'DIFFER'}")
            record.append({"what": f"{what} call {i} against another "
                           "setting", "same": same})
            if not same:
                raise AssertionError(f"{what} call {i}: the setting changed "
                                     "a result")
            out.append({"kw": kw, "err": 0.0, "plain_ms": None,
                        "iters": got.iters, "out": got, "q": q,
                        "clusters": clusters, "tri_shade": tri_shade,
                        **walk_bound(q, got, clusters, kw,
                                     against[i]["pairs"])})
            continue
        most = longest if longest_calls is None or i in longest_calls else 0
        cq, cgot, sampled = (q, got, None) if tile_stride == 1 else (
            tile_subset(q, got, tile_stride, most))
        err, plain_ms, pairs, signs = compare_counted(
            clusters, tri_shade, cq, f"{what} call {i}", record, cgot, got,
            sampled, **kw)
        out.append({"kw": kw, "err": err, "plain_ms": plain_ms,
                    "plain_tiles": 1.0 / tile_stride,
                    "iters": got.iters, "out": got, "q": q,
                    "clusters": clusters,
                    "tri_shade": tri_shade,
                    **walk_bound(q, got, clusters, kw, pairs, signs)})
    return out


def phase_frame(dev, record):
    from raytpu_torch import Quantize, RenderConfig
    from raytpu_torch.render.wavefront import render_rays

    t0 = time.perf_counter()
    flat = bench_scene(TRIS).flatten(cluster_size=CLUSTER_SIZE, device=dev,
                                     build_octree=False)
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
    print(f"  render_rays: launches {_ran(launches)}")
    if not (launches["nearest"] > 0 and launches["any_hit"] > 0):
        raise AssertionError(f"a walk kernel did not run: {launches}")
    nonblack = _check_image(img, "frame")
    with recording_walks() as calls:
        render_rays(flat, cfg, o, d)
    checked = check_recorded(calls, "frame", record)
    record.append({"what": "frame", "tris": flat.num_tris, "clusters": ncg,
                   "launches": launches, "nonblack": nonblack})
    return flat, cfg, (o, d), img, checked, launches


def _check_image(img, what, least=0.5):
    if torch.isnan(img).any():
        raise AssertionError(f"{what} has NaN")
    nonblack = float((img.reshape(-1, 3).max(-1).values > 0).float().mean())
    print(f"  image: no NaN, nonblack fraction {nonblack:.4f}, mean "
          f"{float(img.mean()):.5f}")
    if nonblack < least:
        raise AssertionError(f"{what} is mostly black")
    return nonblack


def phase_instanced(dev, record):
    from raytpu_torch import Quantize, RenderConfig
    from raytpu_torch.core.camera import Camera
    from raytpu_torch.render import instanced as prender

    t0 = time.perf_counter()
    iscene = prender.flatten_instanced(instanced_frame_scene(TRIS),
                                       cluster_size=CLUSTER_SIZE, device=dev,
                                       build_octree=False)
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
    print(f"  render_image_instanced: launches {_ran(launches)}")
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
          f"{live_rays} live rays; calls held against the plain walk on "
          f"every {INSTANCED_TILE_STRIDE}th tile and the "
          f"{INSTANCED_LONGEST} with the most trips")
    checked = check_recorded(calls, "instanced", record,
                             INSTANCED_TILE_STRIDE, INSTANCED_LONGEST)
    record.append({"what": "instanced frame", "world_tris": world_tris,
                   "launches": launches, "walk_calls": len(calls),
                   "live_rays": live_rays, "nonblack": nonblack})
    return iscene, cfg, camera, checked, launches, live_rays, img


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
    print(f"  render_rays: launches {_ran(launches)}")
    if not (launches["nearest_pretest"] > 0
            and launches["any_hit_pretest"] > 0):
        raise AssertionError(f"a pretest walk did not run: {launches}")
    _check_image(img, "pretest frame")
    with recording_walks() as calls:
        render_rays(flat, pcfg, o, d)
    checked = check_recorded(calls, "pretest frame", record)
    base = [r["out"] for r in frame_rows if not r["kw"]["any_hit"]][0]
    got = [r["out"] for r in checked if not r["kw"]["any_hit"]][0]
    ties, differ = _against_base(img, img_default, base, got, o.shape[0],
                                 "pretest frame against the default")
    record.append({"what": "pretest frame", "launches": launches,
                   "ties": ties, "pixels_differ": differ})
    return pcfg, checked, launches


def _kernel_ms(row, reps):
    kernel, _ = _walks(row["kw"])
    return _cuda_ms(lambda: kernel(row["clusters"], row["tri_shade"],
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


def _bounded(kw):
    return "picks" in kw or kw.get("max_trips", 0) > 0


def _call_line(row):
    """One walk call's kernel ms, bound, trips and, for a bounded walk,
    overflow share (rays it left unresolved, of its live rays)."""
    kw, q, out = row["kw"], row["q"], row["out"]
    live = int((torch.isfinite(q.origin).all(-1)
                & torch.isfinite(q.direction).all(-1)).sum())
    if "picks" in kw:
        walk = f"prepick {kw['picks']}"
    elif kw.get("max_trips", 0):
        walk = f"max_trips {kw['max_trips']}"
    else:
        walk = "classic"
    row["overflow_share"] = (int((out.resolved == 0).sum()) / max(live, 1)
                             if _bounded(kw) else None)
    share = ("" if row["overflow_share"] is None
             else f", overflow {row['overflow_share']:.4%}")
    return (f"{'any_hit' if kw['any_hit'] else 'nearest'} {walk} "
            f"({live} live rays): kernel {row['kernel_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms ({row['counted']}), trips mean "
            f"{float(out.iters.float().mean()):.2f} max {int(out.iters.max())}"
            f"{share}")


def _timed_calls(calls, reps):
    """Rows of recorded walk calls with their kernel ms and bound (no plain
    comparison)."""
    rows = []
    for clusters, tri_shade, q, kw, got in calls:
        row = {"kw": kw, "q": q, "out": got, "iters": got.iters,
               "clusters": clusters, "tri_shade": tri_shade,
               **walk_bound(q, got, clusters, kw)}
        row["kernel_ms"] = _kernel_ms(row, reps)
        rows.append(row)
    return rows


def _call_summary(row):
    return {"walk": {k: str(v) for k, v in row["kw"].items()},
            "kernel_ms": row["kernel_ms"], "bound_ms": row["bound_ms"],
            "trips_mean": float(row["iters"].float().mean()),
            "trips_max": int(row["iters"].max()),
            "overflow_share": row.get("overflow_share")}


def phase_times(card, flat, cfg, pcfg, rays, frame_rows, pre_rows, inst,
                overflow, record):
    import dataclasses

    from raytpu_torch.render.instanced import render_image_instanced
    from raytpu_torch.render.wavefront import render_rays, trace_colors

    o, d = rays
    frame_rays = 2 * RES ** 2
    print(f"[times] {card}")
    default = lambda: render_rays(flat, cfg, o, d)  # noqa: E731
    pretest = lambda: render_rays(flat, pcfg, o, d)  # noqa: E731
    frames = [("default", default), ("pretest", pretest)] + [
        (label, functools.partial(render_rays, flat,
                                  dataclasses.replace(cfg, **change), o, d))
        for label, change in TIMED_OVERFLOW]
    # Turns: each setting, then all of them in reverse order.
    turns = frames + frames[::-1]
    ms = {name: [] for name, _ in frames}
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
    out["overflow_frames"] = {
        label: {"kernel_ms": statistics.mean(ms[label]),
                "turns_ms": ms[label],
                "rays_per_s": frame_rays / statistics.mean(ms[label]) * 1e3}
        for label, _ in TIMED_OVERFLOW}
    print(f"  bench frame by walk setting, in turns (each, then in reverse "
          f"order), {REPS} frames a turn: " + "; ".join(
              f"{k} {[round(m, 3) for m in v]} ms" for k, v in ms.items()))
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
    # The overflow settings' walk calls: those held against the plain walk
    # in [overflow], and the 7,811-pick frame's, recorded here.
    with recording_walks() as calls:
        render_rays(flat, dataclasses.replace(cfg, cull_prepick=7811), o, d)
    per_call = {label: overflow[label]["rows"] for label in overflow}
    per_call["cull_prepick=7811"] = _timed_calls(calls, REPS * 4)
    for label, rows in per_call.items():
        for row in rows:
            row.setdefault("kernel_ms", _kernel_ms(row, REPS * 4))
            print(f"  bench {label} call: " + _call_line(row))
    out["overflow_calls"] = {label: [_call_summary(r) for r in rows]
                             for label, rows in per_call.items()}

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
          f"{len(irows)} walk calls: kernel {k_sum:.3f} ms, bound "
          f"{b_sum:.3f} ms in all; plain walk {p_sum:.3f} ms on every "
          f"{INSTANCED_TILE_STRIDE}th tile")
    for i, c in enumerate(calls):
        print(f"    call {i}: kernel {c['kernel_ms']:.3f} ms, bound "
              f"{c['bound_ms']:.3f} ms ({c['ops']:.4g} ops; overhead "
              f"{c['overhead_ops']:.4g} ops), trips mean "
              f"{c['trips_mean']:.2f} max {c['trips_max']}, tested "
              f"{c['tests_mean']:.2f}, ray tests {c['ray_tests_mean']:.1f}")
    # The same frame with the walk's opt-ins turned off, between two turns
    # of the defaults.
    overflow_walks = tuple(
        (label, {**change, **(NO_OPT_INS if "cull_prepick" in change
                              else {})})
        for label, change in TIMED_OVERFLOW)
    walks = {"defaults": [],
             **{name: [] for name, _ in INSTANCED_WALKS + overflow_walks}}
    for name, kw in (("defaults", {}),) + INSTANCED_WALKS + overflow_walks + (
            ("defaults", {}),):
        walks[name].append(_instanced_ms(iscene, icfg, camera, kw))
    out["instanced_walks_ms"] = walks
    print("  instanced frame by walk setting (turns of 1 frame after a "
          "warm-up; prepick with the pretest and re-cull off): "
          + "; ".join(f"{k} {[round(m, 3) for m in v]} ms"
                      for k, v in walks.items()))
    # The bounded walks' calls of one instanced frame per overflow setting.
    from raytpu_torch.render import instanced as prender

    query = prender.nearest_hit_instanced
    out["instanced_overflow_calls"] = {}
    for label, kw in overflow_walks:
        prender.nearest_hit_instanced = functools.partial(query, **kw)
        try:
            with recording_walks() as calls:
                render_image_instanced(iscene, icfg, camera)
        finally:
            prender.nearest_hit_instanced = query
        rows = _timed_calls(calls, 1)
        for row in rows:
            _call_line(row)
        bounded = [r for r in rows if _bounded(r["kw"])]
        finish = [r for r in rows if not _bounded(r["kw"])]
        shares = [r["overflow_share"] for r in bounded]
        print(f"  instanced {label}: {len(bounded)} bounded calls, kernel "
              f"{sum(r['kernel_ms'] for r in bounded):.3f} ms, bound "
              f"{sum(r['bound_ms'] for r in bounded):.3f} ms, trips max "
              f"{max(int(r['iters'].max()) for r in bounded)}, overflow "
              f"{min(shares):.2%}-{max(shares):.2%}; {len(finish)} finishing "
              f"calls, kernel {sum(r['kernel_ms'] for r in finish):.3f} ms")
        out["instanced_overflow_calls"][label] = [_call_summary(r)
                                                 for r in rows]
    record.append({"what": "times", "card": card, **out})
    return out


def phase_sub_times(card, flat128, cfg, rays, sub, record):
    """The subcluster and chunked bench frames in turns (each setting, then
    all in reverse order), and their walk calls' kernel ms beside the
    plain ms and bound."""
    import dataclasses

    from raytpu_torch.render.wavefront import render_rays

    o, d = rays
    frame_rays = 2 * RES ** 2
    print(f"[times] {card}; subcluster and chunked bench frames")
    frames = [("128", flat128, {}, {})]
    frames += [(str(c), sub[c]["flat"], {}, {}) for c in SUB_FRAME_SIZES]
    s32 = sub[SUB_FRAME_SIZES[-1]]["flat"]
    frames += [("32 gate", s32, {}, {"gate": True})]
    frames += [(f"32 cull_chunk={k}", s32, {"cull_chunk": k}, {})
               for k in (2, 4)]
    frames += [(f"128 cull_chunk={k}", flat128, {"cull_chunk": k}, {})
               for k in (2, 4)]
    ms = {name: [] for name, _, _, _ in frames}
    for name, flat, change, walk in frames + frames[::-1]:
        fcfg = dataclasses.replace(cfg, **change)
        with walk_defaults(**walk):
            ms[name].append(_cuda_ms(
                lambda: render_rays(flat, fcfg, o, d), REPS))
    out = {"frames": {k: {"turns_ms": v, "ms": statistics.mean(v),
                          "rays_per_s": frame_rays / statistics.mean(v) * 1e3}
                      for k, v in ms.items()}}
    print("  bench frame by bake and walk, in turns, "
          f"{REPS} frames a turn: " + "; ".join(
              f"{k} {[round(m, 3) for m in v]} ms" for k, v in ms.items()))
    calls = {}
    for c in SUB_FRAME_SIZES:
        calls[f"{c}"] = sub[c]["rows"]
        for label, _ in SUB_FRAME_WALKS:
            calls[f"{c} {label}"] = sub[c]["variants"][label]
    calls[f"128 cull_chunk={CHUNK_CLASSIC}"] = sub["classic_chunk"]["rows"]
    for label, rows in calls.items():
        for row in rows:
            row["kernel_ms"] = _kernel_ms(row, REPS * 4)
            out_ = row["out"]
            print(f"  {label} {'any_hit' if row['kw']['any_hit'] else 'nearest'}"
                  f" call: kernel {row['kernel_ms']:.3f} ms, plain walk "
                  f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
                  f"({row['ops']:.4g} ops; overhead {row['overhead_ops']:.4g}"
                  f"), trips mean {float(out_.iters.float().mean()):.2f} max "
                  f"{int(out_.iters.max())}, blocks tested "
                  f"{float(out_.tests.float().mean()):.2f}, ray tests "
                  f"{float(out_.ray_tests.float().mean()):.1f}")
    out["calls"] = {label: [_call_summary(r) for r in rows]
                    for label, rows in calls.items()}
    record.append({"what": "subcluster times", "card": card, **out})
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
_SUB_VARIANT = re.compile(r"subwalk_kernel<(\w+), (\d), (\d), (\w+)>")


def _variant(name):
    """The walk kernel variant of a device kernel's name ("other" for the
    rest): ``kernel_name`` for walk_kernel, ``subwalk<kind> SUBK=n`` for
    the group kernel."""
    from raytpu_torch.kernels.fused import kernel_name

    m = _SUB_VARIANT.search(name)
    if m:
        kind = "any_hit" if m.group(1) == "true" else "nearest"
        return f"subwalk<{kind}> SUBK={m.group(3)}"
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
    groups, others = {}, {}
    for e in dev_events:
        g = _variant(e.name)
        span = e.time_range.end - e.time_range.start
        groups[g] = groups.get(g, 0.0) + span
        if g == "other":
            others[e.name] = others.get(e.name, 0.0) + span
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
        out["top_other_ms"] = [
            (k[:60], v / frames / 1e3)
            for k, v in sorted(others.items(), key=lambda kv: -kv[1])[:4]]
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
          f"{p['host_sync_ms_per_frame']:.3f} ms blocked in them; other's "
          "largest kernels: " + "; ".join(
              f"{k} {v:.3f} ms" for k, v in p["top_other_ms"]))


def phase_profile(card, flat, cfg, rays, inst, flagship, record):
    from raytpu_torch.render.instanced import render_image_instanced
    from raytpu_torch.render.wavefront import render_image, render_rays

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
    print("  flagship frame (the 32 bake):")
    fscene, fcfg, fcamera = flagship
    flag = _profile(lambda: render_image(fscene, fcfg, fcamera), 2)
    _print_profile(flag, 2)
    record.append({"what": "profile", "card": card, "frames": ms,
                   "median_ms": med, "host_median_ms": statistics.median(host),
                   "bench": bench, "instanced": instanced, "flagship": flag})


def _each_ms(fn, n):
    """``n`` calls of ``fn`` after one warm-up, each timed with CUDA
    events."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def _grads_close(gpu, cpu):
    """The largest excess of |card - CPU| over FIT_RTOL * |CPU| +
    FIT_ATOL * max|CPU| (<= 0: within the tolerance)."""
    a, b = gpu.detach().cpu().double(), cpu.detach().double()
    scale = float(b.abs().max())
    return float(((a - b).abs() - FIT_RTOL * b.abs()
                  - FIT_ATOL * scale).max())


def _card_vs_cpu_grads(dev, record):
    """render_loss gradients on the card and on the CPU: the small instanced
    scene's objects baked as one scene (two spheres, a checkered ground),
    one reflection."""
    import dataclasses

    from raytpu_torch import Intersector, Quantize, RenderConfig
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.diff.fit import render_loss
    from raytpu_torch.diff.params import GEOMETRY, TEXTURE, extract_params

    cfg = RenderConfig(width=32, height=32, max_reflections=1,
                       quantize=Quantize.NONE, tile_pixels=32 * 32,
                       cull_tile=64, intersector=Intersector.PALLAS)
    cam = Camera(position=(3.0, 16.0, 32.0))
    host = _small_instanced_scene(0.3, False)
    target = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (32 * 32, 3)).astype(np.float32))
    for fields, tau in ((GEOMETRY, 0.0), (GEOMETRY, 0.05), (TEXTURE, 0.0)):
        grads, losses = {}, {}
        for where in ("cpu", dev):
            scene = host.flatten(cluster_size=16, device=where)
            o, d = camera_rays(cam, 32, 32, device=where)
            params = extract_params(scene, fields)
            loss = render_loss(scene, dataclasses.replace(cfg, soft_tau=tau),
                               params, o, d, target.to(where))
            loss.backward()
            grads[str(where)] = {k: v.grad for k, v in params.items()}
            losses[str(where)] = float(loss.detach())
        gc, gg = grads["cpu"], grads[str(dev)]
        excess = max(_grads_close(gg[k], gc[k]) for k in gc)
        diff = max(float((gg[k].cpu() - gc[k]).abs().max()) for k in gc)
        finite = all(bool(torch.isfinite(g).all()) for g in gg.values())
        print(f"  gradients {fields} soft_tau={tau}, card vs CPU: loss "
              f"{losses[str(dev)]:.7g} / {losses['cpu']:.7g}, max abs diff "
              f"{diff:.3g}, finite {finite}, within rtol {FIT_RTOL} + atol "
              f"{FIT_ATOL} x max|g|: {excess <= 0}")
        if not finite or excess > 0:
            raise AssertionError("card and CPU gradients differ")
        record.append({"what": "grads card vs cpu", "fields": fields,
                       "soft_tau": tau, "max_abs_diff": diff})


def _step_split(forward, backward, update):
    """One fit step in its parts (``forward()`` returns the loss,
    ``backward(loss)``, ``update()``), CUDA events between them, and the
    torch.profiler split of another: device ms of the walk kernels, of the
    row gather's scatter-add (``geo_rows_scatter_add``), of everything
    else, and the five device kernels that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    loss = forward()
    ev[1].record()
    backward(loss)
    ev[2].record()
    update()
    ev[3].record()
    torch.cuda.synchronize()
    parts = {name: ev[i].elapsed_time(ev[i + 1])
             for i, name in enumerate(("forward", "backward", "update"))}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        backward(forward())
        update()
        torch.cuda.synchronize()
    dev_ms, by_name = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            key = ("walks" if "walk_kernel" in e.name else "other")
            dev_ms[key] = dev_ms.get(key, 0.0) + ms
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
    scatter = sum(e.device_time_total for e in prof.key_averages()
                  if e.key == "geo_rows_scatter_add") / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return parts, {**dev_ms, "scatter_add": scatter,
                   "top": [(name[:90], ms) for name, ms in top]}


def phase_fit(dev, card, flat, record):
    """bench.py's backward workload on the port: 512x512 gradient steps on
    the 1M-triangle terrain (geometry, then the textured terrain's atlas),
    a real Adam fit with re-bakes, and card-vs-CPU gradients."""
    import dataclasses

    from raytpu_torch import Quantize, RenderConfig, TextureFiltering
    from raytpu_torch.core.camera import Camera
    from raytpu_torch.diff.fit import (fit, make_fit_step, rebuild_accel,
                                       render_loss)
    from raytpu_torch.diff.params import GEOMETRY, TEXTURE, extract_params
    from raytpu_torch.render.wavefront import render_image, render_rays

    print(f"[fit] {card}; bench.py's backward workload, {FIT_RES}x"
          f"{FIT_RES}, max_reflections=0")
    _card_vs_cpu_grads(dev, record)
    cfg = RenderConfig(width=FIT_RES, height=FIT_RES, max_reflections=0,
                       tile_pixels=FIT_RES ** 2, quantize=Quantize.NONE)
    o, d = _frame_rays(FIT_RES, dev)
    t0 = time.perf_counter()
    textured = bench_scene(TRIS, textured=True).flatten(
        cluster_size=CLUSTER_SIZE, device=dev, build_octree=False)
    torch.cuda.synchronize()
    print(f"  textured terrain baked in {time.perf_counter() - t0:.1f} s")
    out = {}
    for label, scene, fields, fcfg in (
            ("geometry", flat, GEOMETRY, cfg),
            ("texture", textured, TEXTURE,
             dataclasses.replace(cfg, filtering=TextureFiltering.BILINEAR))):
        # bench.py: the target is the scene's own render, the optimizer
        # SGD with learning rate 0 (timing only).
        target = render_rays(scene, fcfg, o, d)
        params = extract_params(scene, fields)
        opt = torch.optim.SGD(list(params.values()), lr=0.0)
        step = make_fit_step(scene, fcfg, opt, fields=fields)
        reset_launches()
        loss = step(params, o, d, target)
        launches = read_launches()
        grads = [p.grad for p in params.values()]
        finite = (bool(torch.isfinite(loss))
                  and all(bool(torch.isfinite(g).all()) for g in grads))
        nonzero = sum(int((g != 0).sum()) for g in grads)
        if not (finite and nonzero and launches["nearest"]
                and launches["any_hit"]):
            raise AssertionError(f"{label} fit step: loss {float(loss)}, "
                                 f"finite {finite}, nonzero grads {nonzero},"
                                 f" launches {launches}")
        times = _each_ms(lambda: step(params, o, d, target), FIT_STEPS)
        ms = statistics.mean(times)
        out[label] = {"step_ms": times, "mean_ms": ms,
                      "backward_rays_per_s": 2 * FIT_RES ** 2 / ms * 1e3,
                      "launches": launches, "nonzero_grads": nonzero,
                      "loss": float(loss)}
        print(f"  {label} step (forward, backward, SGD update): "
              f"{[round(t, 3) for t in times]} ms, mean {ms:.3f} ms, "
              f"{out[label]['backward_rays_per_s']:.4g} backward rays/s "
              f"(2 x {FIT_RES}^2 per step); loss {float(loss):.3g}, "
              f"{nonzero} nonzero gradient entries, all finite; launches "
              f"{_ran(launches)}")
        if label == "geometry":
            with recording_walks() as calls:
                step(params, o, d, target)
            check_recorded(calls, "fit step", record)
        # The step's own settings: neither field group flows through the
        # non-geometry row channels (make_fit_step's choice).
        scfg = dataclasses.replace(fcfg, grad_channels="geometry")

        def forward():
            opt.zero_grad(set_to_none=True)
            return render_loss(scene, scfg, params, o, d, target)

        parts, dev_ms = _step_split(forward, lambda l: l.backward(),
                                    opt.step)
        out[label]["split_ms"] = parts
        out[label]["device_ms"] = dev_ms
        print(f"  {label} step split (CUDA events): forward "
              f"{parts['forward']:.3f} ms, backward "
              f"{parts['backward']:.3f} ms, update {parts['update']:.3f}"
              f" ms; torch.profiler device ms: walk kernels "
              f"{dev_ms.get('walks', 0.0):.3f}, geo_rows_scatter_add "
              f"(index_add_) {dev_ms['scatter_add']:.3f}, all other "
              f"kernels {dev_ms.get('other', 0.0):.3f}; top kernels "
              + "; ".join(f"{n} {ms:.3f}" for n, ms in dev_ms["top"]))
        del params, opt, step, grads, forward

    # A real fit: Adam from the terrain with its heights scaled, toward the
    # unscaled terrain's image, re-baking the cluster tables every
    # FIT_REBUILD steps.
    camera = Camera(position=(0.0, 28.0, 34.0), target=(0.0, 0.0, 0.0),
                    aspect=1.0)
    target_img = render_image(flat, cfg, camera)
    scaled = bench_scene(TRIS, height_scale=FIT_HEIGHT_SCALE).flatten(
        cluster_size=CLUSTER_SIZE, device=dev, build_octree=False)
    losses = []
    t0 = time.perf_counter()
    fitted, params, hist = fit(
        scaled, cfg, camera, target_img, fields=GEOMETRY,
        steps=FIT_ADAM_STEPS, learning_rate=FIT_LR,
        rebuild_every=FIT_REBUILD,
        callback=lambda i, l: losses.append((i, l)))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    print(f"  Adam fit, heights x{FIT_HEIGHT_SCALE}, lr {FIT_LR}, "
          f"{FIT_ADAM_STEPS} steps, re-bake every {FIT_REBUILD}: losses "
          + ", ".join(f"{l:.7g}" for l in hist) + f" ({fit_s:.1f} s)")
    # The re-bake exposes the cracks that independent per-triangle vertex
    # updates open in a watertight mesh (the walk between re-bakes still
    # finds the baked, closed surface): count the primary rays that miss.
    with torch.no_grad():
        stale = render_image(fitted, cfg, camera)
        fresh = render_image(rebuild_accel(fitted, params), cfg, camera)
    black = lambda img: int((img.reshape(-1, 3).max(-1).values  # noqa
                             == 0).sum())
    print(f"  black pixels: target {black(target_img)}, fitted with the "
          f"last bake's tables {black(stale)}, re-baked {black(fresh)}")
    epochs = [hist[i:i + FIT_REBUILD] for i in range(0, len(hist),
                                                     FIT_REBUILD)]
    falling = all(b < a for e in epochs for a, b in zip(e, e[1:]))
    if not (all(math.isfinite(l) for l in hist) and falling):
        raise AssertionError(f"the Adam fit does not descend between "
                             f"re-bakes: {hist}")
    out["adam_fit"] = {"losses": hist, "seconds": fit_s,
                       "last_below_first": hist[-1] < hist[0],
                       "black_pixels": {"target": black(target_img),
                                        "last_bake": black(stale),
                                        "re_baked": black(fresh)}}
    record.append({"what": "fit", "card": card, **out})
    return out


def _same_hits(flat, rays, base, strategy):
    """The primary query under ``strategy`` against ``base``: same hits at
    the same t bit for bit; returns (same, exact-t ties won by another
    triangle)."""
    from raytpu_torch.kernels.fused import nearest_hit_fused

    o, d = rays
    got = nearest_hit_fused(flat, o, d, **strategy)
    same = (torch.equal(got.hit, base.hit)
            and _bits_equal(got.t[base.hit], base.t[base.hit]))
    return same, base.hit & (got.tri != base.tri)


def phase_overflow(flat, cfg, rays, img_default, record):
    """The bench frame through the prepick walk and the phase-1 compaction:
    launch counters (the rescue and phase 2 must run), the image against
    the default frame's, every walk call against its plain version."""
    import dataclasses

    from raytpu_torch.kernels.fused import nearest_hit_fused
    from raytpu_torch.render.wavefront import render_rays

    o, d = rays
    base = nearest_hit_fused(flat, o, d)
    print("[overflow] the bench frame with the prepick walk and the phase-1 "
          "compaction")
    out = {}
    for label, change in OVERFLOW_SETTINGS:
        ocfg = dataclasses.replace(cfg, **change)
        reset_launches()
        img = render_rays(flat, ocfg, o, d)
        launches = read_launches()
        picked = "cull_prepick" in change
        first = ("nearest_prepick", "any_hit_prepick") if picked else (
            "nearest_budget", "any_hit_budget")
        finish = launches["nearest"] + launches["any_hit"]
        print(f"  {label}: launches {_ran(launches)}")
        if not all(launches[k] > 0 for k in first) or (
                label in MUST_FINISH and finish == 0):
            raise AssertionError(f"{label}: a walk did not run: {launches}")
        _check_image(img, label)
        strategy = ({"prepick": change["cull_prepick"]} if picked
                  else {"phase1_trips": change["cull_phase1"]})
        same, ties = _same_hits(flat, rays, base, strategy)
        differ = (img != img_default).any(-1)
        print(f"  primary hits and t bit for bit the default's: {same}; "
              f"exact-t ties won by another triangle: {int(ties.sum())}; "
              f"pixels that differ from the default frame: "
              f"{int(differ.sum())}")
        if not same or bool((differ & ~ties).any()):
            raise AssertionError(f"{label}: the frame differs from the "
                                 "default beyond exact-t ties")
        with recording_walks() as calls:
            render_rays(flat, ocfg, o, d)
        rows = check_recorded(calls, label, record)
        out[label] = {"launches": launches, "rows": rows,
                      "ties": int(ties.sum()),
                      "pixels_differ": int(differ.sum())}
        record.append({"what": f"overflow {label}", "launches": launches,
                       "ties": int(ties.sum()),
                       "pixels_differ": int(differ.sum())})
    return out


@contextlib.contextmanager
def walk_defaults(**kw):
    """Inside, every query of the renderers gets ``kw`` (``nearest_hit``
    walk settings): the baked renderer's ``nearest_hit`` and the instanced
    renderer's ``nearest_hit_instanced``."""
    from raytpu_torch.render import instanced, wavefront

    saved = (wavefront.nearest_hit, instanced.nearest_hit_instanced)
    wavefront.nearest_hit = functools.partial(saved[0], **kw)
    instanced.nearest_hit_instanced = functools.partial(saved[1], **kw)
    try:
        yield
    finally:
        wavefront.nearest_hit, instanced.nearest_hit_instanced = saved


def _require(launches, *names, absent=()):
    ran = _ran(launches)
    print(f"  launches {ran}")
    if not all(launches[n] > 0 for n in names) or any(
            a in k for k in ran for a in absent):
        raise AssertionError(f"expected launches of {names} and none of "
                             f"{absent}: {ran}")


def _against_base(img, img_base, base, got, r, what):
    """A frame against the base frame: the primary query's hits at the
    same t bit for bit, and the pixels that differ only those whose primary
    ray ties exactly (same t, another triangle).  Returns (ties, pixels
    that differ)."""
    hit = base.code[:r] >= 0
    same = (torch.equal(hit, got.code[:r] >= 0)
            and _bits_equal(base.t[:r][hit], got.t[:r][hit]))
    ties = hit & (base.tri[:r] != got.tri[:r])
    differ = (img != img_base).any(-1)
    print(f"  {what}: primary hits and t bit for bit the base frame's: "
          f"{same}; exact-t ties won by another triangle: "
          f"{int(ties.sum())}; pixels that differ: {int(differ.sum())}")
    if not same or bool((differ & ~ties).any()):
        raise AssertionError(f"{what} differs from the base frame beyond "
                             "exact-t ties")
    return int(ties.sum()), int(differ.sum())


def _variant_rows(rows, change, what, record):
    """The subcluster walk with ``change`` on the recorded calls' queries,
    each held against its plain version and against the recorded output:
    the gate gives every output bit for bit, more picks a trip the same
    hits at the same t."""
    from raytpu_torch.kernels.fused import subwalk_cuda

    out = []
    for row in rows:
        kw = {**row["kw"], **change}
        got = subwalk_cuda(row["clusters"], row["tri_shade"], row["q"], **kw)
        err, plain_ms, pairs, signs = compare_counted(
            row["clusters"], row["tri_shade"], row["q"], what, record, got,
            got, None, **kw)
        base = row["out"]
        hit = base.code >= 0
        fields = GATE_KEEPS if "chunk_k" not in change else ()
        same = (torch.equal(hit, got.code >= 0)
                and _bits_equal(base.t[hit], got.t[hit])
                and all(getattr(base, f) is None
                        or _bits_equal(getattr(base, f), getattr(got, f))
                        for f in fields))
        if not same:
            raise AssertionError(f"{what}: {change} changed a result")
        out.append({"kw": kw, "err": err, "plain_ms": plain_ms,
                    "iters": got.iters, "out": got, "q": row["q"],
                    "clusters": row["clusters"],
                    "tri_shade": row["tri_shade"],
                    **walk_bound(row["q"], got, row["clusters"], kw, pairs,
                                 signs)})
    return out


def phase_subcluster_frames(dev, flat128, cfg, rays, img128, frame_rows,
                            record):
    """bench.py's frame at BENCH_CSIZE 64 and 32: the renderer's defaults
    take the subcluster walk; every walk call against the plain walk; the
    image against the 128 frame's up to exact-t ties; the gate and 2 and 4
    picks a trip on the frame's queries; the gated render (its sibling
    gate turned on in every query) and the chunked renders (cull_chunk 4
    at 32, and 2 at 128 through the classic walk) with their launch
    counters, each image the same as its base frame."""
    import dataclasses

    from raytpu_torch.render.wavefront import render_rays

    o, d = rays
    r = o.shape[0]
    base = [row["out"] for row in frame_rows if not row["kw"]["any_hit"]][0]
    out = {}
    for csize in SUB_FRAME_SIZES:
        t0 = time.perf_counter()
        flat = bench_scene(TRIS).flatten(cluster_size=csize, device=dev,
                                         build_octree=False)
        torch.cuda.synchronize()
        ncg = flat.clusters["block"].shape[0]
        print(f"[subcluster frame] the bench frame at cluster size {csize}: "
              f"{ncg} blocks of {128 // csize} leaves, baked in "
              f"{time.perf_counter() - t0:.1f} s")
        reset_launches()
        img = render_rays(flat, cfg, o, d)
        launches = read_launches()
        _require(launches, "nearest_sub", "any_hit_sub", absent=("pretest",))
        _check_image(img, f"csize {csize} frame")
        with recording_walks() as calls:
            render_rays(flat, cfg, o, d)
        rows = check_recorded(calls, f"csize {csize} frame", record)
        got = [row["out"] for row in rows if not row["kw"]["any_hit"]][0]
        ties, differ = _against_base(img, img128, base, got, r,
                                     f"csize {csize} frame against 128")
        variants = {label: _variant_rows(
            rows, change, f"csize {csize} frame {label}", record)
            for label, change in SUB_FRAME_WALKS}
        entry = {"flat": flat, "img": img, "rows": rows,
                 "variants": variants, "launches": launches, "ties": ties,
                 "pixels_differ": differ}
        if csize == SUB_FRAME_SIZES[-1]:
            # The gated render and the chunked render: their own paths.
            with walk_defaults(gate=True):
                reset_launches()
                gated = render_rays(flat, cfg, o, d)
                entry["gate_launches"] = read_launches()
            _require(entry["gate_launches"], "nearest_sub_gate",
                     "any_hit_sub_gate")
            ccfg = dataclasses.replace(cfg, cull_chunk=CHUNK_SUB)
            reset_launches()
            chunked = render_rays(flat, ccfg, o, d)
            entry["chunk_launches"] = read_launches()
            _require(entry["chunk_launches"], "nearest_sub_chunk",
                     "any_hit_sub_chunk")
            if not (torch.equal(gated, img) and torch.equal(chunked, img)):
                raise AssertionError("the gated or chunked frame differs")
            print(f"  gated and cull_chunk={CHUNK_SUB} frames: the same "
                  "image bit for bit")
        record.append({"what": f"subcluster frame {csize}", "blocks": ncg,
                       "launches": launches, "ties": ties,
                       "pixels_differ": differ})
        out[csize] = entry
    # The classic walk with two picks a trip, at 128.
    ccfg = dataclasses.replace(cfg, cull_chunk=CHUNK_CLASSIC)
    reset_launches()
    chunked = render_rays(flat128, ccfg, o, d)
    launches = read_launches()
    print(f"[subcluster frame] the 128 frame with cull_chunk={CHUNK_CLASSIC}")
    _require(launches, "nearest_chunk", "any_hit_chunk")
    if not torch.equal(chunked, img128):
        raise AssertionError("the chunked 128 frame differs")
    with recording_walks() as calls:
        render_rays(flat128, ccfg, o, d)
    out["classic_chunk"] = {"launches": launches, "rows": check_recorded(
        calls, f"128 frame cull_chunk={CHUNK_CLASSIC}", record)}
    return out


def flagship_scene():
    """__graft_entry__.py::_flagship_scene with the port's types: a glass
    sphere (reflective and transparent), a textured crate and a reflective
    ground under a spot and a directional light."""
    from raytpu_torch.scene.lights import DirectionalLight, SpotLight
    from raytpu_torch.scene.procedural import box, plane, uv_sphere
    from raytpu_torch.scene.types import Material, Scene, SceneObject

    yy, xx = np.mgrid[0:32, 0:32]
    checker = np.where((((yy // 4) + (xx // 4)) % 2 == 0)[..., None], 255, 40)
    checker = np.broadcast_to(checker, (32, 32, 3)).astype(np.uint8)
    glass = Material(reflectiveness=0.7, transparent=True,
                     refraction_index=1.32,
                     diffuse_color=(0.9, 0.9, 1.0, 0.55))
    crate = Material(reflectiveness=0.2, use_texture=True, texture=checker)
    ground = Material(reflectiveness=0.1, diffuse_color=(0.4, 0.45, 0.5, 1.0))
    return Scene(
        objects=[
            SceneObject(meshes=[uv_sphere(radius=4.0, stacks=10, slices=16,
                                          material=glass, convex=True)],
                        position=(-5.0, 4.0, 0.0)),
            SceneObject(meshes=[box(size=(6.0, 6.0, 6.0), material=crate)],
                        position=(5.0, 3.0, 0.0), rotation=(0.0, 0.6, 0.0)),
            SceneObject(meshes=[plane(size=(60.0, 60.0), material=ground)]),
        ],
        lights=[SpotLight(position=(0, 5, 20),
                          direction=(0.0, -0.2425356, -0.9701425)),
                DirectionalLight(direction=(0.3, -0.9, 0.1))])


def _flagship_grads(dev, record):
    """render_loss gradients of the dryrun's fields on the flagship's 32
    bake, on the card and on the CPU, at 32x32."""
    from raytpu_torch import Intersector, Quantize, RenderConfig
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.diff.fit import render_loss
    from raytpu_torch.diff.params import extract_params

    res = FLAGSHIP_GRAD_RES
    cfg = RenderConfig(width=res, height=res, max_reflections=1,
                       quantize=Quantize.NONE, tile_pixels=res * res,
                       cull_tile=64, soft_tau=0.01,
                       intersector=Intersector.PALLAS)
    cam = Camera(position=FLAGSHIP_CAMERA, aspect=1.0)
    target = torch.full((res * res, 3), 0.5)
    grads, losses = {}, {}
    for where in ("cpu", dev):
        scene = flagship_scene().flatten(cluster_size=32, device=where)
        o, d = camera_rays(cam, res, res, device=where)
        params = extract_params(scene, FLAGSHIP_FIELDS)
        loss = render_loss(scene, cfg, params, o, d, target.to(where))
        loss.backward()
        grads[str(where)] = {k: v.grad for k, v in params.items()}
        losses[str(where)] = float(loss.detach())
    gc, gg = grads["cpu"], grads[str(dev)]
    excess = max(_grads_close(gg[k], gc[k]) for k in gc)
    diff = max(float((gg[k].cpu() - gc[k]).abs().max()) for k in gc)
    finite = all(bool(torch.isfinite(g).all()) for g in gg.values())
    print(f"  flagship gradients {FLAGSHIP_FIELDS} soft_tau=0.01 at "
          f"{res}x{res}, card vs CPU: loss {losses[str(dev)]:.7g} / "
          f"{losses['cpu']:.7g}, max abs diff {diff:.3g}, finite {finite}, "
          f"within rtol {FIT_RTOL} + atol {FIT_ATOL} x max|g|: {excess <= 0}")
    if not finite or excess > 0:
        raise AssertionError("card and CPU gradients differ")
    record.append({"what": "flagship grads card vs cpu",
                   "max_abs_diff": diff})
    return diff


def phase_flagship(dev, card, record):
    """The flagship scene at full size: entry()'s three bounces at
    1024x1024, baked at 32 and at 128; every query of the 32 render also
    through the 128 bake (the same hits at the same t, exact-t ties
    counted); every walk call of both bakes against the plain walk; frame
    ms and live rays/s with the ray slots and live rays per level; one step
    of the dryrun's fit on the 32 bake; card against CPU gradients."""
    from raytpu_torch import Intersector, Quantize, RenderConfig
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.diff.fit import make_fit_step
    from raytpu_torch.diff.params import extract_params
    from raytpu_torch.kernels.fused import nearest_hit_fused
    from raytpu_torch.render.wavefront import (_default_query,
                                               block_order_perm,
                                               render_image, trace_colors)

    # The walk's frame: the flagship (302 triangles) takes the sweep under
    # AUTO ([query] renders it so), so the walk is named.
    cfg = RenderConfig(width=FLAGSHIP_RES, height=FLAGSHIP_RES,
                       max_reflections=FLAGSHIP_REFLECTIONS,
                       tile_pixels=FLAGSHIP_RES ** 2,
                       intersector=Intersector.PALLAS)
    camera = Camera(position=FLAGSHIP_CAMERA, aspect=1.0)
    bakes = {c: flagship_scene().flatten(cluster_size=c, device=dev)
             for c in FLAGSHIP_SIZES}
    flat = bakes[32]
    print(f"[flagship] {flat.num_tris} triangles, dual-branch "
          f"{flat.has_dual_branch}; {FLAGSHIP_RES}x{FLAGSHIP_RES}, "
          f"max_reflections={FLAGSHIP_REFLECTIONS}; blocks: "
          + ", ".join(f"{c}: {b.clusters['block'].shape[0]}"
                      for c, b in bakes.items()))
    imgs, launches = {}, {}
    for c, b in bakes.items():
        reset_launches()
        imgs[c] = render_image(b, cfg, camera)
        launches[c] = read_launches()
        _require(launches[c], "nearest_sub" if c == 32 else "nearest",
                 absent=("any_hit",) + (("_sub",) if c == 128 else ()))
        nonblack = float((imgs[c].reshape(-1, 3).max(-1).values > 0)
                         .float().mean())
        if torch.isnan(imgs[c]).any() or nonblack < 0.3:
            raise AssertionError(f"flagship at {c}: NaN or mostly black")
        print(f"  bake {c}: nonblack {nonblack:.4f}, mean "
              f"{float(imgs[c].mean()):.5f}")
    # Every query of the 32 render, also through the 128 bake.
    o, d = camera_rays(camera, FLAGSHIP_RES, FLAGSHIP_RES, device=dev)
    perm = block_order_perm(FLAGSHIP_RES, FLAGSHIP_RES,
                            max(1, int(cfg.cull_tile ** 0.5)), dev)
    query32 = _default_query(cfg)
    levels, ties = [], []

    def both(scene, origin, direction, **kw):
        res = query32(scene, origin, direction, **kw)
        hit = res[0] if kw.get("with_rows") else res
        other = nearest_hit_fused(
            bakes[128], origin, direction, ignore_tri=kw.get("ignore_tri"),
            ignore_mesh=kw.get("ignore_mesh"), cull=kw.get("cull", True),
            t_max=kw.get("t_max"), any_hit=kw.get("any_hit", False),
            tile_size=cfg.cull_tile)
        if not (torch.equal(hit.hit, other.hit)
                and _bits_equal(hit.t[hit.hit], other.t[hit.hit])):
            raise AssertionError("the 32 and 128 bakes find other hits")
        ties.append(int((hit.hit & (hit.tri != other.tri)).sum()))
        levels.append({"primary": kw.get("ignore_mesh") is not None,
                       "slots": int(origin.shape[0]),
                       "live": int(torch.isfinite(direction).all(-1).sum())})
        return res

    both.supports_rows = True
    with recording_walks() as calls:
        colors = trace_colors(flat, cfg, o[perm], d[perm], query=both)
    again = torch.empty_like(colors)
    again[perm] = colors
    if not torch.equal(again.reshape(imgs[32].shape), imgs[32]):
        raise AssertionError("the flagship render is not repeatable")
    differ = int((imgs[32] != imgs[128]).any(-1).sum())
    print(f"  {len(levels)} queries, every one the same hits at the same t "
          f"through both bakes; exact-t ties won by another triangle: "
          f"{sum(ties)}; pixels that differ between the 32 and 128 images: "
          f"{differ}")
    per_level = [q for q in levels if q["primary"]]
    print("  ray slots / live rays per level: " + "; ".join(
        f"{q['slots']} / {q['live']}" for q in per_level))
    rows = check_recorded(calls, "flagship", record)
    # Frame times in turns (32, 128, 128, 32).
    ms = {c: [] for c in FLAGSHIP_SIZES}
    for c in FLAGSHIP_SIZES + FLAGSHIP_SIZES[::-1]:
        ms[c].append(_cuda_ms(lambda: render_image(bakes[c], cfg, camera), 2))
    live = sum(q["live"] for q in levels)
    frame = {c: {"turns_ms": v, "ms": statistics.mean(v),
                 "live_rays_per_s": live / statistics.mean(v) * 1e3}
             for c, v in ms.items()}
    print(f"  frame ms in turns: " + "; ".join(
        f"bake {c} {[round(m, 3) for m in v['turns_ms']]} "
        f"({v['live_rays_per_s']:.4g} live rays/s)"
        for c, v in frame.items()) + f"; {live} live rays in all queries")
    # One step of the dryrun's fit on the 32 bake, without the mesh.
    fcfg = RenderConfig(width=FLAGSHIP_FIT_RES, height=FLAGSHIP_FIT_RES,
                        max_reflections=1, quantize=Quantize.NONE,
                        tile_pixels=FLAGSHIP_FIT_RES ** 2,
                        differentiable=True, soft_tau=0.01,
                        intersector=Intersector.PALLAS)
    fo, fd = camera_rays(camera, FLAGSHIP_FIT_RES, FLAGSHIP_FIT_RES,
                         device=dev)
    target = torch.full_like(fo, 0.5)
    params = extract_params(flat, FLAGSHIP_FIELDS)
    opt = torch.optim.Adam([params[k] for k in sorted(params)], lr=1e-2)
    step = make_fit_step(flat, fcfg, opt, fields=FLAGSHIP_FIELDS)
    reset_launches()
    loss = step(params, fo, fd, target)
    fit_launches = read_launches()
    _require(fit_launches, "nearest_sub")
    grads = [p.grad for p in params.values()]
    finite = (bool(torch.isfinite(loss))
              and all(bool(torch.isfinite(g).all()) for g in grads)
              and all(bool(torch.isfinite(p).all())
                      for p in params.values()))
    step_ms = _each_ms(lambda: step(params, fo, fd, target), 2)
    print(f"  dryrun fit step (Adam 1e-2, {FLAGSHIP_FIELDS}, soft_tau 0.01, "
          f"{FLAGSHIP_FIT_RES}x{FLAGSHIP_FIT_RES}, one reflection): loss "
          f"{float(loss):.6g}, gradients and params finite {finite}, step "
          f"{[round(t, 3) for t in step_ms]} ms")
    if not finite:
        raise AssertionError("the flagship fit step is not finite")
    grad_diff = _flagship_grads(dev, record)
    out = {"launches": launches, "ties": sum(ties), "pixels_differ": differ,
           "levels": per_level, "queries": levels, "frame": frame,
           "live_rays": live, "fit_step_ms": step_ms,
           "fit_loss": float(loss), "fit_launches": fit_launches,
           "grad_max_abs_diff": grad_diff}
    record.append({"what": "flagship", **out})
    return {**out, "rows": rows, "render": (flat, cfg, camera)}


def phase_instanced32(dev, inst, record):
    """The instanced frame from a cluster_size=32 bake: with the defaults
    (the block walk, pretest and re-cull) and with the pretest and re-cull
    off (the subcluster walk), its gate off and on; their calls held against
    the plain walk on a fixed subset of whole tiles and, the subcluster
    walk's, on the tiles with the most trips, and timed; frame ms in turns
    against the 128 bake."""
    from raytpu_torch.render import instanced as prender

    iscene128, icfg, camera, img128 = inst
    t0 = time.perf_counter()
    iscene = prender.flatten_instanced(instanced_frame_scene(TRIS),
                                       cluster_size=32, device=dev,
                                       build_octree=False)
    torch.cuda.synchronize()
    print(f"[instanced 32] the instanced frame from a cluster_size=32 bake "
          f"({iscene.bakes[0].clusters['block'].shape[0]} blocks), baked in "
          f"{time.perf_counter() - t0:.1f} s; calls held against the plain "
          f"walk on every {INSTANCED_TILE_STRIDE}th tile")
    settings = (("defaults", {}, "nearest_pretest"),
                ("subcluster walk", NO_OPT_INS, "nearest_sub"),
                ("subcluster walk, gate", {**NO_OPT_INS, "gate": True},
                 "nearest_sub_gate"))
    out = {}
    for label, kw, want in settings:
        with walk_defaults(**kw):
            reset_launches()
            img = prender.render_image_instanced(iscene, icfg, camera)
            launches = read_launches()
            print(f"  {label}:")
            _require(launches, want, absent=("_sub",) if not kw else ())
            with recording_walks() as calls:
                again = prender.render_image_instanced(iscene, icfg, camera)
        if not torch.equal(again, img):
            raise AssertionError(f"instanced 32 {label}: not repeatable")
        _check_image(img, f"instanced 32 {label}")
        # The subcluster walk's calls also on the tiles with the most trips,
        # thousands of picks deep into the key table: every call's whose
        # longest tile walks at most INSTANCED_DEEP trips and, of the deeper
        # calls, every eighth one, the two settings taking turns (the plain
        # walk takes ~6 ms a trip there).
        deep = [i for i, c in enumerate(calls)
                if int(c[4].iters.max()) > INSTANCED_DEEP]
        turn = deep[4::8] if kw.get("gate") else deep[::8]
        # The gated walk's other deep calls against the ungated walk's
        # outputs, on every tile (the gate changes only the counters, and
        # skips only passes that no ray reaches, so the pairs are the
        # same): their sampled tiles alone take ~50 s of plain walk each.
        against = ({i: out["subcluster walk"]["rows"][i]
                    for i in deep if i not in turn}
                   if kw.get("gate") else None)
        rows = check_recorded(
            calls, f"instanced 32 {label}", record, INSTANCED_TILE_STRIDE,
            longest=INSTANCED_LONGEST if kw else 0,
            longest_calls=set(range(len(calls))) - set(deep) | set(turn),
            against=against)
        if kw:
            for i, row in enumerate(rows):
                row["kernel_ms"] = _kernel_ms(row, 2)
                got = row["out"]
                per_block = (float(got.ray_tests.double().sum())
                             / max(float(got.tests.double().sum()), 1.0))
                print(f"    call {i}: kernel {row['kernel_ms']:.3f} ms, "
                      f"bound {row['bound_ms']:.3f} ms, trips mean "
                      f"{float(row['iters'].float().mean()):.2f} max "
                      f"{int(row['iters'].max())}, ray tests per tested "
                      f"block {per_block:.1f}")
            print(f"  {label}: its {len(rows)} walk calls: kernel "
                  f"{sum(r['kernel_ms'] for r in rows):.3f} ms, bound "
                  f"{sum(r['bound_ms'] for r in rows):.3f} ms")
        differ = int((img != img128).any(-1).sum())
        print(f"  {label}: {len(calls)} walk calls; pixels that differ from "
              f"the 128 bake's frame: {differ}")
        out[label] = {"launches": launches, "rows": rows, "img": img,
                      "pixels_differ_128": differ}
    if not torch.equal(out["subcluster walk, gate"]["img"],
                       out["subcluster walk"]["img"]):
        raise AssertionError("the gate changed the instanced frame")
    # Frame ms in turns against the 128 bake, and both bakes' block walks
    # with the re-cull off.
    frames = [("128 defaults", iscene128, {})] + [
        (f"32 {label}", iscene, kw) for label, kw, _ in settings] + [
        ("128 cull_recull=0", iscene128, {"cull_recull": 0}),
        ("32 cull_recull=0", iscene, {"cull_recull": 0})]
    ms = {name: [] for name, _, _ in frames}
    for name, sc, kw in frames + frames[::-1]:
        with walk_defaults(**kw):
            ms[name].append(_cuda_ms(
                lambda: prender.render_image_instanced(sc, icfg, camera), 1))
    print("  instanced frame ms in turns: " + "; ".join(
        f"{k} {[round(m, 3) for m in v]}" for k, v in ms.items()))
    record.append({"what": "instanced 32", "turns_ms": ms, **{
        label: {"launches": v["launches"],
                "pixels_differ_128": v["pixels_differ_128"],
                "calls": [_call_summary(r) for r in v["rows"]
                          if "kernel_ms" in r]}
        for label, v in out.items()}})
    out["turns_ms"] = ms
    return out


# ---- [mxu]: the matmul pair test on the tensor cores ------------------------

# The tolerance of the tensor-core walk against its plain version, and of
# its frame against the exact walk's.  Both versions round their inputs to
# TF32 alike and sum exact products in float32; only the order of the sums
# differs (and, against the exact walk, the dropped a_lo*b_lo terms and the
# rounding of the lo parts: ~3 * 2^-22 of each product).  On the bench
# terrain a pair's terms reach ~1,100 x |det| (|d x o| ~ 45, edges ~0.057,
# |det| ~ 0.0032), so u and v err by up to ~1e-3 (sum order) and ~8e-4
# (3xTF32 against float32), t by ~4e-5 relative.  Where two walks' winners
# differ, each is evaluated in the other's rounding (``trace_winners``):
# the difference is traced when either winner's det-space margin, min(|u|,
# |v|, |1 - u - v|, |t|) or |t - t_max| / t_max, is below MXU_EPS there (one
# walk may accept it and the other not), or when the other walk accepts
# this one's winner at a t within MXU_RTOL of its own (an exact-t tie).
# Winners that agree: t within MXU_RTOL, u and v within MXU_EPS.  Rays
# whose winners differ: at most MXU_SHARE of a query's live rays, rounded
# up (the rate PERF.md predicts).
MXU_EPS = 4e-3
MXU_RTOL = 1e-4
MXU_SHARE = 1e-4
# Operations on the CUDA cores per ray-triangle pair of the tensor-core walk,
# read off mxuwalk.cu: the acceptance (5 compares, 1 add), two id compares
# and the best-t compare (nearest), or the t-bound product and compare
# (any-hit); by early-out stage (``sign_pairs(mxu=)``), the sign test of
# det alone (OPS_DET_MXU), then that of u*det (OPS_U_MXU more), then the
# rest.  The tensor-core work: the product's nonzero multiply-adds,
# 19 a pair (det 3, u*det and v*det 6 each, t*det 4; the kernel issues 32,
# one k8 step a column block), 2 FLOP each, x3 for "highest", at the
# H100's 495 TFLOP/s (TF32, dense).  The coefficients it needs are those
# 19 floats a lane and the 2 ids.
OPS_PAIR_MXU = {False: 9, True: 10}
OPS_DET_MXU = 1
OPS_U_MXU = 1
MXU_MACS = 19
PEAK_TF32 = 495e12
# The small comparisons: cluster sizes (32: a subcluster bake, walked at
# block granularity) and walk shapes (kind, options).
MXU_SIZES = (128, 32, 16)
MXU_SHAPES = (
    ("nearest ignore", False, {}), ("any-hit t_max", True, {}),
    ("nearest pretest recull", False, {"pretest": True, "recull_every": 2}),
    ("any-hit pretest recull", True, {"pretest": True, "recull_every": 2}),
    ("nearest budget 8", False, {"max_trips": 8}),
    ("any-hit budget 8", True, {"max_trips": 8}),
    ("nearest chunk_k 2", False, {"chunk_k": 2}),
    ("nearest chunk_k 2 pretest recull", False,
     {"chunk_k": 2, "pretest": True, "recull_every": 2}),
    ("any-hit chunk_k 2 pretest recull", True,
     {"chunk_k": 2, "pretest": True, "recull_every": 2}))
# Queries of the tensor-core walk's compacted rows: the first warps of
# every tile dead (NaN direction) from the start, or only a few live rays
# a tile.
MXU_SPARSE = (("whole warps resolved", lambda i: i % RAYS_PER_TILE < 96),
              ("few unresolved rays", lambda i: i % RAYS_PER_TILE % 37 != 0))
# Colour change of a pixel, beyond the discrete differences (another
# primary triangle, another shadow verdict), that would be a fault.
MXU_PIXEL_TOL = 1e-2


def _det_space(o, d, rows, coef=None, mxu=None):
    """det, u*det, v*det and t*det (n, m, L) of rays ``o``, ``d`` (n, 3)
    against the m x L pairs of the walk's rows ``rows`` (n or 1, m, 18, L):
    their exact float32 triple products or, with ``mxu``, that precision's
    ``R @ G`` on the coefficients ``coef``, (16, m * 4L) for every ray or
    (n, 16, 4L) a ray (m = 1), each block's four L-wide column blocks in
    turn."""
    from raytpu_torch.kernels.fused import mxu_values

    col = lambda x: x[:, None, None]  # noqa: E731
    ox, oy, oz = (col(o[:, k]) for k in range(3))
    dx, dy, dz = (col(d[:, k]) for k in range(3))
    wx, wy, wz = dy * oz - dz * oy, dz * ox - dx * oz, dx * oy - dy * ox
    if mxu:
        n = o.shape[0]
        rmat = torch.cat([a[:, 0] for a in (dx, dy, dz, wx, wy, wz, ox, oy,
                                            oz)]
                         + [torch.ones_like(dx[:, 0])]
                         + [torch.zeros_like(dx[:, 0])] * 6, dim=1)
        vals = (mxu_values(rmat, coef, mxu) if coef.dim() == 2
                else mxu_values(rmat[:, None], coef, mxu))
        return vals.reshape(n, rows.shape[-3], 4, rows.shape[-1]).unbind(2)
    row = lambda i: rows[..., i, :]  # noqa: E731
    det = dx * row(0) + dy * row(1) + dz * row(2)
    udet = (wx * row(6) + wy * row(7) + wz * row(8) + dx * row(3)
            + dy * row(4) + dz * row(5))
    vdet = (wx * row(12) + wy * row(13) + wz * row(14) + dx * row(9)
            + dy * row(10) + dz * row(11))
    tdet = row(15) - (ox * row(0) + oy * row(1) + oz * row(2))
    return det, udet, vdet, tdet


def _margins(vals, ids, q, rays, cull, eps):
    """For pairs of rays ``rays`` (indices into the padded query ``q``)
    with det-space values ``vals`` and triangle and mesh ids ``ids``
    ((n or 1, m, L) each): whether each pair is within ``eps`` of
    acceptance (u, v >= -eps, u + v <= 1 + eps, t >= -eps, t <= t_max (1 +
    eps), the facing of ``cull``, not ignored), its margin, min(|udet|,
    |vdet|, |det - udet - vdet|, |tdet|) / |det| or |t - t_max| / max(t_max,
    1) when that is smaller (INF where it is not near), and its t."""
    det, udet, vdet, tdet = vals
    tid, mesh = ids
    col = lambda x: x[:, None, None]  # noqa: E731
    u, v, t = udet / det, vdet / det, tdet / det
    tb = col(q.t_max[rays])
    facing = (det < 0 if cull is True else det > 0 if cull == "reverse"
              else det != 0)
    near = ((u >= -eps) & (v >= -eps) & (u + v <= 1 + eps) & (t >= -eps)
            & (t <= tb * (1 + eps)) & facing & (tid >= 0)
            & (tid != col(q.ignore_tri[rays]))
            & (mesh != col(q.ignore_mesh[rays])))
    m = torch.stack([udet.abs(), vdet.abs(), (det - udet - vdet).abs(),
                     tdet.abs()]).amin(0) / det.abs()
    m = torch.minimum(m, (t - tb).abs() / tb.clamp(min=1.0))
    return near, torch.where(near, m, float("inf")), t


def near_margin(clusters, q, rays, cull, eps, mxu=None):
    """For rays ``rays`` (indices into the padded query ``q``): the least
    margin (``_margins``) over every pair of every block, in the exact
    walk's rounding or, with ``mxu``, in that precision's ``R @ G``.  An
    any-hit verdict that differs between two walks names no triangle, so it
    is traced to the nearest pair to acceptance."""
    g = clusters["block"]
    ids = (g[None, :, 16].view(torch.int32), g[None, :, 17].view(torch.int32))
    coef = (clusters["gblock"][:, :16].permute(1, 0, 2).reshape(16, -1)
            if mxu else None)
    out = []
    for s in range(0, rays.shape[0], 8):
        idx = rays[s:s + 8]
        vals = _det_space(q.origin[idx], q.direction[idx], g[None, :, :18],
                          coef, mxu)
        out.append(_margins(vals, ids, q, idx, cull, eps)[1].flatten(1)
                   .amin(1))
    return torch.cat(out) if out else torch.zeros(0, device=q.origin.device)


def slot_margin(clusters, q, rays, codes, cull, eps, mxu=None):
    """``_margins`` (near, margin, t: (n,) each) of one pair a ray: ray
    ``rays[i]`` of the padded query ``q`` against the slot ``codes[i]``
    (block * C + lane; -1: no pair, never near), in the exact walk's
    rounding or, with ``mxu``, in that precision's ``R @ G``."""
    g = clusters["block"]
    c = g.shape[2]
    code = codes.clamp(min=0).long()
    k, lane = code // c, code % c
    rows = g[k].gather(2, lane[:, None, None].expand(-1, g.shape[1], 1))
    coef = None
    if mxu:
        cols = lane[:, None] + c * torch.arange(4, device=lane.device)
        coef = clusters["gblock"][k, :16].gather(
            2, cols[:, None, :].expand(-1, 16, 4))
    vals = _det_space(q.origin[rays], q.direction[rays], rows[:, None, :18],
                      coef, mxu)
    ids = (rows[:, None, 16].view(torch.int32),
           rows[:, None, 17].view(torch.int32))
    near, m, t = (x[:, 0, 0] for x in _margins(vals, ids, q, rays, cull, eps))
    some = codes >= 0
    return near & some, torch.where(some, m, float("inf")), t


def slot_of_tri(clusters, tri):
    """The slot codes (block * C + lane) of triangle ids ``tri`` (-1 stays
    -1) in the bake ``clusters``."""
    ids = clusters["block"][:, 16].reshape(-1).view(torch.int32)
    slots = torch.arange(ids.shape[0], device=ids.device, dtype=torch.int32)
    inv = torch.full((int(ids.max()) + 1,), -1, dtype=torch.int32,
                     device=ids.device)
    inv[ids[ids >= 0].long()] = slots[ids >= 0]
    return torch.where(tri >= 0, inv[tri.clamp(min=0).long()], -1)


def trace_winners(clusters, rays, got, ref, cull, eps, rtol, mxu_got=None,
                  mxu_ref=None):
    """Rays ``rays`` on which two nearest walks' winners differ, traced.
    ``got`` and ``ref`` are (padded query, slot codes, t) of each walk,
    whose rounding is ``mxu_got`` and ``mxu_ref`` (None: the exact
    walk's).  A ray is traced where ``got``'s winner, evaluated on ``ref``'s
    ray in ``ref``'s rounding, or ``ref``'s winner on ``got``'s ray in
    ``got``'s rounding, has a margin below ``eps`` (the walk that passed it
    over may have rejected it), or where ``ref``'s rounding accepts
    ``got``'s winner at a t within ``rtol`` of its own winner's (an exact-t
    tie).  Returns (traced, tie and not near a margin, margin)."""
    (qg, cg, _), (qr, cr, tr) = got, ref
    near_k, m_k, t_k = slot_margin(clusters, qr, rays, cg[rays], cull, eps,
                                   mxu_ref)
    _, m_p, _ = slot_margin(clusters, qg, rays, cr[rays], cull, eps, mxu_got)
    margin = torch.minimum(m_k, m_p)
    t0 = tr[rays]
    tie = near_k & (cr[rays] >= 0) & ((t_k - t0).abs() <= rtol * t0.abs())
    traced = (margin < eps) | tie
    return traced, tie & ~(margin < eps), margin


def _allowed(q):
    """Rays of the padded query ``q`` whose winners may differ between two
    walks: MXU_SHARE of its live rays, rounded up."""
    live = int(torch.isfinite(q.direction).all(-1).sum())
    return math.ceil(MXU_SHARE * live)


def compare_mxu(clusters, tri_shade, q, what, record, got=None, **walk):
    """The tensor-core walk (``got``, or a fresh launch) against its plain
    version on the same padded query: hits and winning slots equal except
    on rays traced (``trace_winners`` in the plain version's rounding, or
    for any-hit verdicts ``near_margin``), at most ``_allowed`` of them;
    winners that agree within MXU_RTOL (t) and MXU_EPS (u, v); the
    counters and resolved flags equal where no ray is an exception.
    Returns (max abs difference, plain ms, exceptions)."""
    from raytpu_torch.kernels.fused import walk_cuda, walk_plain

    any_hit, cull, prec = walk["any_hit"], walk["cull"], walk["mxu"]
    if got is None:
        got = walk_cuda(clusters, tri_shade, q, **walk)
    ref, plain_ms = _once_ms(lambda: walk_plain(clusters, tri_shade, q,
                                                **walk))
    hk, hp = got.code >= 0, ref.code >= 0
    differ = hk != hp
    both = hk & hp
    if not any_hit:
        differ |= both & (got.code != ref.code)
    ex = differ.nonzero()[:, 0]
    if any_hit:
        margin = near_margin(clusters, q, ex, cull, MXU_EPS, mxu=prec)
        traced, ties = margin < MXU_EPS, torch.zeros_like(ex, dtype=bool)
    else:
        traced, ties, margin = trace_winners(
            clusters, ex, (q, got.code, got.t), (q, ref.code, ref.t), cull,
            MXU_EPS, MXU_RTOL, prec, prec)
    same = both & ~differ
    t_err = u_err = abs_err = 0.0
    if not any_hit and bool(same.any()):
        dt = (got.t[same] - ref.t[same]).abs()
        t_err = float((dt / ref.t[same].abs().clamp(min=1e-30)).max())
        u_err = float(torch.maximum((got.u[same] - ref.u[same]).abs(),
                                    (got.v[same] - ref.v[same]).abs()).max())
        abs_err = max(float(dt.max()), u_err)
    counters = all(torch.equal(getattr(got, f), getattr(ref, f))
                   for f in ("iters", "tests", "ray_tests", "resolved"))
    n_ex, untraced, allowed = int(ex.shape[0]), int((~traced).sum()), \
        _allowed(q)
    fin = traced & torch.isfinite(margin)
    worst = float(margin[fin].max()) if bool(fin.any()) else 0.0
    rec = {"what": what, "walk": {k: str(v) for k, v in walk.items()},
           "rays": int(q.origin.shape[0]), "hits": int(hk.sum()),
           "exceptions": n_ex, "allowed": allowed, "ties": int(ties.sum()),
           "untraced": untraced, "largest_traced_margin": worst,
           "t_rel_err": t_err, "uv_abs_err": u_err,
           "counters_equal": counters, "plain_ms": plain_ms}
    record.append(rec)
    print(f"  {what}: {walk} rays={q.origin.shape[0]} hits {int(hk.sum())}/"
          f"{int(hp.sum())}, exceptions {n_ex} of at most {allowed} "
          f"(exact-t ties {int(ties.sum())}, untraced {untraced}, largest "
          f"margin {worst:.2e}), t rel {t_err:.2e}, u/v abs {u_err:.2e}, "
          f"counters equal {counters}, plain walk {plain_ms:.0f} ms")
    if untraced or n_ex > allowed or t_err > MXU_RTOL or u_err > MXU_EPS or (
            n_ex == 0 and not counters):
        raise AssertionError(f"the tensor-core walk and its plain version "
                             f"disagree on {what}")
    return abs_err, plain_ms, n_ex


def mxu_bound(q, out, clusters, walk, signs):
    """The least time the card could take for one tensor-core walk call:
    the largest of the tensor-core work (every pair the walk tests, the
    first of ``signs``, x 2 * MXU_MACS FLOP, x3 for "highest", at 495
    TFLOP/s), the CUDA-core work (those pairs by early-out stage,
    ``sign_pairs(mxu=)``: OPS_DET_MXU each, OPS_U_MXU more for those whose
    det passes its sign test, the rest of OPS_PAIR_MXU for those whose
    u*det passes too) and the bytes (each input read once: the rays, the
    MXU_MACS nonzero coefficients and the 2 ids of every lane, the cull
    tables; each output written once)."""
    any_hit = walk["any_hit"]
    ncg, _, csize = clusters["block"].shape
    r, nt = q.origin.shape[0], q.origin.shape[0] // q.tile
    n, n_det, n_u = (float(x) for x in signs)
    passes = 3 if walk["mxu"] == "highest" else 1
    tc = n * 2 * MXU_MACS * passes
    cuda = (n * OPS_DET_MXU + n_det * OPS_U_MXU
            + n_u * (OPS_PAIR_MXU[any_hit] - OPS_DET_MXU - OPS_U_MXU))
    nbytes = (r * 36 + ncg * (11 + (MXU_MACS + 2) * csize) * 4 + 32 + nt * 12
              + r * (12 if any_hit else 24))
    if walk.get("rows", True) and not any_hit:
        nbytes += r * 128 + int((out.code >= 0).sum()) * 128
    times = {"tensor cores": tc / PEAK_TF32 * 1e3,
             "CUDA cores": cuda / PEAK_OPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    unit = max(times, key=times.get)
    return {"bound_ms": times[unit],
            "bound_by": "bytes" if unit == "bytes" else "operations",
            "bound_unit": unit, "tc_flop": tc, "ops": cuda, "bytes": nbytes,
            "bound_parts_ms": times}


def _fused_query(**fused_kw):
    """A render query through ``nearest_hit_fused(**fused_kw)``, tiles of
    RAYS_PER_TILE rays."""
    from raytpu_torch.kernels.fused import nearest_hit_fused

    def query(scene, origin, direction, *, ignore_tri=None, ignore_mesh=None,
              t_max=None, any_hit=False, cull=True, with_rows=False):
        return nearest_hit_fused(scene, origin, direction, ignore_tri,
                                 ignore_mesh, cull, t_max=t_max,
                                 any_hit=any_hit, tile_size=RAYS_PER_TILE,
                                 return_rows=with_rows, **fused_kw)

    query.supports_rows = True
    return query


def _recording_hook(calls, base):
    """A render query that runs ``base`` and keeps each call's inputs and
    Hit in ``calls``."""

    def query(scene, origin, direction, **kw):
        res = base(scene, origin, direction, **kw)
        hit = res[0] if kw.get("with_rows") else res
        calls.append({"origin": origin, "direction": direction,
                      "ignore_tri": kw.get("ignore_tri"),
                      "ignore_mesh": kw.get("ignore_mesh"),
                      "t_max": kw.get("t_max"),
                      "any_hit": kw.get("any_hit", False),
                      "cull": kw.get("cull", True), "hit": hit})
        return res

    query.supports_rows = getattr(base, "supports_rows", False)
    return query


def _call_query(call):
    """The padded query of a recorded render query."""
    from raytpu_torch.kernels.fused import pack_query

    return pack_query(call["origin"], call["direction"], call["ignore_tri"],
                      call["ignore_mesh"], call["t_max"], RAYS_PER_TILE)


def _trace_calls(flat, got, ref, rays, eps, rtol, mxu_got=None,
                 mxu_ref=None):
    """``trace_winners`` of rays ``rays`` of two recorded nearest render
    queries (``got`` and ``ref``, in the roundings ``mxu_got`` and
    ``mxu_ref``), or for any-hit queries the least ``near_margin`` on
    either query's ray below ``eps``.  Returns (traced, tie only,
    margin)."""
    cl = flat.clusters
    qg, qr = _call_query(got), _call_query(ref)
    if ref["any_hit"]:
        margin = torch.minimum(
            near_margin(cl, qg, rays, got["cull"], eps, mxu_got),
            near_margin(cl, qr, rays, ref["cull"], eps, mxu_ref))
        return margin < eps, torch.zeros_like(rays, dtype=bool), margin
    hg, hr = got["hit"], ref["hit"]
    return trace_winners(cl, rays, (qg, slot_of_tri(cl, hg.tri), hg.t),
                         (qr, slot_of_tri(cl, hr.tri), hr.t), ref["cull"],
                         eps, rtol, mxu_got, mxu_ref)


def _mxu_image(flat, cfg, rays, img_exact, record):
    """The bench frame with mxu="highest" against the exact walk's frame:
    every pixel whose primary triangle or shadow verdict differs traced
    (``_trace_calls``), at most ``_allowed`` of them; every pixel whose
    colour differs by more than MXU_PIXEL_TOL traced to a margin, not to
    an exact-t tie alone (a tie on the smooth-shaded terrain is the same
    point and nearly the same normal)."""
    from raytpu_torch.render.wavefront import trace_colors

    o, d = rays
    exact, mxu = [], []
    img_e = trace_colors(flat, cfg, o, d,
                         query=_recording_hook(exact, _fused_query()))
    img_m = trace_colors(flat, cfg, o, d, query=_recording_hook(
        mxu, _fused_query(mxu=True, mxu_precision="highest")))
    if not torch.equal(img_e, img_exact):
        raise AssertionError("the exact frame through the hook is not the "
                             "frame")
    (pe, se), (pm, sm) = exact, mxu
    he, hm = pe["hit"], pm["hit"]
    d_tri = (he.hit != hm.hit) | (he.hit & hm.hit & (he.tri != hm.tri))
    d_sh = ~d_tri & (se["hit"].hit != sm["hit"].hit)
    delta = (img_e - img_m).abs().amax(-1)
    px_tri, px_sh = d_tri.nonzero()[:, 0], d_sh.nonzero()[:, 0]
    ok_tri, tie, m_tri = _trace_calls(flat, pm, pe, px_tri, MXU_EPS,
                                      MXU_RTOL, "highest")
    ok_sh, _, m_sh = _trace_calls(flat, sm, se, px_sh, MXU_EPS, MXU_RTOL,
                                  "highest")
    # Pixels whose colour may change: a traced primary difference that is
    # not a tie alone, or a traced shadow verdict.
    free = torch.zeros_like(d_tri)
    free[px_tri[ok_tri & ~tie]] = True
    free[px_sh[ok_sh]] = True
    d_col = ~free & (delta > MXU_PIXEL_TOL)
    untraced = int((~ok_tri).sum() + (~ok_sh).sum() + d_col.sum())
    n_ex = int(px_tri.shape[0] + px_sh.shape[0])
    allowed = _allowed(_call_query(pe))
    traced = torch.cat([m_tri[ok_tri & (m_tri < MXU_EPS)], m_sh[ok_sh]])
    differ = int((delta > 0).sum())
    tie_px = px_tri[tie]
    tie_delta = float(delta[tie_px].max()) if tie_px.numel() else 0.0
    print(f"  bench frame, mxu='highest' against the exact walk: pixels "
          f"that differ at all {differ} (largest {float(delta.max()):.3g}); "
          f"another primary triangle {px_tri.shape[0]} ({tie_px.shape[0]} "
          f"exact-t ties alone, their colour within {tie_delta:.3g}), "
          f"another shadow verdict {px_sh.shape[0]} (at most {allowed} in "
          f"all); colour beyond {MXU_PIXEL_TOL} otherwise "
          f"{int(d_col.sum())}; untraced {untraced}; largest traced margin "
          f"{float(traced.max()) if traced.numel() else 0.0:.2e}")
    for kind, px, m, ok in (("primary", px_tri, m_tri, ok_tri),
                            ("shadow", px_sh, m_sh, ok_sh)):
        for i in range(min(8, px.shape[0])):
            print(f"    pixel {int(px[i])}: {kind} differs, margin "
                  f"{float(m[i]):.3e}, traced {bool(ok[i])}, colour "
                  f"{float(delta[px[i]]):.3g}")
    record.append({"what": "mxu frame vs exact", "pixels_differ": differ,
                   "primary": int(px_tri.shape[0]),
                   "ties": int(tie_px.shape[0]), "tie_colour": tie_delta,
                   "shadow": int(px_sh.shape[0]), "allowed": allowed,
                   "colour": int(d_col.sum()), "untraced": untraced})
    if untraced or n_ex > allowed:
        raise AssertionError("the mxu frame differs from the exact frame in "
                             "pixels no near pair or tie explains")
    return {"pixels_differ": differ, "primary": int(px_tri.shape[0]),
            "ties": int(tie_px.shape[0]), "shadow": int(px_sh.shape[0])}


def phase_mxu(dev, card, img_exact, record):
    """[mxu]: mxu_walk_kernel against its plain version on small scenes
    (cluster sizes 128, 32 and 16 with gblock; nearest and any-hit; cull
    True, False and "reverse"; pretest and re-cull; a budget of 8 trips
    and the phase-1 compaction; chunk_k 2, alone and with pretest and
    re-cull; ignore ids; MXU_SPARSE's queries; both precisions), then
    every walk call of the bench frame at 128 with gblock at both
    precisions (counted: the launches of that run), the calls' times and
    bounds, and the frame against the exact walk's."""
    from raytpu_torch import Quantize, RenderConfig
    from raytpu_torch.kernels.fused import (MXU_PRECISIONS, nearest_hit_fused,
                                            pack_query)
    from raytpu_torch.render.wavefront import trace_colors

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[mxu] tensor-core walk vs its plain version (matmul "
          "allow_tf32=False), small scenes")
    rng = np.random.default_rng(2)
    err = {p: 0.0 for p in MXU_PRECISIONS}
    small_ex = 0
    for csize in MXU_SIZES:
        scene = _small_scene(csize, dev, build_gblock=True,
                             build_octree=False)
        tables = (scene.clusters, scene.tri_shade)
        o, d, itri, tmax = _small_rays(rng, 4096, scene, dev)
        for prec in MXU_PRECISIONS:
            for cull in (True, False, "reverse"):
                for name, any_hit, kw in MXU_SHAPES:
                    if cull is not True and kw:
                        continue  # the shapes run with backface culling
                    q = pack_query(o, d, ignore_tri=itri,
                                   t_max=tmax if any_hit else None,
                                   tile_size=RAYS_PER_TILE)
                    e, _, n = compare_mxu(
                        *tables, q, f"csize {csize} {prec} {name}", record,
                        cull=cull, any_hit=any_hit, mxu=prec, **kw)
                    err[prec] = max(err[prec], e)
                    small_ex += n
            for name, dead in MXU_SPARSE:
                idx = torch.arange(o.shape[0], device=dev)
                ds = torch.where(dead(idx)[:, None], float("nan"), d)
                for any_hit in (False, True):
                    q = pack_query(o, ds, ignore_tri=itri,
                                   t_max=tmax if any_hit else None,
                                   tile_size=RAYS_PER_TILE)
                    e, _, n = compare_mxu(
                        *tables, q, f"csize {csize} {prec} {name}", record,
                        cull=True, any_hit=any_hit, mxu=prec)
                    err[prec] = max(err[prec], e)
                    small_ex += n
            # The phase-1 compaction: card against CPU through the entry
            # point.
            cpu = scene.to("cpu")
            for any_hit in (False, True):
                args = dict(ignore_tri=itri, t_max=tmax if any_hit else None,
                            any_hit=any_hit, tile_size=RAYS_PER_TILE,
                            mxu=True, mxu_precision=prec, phase1_trips=2)
                got = nearest_hit_fused(scene, o, d, **args)
                ref = nearest_hit_fused(cpu, o.cpu(), d.cpu(), **{
                    k: v.cpu() if torch.is_tensor(v) else v
                    for k, v in args.items()})
                gh, rh = got.hit, ref.hit.to(dev)
                gt, rt = got.tri, ref.tri.to(dev)
                q = pack_query(o, d, itri, None, args["t_max"],
                               RAYS_PER_TILE)
                if any_hit:
                    mis = (gh != rh).nonzero()[:, 0]
                    traced = near_margin(scene.clusters, q, mis, True,
                                         MXU_EPS, mxu=prec) < MXU_EPS
                else:
                    mis = ((gh != rh) | (gh & rh & (gt != rt))).nonzero()[:, 0]
                    traced = trace_winners(
                        scene.clusters, mis,
                        (q, slot_of_tri(scene.clusters, gt), got.t),
                        (q, slot_of_tri(scene.clusters, rt), ref.t.to(dev)),
                        True, MXU_EPS, MXU_RTOL, prec, prec)[0]
                untraced = int((~traced).sum())
                print(f"  csize {csize} {prec} phase1_trips=2 any_hit="
                      f"{any_hit}: hits {int(gh.sum())}, card and CPU "
                      f"differ on {mis.shape[0]} rays (at most "
                      f"{_allowed(q)}), untraced {untraced}")
                if untraced or mis.shape[0] > _allowed(q):
                    raise AssertionError("the phase-1 mxu walk on the card "
                                         "differs from the CPU")

    t0 = time.perf_counter()
    flat = bench_scene(TRIS).flatten(cluster_size=CLUSTER_SIZE, device=dev,
                                     build_octree=False, build_gblock=True)
    torch.cuda.synchronize()
    mb = flat.clusters["gblock"].numel() * 4 / 1e6
    print(f"  bench bake with gblock ({mb:.0f} MB on the card) in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = RenderConfig(width=RES, height=RES, max_reflections=0,
                       tile_pixels=RES ** 2, quantize=Quantize.NONE)
    rays = _frame_rays(RES, dev)
    out = {"small_err": err, "small_exceptions": small_ex}
    for prec in MXU_PRECISIONS:
        query = _fused_query(mxu=True, mxu_precision=prec)
        reset_launches()
        img = trace_colors(flat, cfg, *rays, query=query)
        launches = read_launches()
        _require(launches, f"nearest_mxu_{prec}", f"any_hit_mxu_{prec}",
                 absent=("_sub", "_prepick"))
        _check_image(img, f"mxu {prec} frame")
        with recording_walks() as calls:
            trace_colors(flat, cfg, *rays, query=query)
        rows = []
        for i, (clusters, tri_shade, q, kw, got) in enumerate(calls):
            with sign_pairs(mxu=prec) as signs:
                e, plain_ms, n = compare_mxu(clusters, tri_shade, q,
                                             f"bench {prec} call {i}",
                                             record, got=got, **kw)
            row = {"kw": kw, "err": e, "plain_ms": plain_ms, "iters":
                   got.iters, "out": got, "q": q, "clusters": clusters,
                   "tri_shade": tri_shade, "exceptions": n,
                   **mxu_bound(q, got, clusters, kw, signs)}
            row["kernel_ms"] = _kernel_ms(row, REPS)
            rows.append(row)
            parts = ", ".join(f"{k} {v:.3f}"
                              for k, v in row["bound_parts_ms"].items())
            kind = "any-hit" if kw["any_hit"] else "nearest"
            print(f"    call {i} ({kind}): {row['kernel_ms']:.3f} ms, bound "
                  f"{row['bound_ms']:.3f} ms by {row['bound_by']} ({parts}), "
                  f"trips mean {float(got.iters.float().mean()):.2f}")
        out[prec] = {"launches": launches, "rows": rows}
    out["image"] = _mxu_image(flat, cfg, rays, img_exact, record)
    print(card)
    return out


# ---- [query]: the brute, octree and tiled backends, AUTO, clearance ---------

# The other backends against the walk: both are exact, but the division
# form (brute, octree, tiled) and the walk's det-space triple product round
# differently (the JAX package holds them to each other at rtol 1e-4 on t,
# tests/test_accel.py), so a ray that grazes an edge may be accepted by one
# and not the other, and an exact-t tie may go to either triangle.  Every
# ray whose hit or triangle differs is traced (``trace_winners``, margins
# below QUERY_EPS, ties within QUERY_RTOL); winners that agree have t
# within QUERY_RTOL relative, or absolute below t = 1 (secondary rays that
# hit close to their origin cancel in t*det).  Two frames through different
# backends are compared slot by slot at every level of the wavefront
# (``_trace_frames``), and every pixel that differs beyond QUERY_PIXEL_TOL
# is traced to a difference in the queries of its ray tree.
QUERY_EPS = 1e-3
QUERY_RTOL = 1e-4
QUERY_PIXEL_TOL = 1e-4
# Point-filtered textures pick a texel by truncating the texture
# coordinate: a hit on the same triangle may take the neighbouring texel
# where the two frames' coordinates lie within TEXEL_EPS texels of each
# other on either side of a texel edge (u, v differ by ~1e-5 between the
# division form and the triple product; times the texture's 127 texels and
# the uv scale, ~1e-3 texel).
TEXEL_EPS = 1e-2
# Triangles of the bench terrain the octree and tiled queries run on (the
# full frame unless printed otherwise).
QUERY_TRIS = {"tiled": TRIS, "octree": TRIS}


def _against_walk(flat, call, got, walk):
    """One query's hits from another backend (``got``) against the walk's
    (``walk``) on the recorded query ``call``: returns (rays that differ,
    untraced, exact-t ties, t rel err).  Any-hit queries compare the
    occlusion verdict against t_max."""
    if call["any_hit"]:
        tm = call["t_max"]
        differ = (got.hit & (got.t < tm)) != (walk.hit & (walk.t < tm))
        both = torch.zeros_like(differ)
    else:
        both = got.hit & walk.hit
        differ = (got.hit != walk.hit) | (both & (got.tri != walk.tri))
    rays = differ.nonzero()[:, 0]
    traced, tie, _ = _trace_calls(flat, dict(call, hit=got),
                                  dict(call, hit=walk), rays, QUERY_EPS,
                                  QUERY_RTOL)
    same = both & ~differ
    t_err = float(((got.t[same] - walk.t[same]).abs()
                   / walk.t[same].abs().clamp(min=1.0)).max()) \
        if bool(same.any()) else 0.0
    return int(rays.shape[0]), int((~traced).sum()), int(tie.sum()), t_err


def _record_frame(flat, cfg, o, d, base):
    """``trace_colors`` of primary rays ``o``, ``d`` through the query
    ``base``: the colours, every query (``_recording_hook``) and the live
    child slots that each compacted dual-branch level carried (of its
    parents' [reflection | refraction] children).  Each shadow query
    carries ``edge``, its fragments' distance from the light's threshold:
    min(|n . l|, |cos - cutoff|) of a spot light (its horizon and cone
    edge), |n . l| of a directional one.  Each level's nearest query of a
    point-filtered textured scene carries ``texel``: its hits' texture
    coordinates in texels before and after addressing, and whether the
    material samples its texture."""
    from raytpu_torch.config import TextureFiltering
    from raytpu_torch.core.math3d import dot, normalize
    from raytpu_torch.render import wavefront
    from raytpu_torch.scene import lights, texture

    calls, lives, edges, texels = [], [], [], []
    live_slots, light_contrib = wavefront._live_slots, lights.light_contrib
    surface_color = wavefront._surface_color

    def contrib_of(lt, i, frag_pos, normal):
        to = normalize(lt["position"][i] - frag_pos)
        spot = torch.minimum(
            dot(to, normal).abs(),
            (dot(-to, lt["direction"][i]) - lt["angle_cosine"][i]).abs())
        edges.append(torch.where(lt["type"][i] == lights.SPOT, spot,
                                 dot(lt["direction"][i], normal).abs()))
        return light_contrib(lt, i, frag_pos, normal)

    def surface_of(scene, cfg_, td, mat, u, v, texel_fetch=None):
        if scene.has_textures and cfg_.filtering == TextureFiltering.POINT:
            uv = (td["uv1"] + (td["uv2"] - td["uv1"]) * u[..., None]
                  + (td["uv3"] - td["uv1"]) * v[..., None])
            tex_id = torch.clamp(scene.mat_texture[mat], min=0)
            size = (scene.tex_hw[tex_id].flip(-1) - 1).to(torch.float32)
            texels.append({
                "coord": texture.address_uv(uv, cfg_.address_mode) * size,
                "raw": uv * size,
                "use": scene.mat_use_texture[mat]
                & (scene.mat_texture[mat] >= 0)})
        return surface_color(scene, cfg_, td, mat, u, v, texel_fetch)

    def live_of(alive):
        live = live_slots(alive)
        lives.append(live)
        return live

    wavefront._live_slots, lights.light_contrib = live_of, contrib_of
    wavefront._surface_color = surface_of
    try:
        colors = wavefront.trace_colors(flat, cfg, o, d,
                                        query=_recording_hook(calls, base))
    finally:
        wavefront._live_slots, lights.light_contrib = live_slots, light_contrib
        wavefront._surface_color = surface_color
    per = 1 + flat.num_lights
    shadows = [c for i, c in enumerate(calls) if i % per]
    nearest = [c for i, c in enumerate(calls) if not i % per]
    if len(shadows) != len(edges) or len(texels) not in (0, len(nearest)):
        raise AssertionError(f"{len(edges)} light and {len(texels)} surface "
                             f"evaluations for {len(calls)} queries")
    for call, edge in zip(shadows, edges):
        call["edge"] = edge
    for call, texel in zip(nearest, texels):
        call["texel"] = texel
    return colors, calls, lives


def _tree_slots(calls, lives, r0, per):
    """The recorded queries by wavefront level (``per`` a level: its
    nearest query, then one shadow query a light), and for each level the
    position in the level's queries of every slot of the full ray tree, -1
    where the level did not carry the slot (a dead child of a compacted
    level).  Slot c of a dual-branch level L >= 1 is child c // T of slot
    c % T of level L - 1, T that level's slot count; c % r0 is its pixel.
    ``lives``: the live child slots of each compacted level
    (``_record_frame``); without them a level of twice its parents' rays
    carried every child, and one of as many kept its parents' slots."""
    levels = [calls[i:i + per] for i in range(0, len(calls), per)]
    dev = calls[0]["origin"].device
    tree = torch.arange(r0, device=dev)  # the tree slot of each position
    pos = [tree]
    width = r0  # the tree's slots at this level
    if lives and len(lives) not in (len(levels) - 1, len(levels)):
        raise AssertionError(f"{len(lives)} compactions for {len(levels)} "
                             "levels")
    for level, lv in enumerate(levels[1:]):
        r, prev = lv[0]["origin"].shape[0], tree.shape[0]
        if not lives and r == prev:  # the children keep their parents' slots
            pos.append(pos[-1])
            continue
        child = torch.arange(2 * prev, device=dev)
        child = (child // prev) * width + tree[child % prev]
        tree = child[lives[level]] if lives else child
        width *= 2
        at = torch.full((width,), -1, dtype=torch.long, device=dev)
        at[tree] = torch.arange(r, device=dev)
        pos.append(at)
    return levels, pos


def _tree_call(call, at):
    """A recorded query with every per-ray array in tree-slot order
    (``at``: each slot's position, -1 for a slot the level did not carry,
    which reads as a dead ray: direction NaN, no hit)."""
    absent = at < 0
    idx = torch.where(absent, 0, at)

    def take(x):
        if x is None:
            return None
        fill = (False if x.dtype == torch.bool else
                -1 if not x.is_floating_point() else float("nan"))
        out = x[idx]
        return out.masked_fill(absent.reshape(absent.shape + (1,) *
                                              (out.ndim - 1)), fill)

    hit = call["hit"]
    return dict(call, origin=take(call["origin"]),
                direction=take(call["direction"]),
                ignore_tri=take(call["ignore_tri"]),
                ignore_mesh=take(call["ignore_mesh"]),
                t_max=take(call["t_max"]), edge=take(call.get("edge")),
                texel={k: take(x) for k, x in call.get("texel", {}).items()},
                hit=type(hit)(*(take(x) for x in hit)))


def _print_tree(flat, a, b, pixel):
    """Each live slot of ``pixel``'s ray tree in two recorded frames: the
    nearest query's hit, triangle, t, u and v in each, its texel
    coordinates and each shadow query's verdict and light threshold."""
    r0 = a[1][0]["origin"].shape[0]
    per = 1 + flat.num_lights
    (lv_a, pos_a), (lv_b, pos_b) = (_tree_slots(f[1], f[2], r0, per)
                                    for f in (a, b))
    for level, (la, lb) in enumerate(zip(lv_a, lv_b)):
        r = pos_a[level].shape[0]
        slots = torch.arange(pixel, r, r0, device=pos_a[level].device)
        la = [_tree_call(c, pos_a[level][slots]) for c in la]
        lb = [_tree_call(c, pos_b[level][slots]) for c in lb]
        for k, c in enumerate(slots.tolist()):
            if not (torch.isfinite(la[0]["direction"][k]).all()
                    or torch.isfinite(lb[0]["direction"][k]).all()):
                continue
            ha, hb = la[0]["hit"], lb[0]["hit"]
            line = (f"      level {level} slot {c}: hit {bool(ha.hit[k])}/"
                    f"{bool(hb.hit[k])} tri {int(ha.tri[k])}/"
                    f"{int(hb.tri[k])} t {float(ha.t[k]):.8g}/"
                    f"{float(hb.t[k]):.8g} u {float(ha.u[k]):.7g}/"
                    f"{float(hb.u[k]):.7g} v {float(ha.v[k]):.7g}/"
                    f"{float(hb.v[k]):.7g}")
            if la[0]["texel"]:
                line += (f" texel {la[0]['texel']['coord'][k].tolist()}/"
                         f"{lb[0]['texel']['coord'][k].tolist()}")
            for j, (sa, sb) in enumerate(zip(la[1:], lb[1:])):
                line += (f"; light {j} hit {bool(sa['hit'].hit[k])}/"
                         f"{bool(sb['hit'].hit[k])} edge "
                         f"{float(sa['edge'][k]):.3g}/"
                         f"{float(sb['edge'][k]):.3g}")
            print(line)


def _trace_frames(flat, a, b):
    """Two frames of the same primary rays (``_record_frame`` of each)
    compared slot by slot over their ray trees.  At every level and query a
    slot whose hit, triangle or shadow verdict differs between the frames
    is explained by a traced difference of its ancestors (or, for a shadow
    query, of its own nearest query), or is traced itself (``_trace_calls``
    on each frame's own ray); a slot live in one frame and dead in the
    other must be so explained (a child lives where its parent hit and its
    weight is not zero), or for a shadow ray (cast where the light reaches
    the fragment) be traced to a fragment within QUERY_EPS of the light's
    threshold in both frames (``_record_frame``'s ``edge``).  A hit on the
    same triangle whose point-filtered texel differs is traced where the
    two frames' texture coordinates lie within TEXEL_EPS of each other
    across a texel edge.  Returns (pixels with a traced difference in
    their tree, per-query lines, untraced slots)."""
    (_, calls_a, live_a), (_, calls_b, live_b) = a, b
    r0 = calls_a[0]["origin"].shape[0]
    per = 1 + flat.num_lights
    lv_a, pos_a = _tree_slots(calls_a, live_a, r0, per)
    lv_b, pos_b = _tree_slots(calls_b, live_b, r0, per)
    if ([len(x) for x in lv_a] != [len(x) for x in lv_b]
            or [p.shape for p in pos_a] != [p.shape for p in pos_b]):
        raise AssertionError("the two frames made different queries")
    dev = calls_a[0]["origin"].device
    lines, untraced = [], 0
    here = torch.zeros(r0, dtype=torch.bool, device=dev)
    for level, (la, lb) in enumerate(zip(lv_a, lv_b)):
        r = pos_a[level].shape[0]
        # Slots whose parent has a traced difference.
        here = here[torch.arange(r, device=dev) % here.shape[0]]
        inherited = here.clone()
        for j, (ca, cb) in enumerate(zip(la, lb)):
            ta, tb = _tree_call(ca, pos_a[level]), _tree_call(cb, pos_b[level])
            ha, hb = ta["hit"], tb["hit"]
            if ca["any_hit"]:
                diff = ((ha.hit & (ha.t < ta["t_max"]))
                        != (hb.hit & (hb.t < tb["t_max"])))
            else:
                diff = (ha.hit != hb.hit) | (ha.hit & hb.hit
                                             & (ha.tri != hb.tri))
            explained = inherited if j == 0 else nearest
            live_a = torch.isfinite(ta["direction"]).all(-1)
            live_b = torch.isfinite(tb["direction"]).all(-1)
            alive = live_a != live_b
            rays = (diff & live_a & live_b & ~explained).nonzero()[:, 0]
            ok, tie, margin = _trace_calls(flat, ta, tb, rays, QUERY_EPS,
                                           QUERY_RTOL)
            here[rays[ok]] = True
            lone = alive & ~explained
            if j > 0:
                edge = lone & (torch.maximum(ta["edge"], tb["edge"])
                               <= QUERY_EPS)
                here |= edge
                lone &= ~edge
            flips, texel_flips = torch.zeros_like(here), 0
            if j == 0 and ta["texel"]:
                xa, xb = ta["texel"], tb["texel"]
                same = (live_a & live_b & ha.hit & hb.hit & ~diff
                        & ~explained & xa["use"] & xb["use"])
                flips = same & (xa["coord"].trunc() != xb["coord"].trunc()
                                ).any(-1)
                straddle = lambda k: (  # noqa: E731
                    ((xa[k] - xb[k]).abs() <= TEXEL_EPS)
                    & (xa[k].floor() != xb[k].floor()))
                across = ((xa["coord"].trunc() == xb["coord"].trunc())
                          | straddle("coord") | straddle("raw")).all(-1)
                texel_flips = int((flips & across).sum())
                here |= flips & across
                flips &= ~across
            if j == 0:
                nearest = here.clone()
            bad = int((~ok).sum() + lone.sum() + flips.sum())
            untraced += bad
            near = ok & (margin < QUERY_EPS)
            lines.append({
                "level": level, "query": j, "any_hit": ca["any_hit"],
                "differ": int(diff.sum()),
                "inherited": int((diff & explained).sum()),
                "traced": int(ok.sum()), "ties": int(tie.sum()),
                "live_in_one": int(alive.sum()),
                "texel_flips": texel_flips, "untraced": bad,
                "largest_margin": float(margin[near].max())
                if bool(near.any()) else 0.0})
            for k in (~ok).nonzero()[:5, 0].tolist():
                c = int(rays[k])
                print(f"    untraced: level {level} query {j} slot {c} "
                      f"(pixel {c % r0}) margin {float(margin[k]):.3e}, "
                      f"hit {bool(ha.hit[c])}/{bool(hb.hit[c])} tri "
                      f"{int(ha.tri[c])}/{int(hb.tri[c])} t "
                      f"{float(ha.t[c]):.7g}/{float(hb.t[c]):.7g}")
            for c in lone.nonzero()[:5, 0].tolist():
                print(f"    untraced: level {level} query {j} slot {c} "
                      f"(pixel {c % r0}) live in one frame only")
            for c in flips.nonzero()[:5, 0].tolist():
                print(f"    untraced: level {level} slot {c} (pixel "
                      f"{c % r0}) another texel, coordinates "
                      f"{ta['texel']['coord'][c].tolist()} / "
                      f"{tb['texel']['coord'][c].tolist()}")
    # The last level holds every slot's descendants: a pixel's tree has a
    # traced difference where one of its last-level slots inherited one.
    return here.reshape(-1, r0).any(0), lines, untraced


def phase_query(dev, card, flat128, rays, img128, record):
    """[query]: the flagship at full size through AUTO (the brute-force
    sweep) against the walk, at the 32 and 128 bakes; the bench frame's
    queries through the tiled and octree backends against the walk's hits;
    the bench frame with shadow clearance against the default frame."""
    import dataclasses

    from raytpu_torch import Intersector, Quantize, RenderConfig
    from raytpu_torch.accel import traverse
    from raytpu_torch.accel.traverse import nearest_hit, resolve_intersector
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.core.xna import quantize_color
    from raytpu_torch.render.wavefront import (_default_query,
                                               block_order_perm,
                                               render_image, trace_colors)

    out = {}
    camera = Camera(position=FLAGSHIP_CAMERA, aspect=1.0)
    cfg = RenderConfig(width=FLAGSHIP_RES, height=FLAGSHIP_RES,
                       max_reflections=FLAGSHIP_REFLECTIONS,
                       tile_pixels=FLAGSHIP_RES ** 2)
    wcfg = dataclasses.replace(cfg, intersector=Intersector.PALLAS)
    o, d = camera_rays(camera, FLAGSHIP_RES, FLAGSHIP_RES, device=dev)
    perm = block_order_perm(FLAGSHIP_RES, FLAGSHIP_RES,
                            max(1, int(cfg.cull_tile ** 0.5)), dev)
    print(f"[query] the flagship at {FLAGSHIP_RES}x{FLAGSHIP_RES}, "
          f"{FLAGSHIP_REFLECTIONS} bounces, through AUTO against the walk")
    for c in FLAGSHIP_SIZES:
        flat = flagship_scene().flatten(cluster_size=c, device=dev,
                                        build_octree=False)
        if resolve_intersector(flat, cfg.intersector) != Intersector.BRUTE:
            raise AssertionError("AUTO does not sweep the flagship")
        reset_launches()
        img = render_image(flat, cfg, camera)
        auto_launches = read_launches()
        if _ran(auto_launches):
            raise AssertionError(f"AUTO launched walks: {auto_launches}")
        # Frame times in turns (AUTO, walk, walk, AUTO).
        ms = {"auto": [], "walk": []}
        for k, q in (("auto", cfg), ("walk", wcfg), ("walk", wcfg),
                     ("auto", cfg)):
            ms[k].append(_cuda_ms(lambda: render_image(flat, q, camera), 2))
        walk_img = render_image(flat, wcfg, camera)
        auto_q, walk_q = _default_query(cfg), _default_query(wcfg)
        # The frames before the framebuffer's rounding (Quantize.FINAL
        # rounds each pixel once, after the combine).
        frame_a, frame_w = (_record_frame(
            flat, dataclasses.replace(q, quantize=Quantize.NONE), o[perm],
            d[perm], _default_query(q)) for q in (cfg, wcfg))
        for got, image in ((frame_a, img), (frame_w, walk_img)):
            if not torch.equal(quantize_color(got[0]),
                               image.reshape(-1, 3)[perm]):
                raise AssertionError("the recorded frame is not the image")
        # Each of AUTO's queries through the walk, on the same rays.
        calls = frame_a[1]
        n_diff = n_untraced = n_ties = 0
        t_err = 0.0
        for call in calls:
            kw = {k: call[k] for k in ("ignore_tri", "ignore_mesh", "t_max",
                                       "any_hit", "cull")}
            walk = walk_q(flat, call["origin"], call["direction"], **kw)
            n, u, ties, te = _against_walk(flat, call, call["hit"], walk)
            n_diff, n_untraced, n_ties = n_diff + n, n_untraced + u, \
                n_ties + ties
            t_err = max(t_err, te)
        # The two frames, slot by slot over their ray trees.
        caused, lines, tree_untraced = _trace_frames(flat, frame_a, frame_w)
        delta = (frame_a[0] - frame_w[0]).abs().amax(-1)
        beyond = delta > QUERY_PIXEL_TOL
        px, px_bad = int(beyond.sum()), int((beyond & ~caused).sum())
        # The images: beyond those pixels only the rounding of colours
        # within QUERY_PIXEL_TOL of each other, one step of 1/255 at most.
        steps = ((quantize_color(frame_a[0]) - quantize_color(frame_w[0]))
                 .abs().amax(-1) * 255).round()
        flips = ~beyond & (steps > 0)
        px_bad += int((flips & (steps > 1)).sum())
        brute_s = _once_ms(lambda: auto_q(
            flat, calls[0]["origin"], calls[0]["direction"],
            ignore_tri=calls[0]["ignore_tri"],
            ignore_mesh=calls[0]["ignore_mesh"]))[1] / 1e3
        print(f"  bake {c}: AUTO frame {statistics.mean(ms['auto']):.2f} ms "
              f"(the sweep, no walk launched), walk frame "
              f"{statistics.mean(ms['walk']):.2f} ms (turns AUTO "
              f"{[round(v, 3) for v in ms['auto']]}, walk "
              f"{[round(v, 3) for v in ms['walk']]}); the sweep's primary "
              f"query of {calls[0]['origin'].shape[0]} rays x "
              f"{flat.num_tris} triangles {brute_s:.3f} s; {len(calls)} "
              f"queries, the walk on AUTO's rays: rays whose hit or "
              f"triangle differs {n_diff} ({n_ties} exact-t ties, untraced "
              f"{n_untraced}), t err {t_err:.2e}")
        for line in lines:
            if line["differ"] or line["live_in_one"]:
                print(f"    frames, level {line['level']} query "
                      f"{line['query']}: {line}")
        print(f"    before rounding, pixels beyond {QUERY_PIXEL_TOL} {px} "
              f"(largest {float(delta.max()):.3g}), untraced {px_bad}; "
              f"untraced slots {tree_untraced}; the images differ in "
              f"{int((steps > 0).sum())} pixels (largest {int(steps.max())}"
              f"/255), {int(flips.sum())} of them rounding flips of "
              f"colours within {QUERY_PIXEL_TOL}")
        for k in (beyond & ~caused).nonzero()[:10, 0].tolist():
            print(f"    untraced pixel {k}: {float(delta[k]):.3g}")
            _print_tree(flat, frame_a, frame_w, k)
        if (n_untraced or t_err > QUERY_RTOL or tree_untraced or px_bad):
            raise AssertionError(f"the flagship at {c} through AUTO differs "
                                 "from the walk beyond traced rays")
        out[f"flagship_{c}"] = {"auto_turns_ms": ms["auto"],
                                "walk_turns_ms": ms["walk"],
                                "brute_primary_s": brute_s,
                                "differ": n_diff, "ties": n_ties,
                                "pixels": px, "rounding_flips":
                                int(flips.sum()), "frame_queries": lines}

    # The bench frame's queries through the tiled and octree backends.
    bcfg = RenderConfig(width=RES, height=RES, max_reflections=0,
                        tile_pixels=RES ** 2, quantize=Quantize.NONE)
    calls = []
    trace_colors(flat128, bcfg, *rays,
                 query=_recording_hook(calls, _default_query(bcfg)))
    for backend in ("tiled", "octree"):
        n_tris = QUERY_TRIS[backend]
        t0 = time.perf_counter()
        if backend == "octree" or n_tris != TRIS:
            scene = bench_scene(n_tris).flatten(
                cluster_size=CLUSTER_SIZE, device=dev,
                build_octree=backend == "octree")
        else:
            scene = flat128
        torch.cuda.synchronize()
        bake_s = time.perf_counter() - t0
        if scene is not flat128:
            bcalls = []
            trace_colors(scene, bcfg, *rays,
                         query=_recording_hook(bcalls, _default_query(bcfg)))
        else:
            bcalls = calls
        mode = Intersector[backend.upper()]
        lines = []
        for call in bcalls:
            kw = {k: call[k] for k in ("ignore_tri", "ignore_mesh", "t_max",
                                       "any_hit", "cull")}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = nearest_hit(scene, call["origin"], call["direction"],
                              intersector=mode, cull_tile=RAYS_PER_TILE, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            n, u, ties, te = _against_walk(scene, call, got, call["hit"])
            live = int(torch.isfinite(call["direction"]).all(-1).sum())
            line = {"any_hit": call["any_hit"], "s": secs, "rays": live,
                    "differ": n, "untraced": u, "ties": ties, "t_rel": te}
            if backend == "octree":
                line.update(traverse.OCTREE_STATS)
            lines.append(line)
            kind = "any-hit" if call["any_hit"] else "nearest"
            print(f"  bench {backend} ({scene.num_tris} triangles, baked in "
                  f"{bake_s:.1f} s), {kind} query of {live} live rays: "
                  f"{secs:.3f} s"
                  + (f" ({traverse.OCTREE_STATS['steps']} steps, "
                     f"{traverse.OCTREE_STATS['leaf_passes']} leaf passes, "
                     f"{traverse.OCTREE_STATS['host_reads']} host reads)"
                     if backend == "octree" else "")
                  + f"; against the walk: {n} rays differ ({ties} exact-t "
                  f"ties, untraced {u}), t err {te:.2e}")
            if u or te > QUERY_RTOL:
                raise AssertionError(f"the {backend} query differs from the "
                                     "walk beyond traced rays")
        out[backend] = {"tris": scene.num_tris, "bake_s": bake_s,
                        "queries": lines}

    # Shadow clearance on the bench frame.
    ccfg = dataclasses.replace(bcfg, shadow_clearance=True)
    reset_launches()
    img = trace_colors(flat128, ccfg, *rays)
    launches = read_launches()
    _require(launches, "nearest", "any_hit")
    ccalls = []
    trace_colors(flat128, ccfg, *rays,
                 query=_recording_hook(ccalls, _default_query(ccfg)))
    shadow = ccalls[1]
    light = flat128.lights["position"][0]
    shifted = int((shadow["origin"] != light).any(-1).sum())
    differ = (img != img128).any(-1)
    px = differ.nonzero()[:, 0]
    untraced = int((~_trace_calls(flat128, shadow, calls[1], px, QUERY_EPS,
                                  QUERY_RTOL)[0]).sum())
    ms = [_cuda_ms(lambda: trace_colors(flat128, c, *rays), REPS)
          for c in (bcfg, ccfg, ccfg, bcfg)]
    print(f"  bench frame with shadow_clearance=True: {shifted} of "
          f"{int(torch.isfinite(shadow['direction']).all(-1).sum())} lit "
          f"shadow rays start past the light; pixels that differ from the "
          f"default frame {int(px.shape[0])} (untraced {untraced}); frame ms "
          f"default / clearance in turns {[round(m, 3) for m in ms]}")
    if untraced:
        raise AssertionError("shadow clearance changed the bench frame")
    out["clearance"] = {"shifted": shifted, "pixels": int(px.shape[0]),
                        "turns_ms": ms}
    record.append({"what": "query", **out})
    print(card)
    return out


# The [cli] phase: the user-facing render path.
CLI_RES = 1024
CLI_QUALITY = 1
# Three quarters of the default tile: 768 quadrants a batch, so the
# supersampled bench frame's last batch ends in a padded tail of dead
# quadrants (the default's 1,024 divides 1024^2).
CLI_TILE_PIXELS = 12288
# Walk calls held against the plain walk: the first and last CLI_ENDS of a
# frame; of the bench frame every CLI_STRIDE-th (its batches launch four
# calls: levels 0 and 1, nearest and any-hit); of the demo frame every call
# of the batches a third and two thirds of the way down the frame (36 a
# batch: 2 levels x 9 bounces x 2 queries), whose rows cross its spheres;
# and of each frame the level-1 nearest and any-hit calls with the most
# live rays (level 1's live sub-pixel rays sit among dead quadrants).
CLI_ENDS = 4
CLI_STRIDE = 1499
CLI_DEMO_BATCHES = (1 / 3, 2 / 3)
CLI_PROFILED_BATCHES = {"bench": 4, "demo": 1}
CLI_ANIM_RES = 256
CLI_ANIM_FRAMES = 4
CLI_VIEW_RES = 256
CLI_FIT_RES = 64
ASSETS = Path(__file__).resolve().parent / "assets"


class _HeldCalls:
    """A ``recording_walks`` sink that holds the calls whose index is below
    ``ends`` or that ``keep`` takes, the last ``ends`` calls, and, of the
    calls of ``level1_rays`` rays (a supersampled batch's level 1), the
    nearest and the any-hit call with the most live rays: a frame of
    thousands of walk calls would otherwise hold every call's rays and
    outputs on the card.  Counting a level-1 call's live rays reads the
    card once a call."""

    def __init__(self, keep, level1_rays, ends=CLI_ENDS):
        import collections

        self.keep, self.level1_rays, self.ends, self.n = keep, level1_rays, \
            ends, 0
        self.held, self.last = {}, collections.deque(maxlen=ends)
        self.best = {}  # any_hit -> (live rays, index, call)

    def append(self, call):
        if self.n < self.ends or self.keep(self.n):
            self.held[self.n] = call
        self.last.append((self.n, call))
        q, any_hit = call[2], call[3]["any_hit"]
        if q.direction.shape[0] == self.level1_rays:
            live = int(torch.isfinite(q.direction).all(-1).sum())
            if live > self.best.get(any_hit, (0,))[0]:
                self.best[any_hit] = (live, self.n, call)
        self.n += 1

    def calls(self):
        """(indices, calls) held, in launch order."""
        best = {i: c for _, i, c in self.best.values()}
        held = {**self.held, **dict(self.last), **best}
        return sorted(held), [held[i] for i in sorted(held)]


@contextlib.contextmanager
def counting_corner_rays(dev):
    """The corner rays the supersampler traces alive, summed on the card."""
    from raytpu_torch.render import supersample

    trace = supersample.trace_colors
    count = torch.zeros((), dtype=torch.int64, device=dev)

    def counted(scene, cfg, origin, direction, alive=None, query=None):
        count.add_(alive.sum())
        return trace(scene, cfg, origin, direction, alive=alive, query=query)

    supersample.trace_colors = counted
    try:
        yield count
    finally:
        supersample.trace_colors = trace


@contextlib.contextmanager
def returned_images():
    """The images ``render_image`` returns inside (the CLI's frames)."""
    from raytpu_torch.render import wavefront

    render = wavefront.render_image
    images = []

    def capture(*args, **kw):
        images.append(render(*args, **kw))
        return images[-1]

    wavefront.render_image = capture
    try:
        yield images
    finally:
        wavefront.render_image = render


def _cli(argv, dev):
    """One CLI command in process, its standard output kept: (output, ms)
    by the host clock, synchronised."""
    from raytpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv], device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return buf.getvalue(), ms


def _avi(path):
    """A RIFF/AVI file's frame count, size and frame chunks."""
    import struct

    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise AssertionError(f"{path} is not an AVI file")
    i = data.index(b"avih") + 8
    total, w, h = (struct.unpack_from("<I", data, i + k)[0]
                   for k in (16, 32, 36))
    frames, j = [], data.index(b"movi") + 4
    while j < len(data) - 8:
        cc, size = data[j:j + 4], struct.unpack_from("<I", data, j + 4)[0]
        if cc == b"idx1":
            break
        if cc in (b"00db", b"00dc"):
            frames.append(data[j + 8:j + 8 + size])
        j += 8 + size + size % 2
    return total, (w, h), frames


def _dib_rgb(buf, w, h):
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(buf, np.uint8).reshape(h, stride)[:, :w * 3]
    return rows.reshape(h, w, 3)[::-1, :, ::-1]


def _held_walks(held, what, record):
    """Hold the walk calls that ``held`` kept against the plain walk, bit
    for bit with their counters; print which calls and how many of their
    rays were dead (NaN directions: dead quadrants, padding, dead lanes)."""
    if False not in held.best:
        raise AssertionError(f"{what}: no level-1 nearest call has a live "
                             "ray")
    level1 = {("any-hit" if k else "nearest"): {"call": i, "live_rays": live}
              for k, (live, i, _) in sorted(held.best.items())}
    idx, calls = held.calls()
    dead = [int((~torch.isfinite(c[2].direction).all(-1)).sum())
            for c in calls]
    live = [c[2].direction.shape[0] - d for c, d in zip(calls, dead)]
    print(f"  {what}: {held.n} walk calls; holding calls {idx} against the "
          f"plain walk (their live rays: {live}; dead rays: {dead}); the "
          f"level-1 calls with the most live rays: {level1}")
    rows = check_recorded(calls, what, record)
    return {"calls": held.n, "held": idx, "live_rays": live,
            "dead_rays": dead, "level1": level1,
            "max_abs_err": max(r["err"] for r in rows)}


def _busy(frame, what):
    """The device's busy share over one call of ``frame`` (torch.profiler),
    or None where the profiler records no device time."""
    p = _profile(frame, 1)
    share = p.get("busy_share")
    print(f"  {what}: device busy "
          + ("not measured" if share is None else f"{share:.1%}")
          + f", {p['host_syncs_per_frame']:.0f} host syncs")
    return share


def _batches(cfg, dev, count):
    """``count`` quadrant batches from the middle of a multisampled
    frame: (centers x, centers y, alive) each, as the frame cuts them."""
    tile = max(1, cfg.tile_pixels // (4 ** cfg.multisample_quality * 4))
    n = cfg.width * cfg.height
    start = (n // tile // 2) * tile
    idx = torch.arange(start, start + count * tile, device=dev)
    cx, cy = (idx % cfg.width).float(), (idx // cfg.width).float()
    return [(cx[s:s + tile], cy[s:s + tile], idx[s:s + tile] < n)
            for s in range(0, count * tile, tile)]


def _cli_args(scene, res, dev, **kw):
    """The CLI's parsed options (its defaults) for ``scene`` at ``res`` on
    ``dev``."""
    base = dict(scene=str(scene), width=res, height=res, max_reflections=8,
                multisample=0, intersector="auto", render_mode="shaded",
                reflect=0.5, transparent=False, obj_scale=1.0,
                camera=None, target=None, fov=None, device=dev)
    return argparse.Namespace(**{**base, **kw})


def phase_cli(dev, card, flat, out_dir, record):
    """The user-facing render path on the card: the supersampled bench
    frame, the CLI's demo render, its debug channels, an animation with
    ``--resume``, the viewer, a fit and a debug ray path."""
    import dataclasses

    from raytpu_torch import RenderConfig
    from raytpu_torch.cli import main as cli
    from raytpu_torch.cli.interactive import InteractiveSession
    from raytpu_torch.core.camera import Camera
    from raytpu_torch.io.image import read_image, to_uint8
    from raytpu_torch.render.debug import REFLECTION, cast_screen_ray
    from raytpu_torch.render.supersample import supersample_colors
    from raytpu_torch.render.wavefront import render_image

    out_dir = out_dir / "cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"[cli] {card}")
    result = {"card": card}

    # (a) The supersampled bench frame.
    cam = Camera(position=(0.0, 28.0, 34.0), target=(0.0, 0.0, 0.0),
                 aspect=1.0)
    cfg = RenderConfig(width=CLI_RES, height=CLI_RES, max_reflections=0,
                       use_multisampling=True, multisample_quality=CLI_QUALITY,
                       tile_pixels=CLI_TILE_PIXELS)
    held = _HeldCalls(lambda i: i % CLI_STRIDE == 0, CLI_TILE_PIXELS)
    reset_launches()
    with counting_corner_rays(dev) as rays, recording_walks(held):
        t0 = time.perf_counter()
        img = render_image(flat, cfg, cam)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    _require(launches, "nearest", "any_hit")
    live = int(rays)
    print(f"  supersampled bench frame ({card}): {CLI_RES}x{CLI_RES}, "
          f"quality {CLI_QUALITY}, {flat.num_tris} triangles: {ms:.1f} ms, "
          f"{live} live corner rays, {live / ms * 1e3:.4g} rays/s, walk "
          f"launches {_ran(launches)}")
    _check_image(img, "supersampled bench frame")
    single = render_image(flat, dataclasses.replace(cfg,
                                                    use_multisampling=False),
                          cam)
    med = float((img - single).abs().amax(-1).median())
    print(f"  against the single-sample frame: median pixel difference "
          f"{med:.4f}")
    if med > 0.08:
        raise AssertionError("the supersampled frame strays from the "
                             "single-sample frame")
    walks = _held_walks(held, "cli bench frame", record)
    busy = _busy(lambda: [supersample_colors(flat, cfg, cam, *b) for b in
                          _batches(cfg, dev, CLI_PROFILED_BATCHES["bench"])],
                 f"{CLI_PROFILED_BATCHES['bench']} of its batches")
    result["bench"] = {"ms": ms, "live_rays": live, "rays_per_s":
                       live / ms * 1e3, "launches": _ran(launches),
                       "busy_share": busy, **walks}

    # (b) The CLI on the demo scene: supersampled, eight reflections.
    demo_png = out_dir / "demo.png"
    per_batch = (CLI_QUALITY + 1) * (8 + 1) * 2
    batches = -(-CLI_RES ** 2 // (RenderConfig().tile_pixels
                                  // (4 ** CLI_QUALITY * 4)))
    kept = {int(f * batches) for f in CLI_DEMO_BATCHES}
    held = _HeldCalls(lambda i: i // per_batch in kept,
                      RenderConfig().tile_pixels)
    reset_launches()
    with counting_corner_rays(dev) as rays, recording_walks(held), \
            returned_images() as images:
        _, ms = _cli(["render", "--scene", ASSETS / "demo.toml", "--width",
                      CLI_RES, "--height", CLI_RES, "--multisample",
                      CLI_QUALITY, "--out", demo_png], dev)
    launches = read_launches()
    _require(launches, "nearest", "any_hit")
    live = int(rays)
    (img,) = images
    print(f"  cli render of assets/demo.toml ({card}): {CLI_RES}x{CLI_RES}, "
          f"--multisample {CLI_QUALITY}, 8 reflections: {ms:.1f} ms, {live} "
          f"live corner rays, {live / ms * 1e3:.4g} rays/s, walk launches "
          f"{_ran(launches)}")
    if not np.array_equal(read_image(str(demo_png)), to_uint8(img)):
        raise AssertionError("the demo PNG does not read back as the image")
    walks = _held_walks(held, "cli demo frame", record)
    dargs = _cli_args(ASSETS / "demo.toml", CLI_RES, dev,
                      multisample=CLI_QUALITY)
    scene, scene_cam = cli._load_scene(dargs)
    demo = cli._flatten(scene, dargs)
    dcfg = cli._config(dargs)
    dcam = cli._camera(dargs, 1.0, scene_cam)
    busy = _busy(lambda: [supersample_colors(demo, dcfg, dcam, *b) for b in
                          _batches(dcfg, dev, CLI_PROFILED_BATCHES["demo"])],
                 f"{CLI_PROFILED_BATCHES['demo']} of its batches")
    result["demo"] = {"ms": ms, "live_rays": live, "rays_per_s":
                      live / ms * 1e3, "launches": _ran(launches),
                      "busy_share": busy, **walks}

    # (c) The debug channels: one primary query each.
    for mode in ("normals", "convex"):
        png = out_dir / f"demo_{mode}.png"
        reset_launches()
        _, ms = _cli(["render", "--scene", ASSETS / "demo.toml", "--width",
                      CLI_RES, "--height", CLI_RES, "--render-mode", mode,
                      "--out", png], dev)
        launches = read_launches()
        _require(launches, "nearest", absent=("any_hit",))
        px = read_image(str(png)).reshape(-1, 3)
        if mode == "convex":
            allowed = {(0, 0, 0), (0, 128, 0), (255, 0, 0)}
            seen = {tuple(int(v) for v in c) for c in np.unique(px, axis=0)}
            if not (seen <= allowed and len(seen) == 3):
                raise AssertionError(f"convex channel colors {seen}")
        elif not px.any():
            raise AssertionError("the normals channel is black")
        print(f"  cli render --render-mode {mode} ({card}): {ms:.1f} ms, "
              f"walk launches {_ran(launches)}")
        result[mode] = {"ms": ms, "launches": _ran(launches)}

    # (d) animate into AVI files, read back, then --resume.
    avi, frames_dir = out_dir / "turn.avi", out_dir / "turn_frames"
    anim = ["animate", "--scene", ASSETS / "demo.toml", "--width",
            CLI_ANIM_RES, "--height", CLI_ANIM_RES, "--frames",
            CLI_ANIM_FRAMES, "--codec", "DIB ", "--out", avi]
    reset_launches()
    text, ms = _cli(anim, dev)
    launches = read_launches()
    writer = text.rsplit(", ", 1)[-1].split(")")[0]
    total, wh, chunks = _avi(avi)
    first = read_image(str(frames_dir / "frame_0000.png"))
    if (total, wh, len(chunks)) != (CLI_ANIM_FRAMES, (CLI_ANIM_RES,) * 2,
                                    CLI_ANIM_FRAMES) or not np.array_equal(
            _dib_rgb(chunks[0], *wh), first):
        raise AssertionError("the DIB AVI does not read back")
    print(f"  cli animate ({card}): {CLI_ANIM_FRAMES} frames at "
          f"{CLI_ANIM_RES}x{CLI_ANIM_RES} into a DIB AVI by {writer} in "
          f"{ms:.1f} ms, walk launches {_ran(launches)}; read back: {total} "
          "frames, frame 0 is its PNG")
    result["animate"] = {"ms": ms, "launches": _ran(launches),
                         "writer": writer}
    try:
        from PIL import Image
    except ImportError:
        print("  MJPG: Pillow does not import here, so no JPEG frames")
    else:
        reset_launches()
        mjpg = out_dir / "turn_mjpg.avi"
        _cli(anim[:-4] + ["--codec", "MJPG", "--out", mjpg, "--frame-dir",
                          frames_dir, "--resume"], dev)
        total, _, chunks = _avi(mjpg)
        with Image.open(io.BytesIO(chunks[0])) as jpeg:
            dec = np.asarray(jpeg.convert("RGB"))
        err = float(np.abs(dec.astype(int) - first.astype(int)).mean())
        if total != CLI_ANIM_FRAMES or err > 8.0 or any(read_launches()
                                                       .values()):
            raise AssertionError("the MJPG AVI does not read back")
        print(f"  MJPG from the same frames (all resumed): {total} frames, "
              f"frame 0 within {err:.2f} of its PNG on average")
    keep = (frames_dir / "frame_0002.png").read_bytes()
    (frames_dir / "frame_0002.png").unlink()
    before = avi.read_bytes()
    with returned_images() as images:
        _cli(anim + ["--resume"], dev)
    if len(images) != 1 or avi.read_bytes() != before or (
            frames_dir / "frame_0002.png").read_bytes() != keep:
        raise AssertionError("--resume did not re-render just the missing "
                             "frame into the same AVI")
    print("  --resume with frame 2's PNG deleted: one frame rendered, the "
          "same AVI bytes")

    # (e) A fit, a debug ray path and the viewer.
    text, ms = _cli(["fit", "--scene", ASSETS / "crate.toml", "--width",
                     CLI_FIT_RES, "--height", CLI_FIT_RES, "--steps", 2,
                     "--out", out_dir / "fit"], dev)
    losses = [float(x) for x in
              text.split("loss ")[1].split(" (")[0].split(" -> ")]
    if not (all(map(math.isfinite, losses))
            and (out_dir / "fit" / "final.png").exists()):
        raise AssertionError(f"fit: {text}")
    print(f"  cli fit --steps 2 on assets/crate.toml at {CLI_FIT_RES}x"
          f"{CLI_FIT_RES}: loss {losses[0]:.6f} -> {losses[1]:.6f}, "
          f"{ms:.1f} ms ({card})")
    # The center pixel (as the reference's ticker casts), and the middle
    # pixel of the front right sphere on the frame's center row (the camera
    # looks through the front spheres' centers' height): a lit point of a
    # reflective sphere, so its path holds a reflection segment.
    cpu_demo = scene.flatten(device="cpu", build_octree=False)
    row = CLI_RES // 2
    gx = np.nonzero((read_image(str(out_dir / "demo_convex.png"))[row]
                     == (0, 128, 0)).all(-1))[0]
    gx = gx[gx > CLI_RES // 2]
    if not gx.size:
        raise AssertionError("no sphere on the convex channel's center row")
    sphere = (float(gx[gx.size // 2]), float(row))
    for px, py in ((None, None), sphere):
        got = cast_screen_ray(demo, dcfg, dcam, px, py)
        ref = cast_screen_ray(cpu_demo, dcfg, dcam, px, py)
        if px is not None and not (len(got.ray) > 1
                                   and (got.kind == REFLECTION).any()):
            raise AssertionError(f"the sphere pixel {sphere} spawns no "
                                 f"reflection: kinds {got.kind}")
        same = all(np.array_equal(getattr(got, f), getattr(ref, f))
                   for f in ("ray", "level", "kind", "hit", "tri"))
        err = max(float(np.abs(getattr(got, f) - getattr(ref, f)).max())
                  for f in ("start", "end"))
        print(f"  cast_screen_ray at pixel "
              f"{'center' if px is None else (px, py)} of the demo: "
              f"{len(got.ray)} segments (kinds {got.kind.tolist()}, hits "
              f"{got.hit.tolist()}), card against the CPU: ids, kinds "
              f"and hits {'equal' if same else 'DIFFER'}, points within "
              f"{err:.2e}")
        if not same or err > 1e-3:
            raise AssertionError("cast_screen_ray differs between card and "
                                 "CPU")
    # The viewer last: its spin turns the demo's first object.
    vargs = _cli_args(ASSETS / "demo.toml", CLI_VIEW_RES, dev)
    sess = InteractiveSession(demo, cli._config(vargs), host_scene=scene,
                              flatten_kwargs=cli._flatten_kwargs(vargs))
    t0 = time.perf_counter()
    shown = [sess.current_image()]
    if sess.handle_key("\r") != "trace":
        raise AssertionError("Enter does not trace")
    shown.append(sess.render_full())
    if sess.handle_key("j") != "move":
        raise AssertionError("j does not spin the first object")
    shown.append(sess.current_image())
    torch.cuda.synchronize()
    if any(not s.any() for s in shown) or shown[1].shape != (
            CLI_VIEW_RES, CLI_VIEW_RES, 3):
        raise AssertionError("the viewer shows a black frame")
    print(f"  view, scripted: preview, Enter ({CLI_VIEW_RES}x{CLI_VIEW_RES}), "
          f"a spin that re-bakes, preview: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({card})")
    record.append({"what": "cli", **result})
    return result


# The [dist] phase: the sharded entry points on one card, at 4 shards (a
# mesh of four entries of one device; 3 shards for a ragged ring).
DIST_ENTRIES = 4
DIST_RING_SHARDS = (4, 3)
DIST_FIT_RES = 512


def _ms(fn):
    """(fn(), ms) by the host clock around a synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _ring_hits(got, want, any_hit, what):
    """A ring query's merged hits against the whole scene's query on the
    same rays: the same hit flags and, nearest, t bit for bit on every
    hit; returns the rays whose winner differs (exact-t ties, which the
    ring gives the shard visited first)."""
    same = torch.equal(got.hit, want.hit)
    if not any_hit:
        same = same and _bits_equal(got.t[want.hit], want.t[want.hit])
    if not same:
        raise AssertionError(f"{what}: the ring's hits are not the whole "
                             "scene's")
    if any_hit:
        return torch.zeros_like(got.hit)
    return want.hit & (got.tri != want.tri)


def _tie_query(ring, whole, scene, stats, resolve):
    """A render query through ``ring`` that also runs ``whole`` (the
    replicated render's query) on ``scene`` with the same inputs, holds
    the ring's hits to it (``_ring_hits``) and counts the exact-t ties;
    ``resolve``: the ties take the whole query's winner (same t), so the
    frame must be the replicated frame bit for bit."""

    from raytpu_torch.accel.traverse import Hit

    def query(s, origin, direction, **kw):
        got = ring(s, origin, direction, **kw)
        want = whole(scene, origin, direction, **kw)
        any_hit = kw.get("any_hit", False)
        ties = _ring_hits(got, want, any_hit, "ring render query")
        stats["queries"] += 1
        stats["ties"] += int(ties.sum())
        if resolve and bool(ties.any()):
            got = Hit(*(torch.where(ties, w, g) for g, w in zip(got, want)))
        return got

    return query


def _ring_frame(flat, cfg, camera, mesh, tables, what, img_rep, record,
                least=0.5, kinds=("nearest", "any_hit")):
    """The ring-sharded frame of ``flat`` (stripped of its per-triangle
    tables, rendered from the prebuilt ``tables``: shards, shade and
    texture shards) against the replicated frame ``img_rep``: its ms and
    launches, then the same render with every ring query held to the
    replicated query on its inputs (hits, t bit for bit, exact-t ties
    counted) and, where there are ties, with the ties given the replicated
    query's winners, which must be the replicated frame bit for bit.
    ``least``: the frame's least nonblack share; ``kinds``: the walk
    kernels the frame must launch."""
    from raytpu_torch.dist import bigscene as big
    from raytpu_torch.render.wavefront import (_default_query,
                                               block_order_perm,
                                               trace_colors)
    from raytpu_torch.core.camera import camera_rays

    shards, shade, tex = tables
    stripped = big.strip_for_ring(flat)
    def render():
        return big.render_image_ring(stripped, cfg, camera, mesh,
                                     shards=shards, shade=shade,
                                     texshards=tex)

    reset_launches()
    img = render()
    launches = read_launches()
    ms = statistics.mean(_ms(render)[1] for _ in range(REPS))
    _require(launches, *kinds)
    _check_image(img, what, least)
    o, d = camera_rays(camera, cfg.width, cfg.height, device=flat.device)
    perm = block_order_perm(cfg.width, cfg.height,
                            max(1, int(cfg.cull_tile ** 0.5)), flat.device)
    ring, gather = big.make_ring_backends(shards, shade, mesh,
                                          tile_size=cfg.cull_tile)
    fetch = (None if tex is None else
             big.make_texel_fetch_ring(tex, mesh))

    def frame(query):
        colors = trace_colors(stripped, cfg, o[perm], d[perm], query=query,
                              gather=gather, texel_fetch=fetch)
        out = torch.zeros_like(colors)
        out[perm] = colors
        return out.reshape(cfg.height, cfg.width, 3)

    stats = {"queries": 0, "ties": 0}
    held = frame(_tie_query(ring, _default_query(cfg), flat, stats, False))
    if not torch.equal(held, img):
        raise AssertionError(f"{what}: two ring frames differ")
    differ = int((img != img_rep).any(-1).sum())
    if stats["ties"]:
        resolved = frame(_tie_query(ring, _default_query(cfg), flat,
                                    dict(stats), True))
        if not torch.equal(resolved, img_rep):
            raise AssertionError(f"{what}: with its ties resolved the ring "
                                 "frame is not the replicated frame")
    elif differ:
        raise AssertionError(f"{what}: {differ} pixels differ from the "
                             "replicated frame without an exact-t tie")
    print(f"  {what}: {ms:.1f} ms, launches {_ran(launches)}; "
          f"{stats['queries']} ring queries held to the replicated "
          f"query (hits, t bit for bit), {stats['ties']} exact-t ties, "
          f"{differ} pixels differ from the replicated frame"
          + (", the ties resolved it is that frame bit for bit"
             if stats["ties"] else ", none"))
    rec = {"what": what, "ms": ms, "launches": _ran(launches),
           "queries": stats["queries"], "ties": stats["ties"],
           "pixels_differ": differ}
    record.append(rec)
    return rec, launches


def phase_dist(dev, card, flat, rays, img, out_dir, record):
    """The port's distribution on one card, the shards sharing it: the
    ray-sharded bench frame (1-D mesh of 4 and 2x2), ring queries at 4 and
    3 shards on the frame's primary and shadow queries with every hop's
    walk call held to the plain walk, a ring over the flagship's 3 blocks
    at 4 shards, the ring-sharded bench and flagship frames, the sharded
    and ring fit steps, elastic re-dispatch and the CLI's refusal of more
    devices than there are."""
    import dataclasses

    from raytpu_torch import Intersector, Quantize, RenderConfig
    from raytpu_torch.core.camera import Camera, camera_rays
    from raytpu_torch.diff.fit import make_fit_step
    from raytpu_torch.diff.params import GEOMETRY, extract_params
    from raytpu_torch.dist import bigscene as big
    from raytpu_torch.dist.elastic import render_units
    from raytpu_torch.dist.mesh import make_mesh, replicate_scene
    from raytpu_torch.dist.render import render_image_sharded
    from raytpu_torch.kernels.fused import nearest_hit_fused
    from raytpu_torch.render.wavefront import (_default_query, render_image,
                                               render_rays, trace_colors)

    print(f"[dist] {card}; {DIST_ENTRIES} mesh entries of {dev}: the "
          "shards share one card, so these times measure no "
          "communication between cards")
    n = DIST_ENTRIES
    r = RES * RES
    camera = Camera(position=(0.0, 28.0, 34.0), target=(0.0, 0.0, 0.0),
                    aspect=1.0)
    mesh = make_mesh([dev] * n)
    out = {}

    # (a) The ray-sharded frame: a shard is one tile of a quarter frame.
    cfg = RenderConfig(width=RES, height=RES, max_reflections=0,
                       tile_pixels=r // n, quantize=Quantize.NONE)
    ref = render_image(flat, cfg, camera)
    ref_ms = statistics.mean(
        _ms(lambda: render_image(flat, cfg, camera))[1] for _ in range(REPS))
    rep = replicate_scene(flat, mesh)
    for label, m in (("1-D mesh of 4", mesh),
                     ("2x2 mesh", make_mesh([dev] * n, axes=("hosts",
                                                             "chips"),
                                            shape=(2, 2)))):
        got = render_image_sharded(rep, cfg, camera, m)
        ms = statistics.mean(
            _ms(lambda m=m: render_image_sharded(rep, cfg, camera, m))[1]
            for _ in range(REPS))
        same = torch.equal(got, ref)
        print(f"  render_image_sharded, {label}: {ms:.1f} ms (render_image"
              f" {ref_ms:.1f} ms), the same image bit for bit: {same}")
        if not same:
            raise AssertionError(f"the sharded frame ({label}) differs")
        out[f"sharded {label} ms"] = ms
    out["render_image ms"] = ref_ms

    # (b) Ring queries: the frame's primary and shadow queries.
    qcfg = dataclasses.replace(cfg, tile_pixels=r)
    calls = []
    trace_colors(flat, qcfg, *rays,
                 query=_recording_hook(calls, _default_query(qcfg)))
    shards = {k: big.shard_scene_clusters(flat, make_mesh([dev] * k))
              for k in DIST_RING_SHARDS}
    rows = {}
    for k in DIST_RING_SHARDS:
        kmesh = make_mesh([dev] * k)
        for call in calls:
            kind = "any_hit" if call["any_hit"] else "nearest"
            def ring(k=k, kmesh=kmesh, call=call):
                return big.nearest_hit_ring(
                    shards[k], call["origin"], call["direction"], kmesh,
                    ignore_tri=call["ignore_tri"],
                    ignore_mesh=call["ignore_mesh"], cull=call["cull"],
                    tile_size=RAYS_PER_TILE, t_max=call["t_max"],
                    any_hit=call["any_hit"])

            with recording_walks() as walks:
                got = ring()
            ms = statistics.mean(_ms(ring)[1] for _ in range(REPS))
            # k hops, each walking every entry's visiting block.
            if len(walks) != k * k:
                raise AssertionError(f"{len(walks)} walk calls for a ring "
                                     f"of {k}")
            ties = _ring_hits(got, call["hit"], call["any_hit"],
                              f"ring of {k}, {kind}")
            print(f"  ring of {k} shards, {kind} (cull {call['cull']}): "
                  f"{ms:.1f} ms, {int(got.hit.sum())} hits, the whole "
                  f"scene's; exact-t ties across shards: {int(ties.sum())}")
            checked = check_recorded(walks, f"ring of {k} {kind} hop",
                                     record, INSTANCED_TILE_STRIDE,
                                     INSTANCED_LONGEST)
            record.append({"what": f"ring of {k}, {kind}", "ms": ms,
                           "ties": int(ties.sum())})
            if k == n:
                for row in checked:
                    row["kernel_ms"] = _kernel_ms(row, REPS)
                rows[kind] = checked
    # A ring over the flagship's 3 blocks at 4 shards: one shard is all
    # padding.
    small = flagship_scene().flatten(cluster_size=128, device=dev)
    nblocks = small.clusters["block"].shape[0]
    if nblocks >= n:
        raise AssertionError(f"the small bake has {nblocks} blocks")
    o, d = camera_rays(Camera(position=FLAGSHIP_CAMERA, aspect=1.0), 256,
                       256, device=dev)
    sshards = big.shard_scene_clusters(small, mesh)
    for any_hit, cull in ((False, True), (True, "reverse")):
        want = nearest_hit_fused(small, o, d, any_hit=any_hit, cull=cull)
        with recording_walks() as walks:
            got = big.nearest_hit_ring(sshards, o, d, mesh, cull=cull,
                                       any_hit=any_hit)
        ties = _ring_hits(got, want, any_hit, "ring over 3 blocks")
        check_recorded(walks, "ring over 3 blocks", record)
        kind = "any-hit" if any_hit else "nearest"
        print(f"  ring of {n} over {nblocks} blocks ({kind}): "
              f"{int(got.hit.sum())} hits, the whole walk's; exact-t ties "
              f"{int(ties.sum())}")

    # (c) Ring-sharded frames against the replicated ones.
    rcfg = dataclasses.replace(cfg, tile_pixels=r)
    ring_rec, launches = _ring_frame(
        flat, rcfg, camera, mesh,
        (shards[n], big.shard_scene_shade(flat, mesh), None),
        "ring-sharded bench frame", render_image(flat, rcfg, camera), record)
    out["ring bench frame"] = ring_rec
    fcfg = RenderConfig(width=FLAGSHIP_RES, height=FLAGSHIP_RES,
                        max_reflections=FLAGSHIP_REFLECTIONS,
                        tile_pixels=FLAGSHIP_RES ** 2,
                        intersector=Intersector.PALLAS)
    fcam = Camera(position=FLAGSHIP_CAMERA, aspect=1.0)
    out["ring flagship"], _ = _ring_frame(
        small, fcfg, fcam, mesh,
        (sshards, big.shard_scene_shade(small, mesh),
         big.shard_scene_textures(small, mesh)),
        "ring-sharded flagship (textured, transparent, 3 bounces)",
        render_image(small, fcfg, fcam), record, least=0.3,
        kinds=("nearest",))

    # (d) The sharded and ring fit steps against the unsharded step.  The
    # ring's exact-t ties move a gradient to another triangle of the same
    # t, so its step is held with its ties given the unsharded query's
    # winners (counted), after a plain timed step.
    gcfg = RenderConfig(width=DIST_FIT_RES, height=DIST_FIT_RES,
                        max_reflections=0, tile_pixels=DIST_FIT_RES ** 2 // n,
                        quantize=Quantize.NONE)
    fo, fd = _frame_rays(DIST_FIT_RES, dev)
    target = torch.full((DIST_FIT_RES ** 2, 3), 0.5, device=dev)
    grads, losses, times = {}, {}, {}
    ties = {"queries": 0, "ties": 0}
    for label in ("unsharded", "sharded", "ring"):
        if label == "ring":
            params = big.extract_ring_params(flat, mesh)
            opt = torch.optim.SGD([x for f in sorted(params)
                                   for x in params[f]], lr=0.0)
            step = big.make_ring_fit_step(
                big.strip_for_ring(flat), gcfg, mesh, opt,
                shards=shards[n], shade=big.shard_scene_shade(flat, mesh))
        else:
            params = extract_params(flat, GEOMETRY)
            opt = torch.optim.SGD(list(params.values()), lr=0.0)
            step = make_fit_step(flat, gcfg, opt, fields=GEOMETRY,
                                 mesh=mesh if label == "sharded" else None)
        loss = step(params, fo, fd, target)
        times[label] = statistics.mean(
            _ms(lambda: step(params, fo, fd, target))[1]
            for _ in range(FIT_STEPS))
        if label == "ring":
            make = big.make_ring_backends

            def resolving(*a, **kw):
                query, gather = make(*a, **kw)
                return _tie_query(query, _default_query(gcfg), flat, ties,
                                  True), gather

            big.make_ring_backends = resolving
            try:
                loss = step(params, fo, fd, target)
            finally:
                big.make_ring_backends = make
        losses[label] = float(loss)
        grads[label] = {f: (torch.cat([x.grad for x in params[f]])
                            [:flat.tri_shade.shape[0]] if label == "ring"
                            else params[f].grad) for f in GEOMETRY}
    print(f"  ring fit step: {ties['queries']} ring queries held to the "
          f"unsharded query, {ties['ties']} exact-t ties given its winners")
    for label in ("sharded", "ring"):
        excess = max(_grads_close(grads[label][f],
                                  grads["unsharded"][f].cpu())
                     for f in GEOMETRY)
        lclose = math.isclose(losses[label], losses["unsharded"],
                              rel_tol=FIT_RTOL)
        finite = all(bool(torch.isfinite(g).all())
                     for g in grads[label].values())
        print(f"  {label} fit step at {DIST_FIT_RES}x{DIST_FIT_RES}, "
              f"{n} shards: {times[label]:.1f} ms (unsharded "
              f"{times['unsharded']:.1f} ms), loss {losses[label]:.7g} / "
              f"{losses['unsharded']:.7g}, gradients within rtol {FIT_RTOL}"
              f" + atol {FIT_ATOL} x max|g|: {excess <= 0}")
        if not (finite and lclose and excess <= 0):
            raise AssertionError(f"the {label} fit step differs from the "
                                 "unsharded one")
        out[f"{label} fit step ms"] = times[label]
    out["unsharded fit step ms"] = times["unsharded"]
    out["ring fit ties"] = ties["ties"]

    # (e) Elastic re-dispatch of the frame's quarters, one failing once.
    ecfg = dataclasses.replace(qcfg, tile_pixels=r // n)

    def quarter(q):
        s = slice(q * r // n, (q + 1) * r // n)
        return render_rays(flat, ecfg, rays[0][s], rays[1][s])

    res, ms = _ms(lambda: render_units(
        range(n), quarter, backoff_s=0.0,
        inject_failure=lambda i, a: i == 2 and a == 1))
    if not (all(x.ok for x in res) and res[2].attempts == 2
            and torch.equal(torch.cat([x.result for x in res]), img)):
        raise AssertionError("the re-dispatched quarters are not the frame")
    print(f"  render_units over {n} quarters, quarter 2 failing once: "
          f"{ms:.1f} ms, attempts {[x.attempts for x in res]}, the frame "
          "bit for bit")

    # (f) The CLI on one card: more devices than there are is refused.
    if torch.cuda.device_count() == 1:
        try:
            _cli(["render", "--devices", "2", "--width", "8", "--height",
                  "8", "--out", out_dir / "devices2.png"], dev)
        except SystemExit as e:
            print(f"  cli render --devices 2: {e}")
            if "only 1 devices available" not in str(e):
                raise AssertionError("--devices 2: not the refusal")
        else:
            raise AssertionError("--devices 2 rendered on one card")
    return out, rows, launches


def _kernel_entry(name, replaces, launches, err, rows,
                  source="raytpu_torch/kernels/csrc/walk.cu"):
    """One kernel's line: times, bound, the bound's share of the time and
    trips, summed or averaged over the walk calls ``rows`` it was measured
    on."""
    iters = torch.cat([r["iters"].float() for r in rows])
    n = len(rows)
    bound_by = {r["bound_by"] for r in rows}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": sum(r["kernel_ms"] for r in rows) / n,
            "plain_ms": statistics.mean(r["plain_ms"] for r in rows
                                        if r["plain_ms"] is not None),
            "bound_ms": sum(r["bound_ms"] for r in rows) / n,
            "bound_share": sum(r["bound_ms"] for r in rows)
            / sum(r["kernel_ms"] for r in rows),
            "bound_by": bound_by.pop() if len(bound_by) == 1 else "operations",
            **({"bound_unit": rows[0]["bound_unit"]}
               if "bound_unit" in rows[0] else {}),
            "library_ms": None,
            "trips": {"mean": float(iters.mean()), "max": int(iters.max())},
            "calls": n}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path,
                        default=Path(__file__).resolve().parent / "build"
                        / "chip_smoke")
    args = parser.parse_args()

    started = time.perf_counter()
    last = [started]

    def clock(phase):
        now = time.perf_counter()
        print(f"[clock] {phase} {now - last[0]:.0f} s, total "
              f"{now - started:.0f} s")
        last[0] = now

    card = phase_device()
    args.out.mkdir(parents=True, exist_ok=True)
    record = []
    build_s = phase_build(args.out)
    clock("build")
    dev = torch.device("cuda")
    small_err = phase_small(dev, record)
    clock("small")
    flat, cfg, rays, img, frame_rows, launches = phase_frame(dev, record)
    clock("frame")
    mxu = phase_mxu(dev, card, img, record)
    clock("mxu")
    query = phase_query(dev, card, flat, rays, img, record)
    clock("query")
    iscene, icfg, camera, inst_rows, inst_launches, live_rays, inst_img = \
        phase_instanced(dev, record)
    clock("instanced")
    sub = phase_subcluster_frames(dev, flat, cfg, rays, img, frame_rows,
                                  record)
    clock("subcluster frames")
    flagship = phase_flagship(dev, card, record)
    clock("flagship")
    inst32 = phase_instanced32(dev, (iscene, icfg, camera, inst_img), record)
    clock("instanced 32")
    pcfg, pre_rows, pre_launches = phase_pretest_frame(
        flat, cfg, rays, img, frame_rows, record)
    overflow = phase_overflow(flat, cfg, rays, img, record)
    clock("pretest and overflow frames")
    phase_fit(dev, card, flat, record)
    clock("fit")
    phase_times(card, flat, cfg, pcfg, rays, frame_rows, pre_rows,
                (iscene, icfg, camera, inst_rows, live_rays), overflow,
                record)
    clock("times")
    phase_sub_times(card, flat, cfg, rays, sub, record)
    clock("subcluster times")
    phase_profile(card, flat, cfg, rays, (iscene, icfg, camera),
                  flagship["render"], record)
    clock("profile")
    cli = phase_cli(dev, card, flat, args.out, record)
    clock("cli")
    dist, dist_rows, dist_launches = phase_dist(dev, card, flat, rays, img,
                                                args.out, record)
    clock("dist")

    def rows_of(rows, any_hit, pretest):
        return [r for r in rows if r["kw"]["any_hit"] == any_hit
                and r["kw"].get("pretest", False) == pretest]

    def err_of(name, *row_sets):
        return max([small_err.get(name, 0.0)]
                   + [r["err"] for rows in row_sets for r in rows])

    def bounded_rows(label, any_hit):
        return [r for r in overflow[label]["rows"]
                if r["kw"]["any_hit"] == any_hit and _bounded(r["kw"])]

    def bounded_err(any_hit, label, **kind):
        names = [n for n in small_err if n.startswith(
            "any_hit" if any_hit else "nearest") and n.endswith(
                "_prepick" if "picks" in kind else "_budget")]
        return max([small_err[n] for n in names]
                   + [r["err"] for r in bounded_rows(label, any_hit)])

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
                      rows_of(pre_rows, False, True)),
        _kernel_entry(f"walk_kernel<any_hit, pretest> recull_every={RECULL}",
                      variant, pre_launches["any_hit_pretest"],
                      err_of("any_hit_pretest", rows_of(pre_rows, True, True)),
                      rows_of(pre_rows, True, True)),
    ]
    # The two new walks, from their own paths' runs: 64 picks, and phase 1
    # on an 8-trip budget.
    prepick, budget = "cull_prepick=64", "cull_phase1=8"
    for any_hit in (False, True):
        kind = "any_hit" if any_hit else "nearest"
        kernels.append(_kernel_entry(
            f"prepick_kernel<{kind}> picks=64",
            "raytpu/kernels/fused.py:732 (_prepick_kernel; rescue :1790)",
            overflow[prepick]["launches"][f"{kind}_prepick"],
            bounded_err(any_hit, prepick, picks=True),
            bounded_rows(prepick, any_hit)))
    for any_hit in (False, True):
        kind = "any_hit" if any_hit else "nearest"
        kernels.append(_kernel_entry(
            f"walk_kernel<{kind}> max_trips=8",
            "raytpu/kernels/fused.py:690 (max_trips; phase-1 compaction :1823)",
            overflow[budget]["launches"][f"{kind}_budget"],
            bounded_err(any_hit, budget), bounded_rows(budget, any_hit)))
    # This slice's walks: the subcluster walk (SUBK 4 and 2) from the 32 and
    # 64 bench frames, its gate from the gated 32 frame, and more than one
    # pick a trip from the chunked frames (cull_chunk 4 at 32 through the
    # subcluster walk, 2 at 128 through the classic walk's group kernel).
    tlane = "raytpu/kernels/fused.py:1026-1229 (_tlane_kernel, subk > 1)"
    group = "raytpu_torch/kernels/csrc/subwalk.cu"
    for any_hit in (False, True):
        kind = "any_hit" if any_hit else "nearest"
        pick = lambda rows: [r for r in rows  # noqa: E731
                             if r["kw"]["any_hit"] == any_hit]
        for c in SUB_FRAME_SIZES:
            rows = pick(sub[c]["rows"])
            kernels.append(_kernel_entry(
                f"subwalk_kernel<{kind}> SUBK={128 // c}", tlane,
                sub[c]["launches"][f"{kind}_sub"],
                err_of(f"{kind}_sub", rows), rows, group))
        s32 = sub[SUB_FRAME_SIZES[-1]]
        rows = pick(s32["variants"]["gate"])
        kernels.append(_kernel_entry(
            f"subwalk_kernel<{kind}> SUBK=4 gate",
            "raytpu/kernels/fused.py:1140-1152, :1211-1219 (_tlane_kernel "
            "gate)", s32["gate_launches"][f"{kind}_sub_gate"],
            err_of(f"{kind}_sub_gate", rows), rows, group))
        rows = pick(s32["variants"][f"chunk_k={CHUNK_SUB}"])
        kernels.append(_kernel_entry(
            f"subwalk_kernel<{kind}> SUBK=4 chunk_k={CHUNK_SUB}",
            "raytpu/kernels/fused.py:1083-1115, :1154 (_tlane_kernel kc)",
            s32["chunk_launches"][f"{kind}_sub_chunk"],
            err_of(f"{kind}_sub_chunk", rows), rows, group))
        if not any_hit:
            # The instanced frame baked at 32 through the subcluster walk:
            # its 16 calls a frame, gate off and on.
            for label, suffix in (("subcluster walk", ""),
                                  ("subcluster walk, gate", " gate")):
                rows = inst32[label]["rows"]
                launch = f"nearest_sub{suffix.replace(' ', '_')}"
                kernels.append(_kernel_entry(
                    f"subwalk_kernel<nearest> SUBK=4{suffix} instanced 32",
                    tlane, inst32[label]["launches"][launch],
                    err_of(launch, rows), rows, group))
        rows = pick(sub["classic_chunk"]["rows"])
        kernels.append(_kernel_entry(
            f"subwalk_kernel<{kind}> SUBK=1 chunk_k={CHUNK_CLASSIC} "
            "(classic walk)",
            "raytpu/kernels/fused.py:407-422 (_fused_kernel k_chunk)",
            sub["classic_chunk"]["launches"][f"{kind}_chunk"],
            err_of(f"{kind}_chunk", rows), rows, group))
    # This slice's walk: the matmul pair test on the tensor cores, at each
    # precision, from the bench frame baked with gblock.
    for prec in ("highest", "default"):
        for any_hit in (False, True):
            kind = "any_hit" if any_hit else "nearest"
            rows = [r for r in mxu[prec]["rows"]
                    if r["kw"]["any_hit"] == any_hit]
            kernels.append(_kernel_entry(
                f"mxu_walk_kernel<{kind}> {prec}",
                "raytpu/kernels/fused.py:434-476, :503-532 (_fused_kernel "
                "mxu)", mxu[prec]["launches"][f"{kind}_mxu_{prec}"],
                max([mxu["small_err"][prec]] + [r["err"] for r in rows]),
                rows, "raytpu_torch/kernels/csrc/mxuwalk.cu"))
    # This slice's path: the classic walk on ring shards, every hop of the
    # ring-sharded bench frame (4 shards, finite caps from the earlier
    # shards; cull "reverse" for the shadow rays).
    for kind, replaces in (("nearest", "raytpu/kernels/fused.py:959"),
                           ("any_hit", "raytpu/kernels/fused.py:299")):
        rows = dist_rows[kind]
        kernels.append(_kernel_entry(
            f"walk_kernel<{kind}> ring hop, {DIST_ENTRIES} shards", replaces
            + " (ring hops: raytpu/dist/bigscene.py:211-227)",
            dist_launches[kind], err_of(kind, rows), rows))
    for k in kernels:
        if not (math.isfinite(k["ms"]) and k["launches"] > 0):
            raise AssertionError(f"{k['name']}: no time or no launch")
    (args.out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernels": kernels,
         "flagship": {k: v for k, v in flagship.items()
                      if k not in ("rows", "render")},
         "instanced_32": inst32["turns_ms"],
         "mxu_image": mxu["image"], "query": query, "cli": cli,
         "dist": dist,
         "records": record},
        indent=1, default=str))
    print(f"[done] {time.perf_counter() - started:.0f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
