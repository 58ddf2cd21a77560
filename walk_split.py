"""Split a walk kernel's trips into phases on the card, per walk call.

    python3 walk_split.py TREE [--kernel walk|subwalk|prepick|mxu]
                          [--out FILE]

TREE is the root of a checkout of the port (``.`` for this one).  The
script copies the tree's ``raytpu_torch`` and ``chip_smoke.py`` into
``build/walk_split/`` under this checkout, adds clock64 stamps to the copy
of one kernel (thread 0 sums the clocks of each phase of each trip of its
tile, and the tile's start and end on the global timer) and runs it in a
fresh process.  Per call it prints the kernel ms, the longest tile's trips,
clocks a trip and their phases, when it started and ended, and each
phase's share of all tiles' clocks.  The stamps cost time, so compare
kernel ms with ``walk_ab.py``, not here.

``--kernel walk`` (the default): the classic walk (``walk_kernel``,
``csrc/walk.cu``) on bench.py's frame (its two walk calls) and the
instanced frame's 16 calls (pretest, re-cull every 6 trips), three of them
again with the re-cull off.  It knows the stamp points of two versions of
``walk.cu``: the walk with a full pick scan and an eager re-cull (before
the lazy re-cull) and the walk with per-thread least entries and the lazy
re-cull ("recull" of the second also holds the owner's refresh).

``--kernel subwalk``: the subcluster walk (``subwalk_kernel``,
``csrc/subwalk.cu``) on the bench frame baked at cluster sizes 32 and 64
(gate off, and on at 32) and on the instanced frame baked at 32 with the
pretest and re-cull off (its 16 calls, gate off and on).  It knows the
stamp points of two versions of ``subwalk.cu``: the walk with a pick scan
per pick and the sibling entries recomputed after it, and the walk that
picks ahead from per-thread least keys.

``--kernel prepick``: the prepick walk (``prepick_kernel``,
``csrc/walk.cu``) on the bench frame's two queries at 64 picks and at
every cluster of the bake.  ``--kernel mxu``: the tensor-core walk
(``mxu_walk_kernel``, ``csrc/mxuwalk.cu``) on the bench frame baked with
``gblock``, at both precisions.  Each knows the stamp points of two
designs: a pick scan (or drain) per pick with synchronous staging, and
picks from per-thread least entries, taken ahead, with asynchronous
staging.

Every split also prints the unresolved rays a tested block (ray tests over
tested blocks) and the registers and spill stores of the stamped kernels.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Stamp points: (phase names, [(anchor, replacement), ...]) per version of
# each kernel's source.
_TID = "  const int tid = threadIdx.x;\n"
_PROF = """  long long prof[7] = {0, 0, 0, 0, 0, 0, 0};
  long long prof_t = clock64();
  const long long prof_0 = prof_t;
  const unsigned long long g_0 = gtime();
"""
_ROW = ("  const bool active = tid < a.ts;\n  const size_t r = "
        "static_cast<size_t>(blockIdx.x) * a.ts + tid;\n")


def _head(after):
    """The stamp state, where walk_kernel's ray index is followed by
    ``after`` (prepick_kernel's is not)."""
    return (_TID + _ROW + after, _TID + _PROF + _ROW + after)
_DECL = '''__device__ long long g_prof[16 * 65536];
#define STAMP(i) do { if (threadIdx.x == 0) { const long long n_ = clock64(); \\
  prof[i] += n_ - prof_t; prof_t = n_; } } while (0)
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''
_TAIL = '''
extern "C" int rt_prof_read(void* dst, int n) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_prof, n * sizeof(long long)));
}
'''
_OUT = '''    for (int i = 0; i < 7; ++i) g_prof[16 * blockIdx.x + i] = prof[i];
    g_prof[16 * blockIdx.x + 7] = clock64() - prof_0;
    g_prof[16 * blockIdx.x + 8] = static_cast<long long>(g_0);
    g_prof[16 * blockIdx.x + 9] = static_cast<long long>(gtime());
'''
WALK_VERSIONS = {
    "scan": (["prologue", "pretest", "stage", "tests", "pick", "settle",
              "recull"], [
        ("namespace {\n\n// At most 80", _DECL + "namespace {\n\n// At most 80"),
        _head("  const float qnan"),
        ("  Pick cur = pick_next(ent, a.ncg, red_f, red_i);\n",
         "  Pick cur = pick_next(ent, a.ncg, red_f, red_i);\n  STAMP(0);\n"),
        ("    if (viable) {\n      ++tests;",
         "    STAMP(1);\n    if (viable) {\n      ++tests;"),
        ("      ray_tests += __syncthreads_count(!res);\n",
         "      ray_tests += __syncthreads_count(!res);\n      STAMP(2);\n"),
        ("    const Pick nxt = pick_next(ent, a.ncg, red_f, red_i);\n",
         "    STAMP(3);\n    const Pick nxt = pick_next(ent, a.ncg, red_f, "
         "red_i);\n    STAMP(4);\n"),
        ("    if (__syncthreads_and(res)) break;\n",
         "    if (__syncthreads_and(res)) { STAMP(5); break; }\n"
         "    STAMP(5);\n"),
        ("    }\n    cur = nxt;\n", "    }\n    STAMP(6);\n    cur = nxt;\n"),
        ("    a.out_ray_tests[blockIdx.x] = ray_tests;\n  }\n  if (!active)",
         "    a.out_ray_tests[blockIdx.x] = ray_tests;\n" + _OUT
         + "  }\n  if (!active)"),
    ]),
    "lazy": (["prologue", "pick", "tests", "settle", "pretest", "recull",
              "-"], [
        ("namespace {\n\n// ---- walk_kernel's parts",
         _DECL + "namespace {\n\n// ---- walk_kernel's parts"),
        _head("  const bool lazy"),
        ("pick_f, pick_i, parity);\n  // No feasible",
         "pick_f, pick_i, parity);\n  STAMP(0);\n  // No feasible"),
        ("pick_f, pick_i, parity);\n    float* geo = geo0",
         "pick_f, pick_i, parity);\n    STAMP(1);\n    float* geo = geo0"),
        ("    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= nxt.v)\n",
         "    STAMP(2);\n"
         "    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= nxt.v)\n"),
        ("    if (__syncthreads_and(res)) break;\n",
         "    if (__syncthreads_and(res)) { STAMP(3); break; }\n"
         "    STAMP(3);\n"),
        ("      if (nviable) stage_async(a, nxt.k, geo_next, vec);\n"
         "      cp_async_commit();\n    }\n",
         "      if (nviable) stage_async(a, nxt.k, geo_next, vec);\n"
         "      cp_async_commit();\n    }\n    STAMP(4);\n"),
        ("    cur = nxt;\n    viable = nviable;\n",
         "    STAMP(5);\n    cur = nxt;\n    viable = nviable;\n"),
        ("    a.out_ray_tests[blockIdx.x] = counts[1];\n  }\n",
         "    a.out_ray_tests[blockIdx.x] = counts[1];\n" + _OUT + "  }\n"),
    ]),
}

# The group walk's pick_group with stamps of its own: the picks and the
# sibling entries.
_PICK_SIG = ("float* esub, const Beam* beam, float* red_f,\n"
             "                           int* red_i) {\n")
_PICK_CALL = "pick_group<SUBK>(a, ent, gv, gk, esub, beam, red_f, red_i);"
SUBWALK_VERSIONS = {
    "scan": (["prologue", "pick", "sibling entries", "caps", "stage",
              "tests", "settle"], [
        ("namespace {\n\n// Room for the beam",
         _DECL + "namespace {\n\n// Room for the beam"),
        _head("  const Ray ray"),
        (_PICK_SIG, _PICK_SIG.replace(
            ") {", ", long long* prof,\n    long long& prof_t) {")),
        ("      __syncthreads();  // thread 0's consumed mark before the next "
         "scan\n    }\n",
         "      __syncthreads();  // thread 0's consumed mark before the next "
         "scan\n    }\n    STAMP(1);\n"),
        ("      esub[j * SUBK + threadIdx.x] = sib_entry(a, threadIdx.x, "
         "p.k, *beam);\n    }\n  }\n  __syncthreads();\n",
         "      esub[j * SUBK + threadIdx.x] = sib_entry(a, threadIdx.x, "
         "p.k, *beam);\n    }\n    STAMP(2);\n  }\n  __syncthreads();\n"
         "  STAMP(2);\n"),
        ("  __syncthreads();\n\n  Best best{",
         "  __syncthreads();\n  STAMP(0);\n\n  Best best{"),
        ("  " + _PICK_CALL + "\n  // No feasible",
         "  " + _PICK_CALL.replace(");", ", prof, prof_t);")
         + "\n  // No feasible"),
        ("    // Stage the lanes of the passes that run.\n",
         "    STAMP(3);\n    // Stage the lanes of the passes that run.\n"),
        ("    __syncthreads();\n    for (int j = 0; j < K; ++j) {\n"
         "      const int k = gk[j];\n",
         "    __syncthreads();\n    STAMP(4);\n"
         "    for (int j = 0; j < K; ++j) {\n      const int k = gk[j];\n"),
        ("    __syncthreads();  // the staged blocks and picks are read: refill "
         "them\n    " + _PICK_CALL + "\n",
         "    __syncthreads();  // the staged blocks and picks are read: refill "
         "them\n    STAMP(5);\n    "
         + _PICK_CALL.replace(");", ", prof, prof_t);") + "\n"),
        ("    if (__syncthreads_and(res)) break;\n",
         "    if (__syncthreads_and(res)) { STAMP(6); break; }\n"
         "    STAMP(6);\n"),
        ("  write_out<ANY_HIT>(a, r, active, best, res, trips, tests, "
         "ray_tests);\n",
         "  if (tid == 0) {\n" + _OUT + "  }\n"
         "  write_out<ANY_HIT>(a, r, active, best, res, trips, tests, "
         "ray_tests);\n"),
    ]),
}
SUBWALK_VERSIONS["ahead"] = (
    ["prologue", "pick", "ready", "gate", "tests", "-", "recull"], [
        ("namespace {\n\n// The largest K",
         _DECL + "namespace {\n\n// The largest K"),
        _head("  const Ray ray"),
        ("    if (SUBK > 1 && tid == 0) beam = bm;\n  }\n",
         "    if (SUBK > 1 && tid == 0) beam = bm;\n  }\n  STAMP(0);\n"),
        ("  // No feasible block", "  STAMP(1);\n  // No feasible block"),
        ("  int unres = ready(0);\n", "  int unres = ready(0);\n  STAMP(2);\n"),
        ("pick_f, pick_i, parity);\n    const float* geo =",
         "pick_f, pick_i, parity);\n    STAMP(1);\n    const float* geo ="),
        ("    if (run && (2 * unres > nt || !vtest)) {\n",
         "    STAMP(3);\n    if (run && (2 * unres > nt || !vtest)) {\n"),
        ("    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= nv) : "
         "(best.t <= nv));\n",
         "    STAMP(4);\n    res = res || (ANY_HIT ? (best.code >= 0 || "
         "tmax0 <= nv) : (best.t <= nv));\n"),
        ("    unres = ready(nb);\n    if (unres == 0) break;\n",
         "    unres = ready(nb);\n    if (unres == 0) { STAMP(2); break; }\n"
         "    STAMP(2);\n"),
        ("    cur = nv;\n    b ^= 1;\n",
         "    STAMP(6);\n    cur = nv;\n    b ^= 1;\n"),
        ("    b ^= 1;\n  }\n  write_out<",
         "    b ^= 1;\n  }\n  if (tid == 0) {\n" + _OUT + "  }\n"
         "  write_out<"),
    ])
# prepick_kernel: the drain of every pick before the walk, then a scan-free
# walk over them with synchronous staging and scalar tests.
PREPICK_VERSIONS = {
    "drain": (["prologue", "pick", "stage", "tests", "settle", "-", "-"], [
        ("namespace {\n\n// ---- walk_kernel's parts",
         _DECL + "namespace {\n\n// ---- walk_kernel's parts"),
        _head("  const Ray ray"),
        ("  fill_entries<false>(a, ray, res, ent, red_f);\n\n  // Pick phase",
         "  fill_entries<false>(a, ray, res, ent, red_f);\n  STAMP(0);\n\n"
         "  // Pick phase"),
        ("  __syncthreads();\n\n  Best best{",
         "  __syncthreads();\n  STAMP(1);\n\n  Best best{"),
        ("    ray_tests += stage(a, k, geo, res);\n",
         "    ray_tests += stage(a, k, geo, res);\n    STAMP(2);\n"),
        ("    test_staged<ANY_HIT, CULL>(geo, C, 0, C, k, ray, w, best);\n",
         "    test_staged<ANY_HIT, CULL>(geo, C, 0, C, k, ray, w, best);\n"
         "    STAMP(3);\n"),
        ("    settled = __syncthreads_and(res);\n  }\n  write_out<",
         "    settled = __syncthreads_and(res);\n    STAMP(4);\n  }\n"
         "  if (tid == 0) {\n" + _OUT + "  }\n  write_out<"),
    ]),
}
# prepick_kernel taking each pick just before the trip that settles against
# it, from per-thread least entries, its rows copied ahead.
PREPICK_VERSIONS["lazy"] = (
    ["prologue", "pick", "ready", "tests", "settle", "-", "-"], [
        ("namespace {\n\n// ---- walk_kernel's parts",
         _DECL + "namespace {\n\n// ---- walk_kernel's parts"),
        _head("  const Ray ray"),
        ("  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};\n  // Pick s: the least",
         "  STAMP(0);\n  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};\n"
         "  // Pick s: the least"),
        ("  Pick cur = pick(geo0, true);\n",
         "  Pick cur = pick(geo0, true);\n  STAMP(1);\n"),
        ("    const Pick nxt = pick(geo0 + (b ^ 1) * kGeoRows * C, more);\n",
         "    const Pick nxt = pick(geo0 + (b ^ 1) * kGeoRows * C, more);\n"
         "    STAMP(1);\n"),
        ("    ray_tests += U;\n", "    ray_tests += U;\n    STAMP(2);\n"),
        ("    const float vn = nxt.v < kInf ? nxt.v : kInf;\n",
         "    STAMP(3);\n    const float vn = nxt.v < kInf ? nxt.v : kInf;\n"),
        ("    cur = nxt;\n    b ^= 1;\n  }\n  cp_async_wait<0>();\n",
         "    STAMP(4);\n    cur = nxt;\n    b ^= 1;\n  }\n"
         "  cp_async_wait<0>();\n  if (tid == 0) {\n" + _OUT + "  }\n"),
    ])
# mxu_walk_kernel: a pick scan per pick, synchronous staging with the TF32
# rounding, every warp's products and acceptance, the quad reduction.
MXU_VERSIONS = {
    "scan": (["prologue", "pick", "pretest", "stage", "tests", "reduction",
              "settle"], [
        ("namespace {\n\nconstexpr int kGRows",
         _DECL + "namespace {\n\nconstexpr int kGRows"),
        _head("  const Ray ray"),
        ("  int trips = 0, tests = 0, ray_tests = 0;\n\n  pick_group(a, ent, "
         "gv, gk, red_f, red_i);\n",
         "  int trips = 0, tests = 0, ray_tests = 0;\n  STAMP(0);\n\n"
         "  pick_group(a, ent, gv, gk, red_f, red_i);\n  STAMP(1);\n"),
        ("    // Stage the tested blocks:",
         "    STAMP(2);\n    // Stage the tested blocks:"),
        ("    __syncthreads();\n    for (int j = 0; j < K; ++j) {\n"
         "      if (!((run >> j) & 1u)) continue;\n      ray_tests += unres;",
         "    __syncthreads();\n    STAMP(3);\n"
         "    for (int j = 0; j < K; ++j) {\n"
         "      if (!((run >> j) & 1u)) continue;\n      ray_tests += unres;"),
        ("      // Reduce each slot over the quad",
         "      STAMP(4);\n      // Reduce each slot over the quad"),
        ("    __syncthreads();  // the staged blocks and picks are read: refill "
         "them\n    pick_group(a, ent, gv, gk, red_f, red_i);\n",
         "    __syncthreads();  // the staged blocks and picks are read: refill "
         "them\n    STAMP(5);\n    pick_group(a, ent, gv, gk, red_f, red_i);"
         "\n    STAMP(1);\n"),
        ("    if (__syncthreads_and(res)) break;\n",
         "    if (__syncthreads_and(res)) { STAMP(6); break; }\n"
         "    STAMP(6);\n"),
        ("  write_out<ANY_HIT>(a, r, active, best, res, trips, tests, "
         "ray_tests);\n",
         "  if (tid == 0) {\n" + _OUT + "  }\n"
         "  write_out<ANY_HIT>(a, r, active, best, res, trips, tests, "
         "ray_tests);\n"),
    ]),
}
# mxu_walk_kernel over the listed rays (every ray that is not dead), its
# picks taken ahead from per-thread least entries and their G rows copied
# asynchronously.
MXU_VERSIONS["ahead"] = (
    ["prologue", "pick", "ready", "pretest", "tests", "reduction", "-"], [
        ("namespace {\n\nconstexpr int kMaxChunk = 8;\nconstexpr int kRayWords",
         _DECL + "namespace {\n\nconstexpr int kMaxChunk = 8;\n"
         "constexpr int kRayWords"),
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
         + _PROF),
        ("  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};\n  // Slab reciprocals",
         "  STAMP(0);\n  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};\n"
         "  // Slab reciprocals"),
        ("  float cur = pick_group(0);\n",
         "  float cur = pick_group(0);\n  STAMP(1);\n"),
        ("  int slot = list_rays();\n", "  int slot = list_rays();\n  STAMP(2);\n"),
        ("    const float nv = pick_group(nb);\n",
         "    const float nv = pick_group(nb);\n    STAMP(1);\n"),
        ("    const int J = __popc(run);\n",
         "    STAMP(3);\n    const int J = __popc(run);\n"),
        ("      __syncthreads();\n      if (slot >= 0) {\n",
         "      __syncthreads();\n      STAMP(4);\n      if (slot >= 0) {\n"),
        ("    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= nv) : "
         "(best.t <= nv));\n    unres = ready();\n    if (unres == 0) break;\n",
         "    STAMP(5);\n    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 "
         "<= nv) : (best.t <= nv));\n    unres = ready();\n"
         "    if (unres == 0) { STAMP(2); break; }\n"),
        ("    slot = list_rays();\n", "    slot = list_rays();\n    STAMP(2);\n"),
        ("  cp_async_wait<0>();\n  write_out<ANY_HIT>(a, r, active, best, res, "
         "trips, tests, ray_tests);\n",
         "  cp_async_wait<0>();\n  if (tid == 0) {\n" + _OUT + "  }\n"
         "  write_out<ANY_HIT>(a, r, active, best, res, trips, tests, "
         "ray_tests);\n"),
    ])
KERNELS = {"walk": ("walk.cu", WALK_VERSIONS),
           "subwalk": ("subwalk.cu", SUBWALK_VERSIONS),
           "prepick": ("walk.cu", PREPICK_VERSIONS),
           "mxu": ("mxuwalk.cu", MXU_VERSIONS)}

# Run inside the stamped copy.
_DRIVE = r'''
import ctypes, json, sys
import torch
import chip_smoke as cs
from raytpu_torch import Quantize, RenderConfig
from raytpu_torch.core.camera import Camera
from raytpu_torch.kernels import fused
from raytpu_torch.kernels.build import build_library, load_library
from raytpu_torch.render import instanced as prender
from raytpu_torch.render.wavefront import render_rays

PHASES = json.loads(sys.argv[1])
KERNEL = sys.argv[2]
with open("ptxas.txt", "w") as f:
    f.write(build_library()[2])
lib = load_library()
lib.rt_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
dev = torch.device("cuda")
rows = []


def split(calls, label, only=None):
    for i, (c, s, q, kw, _) in enumerate(calls):
        if only is not None and i not in only:
            continue
        launch = cs._walks(kw)[0]
        ms = cs._cuda_ms(lambda: launch(c, s, q, **kw), 2)
        out = launch(c, s, q, **kw)
        torch.cuda.synchronize()
        nt = out.iters.shape[0]
        host = torch.zeros(nt * 16, dtype=torch.int64)
        if lib.rt_prof_read(host.data_ptr(), nt * 16) != 0:
            raise RuntimeError("could not read the stamps")
        p = host.reshape(nt, 16).double()
        t0 = p[:, 8].min()
        L = int(out.iters.argmax())
        trips = max(int(out.iters[L]), 1)
        share = p[:, :7].sum(0) / p[:, :7].sum()
        row = {"call": f"{label} {i}", "walk": {k: str(v) for k, v in kw.items()},
               "ms": ms, "trips_mean": float(out.iters.float().mean()),
               "ray_tests_per_test": float(out.ray_tests.double().sum())
               / max(float(out.tests.double().sum()), 1.0),
               "longest": {"trips": int(out.iters[L]),
                           "tested": int(out.tests[L]),
                           "clocks_per_trip": float(p[L, 7]) / trips,
                           "phases_per_trip": {n: float(p[L, k]) / trips
                                               for k, n in enumerate(PHASES)
                                               if n != "-"},
                           "start_ms": float(p[L, 8] - t0) / 1e6,
                           "end_ms": float(p[L, 9] - t0) / 1e6},
               "share": {n: float(share[k]) for k, n in enumerate(PHASES)
                         if n != "-"}}
        rows.append(row)
        lo = row["longest"]
        print(f"{row['call']} ({'any_hit' if kw['any_hit'] else 'nearest'}, "
              f"pretest {kw.get('pretest', False)}, re-cull "
              f"{kw.get('recull_every', 0)}, gate {kw.get('gate', '-')}, "
              f"picks {kw.get('picks', '-')}, mxu {kw.get('mxu', '-')}): "
              f"{ms:.3f} ms (stamped), trips "
              f"mean {row['trips_mean']:.1f}, unresolved rays a tested block "
              f"{row['ray_tests_per_test']:.1f}; longest tile {lo['trips']} "
              f"trips ({lo['tested']} tested) from {lo['start_ms']:.2f} to "
              f"{lo['end_ms']:.2f} ms, {lo['clocks_per_trip']:.0f} clocks a "
              "trip: " + ", ".join(f"{n} {v:.0f}" for n, v in
                                   lo["phases_per_trip"].items())
              + "; share of all tiles' clocks: " + ", ".join(
                  f"{n} {v:.3f}" for n, v in row["share"].items()),
              flush=True)


cfg = RenderConfig(width=cs.RES, height=cs.RES, max_reflections=0,
                   tile_pixels=cs.RES ** 2, quantize=Quantize.NONE)
o, d = cs._frame_rays(cs.RES, dev)
icfg = RenderConfig(width=cs.RES, height=cs.RES, max_reflections=1,
                    tile_pixels=cs.RES ** 2, quantize=Quantize.NONE)
camera = Camera(position=cs.INSTANCED_CAMERA, aspect=1.0)


def gated(calls):
    return [(c, s, q, {**kw, "gate": True}, o_) for c, s, q, kw, o_ in calls]


if KERNEL == "walk":
    flat = cs.bench_scene(cs.TRIS).flatten(cluster_size=cs.CLUSTER_SIZE,
                                           device=dev, build_octree=False)
    with cs.recording_walks() as calls:
        render_rays(flat, cfg, o, d)
    split(calls, "bench")
    del flat
    iscene = prender.flatten_instanced(cs.instanced_frame_scene(cs.TRIS),
                                       cluster_size=cs.CLUSTER_SIZE,
                                       device=dev, build_octree=False)
    with cs.recording_walks() as calls:
        prender.render_image_instanced(iscene, icfg, camera)
    split(calls, "instanced")
    split([(c, s, q, {**kw, "recull_every": 0}, o_)
           for c, s, q, kw, o_ in calls], "instanced, re-cull off",
          only={0, 8, 12})
elif KERNEL == "prepick":
    flat = cs.bench_scene(cs.TRIS).flatten(cluster_size=cs.CLUSTER_SIZE,
                                           device=dev, build_octree=False)
    with cs.recording_walks() as calls:
        render_rays(flat, cfg, o, d)
    for picks in (64, flat.clusters["block"].shape[0]):
        split([(c, s, q, {"cull": kw["cull"], "any_hit": kw["any_hit"],
                          "picks": picks}, o_)
               for c, s, q, kw, o_ in calls], f"bench prepick {picks}")
elif KERNEL == "mxu":
    from raytpu_torch.render.wavefront import trace_colors

    torch.backends.cuda.matmul.allow_tf32 = False
    flat = cs.bench_scene(cs.TRIS).flatten(cluster_size=cs.CLUSTER_SIZE,
                                           device=dev, build_octree=False,
                                           build_gblock=True)
    for prec in ("highest", "default"):
        with cs.recording_walks() as calls:
            trace_colors(flat, cfg, o, d, query=cs._fused_query(
                mxu=True, mxu_precision=prec))
        split(calls, f"bench mxu {prec}")
else:
    for size in (32, 64):
        flat = cs.bench_scene(cs.TRIS).flatten(cluster_size=size, device=dev,
                                               build_octree=False)
        with cs.recording_walks() as calls:
            render_rays(flat, cfg, o, d)
        split(calls, f"bench {size}")
        if size == 32:
            split(gated(calls), f"bench {size} gate")
        del flat
    iscene = prender.flatten_instanced(cs.instanced_frame_scene(cs.TRIS),
                                       cluster_size=32, device=dev,
                                       build_octree=False)
    with cs.walk_defaults(**cs.NO_OPT_INS):
        with cs.recording_walks() as calls:
            prender.render_image_instanced(iscene, icfg, camera)
    split(calls, "instanced 32")
    split(gated(calls), "instanced 32 gate")
print(json.dumps(rows))
'''


def stamp(tree: Path, dest: Path, kernel: str) -> list:
    """Copy the tree into ``dest`` with the kernel's source stamped; its
    phases."""
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(tree / "raytpu_torch", dest / "raytpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tree / "chip_smoke.py", dest / "chip_smoke.py")
    name, versions = KERNELS[kernel]
    src = dest / "raytpu_torch" / "kernels" / "csrc" / name
    text = src.read_text()
    for phases, edits in versions.values():
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            src.write_text(text + _TAIL)
            return phases
    raise SystemExit(f"{tree}: {name} has no known stamp points")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree", type=Path)
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="walk")
    parser.add_argument("--out", type=Path,
                        default=HERE / "build" / "walk_split.json")
    args = parser.parse_args()
    dest = HERE / "build" / "walk_split"
    phases = stamp(args.tree.resolve(), dest, args.kernel)
    import json

    proc = subprocess.run([sys.executable, "-c", _DRIVE, json.dumps(phases),
                           args.kernel],
                          cwd=dest, capture_output=True, text=True)
    sys.stdout.write("\n".join(proc.stdout.splitlines()[:-1]) + "\n")
    if proc.returncode != 0:
        raise SystemExit(f"walk_split failed ({proc.returncode}):\n"
                         f"{proc.stderr[-4000:]}")
    from walk_ab import kernel_registers

    for key, v in kernel_registers((dest / "ptxas.txt").read_text()).items():
        print(f"{key}: registers {'/'.join(v['registers'])}, spill stores "
              f"{v['spill_store_bytes']} bytes (stamped)")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(proc.stdout.splitlines()[-1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
