"""Split a walk kernel's trips into phases on the card, per walk call.

    python3 walk_split.py TREE [--kernel walk|subwalk] [--out FILE]

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
KERNELS = {"walk": ("walk.cu", WALK_VERSIONS),
           "subwalk": ("subwalk.cu", SUBWALK_VERSIONS)}

# Run inside the stamped copy.
_DRIVE = r'''
import ctypes, json, sys
import torch
import chip_smoke as cs
from raytpu_torch import Quantize, RenderConfig
from raytpu_torch.core.camera import Camera
from raytpu_torch.kernels import fused
from raytpu_torch.kernels.build import load_library
from raytpu_torch.render import instanced as prender
from raytpu_torch.render.wavefront import render_rays

PHASES = json.loads(sys.argv[1])
KERNEL = sys.argv[2]
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
              f"{kw.get('recull_every', 0)}, gate {kw.get('gate', '-')}): "
              f"{ms:.3f} ms (stamped), trips "
              f"mean {row['trips_mean']:.1f}; longest tile {lo['trips']} "
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
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(proc.stdout.splitlines()[-1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
