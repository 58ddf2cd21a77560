"""Split the classic walk's trips into phases on the card, per walk call of
bench.py's frame and of the instanced frame.

    python3 walk_split.py TREE [--out FILE]

TREE is the root of a checkout of the port (``.`` for this one).  The
script copies the tree's ``raytpu_torch`` and ``chip_smoke.py`` into
``build/walk_split/`` under this checkout, adds clock64 stamps to the copy
of ``walk_kernel`` (thread 0 sums the clocks of each phase of each trip of
its tile, and the tile's start and end on the global timer) and runs, in a
fresh process, the bench frame's two walk calls and the instanced frame's
16 (pretest, re-cull every 6 trips) and three of them again with the
re-cull off.  Per call it prints the kernel ms, the longest tile's trips,
clocks a trip and their phases, when it started and ended, and each
phase's share of all tiles' clocks.  It knows the stamp points of two
versions of ``csrc/walk.cu``: the walk with a full pick scan and an eager
re-cull (before the lazy re-cull) and the walk with per-thread least
entries and the lazy re-cull; the phases are the version's own ("recull"
of the second also holds the owner's refresh).  The
stamps cost time, so compare kernel ms with ``walk_ab.py``, not here.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Stamp points: (phase names, [(anchor, replacement), ...]) per version.
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
VERSIONS = {
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
lib = load_library()
lib.rt_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
dev = torch.device("cuda")
rows = []


def split(calls, label, only=None):
    for i, (c, s, q, kw, _) in enumerate(calls):
        if only is not None and i not in only:
            continue
        ms = cs._cuda_ms(lambda: fused.walk_cuda(c, s, q, **kw), 2)
        out = fused.walk_cuda(c, s, q, **kw)
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
              f"{kw.get('recull_every', 0)}): {ms:.3f} ms (stamped), trips "
              f"mean {row['trips_mean']:.1f}; longest tile {lo['trips']} "
              f"trips ({lo['tested']} tested) from {lo['start_ms']:.2f} to "
              f"{lo['end_ms']:.2f} ms, {lo['clocks_per_trip']:.0f} clocks a "
              "trip: " + ", ".join(f"{n} {v:.0f}" for n, v in
                                   lo["phases_per_trip"].items())
              + "; share of all tiles' clocks: " + ", ".join(
                  f"{n} {v:.3f}" for n, v in row["share"].items()),
              flush=True)


flat = cs.bench_scene(cs.TRIS).flatten(cluster_size=cs.CLUSTER_SIZE,
                                       device=dev, build_octree=False)
cfg = RenderConfig(width=cs.RES, height=cs.RES, max_reflections=0,
                   tile_pixels=cs.RES ** 2, quantize=Quantize.NONE)
o, d = cs._frame_rays(cs.RES, dev)
with cs.recording_walks() as calls:
    render_rays(flat, cfg, o, d)
split(calls, "bench")
del flat
iscene = prender.flatten_instanced(cs.instanced_frame_scene(cs.TRIS),
                                   cluster_size=cs.CLUSTER_SIZE, device=dev,
                                   build_octree=False)
icfg = RenderConfig(width=cs.RES, height=cs.RES, max_reflections=1,
                    tile_pixels=cs.RES ** 2, quantize=Quantize.NONE)
camera = Camera(position=cs.INSTANCED_CAMERA, aspect=1.0)
with cs.recording_walks() as calls:
    prender.render_image_instanced(iscene, icfg, camera)
split(calls, "instanced")
split([(c, s, q, {**kw, "recull_every": 0}, o_)
       for c, s, q, kw, o_ in calls], "instanced, re-cull off",
      only={0, 8, 12})
print(json.dumps(rows))
'''


def stamp(tree: Path, dest: Path) -> list:
    """Copy the tree into ``dest`` with a stamped walk.cu; its phases."""
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(tree / "raytpu_torch", dest / "raytpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tree / "chip_smoke.py", dest / "chip_smoke.py")
    src = dest / "raytpu_torch" / "kernels" / "csrc" / "walk.cu"
    text = src.read_text()
    for phases, edits in VERSIONS.values():
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            src.write_text(text + _TAIL)
            return phases
    raise SystemExit(f"{tree}: walk.cu has no known stamp points")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree", type=Path)
    parser.add_argument("--out", type=Path,
                        default=HERE / "build" / "walk_split.json")
    args = parser.parse_args()
    dest = HERE / "build" / "walk_split"
    phases = stamp(args.tree.resolve(), dest)
    import json

    proc = subprocess.run([sys.executable, "-c", _DRIVE, json.dumps(phases)],
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
