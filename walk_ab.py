"""Time the bench frame and its walk calls in several checkouts of the port
on one card, in turns.

    python3 walk_ab.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout (this one is ``.``).  Every turn is a
fresh process that imports ``raytpu_torch`` and ``chip_smoke`` from its
tree, builds that tree's kernels, bakes bench.py's terrain and times, with
CUDA events, the 1024x1024 frame (primary + shadow rays), each of its
walk calls, the prepick walk (64 picks, and as many as the bake has
clusters) on the same queries, the
frame baked at cluster size 32 with its subcluster walk calls and, where
the tree bakes ``gblock``, the tensor-core walk's calls of the frame at
each precision.  Then the instanced frame (chip_smoke.py's: the terrain's
one bake instanced 2x2, 1024x1024, one reflection): the frame's ms and, per
walk call (the pretest walk with a re-cull every 6 trips), the kernel ms,
the trips per tile (mean, p99, max), the ms per trip of the longest tile,
the tested clusters of that tile and the kernel ms with the re-cull off
(``recull_every=0``) on the same queries.  Last, the instanced frame baked
at cluster size 32 through the subcluster walk (the pretest and re-cull
off), gate off and on: the frame's ms and, per walk call, the kernel ms,
the trips per tile (mean, p99, max), the ms per trip of the longest tile,
the ray tests per tested block, the unresolved rays a trip of the longest
tile and the share of the trips made in tiles that average more than half
the tile unresolved (four passes a trip: with the gate they read low).
The trees run in the given
order, then in reverse (A, B, B, A), so that drift of the card shows.
Prints one line per turn (with the registers and spill stores of each
kernel of each source), the card's name and power limit, and writes all of it
as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

# Run inside each tree: only what every checkout of the port has.
_TURN = r'''
import inspect, json, sys, torch
import chip_smoke as cs
PICKS = 64
SUB = 32  # the subcluster walk's bake (bench.py's BENCH_CSIZE)
from raytpu_torch import Quantize, RenderConfig
from raytpu_torch.kernels import fused
from raytpu_torch.kernels.build import build_library
from raytpu_torch.render.wavefront import render_rays
from raytpu_torch.scene.flatten import flatten_scene

_, _, log = build_library()
dev = torch.device("cuda")
# A tree whose bake builds an octree by default is told not to: the walk
# does not read it.
bake_kw = ({"build_octree": False} if "build_octree" in
           inspect.signature(flatten_scene).parameters else {})
cfg = RenderConfig(width=cs.RES, height=cs.RES, max_reflections=0,
                   tile_pixels=cs.RES ** 2, quantize=Quantize.NONE)
o, d = cs._frame_rays(cs.RES, dev)


def timed_walks(flat, launch):
    with cs.recording_walks() as calls:
        render_rays(flat, cfg, o, d)
    return [{"any_hit": kw["any_hit"],
             "ms": cs._cuda_ms(lambda: launch(c, s, q, **kw), 16)}
            for c, s, q, kw, _ in calls], calls


flat = cs.bench_scene(cs.TRIS).flatten(cluster_size=cs.CLUSTER_SIZE,
                                       device=dev, **bake_kw)
frame_ms = cs._cuda_ms(lambda: render_rays(flat, cfg, o, d), 8)
walks, calls = timed_walks(flat, fused.walk_cuda)
# The prepick walk on the same queries, at 64 picks and at every cluster.
prepick = [{"any_hit": kw["any_hit"], "picks": picks,
            "ms": cs._cuda_ms(lambda: fused.prepick_cuda(
                c, s, q, cull=kw["cull"], any_hit=kw["any_hit"],
                picks=picks), reps)}
           for picks, reps in ((PICKS, 16),
                               (flat.clusters["block"].shape[0], 4))
           for c, s, q, kw, _ in calls]
del flat
# The subcluster walk: the bench frame baked at 32.
flat = cs.bench_scene(cs.TRIS).flatten(cluster_size=SUB, device=dev,
                                       **bake_kw)
sub_frame_ms = cs._cuda_ms(lambda: render_rays(flat, cfg, o, d), 8)
sub, _ = timed_walks(flat, fused.subwalk_cuda)
del flat
# The tensor-core walk at each precision, where the tree bakes gblock.
mxu = {}
if "build_gblock" in inspect.signature(flatten_scene).parameters:
    from raytpu_torch.render.wavefront import trace_colors

    torch.backends.cuda.matmul.allow_tf32 = False
    flat = cs.bench_scene(cs.TRIS).flatten(
        cluster_size=cs.CLUSTER_SIZE, device=dev, build_gblock=True,
        **bake_kw)
    for prec in ("highest", "default"):
        with cs.recording_walks() as calls:
            trace_colors(flat, cfg, o, d, query=cs._fused_query(
                mxu=True, mxu_precision=prec))
        mxu[prec] = [{"any_hit": kw["any_hit"],
                      "ms": cs._cuda_ms(lambda: fused.walk_cuda(
                          c, s, q, **kw), 16)}
                     for c, s, q, kw, _ in calls]
# The instanced frame and its re-cull walk calls.
from raytpu_torch.core.camera import Camera
from raytpu_torch.render import instanced as prender

iscene = prender.flatten_instanced(cs.instanced_frame_scene(cs.TRIS),
                                   cluster_size=cs.CLUSTER_SIZE, device=dev,
                                   **bake_kw)
icfg = RenderConfig(width=cs.RES, height=cs.RES, max_reflections=1,
                    tile_pixels=cs.RES ** 2, quantize=Quantize.NONE)
camera = Camera(position=cs.INSTANCED_CAMERA, aspect=1.0)
inst_frame_ms = cs._cuda_ms(
    lambda: prender.render_image_instanced(iscene, icfg, camera), 2)
with cs.recording_walks() as calls:
    prender.render_image_instanced(iscene, icfg, camera)
inst = []
for c, s, q, kw, out in calls:
    trips = out.iters.float()
    longest = int(trips.argmax())
    ms = cs._cuda_ms(lambda: fused.walk_cuda(c, s, q, **kw), 4)
    inst.append({
        "any_hit": kw["any_hit"], "recull_every": kw.get("recull_every", 0),
        "ms": ms, "trips_mean": float(trips.mean()),
        "trips_p99": float(torch.quantile(trips, 0.99)),
        "trips_max": int(trips.max()),
        "us_per_trip": 1e3 * ms / max(int(trips.max()), 1),
        "longest_tested": int(out.tests[longest]),
        "longest_ray_tests": int(out.ray_tests[longest]),
        "recull0_ms": cs._cuda_ms(lambda: fused.walk_cuda(
            c, s, q, **{**kw, "recull_every": 0}), 4)})
del iscene
# The instanced frame baked at 32 through the subcluster walk.
iscene = prender.flatten_instanced(cs.instanced_frame_scene(cs.TRIS),
                                   cluster_size=SUB, device=dev, **bake_kw)
inst32 = {}
for gate in (False, True):
    with cs.walk_defaults(**cs.NO_OPT_INS, gate=gate):
        frame32_ms = cs._cuda_ms(
            lambda: prender.render_image_instanced(iscene, icfg, camera), 1)
        with cs.recording_walks() as calls:
            prender.render_image_instanced(iscene, icfg, camera)
    rows = []
    for c, s, q, kw, out in calls:
        trips = out.iters.float()
        ms = cs._cuda_ms(lambda: fused.subwalk_cuda(c, s, q, **kw), 1)
        # Unresolved rays a trip, per tile: ray tests over the passes run
        # (four a tested block without the gate).
        per_trip = out.ray_tests.double() / (4 * trips.double()).clamp(min=1)
        longest = int(trips.argmax())
        rows.append({
            "ms": ms, "trips_mean": float(trips.mean()),
            "trips_p99": float(torch.quantile(trips, 0.99)),
            "trips_max": int(trips.max()),
            "us_per_trip": 1e3 * ms / max(int(trips.max()), 1),
            "ray_tests_per_test": float(out.ray_tests.double().sum())
            / max(float(out.tests.double().sum()), 1.0),
            "longest_unresolved": float(per_trip[longest]),
            "wide_trip_share": float(trips[per_trip > q.tile / 2].sum())
            / max(float(trips.sum()), 1.0)})
    inst32["gate" if gate else "off"] = {"frame_ms": frame32_ms,
                                         "calls": rows}
print(json.dumps({"frame_ms": frame_ms, "walks": walks, "prepick": prepick,
                  "sub_frame_ms": sub_frame_ms, "sub": sub, "mxu": mxu,
                  "inst_frame_ms": inst_frame_ms, "inst": inst,
                  "inst32": inst32, "ptxas": log}))
'''


def kernel_registers(log: str) -> dict:
    """Registers (one entry per instantiation, in the compiler's order) and
    spill stores (bytes, summed) of each kernel in a ``-Xptxas -v`` log,
    keyed ``"walk.cu walk_kernel"``."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?_\d+_([a-z]+)_cu_.*?"
                      r"\d+([a-z_]+_kernel)I", line)
        if m:
            key = f"{m.group(1)}.cu {m.group(2)}"
            out.setdefault(key, {"registers": [], "spill_store_bytes": 0})
        elif "Used" in line and "registers" in line and key:
            out[key]["registers"].append(
                line.split("Used ")[1].split(" registers")[0])
        elif "spill stores" in line and key:
            out[key]["spill_store_bytes"] += int(
                line.split("bytes spill stores")[0].split(",")[-1])
    return out


def _turn(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["kernels"] = kernel_registers(res.pop("ptxas"))
    return res


SUB = 32


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--out", type=Path,
                        default=Path("build") / "walk_ab.json")
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    # Each tree's first turn builds its kernels anew, so that its compiler
    # log (registers, spills) is there to read.
    for tree in args.trees:
        shutil.rmtree(tree / "build" / "raytpu_torch", ignore_errors=True)
    turns = []
    for tree in args.trees + args.trees[::-1]:
        res = _turn(tree.resolve())
        turns.append({"tree": str(tree), **res})
        kind = lambda w: "any_hit" if w["any_hit"] else "nearest"  # noqa
        print(f"{tree}: frame {res['frame_ms']:.3f} ms; walks "
              + ", ".join(f"{kind(w)} {w['ms']:.3f} ms"
                          for w in res["walks"])
              + "".join(f", prepick {w.get('picks', 64)} {kind(w)} "
                        f"{w['ms']:.3f} ms" for w in res["prepick"])
              + f"; at {SUB}: frame {res['sub_frame_ms']:.3f} ms, subcluster "
              + ", ".join(f"{kind(w)} {w['ms']:.3f} ms" for w in res["sub"])
              + "".join(f"; mxu {prec} " + ", ".join(
                  f"{kind(w)} {w['ms']:.3f} ms" for w in walks)
                  for prec, walks in res.get("mxu", {}).items())
              + f"; instanced frame {res['inst_frame_ms']:.1f} ms, "
              + f"{len(res['inst'])} walk calls "
              + f"{sum(w['ms'] for w in res['inst']):.1f} ms "
              + f"(re-cull off {sum(w['recull0_ms'] for w in res['inst']):.1f})"
              + "".join(
                  f"; {k} registers {'/'.join(v['registers'])} (spill "
                  f"stores {v['spill_store_bytes']} bytes)"
                  for k, v in res["kernels"].items()), flush=True)
        for i, w in enumerate(res["inst"]):
            print(f"  instanced call {i} ({kind(w)}, re-cull "
                  f"{w['recull_every']}): {w['ms']:.3f} ms, trips mean "
                  f"{w['trips_mean']:.1f} p99 {w['trips_p99']:.0f} max "
                  f"{w['trips_max']} ({w['us_per_trip']:.3f} us a trip of "
                  f"the longest tile; it tested {w['longest_tested']} "
                  f"clusters, {w['longest_ray_tests']} ray tests); re-cull "
                  f"off {w['recull0_ms']:.3f} ms", flush=True)
        for gate, run in res["inst32"].items():
            print(f"  instanced frame at {SUB}, subcluster walk, gate {gate}: "
                  f"{run['frame_ms']:.1f} ms, {len(run['calls'])} walk calls "
                  f"{sum(w['ms'] for w in run['calls']):.1f} ms", flush=True)
            for i, w in enumerate(run["calls"]):
                print(f"    call {i}: {w['ms']:.3f} ms, trips mean "
                      f"{w['trips_mean']:.1f} p99 {w['trips_p99']:.0f} max "
                      f"{w['trips_max']} ({w['us_per_trip']:.3f} us a trip "
                      f"of the longest tile), ray tests per tested block "
                      f"{w['ray_tests_per_test']:.1f}; unresolved rays a "
                      f"trip in the longest tile "
                      f"{w.get('longest_unresolved', 0.0):.1f}, trips in "
                      f"tiles averaging more than half the tile unresolved "
                      f"{w.get('wide_trip_share', 0.0):.1%}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "turns": turns},
                                   indent=1))
    print(card)


if __name__ == "__main__":
    main()
