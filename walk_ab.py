"""Time the bench frame and its walk calls in several checkouts of the port
on one card, in turns.

    python3 walk_ab.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout (this one is ``.``).  Every turn is a
fresh process that imports ``raytpu_torch`` and ``chip_smoke`` from its
tree, builds that tree's kernels, bakes bench.py's terrain and times, with
CUDA events, the 1024x1024 frame (primary + shadow rays), each of its
walk calls, the prepick walk (64 picks) on the same queries, the
frame baked at cluster size 32 with its subcluster walk calls and, where
the tree bakes ``gblock``, the tensor-core walk's calls of the frame at
each precision.  The trees
run in the given order, then in reverse (A, B, B, A), so that drift of the
card shows.  Prints one line per turn (with the
registers and spill stores of each source's kernels), the card's name and
power limit, and writes all of it as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

# Run inside each tree: only what every checkout of the port has.
_TURN = r'''
import inspect, json, re, sys, torch
import chip_smoke as cs
PICKS = 64
SUB = 32  # the subcluster walk's bake (bench.py's BENCH_CSIZE)
from raytpu_torch import Quantize, RenderConfig
from raytpu_torch.kernels import fused
from raytpu_torch.kernels.build import build_library
from raytpu_torch.render.wavefront import render_rays
from raytpu_torch.scene.flatten import flatten_scene

_, _, log = build_library()
# Registers and spill stores per source, in the compiler's order.
regs, spills, src = {}, {}, None
for line in log.splitlines():
    m = re.search(r"Compiling entry function '.*?_\d+_([a-z]+)_cu_", line)
    if m:
        src = m.group(1) + ".cu"
    elif "registers" in line and src:
        regs.setdefault(src, []).append(
            line.split("Used ")[1].split(" registers")[0])
    elif "spill stores" in line and src:
        spills[src] = spills.get(src, 0) + int(
            line.split("bytes spill stores")[0].split(",")[-1])
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
# The prepick walk on the same queries.
prepick = [{"any_hit": kw["any_hit"],
            "ms": cs._cuda_ms(lambda: fused.prepick_cuda(
                c, s, q, cull=kw["cull"], any_hit=kw["any_hit"],
                picks=PICKS), 16)}
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
print(json.dumps({"frame_ms": frame_ms, "walks": walks, "prepick": prepick,
                  "sub_frame_ms": sub_frame_ms, "sub": sub, "mxu": mxu,
                  "registers": regs, "spill_store_bytes": spills}))
'''


def _turn(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


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
              + "".join(f", prepick {kind(w)} {w['ms']:.3f} ms"
                        for w in res["prepick"])
              + f"; at {SUB}: frame {res['sub_frame_ms']:.3f} ms, subcluster "
              + ", ".join(f"{kind(w)} {w['ms']:.3f} ms" for w in res["sub"])
              + "".join(f"; mxu {prec} " + ", ".join(
                  f"{kind(w)} {w['ms']:.3f} ms" for w in walks)
                  for prec, walks in res.get("mxu", {}).items())
              + "".join(
                  f"; {src} registers {'/'.join(r)} (spill stores "
                  f"{res['spill_store_bytes'].get(src, 0)} bytes)"
                  for src, r in res["registers"].items()), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "turns": turns},
                                   indent=1))
    print(card)


if __name__ == "__main__":
    main()
