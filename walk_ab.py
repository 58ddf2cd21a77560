"""Time the bench frame and its two walk calls in several checkouts of the
port on one card, in turns.

    python3 walk_ab.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout (this one is ``.``).  Every turn is a
fresh process that imports ``raytpu_torch`` and ``chip_smoke`` from its
tree, builds that tree's kernels, bakes bench.py's terrain and times, with
CUDA events, the 1024x1024 frame (primary + shadow rays), each of its
walk calls and, where the tree has it, the prepick walk (64 picks) on the
same queries.  The trees run in the given order, then in reverse (A, B, B,
A), so that drift of the card shows.  Prints one line per turn, the card's
name and power limit, and writes all of it as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# Run inside each tree: only what every checkout of the port has.
_TURN = r'''
import json, sys, torch
import chip_smoke as cs
PICKS = 64
from raytpu_torch import Quantize, RenderConfig
from raytpu_torch.kernels import fused
from raytpu_torch.kernels.build import build_library
from raytpu_torch.render.wavefront import render_rays

_, _, log = build_library()
regs = [line.split("Used ")[1].split(" registers")[0]
        for line in log.splitlines() if "registers" in line]
spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
             for line in log.splitlines() if "spill stores" in line)
dev = torch.device("cuda")
flat = cs.bench_scene(cs.TRIS).flatten(cluster_size=cs.CLUSTER_SIZE,
                                       device=dev)
cfg = RenderConfig(width=cs.RES, height=cs.RES, max_reflections=0,
                   tile_pixels=cs.RES ** 2, quantize=Quantize.NONE)
o, d = cs._frame_rays(cs.RES, dev)
frame_ms = cs._cuda_ms(lambda: render_rays(flat, cfg, o, d), 8)
with cs.recording_walks() as calls:
    render_rays(flat, cfg, o, d)
walks = [{"any_hit": kw["any_hit"],
          "ms": cs._cuda_ms(lambda: fused.walk_cuda(c, s, q, **kw), 16)}
         for c, s, q, kw, _ in calls]
# The prepick walk on the same queries, in a tree that has it.
prepick = [{"any_hit": kw["any_hit"],
            "ms": cs._cuda_ms(lambda: fused.prepick_cuda(
                c, s, q, cull=kw["cull"], any_hit=kw["any_hit"],
                picks=PICKS), 16)}
           for c, s, q, kw, _ in calls] if hasattr(fused, "prepick_cuda") \
    else []
print(json.dumps({"frame_ms": frame_ms, "walks": walks, "prepick": prepick,
                  "registers": regs, "spill_store_bytes": spills}))
'''


def _turn(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


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
    turns = []
    for tree in args.trees + args.trees[::-1]:
        res = _turn(tree.resolve())
        turns.append({"tree": str(tree), **res})
        print(f"{tree}: frame {res['frame_ms']:.3f} ms; walks "
              + ", ".join(f"{'any_hit' if w['any_hit'] else 'nearest'} "
                          f"{w['ms']:.3f} ms" for w in res["walks"])
              + "".join(f", prepick {w['ms']:.3f} ms" for w in res["prepick"])
              + f"; registers {'/'.join(res['registers'])}, spill stores "
              f"{res['spill_store_bytes']} bytes", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "turns": turns},
                                   indent=1))
    print(card)


if __name__ == "__main__":
    main()
