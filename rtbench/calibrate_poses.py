"""The readings the correctness limit of a turntable cell is set from, on
every pose of one turn, in one process on the card:

    python3 -m rtbench.calibrate_poses --workload <cell> --control 12 \
        --out cal_<cell>.json

A turntable whose window starts at the same pose for every seed
(mixes/turntable.py) renders the same frames for every seed, and a seed
draws only which of them are checked; so every run's reading is one of
the poses' readings here:

- the program's frame of each pose, as a run renders it, against the
  float32 reference;
- the control on the first ``--control`` poses: the reference computed in
  bfloat16 put in the program's place;
- each fault of the mix (``faults``: the refraction child dropped, one
  bounce fewer, the texture ignored, opaque shadow occluders), planted in
  the reference put in the program's place, on every pose.

rtbench/calibrate.py covers the seeds' own runs.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from rtbench import workload


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", type=int, default=12)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_poses needs a CUDA card")
    spec = json.loads((workload.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    config = workload.load("configs", cell["config"])
    traffic = workload.load("traffic", cell["traffic"])
    dev = "cuda"
    scenes = workload.scene_module(config)
    arrays = scenes.build(config)
    mix = workload.mix_class(traffic)(arrays, config, traffic, 0, dev)
    ref = scenes.reference(arrays, dev)
    faults = getattr(mix, "faults", {})
    parts = ("program", "control", *faults)
    out = {"cell": args.workload, "card": torch.cuda.get_device_name(0),
           **{part: {} for part in parts}}
    for k in range(traffic["poses_per_turn"]):
        t0 = time.perf_counter()
        frame = mix.render(k)
        mix.keep = [(0, k, frame.copy())]
        want = mix.reference_frames(ref)
        got = [torch.as_tensor(np.ascontiguousarray(frame), device=dev)]
        out["program"][k] = workload.compare_frames(got, want)
        if k < args.control:
            out["control"][k] = workload.compare_frames(
                mix.reference_frames(ref, torch.bfloat16), want)
        for fault, kw in faults.items():
            out[fault][k] = workload.compare_frames(
                mix.reference_frames(ref, **kw), want)
        print(f"[calibrate] pose {k}: " + "; ".join(
            f"{part} {out[part].get(k)}" for part in parts)
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    for part in parts:
        vals = [v["bad_px_ppm"] for v in out[part].values()]
        if vals:
            print(f"[calibrate] {part}: bad_px_ppm min {min(vals)!r} max "
                  f"{max(vals)!r}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
