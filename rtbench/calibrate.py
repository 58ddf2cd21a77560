"""The readings the correctness limits are set from (rtbench/limits/), for
one cell, in one process on the card:

    python3 -m rtbench.calibrate --workload <cell> --first <seed> --seeds 12 \
        --control 3 --items 8 --out cal_<cell>.json

- the program's numbers on ``--seeds`` seeds from ``--first`` on: each seed
  as a run makes it (its first pose or fit start, its checked frames drawn
  from ``--items`` frames rendered at the cell's size, or its checked fit
  steps), compared with the float32 reference;
- the control on ``--control`` of those seeds: the reference computed in
  bfloat16 put in the program's place, compared with the float32
  reference;
- for a fit cell, the faults of its mix (``faults``: "half the batch
  left out, the mean taken over the rest", and for the textured fit "the
  texel gradient dropped") on the same seeds, in the reference put in the
  program's place (the fault "a step that returns its state unchanged"
  reads 1 on the change without a run).

The cell's scene and mix are found by name as a run finds them
(workload.py's ``scene_module`` and ``mix_class``).

The benchmark's own runs never run this.
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
    p.add_argument("--first", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--items", type=int, default=8)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA card")
    spec = json.loads((workload.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    config = workload.load("configs", cell["config"])
    traffic = workload.load("traffic", cell["traffic"])
    dev = "cuda"
    scenes, mix_class = (workload.scene_module(config),
                         workload.mix_class(traffic))
    arrays = scenes.build(config)
    t0 = time.perf_counter()
    ref = scenes.reference(arrays, dev)
    print(f"[calibrate] reference scene {time.perf_counter() - t0:.2f} s",
          flush=True)
    seeds = [args.first + i for i in range(args.seeds)]
    faults = getattr(mix_class, "faults", {})
    out = {"cell": args.workload, "card": torch.cuda.get_device_name(0),
           "program": {}, "control": {}, **{f: {} for f in faults}}
    mix = None
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if traffic["kind"] == "orbit":
            if mix is None:
                mix = mix_class(arrays, config, traffic, seed, dev)
            mix.reseed(seed)
            for _ in range(args.items):
                mix.item()
            got = [torch.as_tensor(np.ascontiguousarray(f), device=dev)
                   for _, _, f in mix.keep]
            nums = workload.compare_frames(got, mix.reference_frames(ref))
            if n < args.control:
                low = mix.reference_frames(ref, torch.bfloat16)
                out["control"][seed] = workload.compare_frames(
                    low, mix.reference_frames(ref))
        else:
            mix = mix_class(arrays, config, traffic, seed, dev,
                            flat=None if mix is None else mix.flat)
            mix.warm_up()
            want = mix.reference_steps(ref)
            nums = workload.compare_fit(mix.record, want)
            out.setdefault("records", {})[seed] = {"program": mix.record,
                                                   "reference": want}
            if n < args.control:
                low = mix.reference_steps(ref, torch.bfloat16)
                out["control"][seed] = workload.compare_fit(low, want)
                for fault, kw in faults.items():
                    out[fault][seed] = workload.compare_fit(
                        mix.reference_steps(ref, **kw), want)
        out["program"][seed] = nums
        print(f"[calibrate] seed {seed}: {nums}; " + "; ".join(
            f"{part} {out[part].get(seed)}" for part in ("control", *faults))
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    for part in ("program", "control", *faults):
        vals = out[part]
        if vals:
            keys = next(iter(vals.values())).keys()
            print(f"[calibrate] {part}: " + "; ".join(
                f"{k} min {min(v[k] for v in vals.values())!r} max "
                f"{max(v[k] for v in vals.values())!r}" for k in keys))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
