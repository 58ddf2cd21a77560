"""Run one cell of the benchmark once and print its result line.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell, its configuration and traffic mix
and its metrics are found by name: ``BENCHMARK.json`` lists them, the files
are ``rtbench/configs/<config>.json``, ``rtbench/traffic/<traffic>.json``,
``rtbench/metrics/<metric>.py`` and ``rtbench/limits/<cell>.json`` (the
limits of the correctness check), and a configuration's scene and a
traffic's mix where they name one (``rtbench/scenes/<scene>.py``,
``rtbench/mixes/<mix>.py``: workload.py).  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` runs the window under torch.profiler and
reports its per-layer metrics.  It needs a CUDA card: without one it exits
with 2 and prints no result.  The last line of standard output is the
result, one JSON object; the numbers compared with the plain reference
come last on standard error, each beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Kernel caches at fixed paths inside the checkout, so that only the first
# run of a cell in a checkout builds (the port's own nvcc build goes to
# build/raytpu_torch/, fixed in raytpu_torch/kernels/build.py).
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton",
          "CUDA_CACHE_PATH": "build/cuda_cache"}
BANNED = ("jax", "jaxlib", "flax", "optax", "raytpu")
# glibc's mallopt parameters: blocks up to 64 MiB come from the heap, and
# the heap keeps up to 1 GiB when freed.  A frame's host arrays (25 MB at
# 1080p) then reuse pages already mapped instead of faulting in fresh
# ones on every frame, which swung frame times by half between runs.
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
HEAP_BLOCKS, HEAP_KEEP = 64 << 20, 1 << 30


def steady_heap():
    import ctypes

    libc = ctypes.CDLL("libc.so.6")
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.mallopt(M_MMAP_THRESHOLD, HEAP_BLOCKS)
    libc.mallopt(M_TRIM_THRESHOLD, HEAP_KEEP)


def banned_modules(modules) -> list:
    """Loaded modules whose top-level name is banned (whole names:
    ``raytpu_torch`` is the program, ``raytpu`` the JAX package)."""
    return sorted({m.split(".")[0] for m in modules} & set(BANNED))


def load_metric(name: str):
    from rtbench.workload import load_module

    return load_module("metrics", name)


def cell_metrics(spec: dict, cell: str, traced: bool) -> list:
    """The cell's metric entries: per-layer when traced, else end-to-end;
    an entry without ``workloads`` holds for every cell."""
    entries = spec["per_layer" if traced else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def read_metrics(spec, run, traced) -> dict:
    out = {}
    for m in cell_metrics(spec, run.cell, traced):
        value = load_metric(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card_line() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return (f"[card] {torch.cuda.get_device_name(0)}; power.limit "
            f"{smi[0].split(',')[-1].strip() if smi else 'not read'}; torch "
            f"{torch.__version__}; CUDA {torch.version.cuda}")


def rate_line(run) -> str:
    """rays/s of the window: 2 rays a pixel (primary and shadow) per frame
    or per fit step (bench.py's counts)."""
    t = run.traffic
    per = 2 * t["width"] * t["height"]
    kind = "backward rays/s" if run.kind == "fit" else "rays/s"
    return (f"[rate] {run.items} items in {run.window_s:.3f} s: "
            f"{per * run.items / run.window_s:.6g} {kind} (2 rays a pixel)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    steady_heap()
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)

    import torch

    from rtbench import workload

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch "
              f"finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import raytpu_torch  # noqa: F401  (the program must be here)

    torch.set_num_threads(1)
    print(card_line(), flush=True)
    device = "cuda"
    traced = bool(args.trace)
    limits = workload.limits(args.workload)
    run, arrays, peak = workload.run_cell(spec, args.workload, args.seed,
                                          args.seconds, traced, device, T0)
    print(rate_line(run), flush=True)
    metrics = read_metrics(spec, run, traced)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"attempted": run.items, "failed": 0}
    if traced:
        if run.summary is None:
            print("torch.profiler recorded no device time", file=sys.stderr)
            return 3
        dev["busy_s"] = run.summary.busy_us / 1e6
        dev["window_s"] = run.summary.window_us / 1e6
        result["breakdown"] = run.summary.breakdown()
    t_check = time.perf_counter()
    checks = workload.check(run, arrays, device, limits)
    print(f"[check] the reference took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    found = banned_modules(sys.modules)
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    correct = run.items > 0 and all(v <= lim for v, lim in checks.values())
    line = {"correct": correct, **result, "metrics": metrics, "device": dev}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"[check] {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
