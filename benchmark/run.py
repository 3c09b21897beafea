"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

The cell's traffic names the loop (loops/<loop>.py) that does its
set-up (timed from process start as `setup_s`), drives the window for
--seconds, with --trace 1 profiles a slice after it, and, once the
device's peak memory is read and the program's state freed, works out
the numbers that the plain reference compares.  Each is held against
the configuration's limit for it.  With --trace 1 the per-layer metrics
are read, without it the end-to-end ones, each by its reader in
metrics/.  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are also the last lines of
standard error.

Exits with 2, printing no result, when no CUDA device is visible or the
cell asks for more devices than there are, and with 3 when a module of
JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from . import spec  # noqa: E402

# top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", sizes: Optional[Dict] = None,
             params: Optional[Dict] = None, t0: float = T0) -> Dict:
    """One run of a cell; returns the result object.  `sizes` and
    `params` are laid over the configuration's (tests run it small, on
    the CPU; the control lowers its precision)."""
    bench = spec.load()
    cell = spec.cell(bench, name)
    cfg = dict(spec.config(bench, cell), **(sizes or {}))
    traffic = spec.traffic(cell)
    dev = torch.device(device)
    run = spec.loop(traffic).run(cfg, traffic, seed, seconds, trace, dev,
                                 params or {}, t0)
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in run.checks.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    metrics = {}
    for m in spec.metrics(bench, cell, trace):
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.slice_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
