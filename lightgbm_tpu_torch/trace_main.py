"""Where the time of a boosting iteration goes, on the GPU.

    python -m lightgbm_tpu_torch.trace_main
        [--workload higgs|ctr|onehot|regression|multiclass|goss|dart]
        [--histogram-dtype int8|float32] [--rows N] [--trace PATH]

Trains a configuration that chip_smoke.py runs — the north-star one
(binary, `synth_higgs(N)` x 28, 255 leaves, max_bin 255, int8
histograms, or float32 ones with --histogram-dtype float32, a valid set
of N/10 rows scored with AUC each iteration),
with `--workload ctr` the CTR one (lambdarank on `synth_ctr(N)` x 50,000
over the sparse store, CTR_PARAMS, a 4,080-row valid set scored with
NDCG), or with `--workload onehot` the EFB one (`synth_onehot(N)`, 240
one-hot features bundled into 40 store columns, ONEHOT_PARAMS, the exact
leaf-wise learner, a valid set of N/10 rows scored with AUC), or with
`--workload regression|multiclass` chip_smoke.py's phase-13 ones (the
north-star rows with synth_higgs's labeling function left unthresholded
as an L2 target, or cut at its 20/40/60/80% quantiles into 5 classes,
K = 5 trees an iteration; l2 / multi_logloss on N/10 valid rows), or
with `--workload goss|dart` chip_smoke.py's phase-14 ones (the
north-star configuration with boosting=goss, top_rate 0.2, other_rate
0.1, or boosting=dart, drop_rate 0.1) — for 2 warm-up iterations (goss:
10, its sampling warm-up at lr 0.1, so the traced iterations are
sampled; dart: 5, so each traced iteration drops trees: drop_seed's
draws drop 2, 1 and 1 trees in iterations 6-8), then traces 3 more with
torch.profiler (CPU and CUDA activities).  Prints one JSON line: wall seconds per
traced iteration, device busy seconds (union of the kernel intervals)
and the idle share, kernel launches per iteration, the device time of
this package's kernels and of everything else, and the top device
kernels and host ops.
With --trace it also writes the Chrome trace.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

TRACED = 3
WARMUP = 2
# the boosting variants of phase 14, and their warm-ups (see above)
BOOSTING = {"goss": {"boosting": "goss", "top_rate": 0.2,
                     "other_rate": 0.1},
            "dart": {"boosting": "dart", "drop_rate": 0.1}}
WARMUPS = {"goss": 10, "dart": 5}
# the kernel symbols of csrc/, by the name chip_smoke.py reports
OWN_KERNELS = {"hist_q_kernel": "hist_masked_int8 (K1)",
               "hist_owned_kernel": "hist_masked_f32 (K2)",
               "lookup_kernel": "table_lookup (K3)",
               "partition_kernel": "partition_rows (K4)",
               "hist_sparse_kernel": "hist_sparse (K7/K8)",
               "pack_rows_kernel": "hist_sparse (K7/K8)",
               "hist_gathered_kernel": "hist_gathered (K5)",
               "hist_multirow_kernel": "hist_multirow (K6)"}


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=("higgs", "ctr", "onehot",
                                           "regression", "multiclass",
                                           "goss", "dart"),
                    default="higgs")
    ap.add_argument("--histogram-dtype", choices=("int8", "float32"),
                    default="int8",
                    help="histogram_dtype of the north-star rows' workloads")
    ap.add_argument("--rows", type=int, default=0,
                    help="training rows (default 2M higgs and onehot, "
                         "500k ctr)")
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_main: no CUDA device is visible", file=sys.stderr)
        sys.exit(2)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import synth

    if args.workload == "ctr":
        args.rows = args.rows or 500_000
        params = dict(synth.CTR_PARAMS)
        X, y, g = synth.synth_ctr(args.rows)
        Xv, yv, gv = synth.synth_ctr(4_080, seed=7)
        ds = lt.Dataset(X, y, group=g, params=params)
        vs = lt.Dataset(Xv.toarray(), yv, group=gv, reference=ds,
                        params=params)
    elif args.workload == "onehot":
        args.rows = args.rows or 2_000_000
        params = dict(synth.ONEHOT_PARAMS, tree_growth="exact")
        X, y = synth.synth_onehot(args.rows)
        Xv, yv = synth.synth_onehot(args.rows // 10, seed=7)
        ds = lt.Dataset(X, y, params=params)
        vs = lt.Dataset(Xv, yv, reference=ds, params=params)
    elif args.workload in ("regression", "multiclass"):
        import numpy as np
        args.rows = args.rows or 2_000_000
        X, t = synth.synth_higgs_target(args.rows)
        Xv, tv = synth.synth_higgs_target(args.rows // 10, seed=7)
        if args.workload == "multiclass":
            cuts = np.quantile(t, [0.2, 0.4, 0.6, 0.8])
            y, yv = (synth.quantile_classes(t, cuts),
                     synth.quantile_classes(tv, cuts))
            extra = {"num_class": 5, "metric": "multi_logloss"}
        else:
            y, yv, extra = t, tv, {"metric": "l2"}
        params = dict(synth.NORTH_STAR_PARAMS, objective=args.workload,
                      histogram_dtype=args.histogram_dtype, **extra)
        ds = lt.Dataset(X, y, params=params)
        vs = lt.Dataset(Xv, yv, reference=ds, params=params)
    else:
        args.rows = args.rows or 2_000_000
        params = dict(synth.NORTH_STAR_PARAMS,
                      histogram_dtype=args.histogram_dtype,
                      **BOOSTING.get(args.workload, {}))
        X, y = synth.synth_higgs(args.rows)
        Xv, yv = synth.synth_higgs(args.rows // 10, seed=7)
        ds = lt.Dataset(X, y, params=params)
        vs = lt.Dataset(Xv, yv, reference=ds, params=params)
    bst = lt.Booster(params=params, train_set=ds)
    bst.add_valid(vs, "valid")
    for _ in range(WARMUPS.get(args.workload, WARMUP)):
        bst.update()
        bst.eval_valid()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            bst.update()
            bst.eval_valid()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = _union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) * 1e-6
    own = {v: 0.0 for v in OWN_KERNELS.values()}
    other = 0.0
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) * 1e-6
        tag = next((v for k, v in OWN_KERNELS.items() if k in e.name), None)
        if tag is None:
            other += dur
        else:
            own[tag] += dur
    avg = prof.key_averages()
    top_dev = sorted((a for a in avg if a.self_device_time_total > 0),
                     key=lambda a: -a.self_device_time_total)[:12]
    top_cpu = sorted(avg, key=lambda a: -a.self_cpu_time_total)[:12]
    out = {
        "device": torch.cuda.get_device_name(0),
        "workload": args.workload, "rows": args.rows,
        "histogram_dtype": params.get("histogram_dtype"),
        "traced_iterations": TRACED,
        "wall_s_per_iter": wall / TRACED,
        "device_busy_s_per_iter": busy_s / TRACED,
        "device_idle_share": 1.0 - busy_s / wall,
        "kernel_launches_per_iter": len(kernels) / TRACED,
        "own_kernels_s_per_iter": {k: v / TRACED for k, v in own.items()},
        "other_kernels_s_per_iter": other / TRACED,
        "boosting": type(bst._gbdt).__name__,
        "trees_per_iteration": bst._gbdt.K,
        "host_syncs_per_tree": bst._gbdt.host_syncs_per_tree[-1],
        "top_device": [[a.key[:80], a.self_device_time_total * 1e-6 / TRACED,
                        a.count // TRACED] for a in top_dev],
        "top_host_self": [[a.key[:80], a.self_cpu_time_total * 1e-6 / TRACED,
                           a.count // TRACED] for a in top_cpu],
    }
    print(json.dumps(out))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
