"""The north-star accuracy gate of lightgbm_tpu_torch on one NVIDIA GPU.

    python3 scripts/bench_torch.py [--out PATH] [--histogram-dtype int8]

Trains the north-star workload at full shape through the port's public
API: synth_higgs(10_500_000) x 28 (seed 42), gbdt with NORTH_STAR_PARAMS
(255 leaves, max_bin 255, lr 0.1, min_data_in_leaf 1,
min_sum_hessian_in_leaf 100, int8 histograms), 500 iterations, with a
500,000-row test set (seed 7, the same labeling function) added as a
valid set, so the tree walk scores it on the device every iteration and
its AUC comes back through `evals_result`.  It does not import bench.py
or the JAX package: the data comes from lightgbm_tpu_torch.synth, a copy
of bench.py's generator.

Writes the fields of northstar_measured.json (workload, rows, iters,
data_gen_seconds, bin_seconds, train_seconds, seconds_per_iter,
test_auc, auc_trajectory every 25 iterations), the card's name and power
limit, the commit (from git, or --commit where the checkout has no
.git), the reference's AUC and its difference, and a cross-check: the
last model's Booster.predict(raw_score=True) on the first 50,000 test
rows against the device-scored valid set, which must agree within 1e-4.
Exits non-zero when no CUDA device is visible or the cross-check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROWS = 10_500_000
TEST_ROWS = 500_000
ITERS = 500
EVAL_KEEP = 25
CHECK_ROWS = 50_000
# northstar_measured.json: the JAX package's 500-iteration test AUC
REFERENCE_AUC = 0.889807


def _commit(fallback: str) -> str:
    try:
        r = subprocess.run(["git", "describe", "--always", "--dirty"],
                           cwd=ROOT, capture_output=True, text=True)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip()
    except OSError:
        pass
    return fallback


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "northstar_torch_measured.json"))
    ap.add_argument("--histogram-dtype", default="int8")
    ap.add_argument("--commit", default="unknown")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device is visible", file=sys.stderr)
        sys.exit(2)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs

    params = dict(NORTH_STAR_PARAMS, device_type="cuda",
                  histogram_dtype=args.histogram_dtype)
    t0 = time.perf_counter()
    X, y = synth_higgs(ROWS, seed=42)
    Xt, yt = synth_higgs(TEST_ROWS, seed=7)
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    train = lt.Dataset(X, y, params=params).construct()
    test = lt.Dataset(Xt, yt, reference=train, params=params).construct()
    t_bin = time.perf_counter() - t0

    res = {}

    def progress(env):
        it = env.iteration + 1
        if it % EVAL_KEEP == 0 or it == ITERS:
            auc = env.evaluation_result_list[-1][2]
            el = time.perf_counter() - t_start
            print(f"iter {it}: test auc {auc:.6f} ({el:.1f} s, "
                  f"{el / it:.4f} s/iter)", flush=True)

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    bst = lt.train(params, train, ITERS, valid_sets=[test],
                   valid_names=["test"], evals_result=res,
                   callbacks=[progress], verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t_start
    aucs = res["test"]["auc"]
    if len(aucs) != ITERS:
        print(f"bench_torch: training stopped after {len(aucs)} of {ITERS} "
              "iterations", file=sys.stderr)
        sys.exit(1)

    dev = bst._gbdt.valid_sets[0][2].score[0, :CHECK_ROWS].double().cpu()
    host = bst.predict(Xt[:CHECK_ROWS], raw_score=True)
    check_err = float(np.abs(dev.numpy() - host).max())

    test_auc = round(float(aucs[-1]), 6)
    out = {
        "workload": ("synthetic HIGGS-shaped binary: 10,500,000 x 28 dense "
                     "numerical (lightgbm_tpu_torch.synth.synth_higgs seed "
                     "42), test 500,000 rows (seed 7, same labeling "
                     "function), gbdt, num_leaves=255, max_bin=255, "
                     "lr=0.1, min_data_in_leaf=1, "
                     "min_sum_hessian_in_leaf=100, 500 iterations "
                     f"[histogram_dtype={args.histogram_dtype}]"),
        "package": "lightgbm_tpu_torch",
        "measured_at_commit": _commit(args.commit),
        "histogram_dtype": args.histogram_dtype,
        "device": _card(),
        "rows": ROWS, "iters": ITERS,
        "data_gen_seconds": round(t_gen, 1),
        "bin_seconds": round(t_bin, 1),
        "train_seconds": round(t_train, 1),
        "seconds_per_iter": round(t_train / ITERS, 4),
        "test_auc_evaluated": "every iteration, on the device",
        "test_auc": test_auc,
        "auc_trajectory": {str(i): round(float(aucs[i - 1]), 6)
                           for i in range(EVAL_KEEP, ITERS + 1, EVAL_KEEP)},
        "reference_test_auc": REFERENCE_AUC,
        "auc_delta_vs_reference": round(test_auc - REFERENCE_AUC, 6),
        "gate": "|test_auc - 0.889807| <= 0.001",
        "gate_met": abs(test_auc - REFERENCE_AUC) <= 0.001,
        "host_syncs_per_tree": round(float(np.mean(
            bst._gbdt.host_syncs_per_tree)), 3),
        "predict_vs_device_valid_max_abs": check_err,
        "predict_check_rows": CHECK_ROWS,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    if not check_err <= 1e-4:
        print(f"bench_torch: Booster.predict disagrees with the device-"
              f"scored test set: {check_err}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
