"""Multi-GPU training of lightgbm_tpu_torch on one host: one rank a card,
over NCCL.

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/bench_torch_multigpu.py [--rows 2000000] [--out PATH]

Every rank builds the north-star dataset (synth_higgs(rows) x 28, seed
42, NORTH_STAR_PARAMS: 255 leaves, max_bin 255, lr 0.1, int8 histograms;
a 200,000-row valid set of seed 7 scored with AUC every iteration, as
chip_smoke.py's phase 3) and trains it through lightgbm_tpu_torch.train
with tree_learner=data (the rounds learner, rows sharded over every
card, the psum_scatter exchange that `auto` picks at this payload) and
tree_learner=data2d (rows over both axes of the 2 x 2 mesh), 2 warm-up
and 10 timed iterations each (s/iter: the host clock between device
synchronisations at the end of iterations 2 and 12), and then the fused
builder feature-parallel (tree_learner=feature) for 3 iterations under
HotPathSanitizer(warmup=1, strict): under NCCL no collective is staged
through the host, so a tree after the first makes no synchronising call
but its one packed read.

Then rank 0 trains the one-rank models on its own card (the same
parameters with tree_learner=serial; for the fused one tree_growth=exact)
and holds the ranks' models against them: int8 trees bitwise (integer
histogram sums, scales shared by the world), the fused float32 tree's
structure equal and its float lines within rtol 1e-4
(lightgbm_tpu_torch.diagnostics.worlds.compare_models).  Every rank's model string must be rank 0's.  Rank 0 prints
one JSON object (s/iter of each mesh run and of the one-rank run in the
same call, collective bytes and calls a tree, AUC, the card's name and
power limit) and writes it to --out.  Exits non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VALID_ROWS = 200_000
WARMUP, TOTAL = 2, 12
FUSED_ITERS = 3


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def _train(lt, torch, params, ds, vs, total, warmup, callbacks=()):
    """(booster, s/iter over iterations warmup+1..total, last AUC)."""
    marks, res = [], {}

    def mark(env):
        if env.iteration + 1 in (warmup, total):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
    bst = lt.train(params, ds, total, valid_sets=[vs], evals_result=res,
                   callbacks=[mark, *callbacks], verbose_eval=False)
    return (bst, (marks[1] - marks[0]) / (total - warmup),
            res["valid_0"]["auc"][-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_multigpu: no CUDA device is visible",
              file=sys.stderr)
        sys.exit(2)
    import torch.distributed as dist
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import distributed as D
    from lightgbm_tpu_torch import kernels
    from lightgbm_tpu_torch.diagnostics.sanitize import (HotPathSanitizer,
                                                         fused_tree_steps)
    from lightgbm_tpu_torch.diagnostics.worlds import compare_models
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs
    if not D.init_distributed(0, device_type="cuda"):
        print("bench_torch_multigpu: start it with python -m "
              "torch.distributed.run --nproc-per-node N", file=sys.stderr)
        sys.exit(2)
    rank, world = dist.get_rank(), dist.get_world_size()
    card = _card()
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    X, y = synth_higgs(args.rows)
    Xv, yv = synth_higgs(VALID_ROWS, seed=7)
    base = dict(NORTH_STAR_PARAMS, device_type="cuda", metric="auc")
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, params=base).construct()
    vs = lt.Dataset(Xv, yv, reference=ds, params=base).construct()
    setup_s = time.perf_counter() - t0
    runs, models = {}, {}
    for name, over in (("data", dict(tree_learner="data")),
                       ("data2d", dict(tree_learner="data2d"))):
        dist.barrier()
        bst, s_iter, auc = _train(lt, torch, dict(base, **over), ds, vs,
                                  TOTAL, WARMUP)
        mesh = bst._gbdt.learner.mesh
        models[name] = bst.model_to_string()
        runs[name] = dict(s_iter=s_iter, auc=auc, mesh=list(mesh.shape),
                          backend=mesh.backend,
                          hist_exchange=bst._gbdt.learner.hist_exchange,
                          collective_bytes_per_tree=mesh.collective_bytes
                          / TOTAL,
                          collective_calls_per_tree=mesh.collective_calls
                          / TOTAL)
    dist.barrier()
    with HotPathSanitizer(warmup=1, strict=True, label="feature") as san:
        with fused_tree_steps(san):
            bst, s_iter, auc = _train(
                lt, torch, dict(base, tree_learner="feature"), ds, vs,
                FUSED_ITERS, 1)
    san.check()
    mesh = bst._gbdt.learner.mesh
    models["feature"] = bst.model_to_string()
    runs["feature"] = dict(s_iter=s_iter, auc=auc, mesh=list(mesh.shape),
                           backend=mesh.backend,
                           implicit_transfers=san.implicit_transfers,
                           steps=san.steps,
                           collective_bytes_per_tree=mesh.collective_bytes
                           / FUSED_ITERS,
                           collective_calls_per_tree=mesh.collective_calls
                           / FUSED_ITERS)
    # every rank's model strings are rank 0's
    dig = np.array([int.from_bytes(hashlib.sha1(
        models[k].encode()).digest()[:8], "little", signed=True)
        for k in sorted(models)], np.int64)
    allg = D.allgather_f64(dig.view(np.float64)).view(np.int64)
    if not (allg == allg[0]).all():
        raise SystemExit(f"ranks' model strings differ: {allg.tolist()}")
    if rank == 0:
        one = {}
        bst, s_iter, auc = _train(lt, torch, base, ds, vs, TOTAL, WARMUP)
        one["rounds"] = dict(s_iter=s_iter, auc=auc)
        ref = bst.model_to_string()
        bst, s_iter, auc = _train(lt, torch, dict(base, tree_growth="exact"),
                                  ds, vs, FUSED_ITERS, 1)
        one["fused"] = dict(s_iter=s_iter, auc=auc)
        trees = {"data": compare_models(ref, models["data"], True),
                 "data2d": compare_models(ref, models["data2d"], True),
                 "feature": compare_models(bst.model_to_string(),
                                           models["feature"], False)}
        out = dict(workload="north-star", rows=args.rows,
                   valid_rows=VALID_ROWS, world=world, card=card,
                   torch=torch.__version__, build_s=build_s,
                   setup_s=setup_s, iterations=[WARMUP, TOTAL],
                   fused_iterations=FUSED_ITERS, mesh_runs=runs,
                   one_rank=one, trees_equal=trees,
                   speedup_data=one["rounds"]["s_iter"]
                   / runs["data"]["s_iter"],
                   speedup_data2d=one["rounds"]["s_iter"]
                   / runs["data2d"]["s_iter"])
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
