"""Smoke run of lightgbm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build   — compile every CUDA kernel of lightgbm_tpu_torch/csrc/ (one
             nvcc per source, in parallel) and print the seconds taken.
2. kernels — each kernel against its plain PyTorch version on the card,
             on seeded inputs at the main path's shapes: K1 (int8
             histogram, int32 and int8-stored bins, bitwise) and K2
             (float32 histogram, tolerance below) on a gathered pass and
             on a tree's root pass (masked feed, one slot, every row;
             dyadic values, so K2 is bitwise there too), K3 (lookup fused
             with the score add, and one level of the valid-set walk,
             bitwise), K4 (row partition, bitwise); median times of
             kernel, plain version and, where one exists, a single
             PyTorch call computing the same function (library_ms).  The
             {"kernels"} line reports the gathered pass for K1/K2 and the
             score add for K3; the other shapes are printed on their own
             lines.
3. main    — lightgbm_tpu_torch.train on synth_higgs(2_000_000) x 28
             (255 leaves, max_bin 255, int8 histograms, a 200k-row valid
             set scored with AUC each iteration; 2 warm-up and 10 timed
             iterations, timed as the difference of a 12- and a
             2-iteration train), then Booster.predict; launch counts are
             zeroed before and read after, and every kernel of the path
             must have launched.  The float32-histogram path is driven
             the same way (1 warm-up, 2 timed) so that K2 launches.
4. card vs CPU — 5 iterations on synth_higgs(50_000) on the CPU (plain
             versions) and on the card (kernels): the first trees must be
             identical unless their first differing split is an f32 gain
             tie, and the valid AUCs must agree within 1e-4.

Prints the card's name and power limit, one {"kernels": [...]} JSON line,
and last {"ok": true, "device": {...}}.  Exits with 2 and no result when
no CUDA device is visible.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): device-memory rate, and the
# float32 / int32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# K2 tolerance: float atomics add a cell's values in a run-dependent
# order; n f32 additions reorder within n * 2^-24 * sum|x|, which for the
# ~60 rows of |x| <= 4 that a cell receives here stays below 1e-3
K2_ATOL = 1e-3

# shapes: a gathered histogram pass at the capacity tier of a 10.5M-row
# training set, the row counts of the main path, the card-vs-CPU run
HIST_ROWS = 1_312_512
MAIN_ROWS = 2_000_000
VALID_ROWS = 200_000
COMPARE_ROWS = 50_000
GPU = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_kernels(torch, kernels, H, LK, P):
    dev = torch.device(GPU)
    rng = np.random.RandomState(7)
    rows = []

    # ---- K1 / K2: one gathered pass at a capacity tier ------------------
    F, B, K, C = 28, 256, 84, HIST_ROWS
    N = 2 * C
    bins_np = rng.randint(0, 255, size=(F, N)).astype(np.int32)
    counts = rng.multinomial(int(C * 0.95), np.full(K, 1.0 / K))
    lid_np = np.full(C, -2, np.int32)                 # pad rows past total
    lid_np[:counts.sum()] = np.repeat(np.arange(K), counts)
    row_idx_np = np.sort(rng.choice(N, C, replace=False)).astype(np.int32)
    sl_np = np.arange(K, dtype=np.int32)
    sl_np[[5, 40, 83]] = -1                           # empty slots
    g = (rng.randn(C) * (lid_np >= 0)).astype(np.float32)
    h = (rng.rand(C) * 0.25 * (lid_np >= 0)).astype(np.float32)
    gh = torch.as_tensor(np.stack([g, h, (lid_np >= 0).astype(np.float32)]),
                         device=dev)
    ghq, _, _ = H._quantize_gh(gh)
    lid = torch.as_tensor(lid_np, device=dev)
    row_idx = torch.as_tensor(row_idx_np, device=dev)
    sl = torch.as_tensor(sl_np, device=dev)
    bins32 = torch.as_tensor(bins_np, device=dev)
    bins8 = (bins32 - 128).to(torch.int8)
    match = np.isin(lid_np, sl_np[sl_np >= 0])
    n_match = int(match.sum())

    def library_hist(vals, acc_dtype):
        """One index_add_ over a flattened (slot, feature, channel, bin)
        index — the same sums as the kernel, index built beforehand."""
        pos = torch.as_tensor(np.flatnonzero(match), device=dev)
        kk = lid[pos].long()
        b = bins32[:, row_idx[pos].long()].long()           # [F, E]
        f = torch.arange(F, device=dev)[:, None]
        idx = torch.cat([(((kk[None, :] * F + f) * 3 + ch) * B + b).reshape(-1)
                         for ch in range(3)])
        v = torch.cat([vals[ch, pos][None, :].expand(F, -1).reshape(-1)
                       for ch in range(3)]).to(acc_dtype)
        out = torch.zeros(K * F * 3 * B, dtype=acc_dtype, device=dev)
        return lambda: out.zero_().index_add_(0, idx, v)

    for name, vals, acc, replaces in (
            ("hist_masked_int8", ghq, torch.int32,
             "lightgbm_tpu/ops/histogram.py:503"),
            ("hist_masked_f32", gh, torch.float32,
             "lightgbm_tpu/ops/histogram.py:443")):
        errs = []
        for bins in (bins32, bins8):
            got = H._hist_cuda(bins, row_idx, lid, vals, sl, B)
            ref = H._hist_plain(bins, row_idx, lid, vals, sl, B)
            torch.cuda.synchronize()
            err = (got.double() - ref.double()).abs().max().item()
            errs.append(err)
            if name == "hist_masked_int8" and not torch.equal(got, ref):
                fail(f"{name} ({bins.dtype} bins) differs from its plain "
                     f"version: max |diff| {err}")
            if name == "hist_masked_f32" and not err <= K2_ATOL:
                fail(f"{name} ({bins.dtype} bins) max |diff| {err} > "
                     f"{K2_ATOL}")
        ms = time_ms(torch, lambda: H._hist_cuda(bins32, row_idx, lid, vals,
                                                 sl, B), 20)
        plain = time_ms(torch, lambda: H._hist_plain(bins32, row_idx, lid,
                                                     vals, sl, B), 3, 1)
        lib = time_ms(torch, library_hist(vals, acc), 5, 1)
        nbytes = (C * 4 * 2 + K * 4 + n_match * (F * 4 + 12)
                  + K * F * 3 * B * 4)
        bms, by = bound_ms(nbytes, 3.0 * F * n_match)
        rows.append(dict(name=name, route="cuda",
                         source="lightgbm_tpu_torch/csrc/histogram.cu",
                         replaces=replaces, max_abs_err=max(errs), ms=ms,
                         plain_ms=plain, bound_ms=bms, bound_by=by,
                         library_ms=lib))
        print(f"[kernels] {name}: C={C} F={F} K={K} B={B} "
              f"max_abs_err={max(errs):.3g} ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} bound_ms={bms:.4f} ({by})", flush=True)

    # ---- K1 / K2: each tree's root pass, the masked feed (no row index),
    # one slot, every training row in leaf 0.  grad and hess are dyadic
    # (multiples of 2^-6 and 2^-8, |g| < 2^4) so that every partial sum of
    # a cell (~N/255 rows) is exact in f32: any order of the float atomics
    # gives the same sums, and K2 is held bitwise here as well ----------
    Nr = MAIN_ROWS
    pbins = bins32[:, :Nr].contiguous()
    rlid = torch.zeros(Nr, dtype=torch.int32, device=dev)
    rsl = torch.zeros(1, dtype=torch.int32, device=dev)
    rg = np.clip(np.round(rng.randn(Nr) * 64), -1000, 1000) / 64
    rh = np.round(rng.rand(Nr) * 64) / 256
    rgh = torch.as_tensor(np.stack([rg, rh, np.ones(Nr)]).astype(np.float32),
                          device=dev)
    rghq, _, _ = H._quantize_gh(rgh)
    for name, vals in (("hist_masked_int8", rghq), ("hist_masked_f32", rgh)):
        errs = []
        for bins in (pbins, (pbins - 128).to(torch.int8)):
            got = H._hist_cuda(bins, None, rlid, vals, rsl, B)
            ref = H._hist_plain(bins, None, rlid, vals, rsl, B)
            torch.cuda.synchronize()
            err = (got.double() - ref.double()).abs().max().item()
            errs.append(err)
            if not torch.equal(got, ref):
                fail(f"{name} root pass ({bins.dtype} bins) differs from "
                     f"its plain version: max |diff| {err}")
        ms = time_ms(torch, lambda: H._hist_cuda(pbins, None, rlid, vals,
                                                 rsl, B), 20)
        plain = time_ms(torch, lambda: H._hist_plain(pbins, None, rlid,
                                                     vals, rsl, B), 3, 1)
        bms, by = bound_ms(Nr * (4 + F * 4 + 12) + 4 + F * 3 * B * 4,
                           3.0 * F * Nr)
        print(f"[kernels] {name} root pass: C=N={Nr} F={F} K=1 B={B} "
              f"max_abs_err={max(errs):.3g} ms={ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={bms:.4f} ({by})", flush=True)

    # ---- K3: the training-score add, T=1, S=255, N=2M -------------------
    table = torch.as_tensor(rng.randn(1, 255).astype(np.float32), device=dev)
    ids = torch.as_tensor(rng.randint(-1, 255, size=Nr).astype(np.int32),
                          device=dev)
    score = torch.as_tensor(rng.randn(1, Nr).astype(np.float32), device=dev)
    got = LK._lookup_cuda(table, ids, score)
    ref = LK._lookup_plain(table, ids, score)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not torch.equal(got, ref):
        fail(f"table_lookup differs from its plain version: {err}")
    ms = time_ms(torch, lambda: LK._lookup_cuda(table, ids, score), 50)
    plain = time_ms(torch, lambda: LK._lookup_plain(table, ids, score), 10)
    ids_in = ids.clamp(0, 254).long()
    lib = time_ms(torch, lambda: torch.index_select(table[0], 0, ids_in), 50)
    bms, by = bound_ms(Nr * 4 + 255 * 4 + 2 * Nr * 4, Nr)
    rows.append(dict(name="table_lookup", route="cuda",
                     source="lightgbm_tpu_torch/csrc/lookup.cu",
                     replaces="lightgbm_tpu/ops/lookup.py:23",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                     bound_by=by, library_ms=lib))
    print(f"[kernels] table_lookup (fused add): T=1 S=255 N={Nr} "
          f"max_abs_err={err} ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} bound_ms={bms:.4f} ({by})", flush=True)

    # ---- K3: one level of the valid-set walk, T=5 node fields, S=254
    # nodes, no addend ------------------------------------------------------
    Nv, T, Sw = VALID_ROWS, 5, 254
    wtab = torch.as_tensor(rng.randn(T, Sw).astype(np.float32), device=dev)
    wids = torch.as_tensor(rng.randint(0, Sw, size=Nv).astype(np.int32),
                           device=dev)
    got = LK._lookup_cuda(wtab, wids)
    ref = LK._lookup_plain(wtab, wids)
    torch.cuda.synchronize()
    werr = (got - ref).abs().max().item()
    if not torch.equal(got, ref):
        fail(f"table_lookup (walk) differs from its plain version: {werr}")
    wms = time_ms(torch, lambda: LK._lookup_cuda(wtab, wids), 50)
    wplain = time_ms(torch, lambda: LK._lookup_plain(wtab, wids), 10)
    wids_l = wids.long()
    wlib = time_ms(torch, lambda: torch.index_select(wtab, 1, wids_l), 50)
    wbms, wby = bound_ms(Nv * 4 + T * Sw * 4 + T * Nv * 4, T * Nv)
    print(f"[kernels] table_lookup (walk step): T={T} S={Sw} N={Nv} "
          f"max_abs_err={werr} ms={wms:.4f} plain_ms={wplain:.4f} "
          f"library_ms={wlib:.4f} bound_ms={wbms:.4f} ({wby})", flush=True)

    # ---- K4: partition, S=256, N=2M, F=28 -------------------------------
    S = 256
    tbl = np.zeros((7, S), np.float32)
    act = rng.rand(S - 1) < 0.5
    tbl[0, :-1] = np.where(act, rng.randint(0, F, S - 1), 0)
    tbl[1, :-1] = np.where(act, rng.randint(0, 255, S - 1), 0)
    tbl[3, :-1] = np.where(act, np.arange(S - 1) + 128, 0)
    tbl[5] = float(1 << 30)
    tblt = torch.as_tensor(tbl, device=dev)
    plid = torch.as_tensor(rng.randint(0, 128, size=Nr).astype(np.int32),
                           device=dev)
    errs = []
    for b in (pbins, (pbins - 128).to(torch.int8)):
        got = P._partition_cuda(b, plid, tblt)
        ref = P._partition_plain(b, plid, tblt)
        torch.cuda.synchronize()
        errs.append((got - ref).abs().max().item())
        if not torch.equal(got, ref):
            fail(f"partition_rows ({b.dtype} bins) differs from its plain "
                 f"version: {errs[-1]}")
    ms = time_ms(torch, lambda: P._partition_cuda(pbins, plid, tblt), 50)
    plain = time_ms(torch, lambda: P._partition_plain(pbins, plid, tblt), 10)
    bms, by = bound_ms(Nr * 4 + Nr * 4 + 7 * S * 4 + Nr * 4, 8.0 * Nr)
    rows.append(dict(name="partition_rows", route="cuda",
                     source="lightgbm_tpu_torch/csrc/partition.cu",
                     replaces="lightgbm_tpu/ops/partition.py:76",
                     max_abs_err=float(max(errs)), ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None))
    print(f"[kernels] partition_rows: S={S} N={Nr} F={F} ms={ms:.4f} "
          f"plain_ms={plain:.4f} bound_ms={bms:.4f} ({by})", flush=True)
    return rows


def drive(torch, lt, kernels, params, X, y, Xv, yv, warmup, timed):
    """Train through lightgbm_tpu_torch.train (the valid set's AUC each
    iteration) and predict with Booster.predict, with the launch counts
    zeroed before and read after.  s/iter excludes set-up and warm-up:
    (wall of a warmup+timed-iteration train - wall of a warmup-iteration
    train) / timed, both ending in a device synchronise."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, params=params).construct()
    vs = lt.Dataset(Xv, yv, reference=ds, params=params).construct()
    setup_s = time.perf_counter() - t0
    walls, bst, res = [], None, None
    for n in (warmup, warmup + timed):
        res = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        bst = lt.train(params, ds, n, valid_sets=[vs], evals_result=res)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if bst.num_trees() != n:
            fail(f"training stopped early: {bst.num_trees()} of {n} trees")
    t = time.perf_counter()
    pred = bst.predict(Xv)
    predict_s = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    syncs = bst._gbdt.host_syncs_per_tree
    return bst, dict(setup_s=setup_s,
                     s_per_iter=(walls[1] - walls[0]) / timed,
                     train_wall_s=walls, auc=res["valid_0"]["auc"][-1],
                     syncs_per_tree=statistics.mean(syncs),
                     predict_s=predict_s, launches=launches), pred


def phase_main(torch, lt, kernels):
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs
    X, y = synth_higgs(MAIN_ROWS)
    Xv, yv = synth_higgs(VALID_ROWS, seed=7)
    params = dict(NORTH_STAR_PARAMS, device_type=GPU)
    bst, st, pred = drive(torch, lt, kernels, params, X, y, Xv, yv, 2, 10)
    print(f"[main] int8: {json.dumps(st)}", flush=True)
    for k in ("hist_masked_int8", "table_lookup", "partition_rows"):
        if st["launches"][k] <= 0:
            fail(f"main path (int8) never launched {k}")
    if not (pred.shape == (VALID_ROWS,) and np.all(np.isfinite(pred))
            and np.all((pred >= 0) & (pred <= 1))):
        fail("Booster.predict gave non-finite or out-of-range values")
    if not (math.isfinite(st["auc"]) and st["auc"] > 0.75):
        fail(f"valid AUC {st['auc']} is not a trained model's")
    # the host f64 walk of the model against the device-scored valid set
    dev_raw = bst._gbdt.valid_sets[0][2].score[0].double().cpu().numpy()
    host_raw = bst.predict(Xv, raw_score=True)
    walk_err = float(np.abs(dev_raw - host_raw).max())
    print(f"[main] device valid score vs host walk: max |diff| {walk_err}",
          flush=True)
    if walk_err > 1e-4:
        fail(f"device valid scores disagree with the host walk: {walk_err}")
    _, st32, _ = drive(torch, lt, kernels,
                       dict(params, histogram_dtype="float32"), X, y,
                       Xv, yv, 1, 2)
    print(f"[main] float32: {json.dumps(st32)}", flush=True)
    for k in ("hist_masked_f32", "table_lookup", "partition_rows"):
        if st32["launches"][k] <= 0:
            fail(f"main path (float32) never launched {k}")
    return st, st32


def phase_card_vs_cpu(lt):
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs
    X, y = synth_higgs(COMPARE_ROWS)
    Xv, yv = synth_higgs(COMPARE_ROWS // 5, seed=7)
    out = {}
    for dev in ("cpu", GPU):
        # both sides pinned to the gathered row feed (auto resolves to
        # masked on the CPU), so they quantize the same rows per pass
        p = dict(NORTH_STAR_PARAMS, device_type=dev, hist_rows="gathered")
        ds = lt.Dataset(X, y, params=p)
        res = {}
        bst = lt.train(p, ds, 5, valid_sets=[lt.Dataset(Xv, yv,
                                                        reference=ds)],
                       evals_result=res)
        out[dev] = (bst._gbdt.models[0], res["valid_0"]["auc"][-1])
    (tc, auc_c), (tg, auc_g) = out["cpu"], out[GPU]
    n = min(tc.num_leaves, tg.num_leaves) - 1
    diff = [i for i in range(n)
            if (tc.split_feature[i], tc.threshold_in_bin[i])
            != (tg.split_feature[i], tg.threshold_in_bin[i])]
    print(f"[card-vs-cpu] leaves cpu={tc.num_leaves} cuda={tg.num_leaves} "
          f"differing splits={len(diff)} auc cpu={auc_c} cuda={auc_g}",
          flush=True)
    if diff or tc.num_leaves != tg.num_leaves:
        i = diff[0] if diff else n
        gc, gg = float(tc.split_gain[i]), float(tg.split_gain[i])
        tie = (diff and abs(gc - gg) <= 1e-5 * max(abs(gc), abs(gg)))
        print(f"[card-vs-cpu] first differing split at node {i}: cpu "
              f"(feature {tc.split_feature[i]}, bin "
              f"{tc.threshold_in_bin[i]}, gain {gc!r}) vs cuda (feature "
              f"{tg.split_feature[i]}, bin {tg.threshold_in_bin[i]}, gain "
              f"{gg!r}); f32 gain tie: {bool(tie)}", flush=True)
        if not tie:
            fail("card and CPU grew different first trees")
    if abs(auc_c - auc_g) > 1e-4:
        fail(f"card and CPU valid AUC differ: {auc_c} vs {auc_g}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        sys.exit(2)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import kernels
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import lookup as LK
    from lightgbm_tpu_torch.ops import partition as P

    t0 = time.perf_counter()
    took = kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})",
          flush=True)
    rows = phase_kernels(torch, kernels, H, LK, P)
    st, st32 = phase_main(torch, lt, kernels)
    for r in rows:
        src = st32 if r["name"] == "hist_masked_f32" else st
        r["launches"] = src["launches"][r["name"]]
    phase_card_vs_cpu(lt)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail("nvidia-smi did not report the card")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
