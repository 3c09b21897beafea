"""Smoke run of lightgbm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build   — compile every CUDA kernel of lightgbm_tpu_torch/csrc/ (one
             nvcc per source, in parallel) and print the seconds taken.
2. kernels — each dense-store kernel against its plain PyTorch version on
             the card, on seeded inputs at the main path's shapes: K1
             (int8 histogram) on a gathered pass (84 slot runs given by
             their bounds in the scratch, three empty), read from the
             row-major byte copy built from the int32 and from the int8
             store and from both [F, N] stores, bitwise equal to its
             plain version over the runs' bounds and to the masked-feed
             one, and bitwise from run to run; K1 on a tree's root pass
             (masked feed, one slot, every row), bitwise the same way; K2
             (float32 histogram, one owner thread a cell) on the same
             gathered pass from the byte copy and both [F, N] stores,
             within K2_ATOL of both plain versions and bitwise from run to
             run, and on the root pass with dyadic values, bitwise; K3
             (lookup fused with the
             score add, and one level of the valid-set walk, bitwise), K4
             (row partition, bitwise); median times of kernel, plain
             version and, where one exists, a single PyTorch call
             computing the same function (library_ms; K3 has none — one
             index_select, which neither adds into the score nor zeroes
             out-of-range ids, is printed as a note).  The {"kernels"}
             line reports the gathered pass for K1/K2 and the score add
             for K3; the other shapes are printed on their own lines.
3. main    — lightgbm_tpu_torch.train on synth_higgs(2_000_000) x 28
             (255 leaves, max_bin 255, int8 histograms, a 200k-row valid
             set scored with AUC each iteration; 2 warm-up and 10 timed
             iterations of one train, timed by the host clock between
             device synchronisations at the end of iteration 2 and of
             iteration 12, from a training callback), then
             Booster.predict; launch counts are
             zeroed before and read after, and every kernel of the path
             must have launched.  The float32-histogram path is driven
             the same way (2 warm-up, 10 timed; K2 must launch and the
             valid AUC exceed 0.75).  Then one tree of each replayed: a
             one-tree train with K1's (int8) or K2's (float32) wrapper
             recording each call's inputs, every call then held against
             its plain version (K1 bitwise, K2 within n * 2^-23 * sum|x|
             a cell) and run twice bitwise, timed, and given its bound;
             the per-tree sums are printed.
4. ctr set-up — synth_ctr(500_000) x 50,000 hashed-count features at
             density 0.01 (scipy CSR, 20-row queries) through
             lightgbm_tpu_torch.Dataset with CTR_PARAMS (sparse_store=csr):
             host seconds of the binning and of the ELL store build; a
             valid set synth_ctr(4_080, seed=7) given as a dense ndarray,
             sparsified against its reference; then the column-sorted
             entry streams that K7/K8 read, built on the card from the ELL
             arrays as the rounds learner builds them: seconds, bytes and
             the build's peak device memory.
5. sparse kernels — K7 (int8) and K8 (float32) against their plain
             version (hist_streams_plain: index_add_ of the stream entries,
             the zero bins, the dequantize) on the ctr store itself (N=500k
             rows, K=31 slots, Cp=its columns, B=128), both given the same
             slot totals: K7 bitwise, K8 bitwise on dyadic gradients and
             on real ones within n * 2^-23 * sum|x| in every cell (n f32
             additions in any order lie within n * 2^-24 * sum|x| of the
             exact sum, and the plain version's index_add_ reorders too; a
             stored cell counts its entries, a zero bin the slot's rows);
             K7 also through the whole hist_sparse_multileaf pass against
             hist_sparse_xla over the ELL arrays, bitwise; times of
             kernel, plain version and one index_add_ over the flattened
             (slot, column, channel, bin) indices of the stored entries.
             Then K7 at K=84, B=256 the same way (alone and through the
             whole pass, bitwise), once at the module's shared-memory
             budget and block length and once with slot tiles and
             long-column chunks forced.  Then the learner's own passes:
             one tree per dtype on the ctr store with the kernel's wrapper
             recording each pass's inputs, and each recorded pass checked
             (as above) and timed, with its bound.
6. ctr main — lightgbm_tpu_torch.train with CTR_PARAMS on the phase-4
             datasets, float32 then int8 histograms (2 warm-up and 10
             timed iterations each, timed as in phase 3), NDCG@1..5 on
             the valid set every iteration; fails unless hist_sparse_f32,
             hist_sparse_int8 and table_lookup launched, no sparse store
             was densified (train or valid), NDCG@5 is finite and no lower
             after the last iteration than after the first, and the
             device-scored valid set agrees with Booster.predict(
             raw_score=True) within 1e-4.
7. card vs CPU — the same training on the CPU (plain versions) and on the
             card (kernels), first trees identical unless their first
             differing split is an f32 gain tie: 5 iterations of the
             phase-3 configuration on synth_higgs(50_000) (valid AUCs
             within 1e-4), and 3 iterations of CTR_PARAMS on
             synth_ctr(4_000, 2_048, 0.01), float32 and int8 (valid
             NDCG@5 within 1e-4).
8. onehot set-up — synth_onehot(2_000_000): 40 one-hot groups of 6, 240
             features (bench.py BENCH_WORKLOAD=onehot, cut from 10.5M
             rows) through lightgbm_tpu_torch.Dataset with ONEHOT_PARAMS:
             host seconds of data, binning with the bundle plan, and the
             store apart; fails unless EFB packed the 240 features into 40
             store columns with 0 conflicting rows.  Valid set
             synth_onehot(200_000, seed=7) on the same plan.
9. gathered kernels — K5 (histogram_from_indices) against its plain
             version at the exact learner's shapes, over its byte feeds
             ([N+1, C] uint8) with the live row count: the root of the
             onehot store (every row, C=40 columns of 7 bins, B=128), a
             mid-tree leaf (65,536 index slots, 60,000 of them rows), and a
             north-star store (C=28, 255 bins, B=256, every row); K6
             (hist_multileaf) at M=128 value rows, F=28, B=256, C=2M.
             Bitwise on dyadic values, and on real ones within
             n * 2^-23 * sum|x| per cell (the kernel's fixed-order float
             sums and the plain version's index_add_ order differ); the
             count channel always bitwise; K5 run twice, bitwise equal.
             Times of kernel, plain version and one PyTorch call over
             prebuilt flat indices (index_add_ for K5; for K6 one
             scatter_add_ over stride-0 views, since its flat index would
             hold F*M*C = 7.2e9 entries).
10. onehot main — the exact leaf-wise learner (tree_growth=exact) on the
             phase-8 datasets, 12 iterations (s/iter over iterations 3-12,
             timed as in phase 3), valid AUC every iteration; fails unless
             the learner is the exact one, K5 launched, AUC rose from
             iteration 1 to 12, and the device-scored valid set agrees with
             Booster.predict(raw_score=True) within 1e-4.  Then the rounds
             learner (tree_growth=auto) on the same bundled store, 6
             iterations, which must launch K1, K3 and K4.  Then one tree
             of each learner replayed: a one-tree train with K5's wrapper
             (exact) or K1's (rounds, 7 bins a column) recording each
             call's inputs, every call then checked as in phase 9 (K5) or
             phase 3 (K1), timed and given its bound; the per-tree sums
             are printed.
11. losslessness — synth_onehot(50_000) with enable_bundle true and
             false, for each learner: the same first tree (unless its first
             differing split is an f32 gain tie), predictions within 1e-5.
12. onehot card vs CPU — 5 iterations of the exact learner on the CPU and
             on the card, on synth_onehot(50_000) with ONEHOT_PARAMS and on
             synth_higgs(50_000) with the north-star parameters: first
             trees as in phase 7, valid AUC within 1e-4.

Every kernel's ms is timed by CUDA events around each call, the method
of earlier versions of this script; it includes the wrapper's host
enqueue where that takes longer than the kernel.  K1-K5 are also timed
as graph_ms, the device time of one call with no host in between, from a
CUDA graph of 10 calls replayed between events (in their {"kernels"}
rows too, null in the others); K1, K2 and K5 also as host_us, the
wrapper's host time a call.

Prints the card's name and power limit, one {"kernels": [...]} JSON line,
and last {"ok": true, "device": {...}}.  Exits with 2 and no result when
no CUDA device is visible.
"""
from __future__ import annotations

import gc
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

# K2 tolerance on phase 2's gathered pass: K2 sums a cell in a fixed
# order, its plain version's index_add_ in another; n f32 additions
# reorder within n * 2^-24 * sum|x|, which for the ~60 rows of |x| <= 4
# that a cell receives here stays below 1e-3
K2_ATOL = 1e-3

# shapes: a gathered histogram pass at the capacity tier of a 10.5M-row
# training set, the row counts of the main path, the card-vs-CPU run
HIST_ROWS = 1_312_512
MAIN_ROWS = 2_000_000
VALID_ROWS = 200_000
COMPARE_ROWS = 50_000
# the ctr configuration (scripts/run_chip_queue.sh bench_ctr): rows,
# hashed features, density; its valid set; the card-vs-CPU shape
CTR_ROWS = 500_000
CTR_FEATURES = 50_000
CTR_DENSITY = 0.01
CTR_VALID_ROWS = 4_080
CTR_COMPARE = (4_000, 2_048)
# slots of the sparse-kernel phase: the ctr tree's 31 leaves
CTR_SLOTS = 31
# the onehot configuration (bench.py BENCH_WORKLOAD=onehot), cut from
# 10.5M to 2M rows; its valid set; the losslessness and card-vs-CPU shape
ONEHOT_ROWS = 2_000_000
ONEHOT_VALID_ROWS = 200_000
ONEHOT_COMPARE = 50_000
# K5's mid-tree leaf (index slots, rows) and K6's value rows
LEAF_CAP, LEAF_ROWS = 65_536, 60_000
K6_ROWS = 128
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


_SIDE = []


def graph_ms(torch, fn, reps: int = 10, per: int = 10) -> float:
    """Median device time of one call with no host in between: `per`
    calls captured in a CUDA graph (on one side stream, after warm-up
    calls on it, which also allocate whatever the calls keep), the graph
    replayed between CUDA events `reps` times.  A small kernel's wrapper
    takes longer on the host than the kernel on the card, so events
    around each call (`time_ms`) time the host enqueue; this times the
    card."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    del graph
    return statistics.median(times)


def host_us(torch, fn, reps: int = 100) -> float:
    """Host microseconds of one call of a kernel wrapper (enqueue only:
    no synchronisation inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def steady_window(torch, warmup: int, total: int, marks: list):
    """After-iteration callback of lightgbm_tpu_torch.train: at the end of
    iteration `warmup` and of iteration `total` (counted from 1) it
    synchronises the device and appends the host clock to `marks`, so
    s/iter = (marks[1] - marks[0]) / (total - warmup) is a steady window
    inside one train."""
    def cb(env):
        if env.iteration + 1 in (warmup, total):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
    return cb


def sparse_bound(torch, cols, srow, vals, K: int, Cp: int, B: int):
    """(bound ms, basis, rows, entries) of one K7/K8 pass: the stored
    entries (column and bin, 8 B) of the rows in a slot that carry a
    value, the slot of every row and the three value lanes of the rows
    in a slot, read once; the [K, Cp, 3, B] output written once; three
    adds per entry."""
    N = cols.shape[0]
    slotted = srow < K
    active = slotted & (vals != 0).any(dim=0)
    n_slotted = int(slotted.sum())
    entries = int(((cols >= 0) & (cols < Cp) & active[:, None]).sum())
    nbytes = entries * 8 + N * 4 + n_slotted * 12 + K * Cp * 3 * B * 4
    return bound_ms(nbytes, 3.0 * entries) + (n_slotted, entries)


def sparse_check(torch, H, SS, name, st, zb, srow, v, tot, scale, K, Cp,
                 B, exact: bool) -> float:
    """K7/K8 against their plain version on one pass's inputs (the same
    slot totals `tot` for both): bitwise when `exact`, else every cell
    within n * 2^-23 * sum|x| (n f32 additions in any order lie within
    n * 2^-24 * sum|x| of the exact sum, and the plain version's
    index_add_ reorders too), where a stored cell counts its own entries
    and a zero bin (slot total minus the column's stored sums) the slot's
    rows.  Returns the max |diff|."""
    got = SS._hist_streams_cuda(st, zb, srow, v, tot, scale, K, Cp, B)
    ref = SS.hist_streams_plain(st, zb, srow, v, tot, scale, K, Cp, B)
    torch.cuda.synchronize()
    # in slices of a few slots: a K=84, B=256 pass is 12.9 GB in float32
    err = max((got[k:k + 8].double() - ref[k:k + 8].double()).abs().max()
              .item() for k in range(0, K, 8))
    if exact and not torch.equal(got, ref):
        fail(f"{name} differs from its plain version: max |diff| {err}")
    if not exact:
        absv = torch.stack([v[0].abs(), v[1].abs(), v[2]])
        ta = H._slot_totals(srow, absv, K)
        s = SS.hist_streams_plain(st, torch.full_like(zb, -1), srow, absv,
                                  ta, None, K, Cp, B).double()
        tol = s[:, :, 2:3, :] * 2.0 ** -23 * s
        del s
        ta = ta.double()
        ok = (zb >= 0).nonzero()[:, 0]
        tol[:, ok, :, zb[ok].long().clamp(max=B - 1)] += (
            ta[:, 2:3] * 2.0 ** -23 * ta)[None]
        bad = ((got.double() - ref.double()).abs() > tol).sum().item()
        if bad:
            fail(f"{name}: {bad} cells beyond n*2^-23*sum|x| (max |diff| "
                 f"{err})")
    return err


def phase_kernels(torch, kernels, H, LK, P):
    dev = torch.device(GPU)
    rng = np.random.RandomState(7)
    rows = []

    # ---- K1 / K2: one gathered pass at a capacity tier ------------------
    F, B, K, C = 28, 256, 84, HIST_ROWS
    N = 2 * C
    bins_np = rng.randint(0, 255, size=(F, N)).astype(np.int32)
    counts = rng.multinomial(int(C * 0.95), np.full(K, 1.0 / K))
    counts[[5, 40, 83]] = 0                           # empty slots
    lid_np = np.full(C, -2, np.int32)                 # pad rows past total
    lid_np[:counts.sum()] = np.repeat(np.arange(K), counts)
    row_idx_np = np.sort(rng.choice(N, C, replace=False)).astype(np.int32)
    sl_np = np.arange(K, dtype=np.int32)
    sl_np[[5, 40, 83]] = -1
    g = (rng.randn(C) * (lid_np >= 0)).astype(np.float32)
    h = (rng.rand(C) * 0.25 * (lid_np >= 0)).astype(np.float32)
    gh = torch.as_tensor(np.stack([g, h, (lid_np >= 0).astype(np.float32)]),
                         device=dev)
    ghq, _, _ = H._quantize_gh(gh)
    lid = torch.as_tensor(lid_np, device=dev)
    row_idx = torch.as_tensor(row_idx_np, device=dev)
    sl = torch.as_tensor(sl_np, device=dev)
    base = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int64, device=dev)
    bins32 = torch.as_tensor(bins_np, device=dev)
    bins8 = (bins32 - 128).to(torch.int8)
    rows32 = H.row_major_bins(bins32, 255)
    rows8 = H.row_major_bins(bins8, 255)
    if not (torch.equal(rows32.rows, rows8.rows) and torch.equal(
            rows32.rows[:, :F].t().to(torch.int32), bins32)):
        fail("the row-major byte copy differs from the [F, N] store")
    n_match = int(counts.sum())

    def library_hist(vals, acc_dtype):
        """One index_add_ over a flattened (slot, feature, channel, bin)
        index — the same sums as the kernel, index built beforehand."""
        pos = torch.arange(n_match, device=dev)
        kk = lid[pos].long()
        b = bins32[:, row_idx[pos].long()].long()           # [F, E]
        f = torch.arange(F, device=dev)[:, None]
        idx = torch.cat([(((kk[None, :] * F + f) * 3 + ch) * B + b).reshape(-1)
                         for ch in range(3)])
        v = torch.cat([vals[ch, pos][None, :].expand(F, -1).reshape(-1)
                       for ch in range(3)]).to(acc_dtype)
        out = torch.zeros(K * F * 3 * B, dtype=acc_dtype, device=dev)
        return lambda: out.zero_().index_add_(0, idx, v)

    # K1 over the segment plan: from the byte copy (built from the int32
    # and from the int8 store) and from both [F, N] stores, bitwise equal
    # to its plain version over the runs' bounds and to the masked-feed one
    ref = H._hist_plain(bins32, row_idx, lid, ghq, sl, B)
    errs = []
    for label, bins, rws in (("byte copy of int32", bins32, rows32),
                             ("byte copy of int8", bins8, rows8),
                             ("int32 [F, N]", bins32, None),
                             ("int8 [F, N]", bins8, None)):
        got = H._hist_q_cuda(bins, rws, row_idx, ghq, B, base=base)
        again = H._hist_q_cuda(bins, rws, row_idx, ghq, B, base=base)
        plan_ref = H._segments_plain(bins, rws, row_idx, ghq, base, B)
        torch.cuda.synchronize()
        errs.append((got.double() - ref.double()).abs().max().item())
        if not (torch.equal(got, ref) and torch.equal(got, plan_ref)
                and torch.equal(got, again)):
            fail(f"hist_masked_int8 gathered pass ({label}) differs from "
                 f"its plain version: max |diff| {errs[-1]}")
    del plan_ref, again

    def k1_gathered():
        return H._hist_q_cuda(bins32, rows32, row_idx, ghq, B, base=base)
    ms = time_ms(torch, k1_gathered, 20)
    graph = graph_ms(torch, k1_gathered)
    host = host_us(torch, k1_gathered)
    plain = time_ms(torch, lambda: H._segments_plain(
        bins32, rows32, row_idx, ghq, base, B), 3, 1)
    lib = time_ms(torch, library_hist(ghq, torch.int32), 5, 1)
    F4 = rows32.rows.shape[1]
    # the byte rows and (row id, 3 values) of the positions in a run, the
    # segment bounds, the [K, F, 3, B] int32 output once
    bms, by = bound_ms(n_match * (F4 + 4 + 12) + (K + 1) * 8
                       + K * F * 3 * B * 4, 3.0 * F * n_match)
    rows.append(dict(name="hist_masked_int8", route="cuda",
                     source="lightgbm_tpu_torch/csrc/histogram.cu",
                     replaces="lightgbm_tpu/ops/histogram.py:503",
                     max_abs_err=max(errs), ms=ms, graph_ms=graph,
                     plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib))
    print(f"[kernels] hist_masked_int8 (gathered pass): C={C} F={F} K={K} "
          f"B={B} rows={n_match} "
          f"f_tile={H._k1_feature_tile(F, 255, True, True)} "
          f"max_abs_err={max(errs):.3g} ms={ms:.4f} graph_ms={graph:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} library_ms={lib:.4f} "
          f"bound_ms={bms:.4f} ({by})", flush=True)
    del ref, got

    # K2 over the same segment plan: from the byte copy and from both
    # [F, N] stores, within K2_ATOL of its plain version over the runs'
    # bounds and of the masked-feed one, and bitwise from run to run
    ref = H._hist_plain(bins32, row_idx, lid, gh, sl, B)
    errs = []
    for label, bins, rws in (("byte copy", bins32, rows32),
                             ("int32 [F, N]", bins32, None),
                             ("int8 [F, N]", bins8, None)):
        got = H._hist_f_cuda(bins, rws, row_idx, gh, B, base=base)
        again = H._hist_f_cuda(bins, rws, row_idx, gh, B, base=base)
        plan_ref = H._segments_plain(bins, rws, row_idx, gh, base, B)
        torch.cuda.synchronize()
        err = max((got.double() - r.double()).abs().max().item()
                  for r in (ref, plan_ref))
        errs.append(err)
        if not err <= K2_ATOL:
            fail(f"hist_masked_f32 gathered pass ({label}) max |diff| {err} "
                 f"> {K2_ATOL}")
        if not torch.equal(got, again):
            fail(f"hist_masked_f32 gathered pass ({label}) differs from run "
                 "to run")
    del plan_ref, again

    def k2_gathered():
        return H._hist_f_cuda(bins32, rows32, row_idx, gh, B, base=base)
    ms = time_ms(torch, k2_gathered, 20)
    graph = graph_ms(torch, k2_gathered)
    host = host_us(torch, k2_gathered)
    plain = time_ms(torch, lambda: H._segments_plain(
        bins32, rows32, row_idx, gh, base, B), 3, 1)
    lib = time_ms(torch, library_hist(gh, torch.float32), 5, 1)
    # the same bytes as K1's pass: byte rows, row id and 3 values of the
    # positions in a run, the bounds, the [K, F, 3, B] float32 output
    bms, by = bound_ms(n_match * (F4 + 4 + 12) + (K + 1) * 8
                       + K * F * 3 * B * 4, 3.0 * F * n_match)
    lay = H._k2_layout(F, 255, True, K)
    rows.append(dict(name="hist_masked_f32", route="cuda",
                     source="lightgbm_tpu_torch/csrc/histogram.cu",
                     replaces="lightgbm_tpu/ops/histogram.py:443",
                     max_abs_err=max(errs), ms=ms, graph_ms=graph,
                     plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib))
    print(f"[kernels] hist_masked_f32 (gathered pass): C={C} F={F} K={K} "
          f"B={B} rows={n_match} f_tile={lay[0]} "
          f"max_abs_err={max(errs):.3g} ms={ms:.4f} graph_ms={graph:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} library_ms={lib:.4f} "
          f"bound_ms={bms:.4f} ({by})", flush=True)
    del ref, got, rows8

    # ---- K1 / K2: each tree's root pass, the masked feed (no row index),
    # one slot, every training row in leaf 0.  grad and hess are dyadic
    # (multiples of 2^-6 and 2^-8, |g| < 2^4) so that every partial sum of
    # a cell (~N/255 rows) is exact in f32: any order of the float adds
    # gives the same sums, and K2 is held bitwise here as well ----------
    Nr = MAIN_ROWS
    pbins = bins32[:, :Nr].contiguous()
    prows = H.row_major_bins(pbins, 255)
    rlid = torch.zeros(Nr, dtype=torch.int32, device=dev)
    rsl = torch.zeros(1, dtype=torch.int32, device=dev)
    rg = np.clip(np.round(rng.randn(Nr) * 64), -1000, 1000) / 64
    rh = np.round(rng.rand(Nr) * 64) / 256
    rgh = torch.as_tensor(np.stack([rg, rh, np.ones(Nr)]).astype(np.float32),
                          device=dev)
    rghq, _, _ = H._quantize_gh(rgh)
    errs = []
    for label, bins, rws in (("byte copy", pbins, prows),
                             ("int32 [F, N]", pbins, None),
                             ("int8 [F, N]", (pbins - 128).to(torch.int8),
                              None)):
        got = H._hist_q_cuda(bins, rws, None, rghq, B, lid=rlid, sl=rsl)
        again = H._hist_q_cuda(bins, rws, None, rghq, B, lid=rlid, sl=rsl)
        ref = H._hist_plain(bins, None, rlid, rghq, rsl, B)
        torch.cuda.synchronize()
        errs.append((got.double() - ref.double()).abs().max().item())
        if not (torch.equal(got, ref) and torch.equal(got, again)):
            fail(f"hist_masked_int8 root pass ({label}) differs from its "
                 f"plain version: max |diff| {errs[-1]}")

    def k1_root():
        return H._hist_q_cuda(pbins, prows, None, rghq, B, lid=rlid, sl=rsl)
    ms = time_ms(torch, k1_root, 20)
    graph = graph_ms(torch, k1_root)
    host = host_us(torch, k1_root)
    plain = time_ms(torch, lambda: H._hist_plain(pbins, None, rlid, rghq,
                                                 rsl, B), 3, 1)
    bms, by = bound_ms(Nr * (F4 + 4 + 12) + 4 + F * 3 * B * 4, 3.0 * F * Nr)
    print(f"[kernels] hist_masked_int8 root pass: C=N={Nr} F={F} K=1 B={B} "
          f"f_tile={H._k1_feature_tile(F, 255, True, False)} "
          f"max_abs_err={max(errs):.3g} ms={ms:.4f} graph_ms={graph:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} bound_ms={bms:.4f} "
          f"({by})", flush=True)
    errs = []
    for label, bins, rws in (("byte copy", pbins, prows),
                             ("int32 [F, N]", pbins, None),
                             ("int8 [F, N]", (pbins - 128).to(torch.int8),
                              None)):
        got = H._hist_f_cuda(bins, rws, None, rgh, B, lid=rlid, sl=rsl)
        again = H._hist_f_cuda(bins, rws, None, rgh, B, lid=rlid, sl=rsl)
        ref = H._hist_plain(bins, None, rlid, rgh, rsl, B)
        torch.cuda.synchronize()
        errs.append((got.double() - ref.double()).abs().max().item())
        if not (torch.equal(got, ref) and torch.equal(got, again)):
            fail(f"hist_masked_f32 root pass ({label}) differs from its "
                 f"plain version: max |diff| {errs[-1]}")

    def k2_root():
        return H._hist_f_cuda(pbins, prows, None, rgh, B, lid=rlid, sl=rsl)
    ms = time_ms(torch, k2_root, 20)
    graph = graph_ms(torch, k2_root)
    host = host_us(torch, k2_root)
    plain = time_ms(torch, lambda: H._hist_plain(pbins, None, rlid, rgh, rsl,
                                                 B, rows=prows), 3, 1)
    bms, by = bound_ms(Nr * (F4 + 4 + 12) + 4 + F * 3 * B * 4, 3.0 * F * Nr)
    print(f"[kernels] hist_masked_f32 root pass: C=N={Nr} F={F} K=1 B={B} "
          f"max_abs_err={max(errs):.3g} ms={ms:.4f} graph_ms={graph:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} bound_ms={bms:.4f} "
          f"({by})", flush=True)
    del prows, got, ref

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
    graph = graph_ms(torch, lambda: LK._lookup_cuda(table, ids, score))
    plain = time_ms(torch, lambda: LK._lookup_plain(table, ids, score), 10)
    # no single PyTorch call adds into the score and zeroes out-of-range
    # ids, so K3 has no library time; one index_select over in-range ids
    # (neither) is printed as a note
    ids_in = ids.clamp(0, 254).long()
    sel = time_ms(torch, lambda: torch.index_select(table[0], 0, ids_in), 50)
    bms, by = bound_ms(Nr * 4 + 255 * 4 + 2 * Nr * 4, Nr)
    rows.append(dict(name="table_lookup", route="cuda",
                     source="lightgbm_tpu_torch/csrc/lookup.cu",
                     replaces="lightgbm_tpu/ops/lookup.py:23",
                     max_abs_err=err, ms=ms, graph_ms=graph, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None))
    print(f"[kernels] table_lookup (fused add): T=1 S=255 N={Nr} "
          f"max_abs_err={err} ms={ms:.4f} graph_ms={graph:.4f} "
          f"plain_ms={plain:.4f} "
          f"index_select_ms={sel:.4f} bound_ms={bms:.4f} ({by})",
          flush=True)

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
    wsel = time_ms(torch, lambda: torch.index_select(wtab, 1, wids_l), 50)
    wbms, wby = bound_ms(Nv * 4 + T * Sw * 4 + T * Nv * 4, T * Nv)
    print(f"[kernels] table_lookup (walk step): T={T} S={Sw} N={Nv} "
          f"max_abs_err={werr} ms={wms:.4f} plain_ms={wplain:.4f} "
          f"index_select_ms={wsel:.4f} bound_ms={wbms:.4f} ({wby})",
          flush=True)

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
    graph = graph_ms(torch, lambda: P._partition_cuda(pbins, plid, tblt))
    plain = time_ms(torch, lambda: P._partition_plain(pbins, plid, tblt), 10)
    bms, by = bound_ms(Nr * 4 + Nr * 4 + 7 * S * 4 + Nr * 4, 8.0 * Nr)
    rows.append(dict(name="partition_rows", route="cuda",
                     source="lightgbm_tpu_torch/csrc/partition.cu",
                     replaces="lightgbm_tpu/ops/partition.py:76",
                     max_abs_err=float(max(errs)), ms=ms, graph_ms=graph,
                     plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=None))
    print(f"[kernels] partition_rows: S={S} N={Nr} F={F} ms={ms:.4f} "
          f"graph_ms={graph:.4f} plain_ms={plain:.4f} bound_ms={bms:.4f} "
          f"({by})", flush=True)
    return rows


def phase_ctr_setup(lt, rows):
    """The ctr training and valid Datasets, built once (phase 4)."""
    from lightgbm_tpu_torch.synth import CTR_PARAMS, synth_ctr
    params = dict(CTR_PARAMS, device_type=GPU)
    t0 = time.perf_counter()
    X, y, g = synth_ctr(rows, CTR_FEATURES, CTR_DENSITY)
    Xv, yv, gv = synth_ctr(CTR_VALID_ROWS, CTR_FEATURES, CTR_DENSITY,
                           seed=7)
    Xv = Xv.toarray()
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, group=g, params=params).construct()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs = lt.Dataset(Xv, yv, group=gv, reference=ds,
                    params=params).construct()
    valid_s = time.perf_counter() - t0
    sp = ds._inner.sparse
    if sp is None or vs._inner.sparse is None:
        fail("the ctr datasets did not build the sparse store")
    # the column-sorted entry streams K7/K8 read, built on the card from
    # the ELL arrays as the rounds learner builds them
    from lightgbm_tpu_torch.ops.sparse_streams import build_sparse_streams
    import torch
    cols, binsv, zb = ds._inner.sparse_triple(torch.device(GPU))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    streams = build_sparse_streams(cols, binsv, sp.num_columns)
    torch.cuda.synchronize()
    streams_s = time.perf_counter() - t0
    st = dict(rows=len(y), features=CTR_FEATURES,
              store_columns=sp.num_columns, nnz=sp.nnz,
              ell_width=sp.nnz_capacity, synth_s=synth_s,
              setup_binning_s=ds._inner.setup_seconds["binning"],
              setup_store_s=ds._inner.setup_seconds["store"],
              setup_train_total_s=train_s, setup_valid_s=valid_s,
              streams_s=streams_s, streams_bytes=streams.nbytes,
              streams_build_peak_bytes=torch.cuda.max_memory_allocated()
              - base, streams_stored_bins=streams.num_bins,
              streams_longest_column=int(
                  (streams.col_off[1:] - streams.col_off[:-1]).max()))
    print(f"[ctr setup] {json.dumps(st)}", flush=True)
    del X
    return params, ds, vs, Xv, (cols, binsv, zb, streams)


def sparse_pass_inputs(torch, H, N, K, seed):
    """Leaf ids (some leaves unslotted), slots (two empty) and gradient
    rows — dyadic and real — of one K-slot sparse pass over N rows."""
    dev = torch.device(GPU)
    rng = np.random.RandomState(seed)
    lid_np = rng.randint(0, K + 9, N).astype(np.int32)
    sl_np = np.arange(K, dtype=np.int32)
    sl_np[[K // 4, (3 * K) // 5]] = -1                  # empty slots
    m = (rng.rand(N) > 0.05).astype(np.float32)
    dy = np.stack([np.round(rng.randn(N) * 8) / 8 * m,
                   np.round(rng.rand(N) * 16) / 32 * m, m])
    real = np.stack([rng.randn(N) * m, rng.rand(N) * m, m])
    return (torch.as_tensor(lid_np, device=dev),
            torch.as_tensor(sl_np, device=dev),
            torch.as_tensor(dy.astype(np.float32), device=dev),
            torch.as_tensor(real.astype(np.float32), device=dev))


def whole_pass_check(torch, H, sp, lid, gh, sl, Cp, B) -> None:
    """hist_sparse_multileaf(int8) — the pass the learner makes, zero bins
    and the one dequantize included — against hist_sparse_xla over the
    ELL arrays: bitwise, as both sum the same integers."""
    full = H.hist_sparse_multileaf(sp, lid, gh, sl, num_columns_padded=Cp,
                                   num_bins_padded=B, input_dtype="int8")
    plain_full = H.hist_sparse_xla(sp[0], sp[1], sp[2], lid, gh, sl,
                                   num_columns_padded=Cp,
                                   num_bins_padded=B, input_dtype="int8")
    if not torch.equal(full, plain_full):
        fail(f"hist_sparse_multileaf (int8, K={sl.shape[0]}, B={B}) "
             "differs from hist_sparse_xla on the card")
    del full, plain_full
    gc.collect()
    torch.cuda.empty_cache()


def phase_sparse_kernels(torch, H, SS, ds, sp):
    """K7 / K8 against their plain version on the ctr store (phase 5)."""
    dev = torch.device(GPU)
    cols, binsv, zb, streams = sp
    N, R = cols.shape
    Cp, B, K = streams.num_columns, 128, CTR_SLOTS
    lid, sl, gh_dy, gh = sparse_pass_inputs(torch, H, N, K, 11)
    nnz = ds._inner.sparse.nnz
    rows = []
    for name, input_dtype, replaces in (
            ("hist_sparse_int8", "int8",
             "lightgbm_tpu/ops/histogram.py:1180"),
            ("hist_sparse_f32", "float32",
             "lightgbm_tpu/ops/histogram.py:1133")):
        quant = input_dtype == "int8"
        srow, vals, tot, scale = H._sparse_pass(lid, gh, sl, input_dtype)
        errs = [sparse_check(torch, H, SS, name, streams, zb, srow, vals,
                             tot, scale, K, Cp, B, quant)]
        if not quant:
            dsrow, dvals, dtot, _ = H._sparse_pass(lid, gh_dy, sl,
                                                   input_dtype)
            errs.append(sparse_check(torch, H, SS, name, streams, zb, dsrow,
                                     dvals, dtot, None, K, Cp, B, True))
            del dsrow, dvals, dtot
        gc.collect()
        torch.cuda.empty_cache()
        if quant:
            whole_pass_check(torch, H, sp, lid, gh, sl, Cp, B)
        ms = time_ms(torch, lambda: SS._hist_streams_cuda(
            streams, zb, srow, vals, tot, scale, K, Cp, B), 10)
        plain = time_ms(torch, lambda: SS.hist_streams_plain(
            streams, zb, srow, vals, tot, scale, K, Cp, B), 2, 1)
        # one index_add_ over the stored entries' flattened (slot, col,
        # channel, bin) indices, built beforehand: the stored-entry sums
        # alone (no zero bins, no dequantize)
        acc = vals.dtype
        r0, j0 = torch.nonzero((cols < Cp) & (srow < K)[:, None],
                               as_tuple=True)
        base = ((srow[r0].long() * Cp + cols[r0, j0].long()) * (3 * B)
                + binsv[r0, j0].long().clamp(max=B - 1))
        idx = torch.cat([base + ch * B for ch in range(3)])
        v = torch.cat([vals[ch, r0] for ch in range(3)]).to(acc)
        out = torch.zeros(K * Cp * 3 * B, dtype=acc, device=dev)
        del base, r0, j0
        lib = time_ms(torch, lambda: out.zero_().index_add_(0, idx, v), 5, 1)
        del idx, v, out
        gc.collect()
        torch.cuda.empty_cache()
        bms, by, _, entries = sparse_bound(torch, cols, srow, vals, K, Cp,
                                           B)
        rows.append(dict(name=name, route="cuda",
                         source="lightgbm_tpu_torch/csrc/hist_sparse.cu",
                         replaces=replaces, max_abs_err=max(errs), ms=ms,
                         plain_ms=plain, bound_ms=bms, bound_by=by,
                         library_ms=lib))
        print(f"[sparse kernels] {name}: N={N} R={R} nnz={nnz} "
              f"(of rows in a slot, with a value: {entries}) K={K} Cp={Cp} "
              f"B={B} "
              f"max_abs_err={max(errs):.3g} ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={bms:.4f} ({by})", flush=True)
        del srow, vals, tot, scale

    # K7 at K=84 (LEAVES_PER_BATCH), B=256: alone and through the whole
    # pass, bitwise; once as the module's constants have it, once with
    # slot tiles and long-column chunks forced (every column of more than
    # 2^15 entries in chunks, slots in tiles of 20)
    K84, B256 = 84, 256
    lid, sl, _, gh = sparse_pass_inputs(torch, H, N, K84, 12)
    srow, vals, tot, scale = H._sparse_pass(lid, gh, sl, "int8")
    nb = min(streams.num_bins, B256)
    for budget, chunk in ((SS.SPARSE_SMEM_BUDGET, SS.SPARSE_BLOCK_ENTRIES),
                          (20 * 3 * (nb | 1) * 4, 1 << 15)):
        saved = SS.SPARSE_SMEM_BUDGET, SS.SPARSE_BLOCK_ENTRIES
        SS.SPARSE_SMEM_BUDGET, SS.SPARSE_BLOCK_ENTRIES = budget, chunk
        try:
            k_tile = SS.slot_tile(K84, nb, budget, 3)
            plan = streams.plan(chunk)
            err = sparse_check(torch, H, SS, "hist_sparse_int8", streams, zb,
                               srow, vals, tot, scale, K84, Cp, B256, True)
            gc.collect()
            torch.cuda.empty_cache()
            whole_pass_check(torch, H, sp, lid, gh, sl, Cp, B256)
            ms = time_ms(torch, lambda: SS._hist_streams_cuda(
                streams, zb, srow, vals, tot, scale, K84, Cp, B256), 5)
        finally:
            SS.SPARSE_SMEM_BUDGET, SS.SPARSE_BLOCK_ENTRIES = saved
        bms, by, _, entries = sparse_bound(torch, cols, srow, vals, K84, Cp,
                                           B256)
        print(f"[sparse kernels] hist_sparse_int8 K={K84} B={B256} nb={nb} "
              f"k_tile={k_tile} slot tiles={-(-K84 // k_tile)} chunk={chunk} "
              f"chunked columns={plan.n_long} chunks={plan.n_parts} "
              f"max_abs_err={err:.3g} ms={ms:.4f} bound_ms={bms:.4f} ({by})",
              flush=True)
    del lid, sl, gh, srow, vals, tot, scale
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_learner_passes(torch, lt, H, SS, params, ds, sp):
    """K7 / K8 at the pass shapes the learner makes (end of phase 5): one
    tree per dtype on the ctr store, with the kernel's wrapper recording
    each pass's inputs; every recorded pass is then held against the
    plain version (int8 bitwise, float32 within n * 2^-23 * sum|x|) and
    timed, and their sums over the tree are printed."""
    real = SS._hist_streams_cuda
    cols = sp[0]
    for dtype, name in (("float32", "hist_sparse_f32"),
                        ("int8", "hist_sparse_int8")):
        passes = []

        def record(st, zb, srow, vals, tot, scale, K, Cp, B):
            passes.append((st, zb, srow.clone(), vals.clone(), tot.clone(),
                           None if scale is None else scale.clone(), K, Cp,
                           B))
            return real(st, zb, srow, vals, tot, scale, K, Cp, B)
        SS._hist_streams_cuda = record
        try:
            lt.train(dict(params, histogram_dtype=dtype), ds, 1)
        finally:
            SS._hist_streams_cuda = real
        per = []
        for i, (st, zb, srow, vals, tot, scale, K, Cp, B) in \
                enumerate(passes):
            err = sparse_check(torch, H, SS, name, st, zb, srow, vals, tot,
                               scale, K, Cp, B, name == "hist_sparse_int8")
            ms = time_ms(torch, lambda: real(st, zb, srow, vals, tot, scale,
                                             K, Cp, B), 10)
            plain = time_ms(torch, lambda: SS.hist_streams_plain(
                st, zb, srow, vals, tot, scale, K, Cp, B), 2, 1)
            bms, by, n_slotted, entries = sparse_bound(torch, cols, srow,
                                                       vals, K, Cp, B)
            per.append(dict(K=K, rows=n_slotted, entries=entries,
                            max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=bms, bound_by=by))
            print(f"[learner passes] {name} pass {i}: K={K} rows in a slot "
                  f"{n_slotted} entries {entries} max_abs_err={err:.3g} "
                  f"ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bms:.4f} "
                  f"({by})", flush=True)
        del passes
        gc.collect()
        torch.cuda.empty_cache()
        tree = dict(passes=len(per),
                    ms_per_tree=sum(p["ms"] for p in per),
                    plain_ms_per_tree=sum(p["plain_ms"] for p in per),
                    bound_ms_per_tree=sum(p["bound_ms"] for p in per),
                    largest=max(per, key=lambda p: p["ms"]))
        print(f"[learner passes] {name} per tree: {json.dumps(tree)}",
              flush=True)


def drive_ctr(torch, lt, kernels, dataset_mod, params, ds, vs, Xv,
              warmup, timed):
    """lightgbm_tpu_torch.train on the built ctr Datasets, NDCG@1..5 of
    the valid set every iteration; counts zeroed before, read after.
    s/iter as in `drive`."""
    gc.collect()
    kernels.reset_launches()
    dataset_mod.reset_sparse_fallbacks()
    n, res, marks = warmup + timed, {}, []
    torch.cuda.synchronize()
    t = time.perf_counter()
    bst = lt.train(params, ds, n, valid_sets=[vs], evals_result=res,
                   callbacks=[steady_window(torch, warmup, n, marks)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if bst.num_trees() != n:
        fail(f"ctr training stopped early: {bst.num_trees()} of {n}")
    launches = dict(kernels.LAUNCHES)
    fallbacks = dataset_mod.sparse_fallbacks()
    nd5 = res["valid_0"]["ndcg@5"]
    dev_raw = bst._gbdt.valid_sets[0][2].score[0].double().cpu().numpy()
    t = time.perf_counter()
    host_raw = bst.predict(Xv, raw_score=True)
    predict_s = time.perf_counter() - t
    st = dict(s_per_iter=(marks[1] - marks[0]) / timed, train_wall_s=wall,
              ndcg={k: [v[0], v[-1]] for k, v in res["valid_0"].items()},
              syncs_per_tree=statistics.mean(bst._gbdt.host_syncs_per_tree),
              launches=launches,
              launches_per_tree={k: v / n for k, v in launches.items() if v},
              sparse_fallbacks=fallbacks,
              valid_walk_vs_host=float(np.abs(dev_raw - host_raw).max()),
              predict_s=predict_s,
              peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not (math.isfinite(nd5[0]) and math.isfinite(nd5[-1])
            and nd5[-1] >= nd5[0]):
        fail(f"valid NDCG@5 went {nd5[0]} -> {nd5[-1]}")
    if fallbacks:
        fail(f"a sparse store was densified {fallbacks} times")
    if st["valid_walk_vs_host"] > 1e-4:
        fail("device valid scores disagree with the host walk: "
             f"{st['valid_walk_vs_host']}")
    return bst, st


def phase_ctr_main(torch, lt, kernels, dataset_mod, params, ds, vs, Xv):
    out = {}
    for dtype, name in (("float32", "hist_sparse_f32"),
                        ("int8", "hist_sparse_int8")):
        torch.cuda.reset_peak_memory_stats()
        _, st = drive_ctr(torch, lt, kernels, dataset_mod,
                          dict(params, histogram_dtype=dtype), ds, vs, Xv,
                          2, 10)
        print(f"[ctr main] {dtype}: {json.dumps(st)}", flush=True)
        for k in (name, "table_lookup"):
            if st["launches"][k] <= 0:
                fail(f"ctr main path ({dtype}) never launched {k}")
        out[dtype] = st
    return out


def drive(torch, lt, kernels, params, X, y, Xv, yv, warmup, timed):
    """Train through lightgbm_tpu_torch.train (the valid set's AUC each
    iteration) and predict with Booster.predict, with the launch counts
    zeroed before and read after.  s/iter excludes set-up and warm-up:
    the host clock over iterations warmup+1 .. warmup+timed of one train,
    between device synchronisations at the end of iteration warmup and of
    the last (`steady_window`)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, params=params).construct()
    vs = lt.Dataset(Xv, yv, reference=ds, params=params).construct()
    setup_s = time.perf_counter() - t0
    n, res, marks = warmup + timed, {}, []
    torch.cuda.synchronize()
    t = time.perf_counter()
    bst = lt.train(params, ds, n, valid_sets=[vs], evals_result=res,
                   callbacks=[steady_window(torch, warmup, n, marks)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if bst.num_trees() != n:
        fail(f"training stopped early: {bst.num_trees()} of {n} trees")
    t = time.perf_counter()
    pred = bst.predict(Xv)
    predict_s = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    syncs = bst._gbdt.host_syncs_per_tree
    return bst, dict(setup_s=setup_s,
                     s_per_iter=(marks[1] - marks[0]) / timed,
                     train_wall_s=wall, auc=res["valid_0"]["auc"][-1],
                     syncs_per_tree=statistics.mean(syncs),
                     predict_s=predict_s, launches=launches), pred, ds


def phase_main(torch, lt, kernels):
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs
    X, y = synth_higgs(MAIN_ROWS)
    Xv, yv = synth_higgs(VALID_ROWS, seed=7)
    params = dict(NORTH_STAR_PARAMS, device_type=GPU)
    bst, st, pred, ds = drive(torch, lt, kernels, params, X, y, Xv, yv, 2,
                              10)
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
    params32 = dict(params, histogram_dtype="float32")
    _, st32, _, _ = drive(torch, lt, kernels, params32, X, y, Xv, yv, 2, 10)
    print(f"[main] float32: {json.dumps(st32)}", flush=True)
    print(f"[main] float32: s/iter {st32['s_per_iter']:.4f} valid AUC "
          f"{st32['auc']:.6f}", flush=True)
    for k in ("hist_masked_f32", "table_lookup", "partition_rows"):
        if st32["launches"][k] <= 0:
            fail(f"main path (float32) never launched {k}")
    if not (math.isfinite(st32["auc"]) and st32["auc"] > 0.75):
        fail(f"float32 valid AUC {st32['auc']} is not a trained model's")
    return st, st32, params, ds


def tree_sums(per, label):
    """Print the per-tree sums of a replay's calls (ms by events around
    each call, graph ms, plain ms, bound ms) and, by rows a call, how
    they split."""
    tree = dict(calls=len(per), ms_per_tree=sum(p["ms"] for p in per),
                graph_ms_per_tree=sum(p["graph_ms"] for p in per),
                plain_ms_per_tree=sum(p["plain_ms"] for p in per),
                bound_ms_per_tree=sum(p["bound_ms"] for p in per),
                largest=max(per, key=lambda p: p["ms"]))
    buckets = {}
    for lo, hi in ((1_000_000, None), (100_000, 1_000_000),
                   (10_000, 100_000), (0, 10_000)):
        sel = [p for p in per if p["rows"] >= lo
               and (hi is None or p["rows"] < hi)]
        if sel:
            buckets[f"rows>={lo}"] = dict(
                calls=len(sel), ms=sum(p["ms"] for p in sel),
                graph_ms=sum(p["graph_ms"] for p in sel),
                bound_ms=sum(p["bound_ms"] for p in sel))
    tree["by_rows"] = buckets
    print(f"[tree replay] {label} per tree: {json.dumps(tree)}", flush=True)


def reorder_tol(torch, plain_fn, vals):
    """Per-cell bound on a float histogram's reordering: n * 2^-23 *
    sum|x| over the cell's n positions (n float additions in any order
    lie within n * 2^-24 * sum|x| of the exact sum, and the kernel and
    the plain version's index_add_ both reorder); `plain_fn(v)` sums
    the values v [3, C] as the checked call does."""
    s = plain_fn(torch.stack([vals[0].abs(), vals[1].abs(),
                              torch.ones_like(vals[2])])).double()
    return s[:, :, 2:3] * 2.0 ** -23 * s


def phase_rounds_tree(torch, lt, H, params, ds, label):
    """The dense histogram kernel of the rounds learner on every call of
    one tree: K1 when params ask for int8 histograms, K2 for float32.
    The wrapper records each call's inputs during a one-tree train; each
    call is then held against its plain version (over the slot runs'
    bounds for the gathered feed, the leaf ids for the masked one) and
    run twice: K1 bitwise, K2 within n * 2^-23 * sum|x| a cell
    (`reorder_tol`) and bitwise from run to run; then timed and given
    its bound."""
    name = "_hist_f_cuda" if params.get("histogram_dtype") == "float32" \
        else "_hist_q_cuda"
    kname = "hist_masked_f32" if name == "_hist_f_cuda" \
        else "hist_masked_int8"
    real = getattr(H, name)
    calls = []

    def record(bins, rows, row_idx, vals, B, **kw):
        calls.append((bins, rows, None if row_idx is None
                      else row_idx.clone(), vals.clone(), B,
                      {k: v.clone() if torch.is_tensor(v) else v
                       for k, v in kw.items()}))
        return real(bins, rows, row_idx, vals, B, **kw)
    setattr(H, name, record)
    try:
        lt.train(params, ds, 1)
    finally:
        setattr(H, name, real)
    per = []
    for i, (bins, rows, row_idx, vals, B, kw) in enumerate(calls):
        lid, sl, base = kw.get("lid"), kw.get("sl"), kw.get("base")
        rb = kw.get("round_bf16", False)
        F, C = bins.shape[0], vals.shape[1]

        def run():
            return real(bins, rows, row_idx, vals, B, **kw)
        F4 = rows.rows.shape[1] if rows is not None else \
            F * bins.element_size()
        if base is not None:
            def plain_fn(v=vals):
                return H._segments_plain(bins, rows, row_idx, v, base, B,
                                         rb)
            K, n = base.numel() - 1, int(base[-1])
            nbytes = n * (F4 + 4 + 12) + (K + 1) * 8
        else:
            def plain_fn(v=vals):
                return H._hist_plain(bins, row_idx, lid, v, sl, B, rb,
                                     rows=rows)
            K = sl.numel()
            n = int(torch.isin(lid, sl).sum())
            nbytes = C * 4 + n * (F4 + 12)
        got, again, ref = run(), run(), plain_fn()
        torch.cuda.synchronize()
        err = (got.double() - ref.double()).abs().max().item()
        if vals.is_floating_point():
            ok = bool(((got.double() - ref.double()).abs()
                       <= reorder_tol(torch, plain_fn, vals)).all())
        else:
            ok = torch.equal(got, ref)
        if not (ok and torch.equal(got, again)):
            fail(f"{kname} on call {i} of the {label} tree differs from its "
                 f"plain version (max |diff| {err})")
        del got, again, ref
        ms = time_ms(torch, run, 10)
        graph = graph_ms(torch, run, 5)
        plain = time_ms(torch, plain_fn, 2, 1)
        bms, by = bound_ms(nbytes + K * F * 3 * B * 4, 3.0 * F * n)
        per.append(dict(feed="gathered" if base is not None else "masked",
                        K=K, rows=n, nb=rows.num_bins if rows is not None
                        else B, max_abs_err=err, ms=ms, graph_ms=graph,
                        plain_ms=plain, bound_ms=bms, bound_by=by))
        print(f"[tree replay] {kname} ({label}) call {i}: "
              f"{json.dumps(per[-1])}", flush=True)
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    if not per:
        fail(f"the {label} tree launched no {kname}")
    tree_sums(per, f"{kname} ({label})")


def phase_k5_tree(torch, lt, H, params, ds):
    """Kernel K5 on every call of one onehot exact-learner tree: the
    wrapper records each call's inputs during a one-tree train; each call
    is then checked as in phase 9 (count channel bitwise, the others
    within n * 2^-23 * sum|x|, two runs bitwise), timed and given its
    bound."""
    real = H._from_indices_cuda
    calls = []

    def record(bins_t, gp, hp, idx, B, input_dtype="float32", count=None,
               nb=None):
        # the learner writes none of these after the call
        calls.append((bins_t, gp, hp, idx, B, input_dtype, count, nb))
        return real(bins_t, gp, hp, idx, B, input_dtype, count, nb)
    H._from_indices_cuda = record
    try:
        lt.train(dict(params, tree_growth="exact"), ds, 1)
    finally:
        H._from_indices_cuda = real
    per = []
    for i, (bt, gp, hp, idx, B, dt, count, nb) in enumerate(calls):
        err = gathered_check(torch, H, f"hist_gathered (tree call {i})", bt,
                             gp, hp, idx, B, count, nb, False)
        def run():
            return real(bt, gp, hp, idx, B, dt, count, nb)
        ms = time_ms(torch, run, 10)
        graph = graph_ms(torch, run, 5)
        plain = time_ms(torch, lambda: H._from_indices_plain(
            bt, gp, hp, idx, B, dt, count, nb), 1, 1)
        n = idx.numel() if count is None else count
        bms, by = gathered_bound(bt, n, B)
        per.append(dict(cap=idx.numel(), rows=n, max_abs_err=err, ms=ms,
                        graph_ms=graph, plain_ms=plain, bound_ms=bms,
                        bound_by=by))
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    tree_sums(per, "hist_gathered (onehot, exact learner)")


def compare_first_trees(label, tc, tg, m_c, m_g, metric):
    """First trees of the CPU and card runs: identical, unless their
    first differing split is an f32 gain tie; metrics within 1e-4."""
    n = min(tc.num_leaves, tg.num_leaves) - 1
    diff = [i for i in range(n)
            if (tc.split_feature[i], tc.threshold_in_bin[i])
            != (tg.split_feature[i], tg.threshold_in_bin[i])]
    print(f"[card-vs-cpu] {label}: leaves cpu={tc.num_leaves} "
          f"cuda={tg.num_leaves} differing splits={len(diff)} {metric} "
          f"cpu={m_c} cuda={m_g}", flush=True)
    if diff or tc.num_leaves != tg.num_leaves:
        i = diff[0] if diff else n
        gc_, gg = float(tc.split_gain[i]), float(tg.split_gain[i])
        tie = (diff and abs(gc_ - gg) <= 1e-5 * max(abs(gc_), abs(gg)))
        print(f"[card-vs-cpu] {label}: first differing split at node {i}: "
              f"cpu (feature {tc.split_feature[i]}, bin "
              f"{tc.threshold_in_bin[i]}, gain {gc_!r}) vs cuda (feature "
              f"{tg.split_feature[i]}, bin {tg.threshold_in_bin[i]}, gain "
              f"{gg!r}); f32 gain tie: {bool(tie)}", flush=True)
        if not tie:
            fail(f"card and CPU grew different first trees ({label})")
    if not abs(m_c - m_g) <= 1e-4:
        fail(f"card and CPU valid {metric} differ ({label}): {m_c} vs "
             f"{m_g}")


def phase_onehot_setup(lt):
    """The onehot training and valid Datasets, built once (phase 8)."""
    from lightgbm_tpu_torch.synth import ONEHOT_PARAMS, synth_onehot
    params = dict(ONEHOT_PARAMS, device_type=GPU)
    t0 = time.perf_counter()
    X, y = synth_onehot(ONEHOT_ROWS)
    Xv, yv = synth_onehot(ONEHOT_VALID_ROWS, seed=7)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, params=params).construct()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs = lt.Dataset(Xv, yv, reference=ds, params=params).construct()
    valid_s = time.perf_counter() - t0
    inner = ds._inner
    st = dict(rows=inner.num_data, features=inner.num_features,
              store_columns=inner.num_store_columns,
              conflict_rows=inner.bundle_conflict_rows,
              max_store_bins=inner.max_num_bin, synth_s=synth_s,
              setup_binning_s=inner.setup_seconds["binning"],
              setup_store_s=inner.setup_seconds["store"],
              setup_train_total_s=train_s, setup_valid_s=valid_s)
    print(f"[onehot setup] {json.dumps(st)}", flush=True)
    if (inner.num_features != 240 or inner.num_store_columns != 40
            or inner.bundle_conflict_rows != 0
            or vs._inner.bundle_plan is not inner.bundle_plan):
        fail("EFB did not bundle the onehot workload's 240 features into "
             "40 store columns with 0 conflicting rows")
    del X
    return params, ds, vs, Xv


def gathered_check(torch, H, name, bins_t, gp, hp, idx, B, count, nb,
                   exact: bool) -> float:
    """K5 against its plain version on one histogram's inputs: bitwise
    when `exact`, else every cell within n * 2^-23 * sum|x|; the count
    channel always bitwise; two runs of the kernel bitwise equal.
    Returns the max |diff|."""
    got = H._from_indices_cuda(bins_t, gp, hp, idx, B, "float32", count, nb)
    again = H._from_indices_cuda(bins_t, gp, hp, idx, B, "float32", count,
                                 nb)
    ref = H._from_indices_plain(bins_t, gp, hp, idx, B, "float32", count, nb)
    torch.cuda.synchronize()
    err = (got.double() - ref.double()).abs().max().item()
    if not torch.equal(got, again):
        fail(f"{name}: two runs of the kernel differ")
    if not torch.equal(got[:, 2], ref[:, 2]):
        fail(f"{name}: the count channel differs from the plain version")
    if exact and not torch.equal(got, ref):
        fail(f"{name} differs from its plain version: max |diff| {err}")
    if not exact:
        absum = H._from_indices_plain(bins_t, gp.abs(), hp.abs(), idx, B,
                                      "float32", count, nb)
        tol = absum[:, 2:3].double() * 2.0 ** -23 * absum.double()
        bad = ((got.double() - ref.double()).abs() > tol).sum().item()
        if bad:
            fail(f"{name}: {bad} cells beyond n*2^-23*sum|x| (max |diff| "
                 f"{err})")
    return err


def gathered_bound(bins_t, count, B):
    """(bound ms, basis) of one K5 call over `count` rows: the row ids,
    the rows' bins in the feed's bytes and their (grad, hess), read once;
    the [C, 3, B] output written once; three adds per (row, column)."""
    C = bins_t.shape[1]
    return bound_ms(count * (4 + C * bins_t.element_size() + 8)
                    + C * 3 * B * 4, 3.0 * C * count)


def multirow_check(torch, H, gb, vals, B, exact: bool) -> float:
    """K6 against its plain version, as gathered_check."""
    got = H._multirow_cuda(gb, vals, B, "float32")
    ref = H.hist_multileaf_xla(gb, vals, num_bins_padded=B)
    torch.cuda.synchronize()
    err = (got.double() - ref.double()).abs().max().item()
    if exact and not torch.equal(got, ref):
        fail(f"hist_multirow differs from its plain version: {err}")
    if not exact:
        absum = H.hist_multileaf_xla(gb, vals.abs(), num_bins_padded=B)
        ones = torch.ones((1, gb.shape[1]), device=gb.device)
        n = H.hist_multileaf_xla(gb, ones, num_bins_padded=B)
        tol = n.double() * 2.0 ** -23 * absum.double()
        bad = ((got.double() - ref.double()).abs() > tol).sum().item()
        if bad:
            fail(f"hist_multirow: {bad} cells beyond n*2^-23*sum|x| (max "
                 f"|diff| {err})")
    return err


def phase_gathered_kernels(torch, H, ds):
    """K5 and K6 against their plain versions at the exact learner's
    shapes (phase 9).  Returns their {"kernels"} rows: K5 at the onehot
    root, K6 at M=128."""
    from lightgbm_tpu_torch.learner.common import (padded_bin_count,
                                                   sentinel_bins_feed)
    dev = torch.device(GPU)
    rng = np.random.RandomState(13)
    inner = ds._inner
    N = inner.num_data

    def values(n):
        """(real, dyadic) padded gradient pairs [n+1] on the card."""
        out = []
        for g, h in ((rng.randn(n), rng.rand(n) * 0.25),
                     (np.clip(np.round(rng.randn(n) * 64), -1000, 1000) / 64,
                      np.round(rng.rand(n) * 64) / 256)):
            out.append(tuple(torch.as_tensor(
                np.concatenate([v, [0.0]]).astype(np.float32), device=dev)
                for v in (g, h)))
        return out

    # the exact learner's byte feeds: the onehot store (40 columns of 7
    # bins) and a north-star-shaped one (28 columns of 255 bins)
    onehot_bt = torch.as_tensor(sentinel_bins_feed(inner), device=dev)
    onehot_B, onehot_nb = padded_bin_count(inner.max_num_bin), \
        inner.max_num_bin
    ns_bt = torch.as_tensor(np.concatenate([
        rng.randint(0, 255, size=(N, 28)), np.zeros((1, 28))]).astype(
            np.uint8), device=dev)
    leaf_idx = np.full(LEAF_CAP, N, np.int32)
    leaf_idx[:LEAF_ROWS] = np.sort(rng.choice(N, LEAF_ROWS, replace=False))
    root_idx = torch.arange(N, dtype=torch.int32, device=dev)
    shapes = (("onehot root", onehot_bt, onehot_B, onehot_nb, root_idx, N),
              ("onehot leaf", onehot_bt, onehot_B, onehot_nb,
               torch.as_tensor(leaf_idx, device=dev), LEAF_ROWS),
              ("north-star root", ns_bt, 256, 255, root_idx, N))
    rows = []
    for label, bt, B, nb, idx, count in shapes:
        C = bt.shape[1]
        (g, h), (gd, hd) = values(N)
        errs = [gathered_check(torch, H, f"hist_gathered ({label})", bt, gd,
                               hd, idx, B, count, nb, True),
                gathered_check(torch, H, f"hist_gathered ({label})", bt, g, h,
                               idx, B, count, nb, False)]
        def k5():
            return H._from_indices_cuda(bt, g, h, idx, B, "float32", count,
                                        nb)
        ms = time_ms(torch, k5, 20)
        graph = graph_ms(torch, k5)
        host = host_us(torch, k5)
        plain = time_ms(torch, lambda: H._from_indices_plain(
            bt, g, h, idx, B, "float32", count, nb), 3, 1)
        live = idx[:count].long()
        E = int(live.numel())
        b = bt[live].long()                                     # [E, C]
        f = torch.arange(C, device=dev)[None, :]
        flat = torch.cat([((f * 3 + ch) * B + b).reshape(-1)
                          for ch in range(3)])
        vals = torch.cat([v[live][:, None].expand(E, C).reshape(-1)
                          for v in (g, h, torch.ones_like(g))])
        out = torch.zeros(C * 3 * B, device=dev)
        del b
        lib = time_ms(torch, lambda: out.zero_().index_add_(0, flat, vals),
                      5, 1)
        del flat, vals, out
        gc.collect()
        torch.cuda.empty_cache()
        bms, by = gathered_bound(bt, E, B)
        print(f"[gathered kernels] hist_gathered {label}: cap={idx.numel()} "
              f"rows={E} C={C} B={B} nb={nb} feed={bt.dtype} "
              f"max_abs_err={max(errs):.3g} ms={ms:.4f} "
              f"graph_ms={graph:.4f} host_us={host:.1f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={bms:.4f} ({by})", flush=True)
        if label == "onehot root":
            rows.append(dict(name="hist_gathered", route="cuda",
                             source="lightgbm_tpu_torch/csrc/hist_gathered.cu",
                             replaces="lightgbm_tpu/ops/histogram.py:178",
                             max_abs_err=max(errs), ms=ms, graph_ms=graph,
                             plain_ms=plain, bound_ms=bms, bound_by=by,
                             library_ms=lib))
    del onehot_bt, ns_bt
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K6: M value rows over an [F, C] store ---------------------------
    F, M, B, C = 28, K6_ROWS, 256, ONEHOT_ROWS
    gb = torch.as_tensor(rng.randint(0, 255, size=(F, C)).astype(np.int32),
                         device=dev)
    vals = torch.as_tensor(rng.randn(M, C).astype(np.float32), device=dev)
    dy = torch.round(vals * 16) / 16
    errs = [multirow_check(torch, H, gb, dy, B, True),
            multirow_check(torch, H, gb, vals, B, False)]
    del dy
    ms = time_ms(torch, lambda: H._multirow_cuda(gb, vals, B, "float32"), 10)
    plain = time_ms(torch, lambda: H.hist_multileaf_xla(
        gb, vals, num_bins_padded=B), 2, 1)
    # one scatter_add_: bins broadcast over the M rows, values over the F
    # features (stride-0 views, nothing materialised)
    index = gb.long()[:, None, :].expand(F, M, C)
    src = vals[None, :, :].expand(F, M, C)
    out = torch.zeros((F, M, B), device=dev)
    lib = time_ms(torch, lambda: out.zero_().scatter_add_(2, index, src), 5,
                  1)
    del index, src, out
    bms, by = bound_ms(F * C * 4 + M * C * 4 + F * M * B * 4, float(F) * M * C)
    print(f"[gathered kernels] hist_multirow: F={F} M={M} C={C} B={B} "
          f"max_abs_err={max(errs):.3g} ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} bound_ms={bms:.4f} ({by})", flush=True)
    rows.append(dict(name="hist_multirow", route="cuda",
                     source="lightgbm_tpu_torch/csrc/hist_gathered.cu",
                     replaces="lightgbm_tpu/ops/histogram.py:252",
                     max_abs_err=max(errs), ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=lib))
    del gb, vals
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def drive_onehot(torch, lt, kernels, params, ds, vs, Xv, warmup, timed):
    """lightgbm_tpu_torch.train on the built onehot Datasets, the valid
    AUC every iteration; counts zeroed before, read after; s/iter as in
    `drive`."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    n, res, marks = warmup + timed, {}, []
    torch.cuda.synchronize()
    t = time.perf_counter()
    bst = lt.train(params, ds, n, valid_sets=[vs], evals_result=res,
                   callbacks=[steady_window(torch, warmup, n, marks)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    if bst.num_trees() != n:
        fail(f"onehot training stopped early: {bst.num_trees()} of {n}")
    auc = res["valid_0"]["auc"]
    models = bst._gbdt.models
    dev_raw = bst._gbdt.valid_sets[0][2].score[0].double().cpu().numpy()
    walk_err = float(np.abs(dev_raw - bst.predict(Xv, raw_score=True)).max())
    st = dict(learner=type(bst._gbdt.learner).__name__,
              s_per_iter=(marks[1] - marks[0]) / timed, train_wall_s=wall,
              auc_first=auc[0], auc_last=auc[-1],
              leaves_per_tree=statistics.mean(t.num_leaves for t in models),
              syncs_per_tree=statistics.mean(bst._gbdt.host_syncs_per_tree),
              launches=launches,
              launches_per_tree={k: v / n for k, v in launches.items() if v},
              valid_walk_vs_host=walk_err,
              peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not (math.isfinite(auc[0]) and math.isfinite(auc[-1])):
        fail(f"onehot valid AUC is not finite: {auc}")
    if walk_err > 1e-4:
        fail(f"onehot device valid scores disagree with the host walk: "
             f"{walk_err}")
    return st


def phase_onehot_main(torch, lt, kernels, params, ds, vs, Xv):
    st = drive_onehot(torch, lt, kernels, dict(params, tree_growth="exact"),
                      ds, vs, Xv, 2, 10)
    print(f"[onehot main] exact: {json.dumps(st)}", flush=True)
    if st["learner"] != "SerialTreeLearner":
        fail(f"tree_growth=exact ran {st['learner']}")
    if st["launches"]["hist_gathered"] <= 0:
        fail("the exact learner never launched hist_gathered")
    if not st["auc_last"] > st["auc_first"]:
        fail(f"onehot valid AUC did not rise: {st['auc_first']} -> "
             f"{st['auc_last']}")
    rd = drive_onehot(torch, lt, kernels, params, ds, vs, Xv, 2, 4)
    print(f"[onehot main] rounds: {json.dumps(rd)}", flush=True)
    if rd["learner"] != "RoundsTreeLearner":
        fail(f"tree_growth=auto ran {rd['learner']}")
    for k in ("hist_masked_int8", "table_lookup", "partition_rows"):
        if rd["launches"][k] <= 0:
            fail(f"the rounds learner on the bundled store never launched "
                 f"{k}")
    return st, rd


def phase_lossless(lt):
    """Bundled against unbundled training on the card (phase 11)."""
    from lightgbm_tpu_torch.synth import ONEHOT_PARAMS, synth_onehot
    X, y = synth_onehot(ONEHOT_COMPARE)
    for growth in ("exact", "auto"):
        out = {}
        for eb in (True, False):
            p = dict(ONEHOT_PARAMS, device_type=GPU, tree_growth=growth,
                     enable_bundle=eb)
            ds = lt.Dataset(X, y, params=p)
            bst = lt.train(p, ds, 1)
            if (ds._inner.bundle_plan is not None) != eb:
                fail(f"enable_bundle={eb} did not decide the bundling")
            out[eb] = (bst._gbdt.models[0], bst.predict(X))
        compare_first_trees(f"onehot bundled vs not ({growth})", out[True][0],
                            out[False][0], 0.0, 0.0, "-")
        d = float(np.abs(out[True][1] - out[False][1]).max())
        print(f"[lossless] {growth}: predictions max |diff| {d}", flush=True)
        if d > 1e-5:
            fail(f"bundled and unbundled predictions differ by {d} "
                 f"({growth})")


def phase_onehot_card_vs_cpu(lt):
    """The exact learner on the CPU and on the card (phase 12)."""
    from lightgbm_tpu_torch.synth import (NORTH_STAR_PARAMS, ONEHOT_PARAMS,
                                          synth_higgs, synth_onehot)
    for label, data, base in (("onehot exact", synth_onehot, ONEHOT_PARAMS),
                              ("higgs exact", synth_higgs,
                               NORTH_STAR_PARAMS)):
        X, y = data(ONEHOT_COMPARE)
        Xv, yv = data(ONEHOT_COMPARE // 5, seed=7)
        out = {}
        for dev in ("cpu", GPU):
            p = dict(base, device_type=dev, tree_growth="exact")
            ds = lt.Dataset(X, y, params=p)
            res = {}
            bst = lt.train(p, ds, 5, valid_sets=[lt.Dataset(Xv, yv,
                                                            reference=ds)],
                           evals_result=res)
            out[dev] = (bst._gbdt.models[0], res["valid_0"]["auc"][-1])
        compare_first_trees(label, out["cpu"][0], out[GPU][0], out["cpu"][1],
                            out[GPU][1], "auc")


def phase_card_vs_cpu(lt):
    from lightgbm_tpu_torch.synth import (CTR_PARAMS, NORTH_STAR_PARAMS,
                                          synth_ctr, synth_higgs)
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
    compare_first_trees("higgs", out["cpu"][0], out[GPU][0], out["cpu"][1],
                        out[GPU][1], "auc")
    n, f = CTR_COMPARE
    X, y, g = synth_ctr(n, f, CTR_DENSITY)
    Xv, yv, gv = synth_ctr(n // 5, f, CTR_DENSITY, seed=7)
    Xv = Xv.toarray()
    for dtype in ("float32", "int8"):
        out = {}
        for dev in ("cpu", GPU):
            p = dict(CTR_PARAMS, device_type=dev, histogram_dtype=dtype)
            ds = lt.Dataset(X, y, group=g, params=p)
            res = {}
            bst = lt.train(p, ds, 3, valid_sets=[lt.Dataset(
                Xv, yv, group=gv, reference=ds)], evals_result=res)
            if bst._gbdt.train_set.sparse is None:
                fail("the card-vs-CPU ctr run did not use the sparse store")
            out[dev] = (bst._gbdt.models[0], res["valid_0"]["ndcg@5"][-1])
        compare_first_trees(f"ctr {dtype}", out["cpu"][0], out[GPU][0],
                            out["cpu"][1], out[GPU][1], "ndcg@5")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        sys.exit(2)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import dataset as dataset_mod
    from lightgbm_tpu_torch import kernels
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import lookup as LK
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops import sparse_streams as SS

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    took = kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})",
          flush=True)
    rows = phase_kernels(torch, kernels, H, LK, P)
    st, st32, ns_params, ns_ds = phase_main(torch, lt, kernels)
    for r in rows:
        src = st32 if r["name"] == "hist_masked_f32" else st
        r["launches"] = src["launches"][r["name"]]
    phase_rounds_tree(torch, lt, H, ns_params, ns_ds, "north-star")
    phase_rounds_tree(torch, lt, H, dict(ns_params, histogram_dtype="float32"),
                      ns_ds, "north-star, float32")
    del ns_ds
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)

    params, ds, vs, Xv, sp = phase_ctr_setup(lt, CTR_ROWS)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    sparse_rows = phase_sparse_kernels(torch, H, SS, ds, sp)
    phase_learner_passes(torch, lt, H, SS, params, ds, sp)
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    ctr = phase_ctr_main(torch, lt, kernels, dataset_mod, params, ds, vs,
                         Xv)
    for r in sparse_rows:
        src = ctr["int8" if r["name"] == "hist_sparse_int8" else "float32"]
        r["launches"] = src["launches"][r["name"]]
    rows += sparse_rows
    del ds, vs, Xv
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_card_vs_cpu(lt)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)

    params, ds, vs, Xv = phase_onehot_setup(lt)
    gathered_rows = phase_gathered_kernels(torch, H, ds)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    ex, _ = phase_onehot_main(torch, lt, kernels, params, ds, vs, Xv)
    for r in gathered_rows:
        # K6 has no caller on any training path (as in the JAX package)
        r["launches"] = ex["launches"][r["name"]]
    rows += gathered_rows
    phase_k5_tree(torch, lt, H, params, ds)
    phase_rounds_tree(torch, lt, H, params, ds, "onehot, rounds learner")
    del ds, vs, Xv
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_lossless(lt)
    phase_onehot_card_vs_cpu(lt)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail("nvidia-smi did not report the card")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
