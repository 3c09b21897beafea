"""K8 (csrc/hist_sparse.cu, the float32 sparse histogram) timed at the
shapes of chip_smoke.py on the card, at several shared-memory budgets of
its slot tiles, beside the K8 of other source files (the kernel as
earlier designs had it, built and bound here the same way), in turns:
the others, each budget, each budget again in reverse, the others.

Passes: the real-valued K=31 pass of phase 5 on the ctr store
(synth_ctr(500_000) x 50,000), the int8 one (K7, which shares the
source, at its own budget), the same pass on the bundled ctr store of
phase 18a (synth_ctr(500_000) x 5,000, enable_bundle), and the K=1 pass
of the fused builder's sparse feed on the ctr store (every row in slot
0, a row mask of 0.9).  Every budget's output must be the same on a
second call (the order of a cell's adds depends on the slots that share
its tile, so two budgets may differ in the last bits); each other
kernel's cells that differ from the first budget's are counted, and so
are those that differ between two of its own calls.  Prints one JSON
line a pass and "[k8] ..." lines.

    python3 scripts/bench_torch_k8.py [--other PATH/hist_sparse.cu:ROWS:BUDGET ...]
        [--budgets 24576,49152,98304]

from the root of a checkout, on a machine with a CUDA card and nvcc
(~5 min, most of it the two stores).  ROWS and BUDGET give the slot
tile the other kernel's wrapper chose: the words a slot takes for each
bin and its shared-memory budget (4 and 98304 for the kernel with float
atomics; 24 and 98304 for one with a copy of the tile a warp).  Each
other kernel is handed one live-row mask a slot tile.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch import kernels  # noqa: E402
from lightgbm_tpu_torch.ops import histogram as H  # noqa: E402
from lightgbm_tpu_torch.ops import sparse_streams as SS  # noqa: E402


def build_other(path: str):
    """The other source's lgbt_hist_sparse, built with nvcc into
    build/kernels/ under a hash of the file and loaded with ctypes."""
    src = open(path, "rb").read()
    out = os.path.join(ROOT, "build", "kernels",
                       f"libhist_sparse_other_{hashlib.sha1(src).hexdigest()[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cmd = [kernels.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
               out, path]
        subprocess.run(cmd, check=True)
    fn = ctypes.CDLL(out).lgbt_hist_sparse
    fn.argtypes = kernels.SIGNATURES["hist_sparse"][2]
    fn.restype = ctypes.c_int
    return fn


def call_other(fn, k_tile, st, zb, srow, vals, tot, K, Cp, B, scale=None):
    """Another kernel on one pass, with its own slot tile."""
    N = srow.shape[0]
    dev = st.e_row.device
    nb = min(st.num_bins, B)
    chunk = SS.SPARSE_BLOCK_ENTRIES
    plan = st.plan(chunk)
    n_tiles = -(-K // k_tile)
    rec = torch.empty((N, 4), dtype=torch.int32, device=dev)
    live = torch.empty(n_tiles * -(-N // 32), dtype=torch.int32,
                       device=dev)
    scratch = tickets = None
    if plan.n_long:
        scratch = torch.empty(plan.n_parts * n_tiles * k_tile * 3 * nb,
                              dtype=vals.dtype, device=dev)
        tickets = torch.zeros(plan.n_long * n_tiles, dtype=torch.int32,
                              device=dev)
    out = torch.empty((K, Cp, 3, B), dtype=torch.float32, device=dev)
    err = fn(st.col_off.data_ptr(), st.e_row.data_ptr(), st.e_bin.data_ptr(),
             st.e_bin.element_size(), plan.w_col.data_ptr(),
             plan.w_chunk.data_ptr(), plan.w_col.shape[0], chunk,
             plan.c_long.data_ptr(), plan.long_base.data_ptr(),
             srow.data_ptr(), vals.data_ptr(), N, live.data_ptr(),
             rec.data_ptr(), tot.data_ptr(), kernels.ptr(scale),
             int(scale is not None), zb.data_ptr(), K,
             k_tile, Cp, B, nb, kernels.ptr(scratch), kernels.ptr(tickets),
             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the other K8 failed to launch: {err}")
    return out


def bench_pass(label, st, zb, srow, vals, tot, K, Cp, B, budgets, others,
               card, scale=None):
    """K8 (or, given int32 values and their `scale`, K7 at the module's
    own budget) against the others on one pass."""
    nb = min(st.num_bins, B)
    quant = scale is not None
    name = "SPARSE_SMEM_BUDGET" if quant else "SPARSE_SMEM_BUDGET_F32"
    saved = getattr(SS, name)
    if quant:
        budgets = [saved]

    def new(b):
        setattr(SS, name, b)
        try:
            return SS._hist_streams_cuda(st, zb, srow, vals, tot, scale, K,
                                         Cp, B)
        finally:
            setattr(SS, name, saved)
    for b in budgets[::-1]:
        ref = new(b)
        if not torch.equal(new(b), ref):
            raise SystemExit(f"[k8] {label}: two calls at budget {b} "
                             "differ")
    times = {b: [] for b in budgets}
    other = []
    for name, fn, rows, budget in others:
        k = SS.slot_tile(K, nb, SS.SPARSE_SMEM_BUDGET if quant else budget,
                         3 if quant else rows)
        o = call_other(fn, k, st, zb, srow, vals, tot, K, Cp, B, scale)
        o2 = call_other(fn, k, st, zb, srow, vals, tot, K, Cp, B, scale)
        other.append(dict(name=name, k_tile=k, ms=[],
                          cells_differing=int((o != ref).sum()),
                          own_calls_differing=int((o != o2).sum())))
        del o, o2
    del ref
    torch.cuda.empty_cache()

    def t_others():
        for (name, fn, rows, budget), row in zip(others, other):
            row["ms"].append(C.time_ms(torch, lambda: call_other(
                fn, row["k_tile"], st, zb, srow, vals, tot, K, Cp, B,
                scale), 10))
    t_others()
    for order in (budgets, budgets[::-1]):
        for b in order:
            times[b].append(C.time_ms(torch, lambda: new(b), 10))
    t_others()
    row = dict(pass_=label, K=K, Cp=Cp, B=B, nb=nb,
               k_tile={b: SS.slot_tile(K, nb, b) for b in budgets},
               ms={b: times[b] for b in budgets}, others=other, card=card)
    print(json.dumps(row), flush=True)
    best = min(budgets, key=lambda b: sum(times[b]))
    print(f"[k8] {label}: fastest budget {best} "
          f"({sum(times[best]) / 2:.4f} ms); "
          + "; ".join(f"{o['name']} {sum(o['ms']) / 2:.4f} ms"
                      for o in other), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--budgets", default="24576,49152,98304")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_k8: no CUDA device", file=sys.stderr)
        sys.exit(2)
    budgets = [int(b) for b in a.budgets.split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    t_all = time.perf_counter()
    kernels.build()
    others = []
    for spec in a.other:
        path, rows, budget = spec.rsplit(":", 2)
        others.append((os.path.basename(os.path.dirname(path)) or path,
                       build_other(path), int(rows), int(budget)))
    dev = torch.device("cuda")
    B, K = 128, C.CTR_SLOTS
    from lightgbm_tpu_torch.synth import CTR_PARAMS, synth_ctr
    _, ds, _, _, sp = C.phase_ctr_setup(lt, C.CTR_ROWS)
    cols, binsv, zb, streams = sp
    N, Cp = cols.shape[0], streams.num_columns
    lid, sl, _, gh = C.sparse_pass_inputs(torch, H, N, K, 11)
    srow, vals, tot, _ = H._sparse_pass(lid, gh, sl, "float32")
    bench_pass("ctr K=31", streams, zb, srow, vals, tot, K, Cp, B, budgets,
               others, card)
    qrow, qvals, qtot, qscale = H._sparse_pass(lid, gh, sl, "int8")
    bench_pass("ctr K=31 int8 (K7)", streams, zb, qrow, qvals, qtot, K, Cp,
               B, budgets, others, card, qscale)
    del qrow, qvals, qtot
    mask = torch.as_tensor(
        (np.random.RandomState(3).rand(N) < 0.9).astype(np.float32),
        device=dev)
    g1, l1, s1 = H._mask_feed(gh[0], gh[1], mask)
    srow1, vals1, tot1, _ = H._sparse_pass(torch.zeros_like(l1), g1,
                                           s1, "float32")
    bench_pass("ctr K=1 (fused sparse feed)", streams, zb, srow1, vals1,
               tot1, 1, Cp, B, budgets, others, card)
    del ds, sp, cols, binsv, zb, streams, srow, vals, tot, srow1, vals1
    torch.cuda.empty_cache()
    params = dict(CTR_PARAMS, enable_bundle=True, device_type="cuda")
    X, y, g = synth_ctr(C.CTRB_ROWS, C.CTRB_FEATURES, C.CTR_DENSITY)
    ds = lt.Dataset(X, y, group=g, params=params).construct()
    cols, binsv, zb = ds._inner.sparse_triple(dev)
    Cp = int(zb.shape[0])
    streams = SS.build_sparse_streams(cols, binsv, Cp)
    lid, sl, _, gh = C.sparse_pass_inputs(torch, H, cols.shape[0], K, 18)
    srow, vals, tot, _ = H._sparse_pass(lid, gh, sl, "float32")
    bench_pass("bundled ctr K=31", streams, zb, srow, vals, tot, K, Cp, B,
               budgets, others, card)
    print(f"[k8] {time.perf_counter() - t_all:.1f} s on {card}", flush=True)


if __name__ == "__main__":
    main()
