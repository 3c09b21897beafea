"""Run-to-run check of the port's float32 sparse path on the card: the
same inputs twice or more, and how many values differ.

On the ctr store of chip_smoke.py (synth_ctr(500_000) x 50,000, its
phase 4) it calls, on the real-valued K=31 pass of phase 5:

- K8 (`sparse_streams._hist_streams_cuda`), 1 + 6 times with the same
  slot totals: cells differing from the first call;
- the slot totals (`histogram._slot_totals`), 1 + 20 times;

then trains phase 6's ctr float32 model (12 iterations, NDCG@1..5 on the
valid set) three times and compares the model strings (first differing
line) and the NDCG lists, and after the first training calls the
lambdarank gradients and the valid NDCG again on the same scores.  The
third training runs under torch.use_deterministic_algorithms(True,
warn_only=True), and the ops that PyTorch names there as
nondeterministic are printed.
Prints "[run-to-run] ..." lines; exits 0 whatever it finds (it measures,
chip_smoke.py's phase 21 gates).

    python3 scripts/check_torch_run_to_run.py

from the root of a checkout, on a machine with a CUDA card (~3 min, most
of it the ctr store).
"""
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch import kernels  # noqa: E402
from lightgbm_tpu_torch.ops import histogram as H  # noqa: E402
from lightgbm_tpu_torch.ops import sparse_streams as SS  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        print("check_torch_run_to_run: no CUDA device", file=sys.stderr)
        sys.exit(2)
    t_all = time.perf_counter()
    kernels.build()
    params, ds, vs, Xv, sp = C.phase_ctr_setup(lt, C.CTR_ROWS)
    cols, binsv, zb, streams = sp
    N = cols.shape[0]
    Cp, B, K = streams.num_columns, 128, C.CTR_SLOTS
    lid, sl, _, gh = C.sparse_pass_inputs(torch, H, N, K, 11)
    srow, vals, tot, _ = H._sparse_pass(lid, gh, sl, "float32")
    ref = SS._hist_streams_cuda(streams, zb, srow, vals, tot, None, K, Cp, B)
    diffs = []
    for _ in range(6):
        out = SS._hist_streams_cuda(streams, zb, srow, vals, tot, None, K,
                                    Cp, B)
        diffs.append(int((out != ref).sum()))
        del out
    print(f"[run-to-run] K8 K={K} real-valued pass, cells differing from "
          f"the first call in 6 more calls: {diffs} of {ref.numel()}",
          flush=True)
    del ref
    torch.cuda.empty_cache()
    t0 = H._slot_totals(srow, vals, K)
    td = [int((H._slot_totals(srow, vals, K) != t0).sum())
          for _ in range(20)]
    print(f"[run-to-run] slot totals float32 [{K}, 3], entries differing "
          f"from the first call in 20 more calls: {td}", flush=True)

    ps = dict(params, histogram_dtype="float32")
    models, ndcgs = [], []
    for rep in range(3):
        res = {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(rep == 2, warn_only=True)
            try:
                bst = lt.train(ps, ds, 12, valid_sets=[vs],
                               evals_result=res, verbose_eval=False)
            finally:
                torch.use_deterministic_algorithms(False)
        if rep == 2:
            named = sorted({str(w.message).split("\n")[0][:160]
                            for w in caught
                            if "deterministic" in str(w.message)})
            print(f"[run-to-run] run 3 under use_deterministic_algorithms("
                  f"warn_only): {len(named)} op(s) named: {named}",
                  flush=True)
        models.append(bst.model_to_string())
        ndcgs.append(res["valid_0"])
        if rep:
            continue
        g = bst._gbdt
        score = g.train_score.score
        ga, ha = g.objective.get_gradients(score)
        gd = []
        for _ in range(5):
            gb, hb = g.objective.get_gradients(score)
            gd.append(int((gb != ga).sum() + (hb != ha).sum()))
        print(f"[run-to-run] lambdarank gradients, entries differing in 5 "
              f"more calls: {gd}", flush=True)
        su, mets = g.valid_sets[0][2], g.valid_sets[0][3]

        def ev():
            return [torch.stack([v for _, v in m.eval(su.score)])
                    for m in mets]
        m0 = ev()
        md = [sum(int((a != b).sum()) for a, b in zip(m0, ev()))
              for _ in range(10)]
        print(f"[run-to-run] valid NDCG@1..5 values differing in 10 more "
              f"evals: {md}", flush=True)
    for rep in (1, 2):
        a, b = models[0].splitlines(), models[rep].splitlines()
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        same = ndcgs[0] == ndcgs[rep]
        if first is None and len(a) == len(b):
            print(f"[run-to-run] ctr float32 12 iterations, run {rep + 1} "
                  f"vs run 1: model strings equal; NDCG lists equal {same}",
                  flush=True)
            continue
        nd = sum(1 for x, y in zip(a, b) if x != y)
        print(f"[run-to-run] ctr float32 12 iterations, run {rep + 1} vs "
              f"run 1: first differing line {first}: {a[first][:160]!r} vs "
              f"{b[first][:160]!r}; {nd} of {len(a)} lines differ; NDCG "
              f"lists equal {same}", flush=True)
    print(f"[run-to-run] {time.perf_counter() - t_all:.1f} s on "
          f"{torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()
