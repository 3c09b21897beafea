"""The split-search kernel (csrc/split.cu) timed on the card at the rounds
learner's shapes, beside the plain PyTorch search it replaced.

Shapes: a chunk of the rounds learner on higgs (k=84 leaves, F=28
features, B=256 bins, both children in one `split_children` call) and its
root (k=1, one `best_split`); then the ctr store's (F=50,000 features,
B=128 bins, 63 of them used, num_leaves 31): its root and the fused
builder's single searches (k=1, one side), and a chunk of the rounds
learner at k=1 and k=15 (both children).  Real-valued histograms.  Each is timed by CUDA events
around each call (`ms`, which includes the host's enqueue) and by a CUDA
graph of 10 calls (`graph_ms`, the device alone), kernel and plain in
turns: plain, kernel, kernel, plain.  The plain version is the two-call
form the learner ran before (a gated `best_split` per side, two
`torch.where`s, two row writes); its launches a call are counted by
torch.profiler.  Bound: the histograms read once at 3.35 TB/s.  Then
`--trees` trees of the north-star job in float32 (synth_higgs(--rows),
255 leaves) count the kernel's launches a tree and the host reads.

    python3 scripts/bench_torch_split.py [--rows 2000000] [--trees 6]

from the root of a checkout, on a machine with a CUDA card and nvcc
(a few minutes).  Prints one JSON line a shape and one for the trees,
and writes them all to chiprun_out/bench_torch_split.json.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from lightgbm_tpu_torch import kernels  # noqa: E402
from lightgbm_tpu_torch.ops import split as S  # noqa: E402

SPLIT_KW = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=1,
                min_sum_hessian_in_leaf=100.0, min_gain_to_split=0.0,
                can_split=(1, 100.0))


def case(k, F, B, used, seed, dev):
    """Real-valued histograms [k, F, 3, B] of `used` bins, drawn on the
    card: each leaf's bins, in another order in every feature, so that
    every feature holds the leaf's totals; those totals; [F] metadata."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    leaf = torch.stack([
        torch.randn(k, used, generator=gen, device=dev) * 40,
        torch.rand(k, used, generator=gen, device=dev) * 60,
        torch.randint(0, 400, (k, used), generator=gen,
                      device=dev).float()], dim=1)            # [k, 3, u]
    perm = torch.argsort(torch.rand(k, F, used, generator=gen, device=dev),
                         dim=-1)
    hist = torch.zeros(k, F, 3, B, device=dev)
    hist[..., :used] = torch.gather(
        leaf[:, None].expand(k, F, 3, used), 3,
        perm[:, :, None].expand(k, F, 3, used))
    sums = hist[:, 0].double().sum(dim=-1).float()
    return (hist, sums,
            torch.full((F,), used, dtype=torch.int64, device=dev),
            torch.zeros(F, dtype=torch.bool, device=dev),
            torch.ones(F, dtype=torch.bool, device=dev))


def plain_children(out, sel, ra, rb, ha, sa, hb, sb, nb, ic, fm):
    rec_a = S._best_split_plain(ha, nb, ic, fm, sa[:, 0], sa[:, 1],
                                sa[:, 2], **SPLIT_KW)
    rec_b = S._best_split_plain(hb, nb, ic, fm, sb[:, 0], sb[:, 1],
                                sb[:, 2], **SPLIT_KW)
    S.write_children(out, sel, ra, rb, rec_a, rec_b)


def device_launches(fn) -> int:
    """CUDA kernels one call of fn launches, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def bench_shape(label, k, F, B, used, two_sides, card, dev):
    L = 255
    ha, sa, nb, ic, fm = case(k, F, B, used, 1, dev)
    hb, sb = case(k, F, B, used, 2, dev)[:2]
    rng = np.random.RandomState(3)
    rows = torch.as_tensor(rng.permutation(L)[:2 * k], device=dev)
    sel = torch.as_tensor(rng.rand(k) < 0.5, device=dev)
    out = torch.full((L, 11), -np.inf, device=dev)
    if two_sides:
        def kern():
            S.split_children(out, sel, rows[:k], rows[k:], ha, sa, hb, sb,
                             nb, ic, fm, **SPLIT_KW)

        def plain():
            plain_children(out, sel, rows[:k], rows[k:], ha, sa, hb, sb,
                           nb, ic, fm)
    else:
        def kern():
            return S.best_split(ha, nb, ic, fm, sa[:, 0], sa[:, 1],
                                sa[:, 2], **SPLIT_KW)

        def plain():
            return S._best_split_plain(ha, nb, ic, fm, sa[:, 0], sa[:, 1],
                                sa[:, 2], **SPLIT_KW)
    # the same records from both, on real values up to a tie that the
    # order of float64 sums flips (the plain version's CUDA cumsum)
    if two_sides:
        kern()
        got = out.clone()
        out.fill_(-np.inf)
        plain()
        want = out.clone()
    else:
        got, want = kern(), plain()
    same = torch.isnan(got) | (got == want)
    times = {"kernel": [], "plain": []}
    graph = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = kern if name == "kernel" else plain
        times[name].append(C.time_ms(torch, fn, 20))
        graph[name].append(C.graph_ms(torch, fn))
    sides = 2 if two_sides else 1
    nbytes = sides * k * F * 3 * B * 4
    bound, basis = C.bound_ms(nbytes, 0)
    before = kernels.LAUNCHES["split_search"]
    kern()
    row = dict(shape=label, k=k, F=F, B=B, sides=sides,
               kernel_ms=times["kernel"], kernel_graph_ms=graph["kernel"],
               plain_ms=times["plain"], plain_graph_ms=graph["plain"],
               kernel_launches=kernels.LAUNCHES["split_search"] - before,
               plain_launches=device_launches(plain),
               kernel_device_launches=device_launches(kern),
               bound_ms=bound, bound_by=basis,
               records_differing=int((~same.all(-1)).sum()), card=card)
    print(json.dumps(row), flush=True)
    return row


def bench_trees(rows_n, trees, card, dev):
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs
    X, y = synth_higgs(rows_n)
    p = dict(NORTH_STAR_PARAMS, device_type=dev.type,
             histogram_dtype="float32", tree_growth="rounds")
    ds = lt.Dataset(X, y, params=p).construct()
    lt.train(p, ds, 1)                       # builds and warms up
    kernels.reset_launches()
    bst = lt.train(p, ds, trees)
    row = dict(trees=trees, rows=rows_n,
               split_search_per_tree=kernels.LAUNCHES["split_search"]
               / trees,
               host_syncs_per_tree=float(np.mean(
                   bst._gbdt.host_syncs_per_tree)),
               card=card)
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--trees", type=int, default=6)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    card = smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)
    print(f"[split] card: {card}", flush=True)
    kernels.build()
    rows = [bench_shape("chunk", 84, 28, 256, 255, True, card, dev),
            bench_shape("root", 1, 28, 256, 255, False, card, dev)]
    for label, k, two in (("ctr root", 1, False), ("ctr chunk k=1", 1, True),
                          ("ctr chunk k=15", 15, True)):
        rows.append(bench_shape(label, k, 50_000, 128, 63, two, card, dev))
        torch.cuda.empty_cache()
    rows.append(bench_trees(a.rows, a.trees, card, dev))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "bench_torch_split.json"),
              "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
