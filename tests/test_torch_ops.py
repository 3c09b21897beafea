"""The port's kernel-bearing ops held against the JAX package.

Inputs are made from numpy seeds and handed to both packages.  On this
CPU-only host each op runs its plain PyTorch version (a CPU tensor takes
it); the JAX side runs as its own tests run it on the CPU: the XLA
branch, or the Pallas kernel in interpret mode.

Tolerances: the int8 histogram (K1), partition (K4), lookups (K3) and
split feature/threshold choices are held bitwise.  float32 histograms
(K2) are summed in another order than XLA's chunked one-hot matmul, so
they agree to atol 1e-4 on O(1) values (the bound the JAX package's own
interpret tests use).  Split records take cumulative sums over the bins
in another order than XLA's cumsum; the right child's sums subtract
those from the leaf total, which turns a last-bit difference of the
total (~5e3 here) into a relative difference of ~3e-5 in the right
child's hessian, output and the gain, so records agree to rtol 1e-4.

test_torch_kernels_cuda.py holds each CUDA kernel against these plain
versions on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import lookup as jl
from lightgbm_tpu.ops import partition as jp
from lightgbm_tpu.ops import split as js

from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import lookup as tl
from lightgbm_tpu_torch.ops import partition as tp
from lightgbm_tpu_torch.ops import split as ts


def _hist_case(C, F, nb, K, seed, int8_bins):
    """Bins [F, C], leaf ids with pad rows (-2), masked gradients, and a
    slot table with empty (-1) slots."""
    rng = np.random.RandomState(seed)
    gb = rng.randint(0, nb, size=(F, C)).astype(np.int32)
    lid = rng.randint(0, 12, size=C).astype(np.int32)
    lid[rng.rand(C) < 0.05] = -2
    gh8 = np.zeros((8, C), np.float32)
    gh8[2] = rng.rand(C) < 0.9
    gh8[0] = rng.randn(C) * gh8[2]
    gh8[1] = rng.rand(C) * gh8[2]
    sl = np.array([3, 7, -1, 0, 11, -1, 5][:K], np.int32)
    bins = (gb.astype(np.int16) - 128).astype(np.int8) if int8_bins else gb
    return bins, lid, gh8, sl


@pytest.mark.parametrize("C,F,nb,B,int8_bins", [
    (4097, 9, 250, 256, False),     # C not a multiple of any chunk
    (3001, 6, 120, 128, False),
    (2503, 5, 250, 256, True),      # int8-stored bins (value-128)
])
def test_hist_int8_bitwise_vs_pallas_interpret(C, F, nb, B, int8_bins):
    bins, lid, gh8, sl = _hist_case(C, F, nb, 7, 11, int8_bins)
    ref = jh.hist_multileaf_masked(
        jnp.asarray(bins), jnp.asarray(lid), jnp.asarray(gh8),
        jnp.asarray(sl), num_bins_padded=B, backend="pallas",
        input_dtype="int8", interpret=True)
    out = th.hist_multileaf_masked(
        torch.as_tensor(bins), torch.as_tensor(lid), torch.as_tensor(gh8),
        torch.as_tensor(sl), num_bins_padded=B, input_dtype="int8")
    assert out.shape == (7, F, 3, B)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # empty slots add nothing
    assert not out[2].any() and not out[5].any()


@pytest.mark.parametrize("input_dtype,int8_bins", [
    ("float32", False), ("float32", True), ("bfloat16", False)])
def test_hist_float_vs_xla(input_dtype, int8_bins):
    bins, lid, gh8, sl = _hist_case(4097, 9, 250, 7, 12, int8_bins)
    ref = jh.hist_multileaf_masked(
        jnp.asarray(bins), jnp.asarray(lid), jnp.asarray(gh8),
        jnp.asarray(sl), num_bins_padded=256, backend="xla",
        input_dtype=input_dtype)
    out = th.hist_multileaf_masked(
        torch.as_tensor(bins), torch.as_tensor(lid), torch.as_tensor(gh8),
        torch.as_tensor(sl), num_bins_padded=256, input_dtype=input_dtype)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    # counts are exact in any order
    np.testing.assert_array_equal(out.numpy()[:, :, 2],
                                  np.asarray(ref)[:, :, 2])


def _gathered_case(seed, int8_bins):
    rng = np.random.RandomState(seed)
    N, F = 3000, 6
    gb = rng.randint(0, 250, size=(F, N)).astype(np.int32)
    bins = (gb.astype(np.int16) - 128).astype(np.int8) if int8_bins else gb
    gh8 = np.zeros((8, N), np.float32)
    gh8[0] = rng.randn(N)
    gh8[1] = rng.rand(N)
    gh8[2] = 1.0
    perm = rng.permutation(N).astype(np.int32)
    seg_off = np.array([0, 700, 1500, 2900], np.int32)
    seg_cnt = np.array([500, 0, 900, 100], np.int32)      # empty slot 1
    return bins, gh8, perm, seg_off, seg_cnt


@pytest.mark.parametrize("input_dtype,int8_bins", [
    ("int8", False), ("int8", True), ("float32", False)])
def test_hist_gathered_vs_jax(input_dtype, int8_bins):
    bins, gh8, perm, so, sn = _gathered_case(4, int8_bins)
    kw = dict(capacity=1536, num_bins_padded=256, input_dtype=input_dtype)
    out = th.hist_multileaf_gathered(
        torch.as_tensor(bins), torch.as_tensor(gh8), torch.as_tensor(perm),
        torch.as_tensor(so), torch.as_tensor(sn), **kw).numpy()
    if input_dtype == "int8":
        ref = jh.hist_multileaf_gathered(
            jnp.asarray(bins), jnp.asarray(gh8), jnp.asarray(perm),
            jnp.asarray(so), jnp.asarray(sn), backend="pallas",
            interpret=True, **kw)
        np.testing.assert_array_equal(out, np.asarray(ref))
    else:
        ref = jh.hist_multileaf_gathered(
            jnp.asarray(bins), jnp.asarray(gh8), jnp.asarray(perm),
            jnp.asarray(so), jnp.asarray(sn), backend="xla", **kw)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-4)
    assert not out[1].any()


def test_gather_segments_bitwise():
    _, _, perm, so, sn = _gathered_case(5, False)
    ji, js_, jt = jh.gather_segments(jnp.asarray(perm), jnp.asarray(so),
                                     jnp.asarray(sn), capacity=1536)
    ti, ts_, tt = th.gather_segments(torch.as_tensor(perm),
                                     torch.as_tensor(so),
                                     torch.as_tensor(sn), capacity=1536)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    assert int(tt) == int(jt)


def _partition_case(n, f, b, L, seed, int8_store):
    rng = np.random.RandomState(seed)
    gb = rng.randint(0, b, size=(f, n)).astype(np.int32)
    lid = rng.randint(0, L, size=n).astype(np.int32)
    # the 7-row table with the always-in-range window (lo=0, hi1=2^30,
    # default-left 0) on every row, as the JAX function pads a 4-row one
    tbl = np.zeros((7, L + 1), np.float32)
    tbl[5] = float(1 << 30)
    for leaf in range(0, L, 2):
        tbl[:4, leaf] = (rng.randint(0, f), rng.randint(0, b),
                         rng.rand() < 0.3, rng.randint(1, L))
    bins = (gb.astype(np.int16) - 128).astype(np.int8) if int8_store else gb
    return bins, lid, tbl


@pytest.mark.parametrize("n,f,b,L,seed,int8_store", [
    (4097, 9, 250, 255, 0, False),
    (3000, 200, 250, 64, 1, False),
    (2500, 37, 250, 255, 2, True),
    (4099, 9, 250, 255, 6, True),      # N not a multiple of 4
    (3, 5, 250, 31, 5, True),
    (1, 5, 250, 31, 7, True),
])
def test_partition_bitwise_vs_jax(n, f, b, L, seed, int8_store):
    bins, lid, tbl = _partition_case(n, f, b, L, seed, int8_store)
    out = tp.partition_rows(torch.as_tensor(bins), torch.as_tensor(lid),
                            torch.as_tensor(tbl)).numpy()
    args = (jnp.asarray(bins), jnp.asarray(lid), jnp.asarray(tbl))
    ref_x = jp.partition_rows(*args, num_slots=L + 1, backend="xla",
                              num_bins_padded=256)
    ref_p = jp.partition_rows(*args, num_slots=L + 1, backend="pallas",
                              num_bins_padded=256, interpret=True)
    np.testing.assert_array_equal(out, np.asarray(ref_x))
    np.testing.assert_array_equal(out, np.asarray(ref_p))


def test_partition_window_and_out_of_range_ids():
    """Store-space window rows (lo, hi1, default-left) and leaf ids
    outside the table, against the XLA branch."""
    rng = np.random.RandomState(3)
    n, f, L = 2000, 7, 31
    bins = rng.randint(0, 60, size=(f, n)).astype(np.int32)
    lid = rng.randint(-3, L + 5, size=n).astype(np.int32)
    tbl = np.zeros((7, L + 1), np.float32)
    for leaf in range(L):
        tbl[:, leaf] = (rng.randint(0, f + 2), rng.randint(0, 60),
                        rng.rand() < 0.3, rng.randint(0, L),
                        rng.randint(0, 20), rng.randint(20, 61),
                        rng.rand() < 0.5)
    out = tp.partition_rows(torch.as_tensor(bins), torch.as_tensor(lid),
                            torch.as_tensor(tbl)).numpy()
    ref = jp.partition_rows(jnp.asarray(bins), jnp.asarray(lid),
                            jnp.asarray(tbl), num_slots=L + 1,
                            backend="xla")
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("n,int8_store,seed", [
    (4099, True, 6),         # N not a multiple of 4
    (1, True, 7),
    (2502, False, 8),
])
def test_partition_window_and_edges(n, int8_store, seed):
    """The int8 store (the learner's feed, value - 128) and the int32 one
    against the JAX function: non-splitting leaves, window rows (lo, hi1,
    default-left), categorical splits and N not a multiple of 4, bitwise
    against the XLA branch and the Pallas kernel in interpret mode; then
    leaf ids outside [0, S) against the XLA branch (the Pallas kernel
    takes ids inside the table only)."""
    rng = np.random.RandomState(seed)
    f, L = 11, 63
    gb = rng.randint(0, 255, size=(f, n)).astype(np.int32)
    bins = (gb.astype(np.int16) - 128).astype(np.int8) if int8_store else gb
    tbl = np.zeros((7, L + 1), np.float32)
    for leaf in range(L):
        if rng.rand() < 0.3:
            continue                                  # does not split
        tbl[:, leaf] = (rng.randint(0, f), rng.randint(0, 255),
                        rng.rand() < 0.3, rng.randint(1, 256),
                        rng.randint(0, 60), rng.randint(180, 256),
                        rng.rand() < 0.5)
    for lo_, hi_, ids_outside in ((0, L, False), (-3, L + 5, True)):
        lid = rng.randint(lo_, hi_, size=n).astype(np.int32)
        out = tp.partition_rows(torch.as_tensor(bins), torch.as_tensor(lid),
                                torch.as_tensor(tbl)).numpy()
        args = (jnp.asarray(bins), jnp.asarray(lid), jnp.asarray(tbl))
        ref = jp.partition_rows(*args, num_slots=L + 1, backend="xla",
                                num_bins_padded=256)
        np.testing.assert_array_equal(out, np.asarray(ref))
        if not ids_outside:
            ref_p = jp.partition_rows(*args, num_slots=L + 1,
                                      backend="pallas", num_bins_padded=256,
                                      interpret=True)
            np.testing.assert_array_equal(out, np.asarray(ref_p))


@pytest.mark.parametrize("T,S,N", [(1, 255, 9001), (5, 254, 3000)])
def test_table_lookup_bitwise(T, S, N):
    rng = np.random.RandomState(T)
    tbl = rng.randn(T, S).astype(np.float32)
    ids = rng.randint(-2, S + 3, size=N).astype(np.int32)
    out = tl.table_lookup(torch.as_tensor(tbl), torch.as_tensor(ids)).numpy()
    ref = jl.table_lookup(jnp.asarray(tbl), jnp.asarray(ids), num_slots=S)
    np.testing.assert_array_equal(out, np.asarray(ref))
    ref_p = jl._lookup_pallas(jnp.asarray(tbl), jnp.asarray(ids),
                              interpret=True)
    np.testing.assert_array_equal(out, np.asarray(ref_p))
    # the fused score add: score + lookup, out-of-range ids add 0.0
    add = rng.randn(T, N).astype(np.float32)
    fused = tl.table_lookup(torch.as_tensor(tbl), torch.as_tensor(ids),
                            addend=torch.as_tensor(add)).numpy()
    np.testing.assert_array_equal(fused, add + np.asarray(ref))


def test_select_bin_by_feature_bitwise():
    rng = np.random.RandomState(9)
    bins = rng.randint(0, 255, size=(11, 5000)).astype(np.int32)
    fi = rng.randint(-2, 14, size=5000).astype(np.int32)
    out = tl.select_bin_by_feature(torch.as_tensor(bins),
                                   torch.as_tensor(fi)).numpy()
    ref = jl.select_bin_by_feature(jnp.asarray(bins), jnp.asarray(fi))
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("l1,l2,min_data,min_hess", [
    (0.0, 0.0, 1, 100.0), (0.5, 1.0, 20, 1e-3)])
def test_best_split_records_vs_jax(l1, l2, min_data, min_hess):
    rng = np.random.RandomState(21)
    F, B, K = 9, 256, 4
    hist = np.zeros((K, F, 3, B), np.float32)
    nbins = rng.randint(2, 250, size=F).astype(np.int32)
    for k in range(K):
        for f in range(F):
            nb = nbins[f]
            hist[k, f, 0, :nb] = rng.randn(nb) * 10
            hist[k, f, 1, :nb] = rng.rand(nb) * 50
            hist[k, f, 2, :nb] = rng.randint(0, 40, size=nb)
    is_cat = np.zeros(F, bool)
    is_cat[[2, 5]] = True
    fmask = np.ones(F, bool)
    fmask[7] = False
    kw = dict(lambda_l1=l1, lambda_l2=l2, min_data_in_leaf=min_data,
              min_sum_hessian_in_leaf=min_hess, min_gain_to_split=0.0)
    sums = hist[:, 0].sum(axis=-1)                        # feature 0 totals
    out = ts.best_split(torch.as_tensor(hist), torch.as_tensor(nbins),
                        torch.as_tensor(is_cat), torch.as_tensor(fmask),
                        torch.as_tensor(sums[:, 0]),
                        torch.as_tensor(sums[:, 1]),
                        torch.as_tensor(sums[:, 2]), **kw).numpy()
    for k in range(K):
        ref = np.asarray(js.best_split(
            jnp.asarray(hist[k]), jnp.asarray(nbins), jnp.asarray(is_cat),
            jnp.asarray(fmask), jnp.float32(sums[k, 0]),
            jnp.float32(sums[k, 1]), jnp.float32(sums[k, 2]),
            **kw).packed())
        np.testing.assert_array_equal(out[k, 1:3], ref[1:3])
        np.testing.assert_allclose(out[k], ref, rtol=1e-4, atol=1e-6)


def test_kernel_signatures_match_the_sources():
    """Every C entry point's argument types (kernels.SIGNATURES, the
    stream last) name as many arguments as its definition in csrc/ has:
    ctypes passes an argument past the list as a 32-bit int, which cuts
    a pointer."""
    import re
    from lightgbm_tpu_torch import kernels
    for name, (src, fn, argtypes) in kernels.SIGNATURES.items():
        text = (kernels.CSRC / f"{src}.cu").read_text()
        m = re.search(r'extern "C" int ' + fn + r'\(([^)]*)\)', text)
        assert m is not None, f"{fn} not defined in csrc/{src}.cu"
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), (name, len(params),
                                              len(argtypes))
        assert "stream" in params[-1]


def test_k6_layout_constants_mirror_the_kernel():
    """K6's layout (ops/histogram.py `_k6_layout`) sizes its staged tile
    and owner warps from copies of the kernel's compile-time constants:
    they must be the values csrc/hist_gathered.cu is built with."""
    import re
    from lightgbm_tpu_torch import kernels
    text = (kernels.CSRC / "hist_gathered.cu").read_text()

    def const(name):
        m = re.search(r"constexpr int " + name + r" = ([^;]+);", text)
        assert m is not None, name
        return m.group(1).strip()
    assert const("kProducerWarps") == str(th._K6_PRODUCER_WARPS)
    assert const("kMultiLoads") == str(th._K6_LOADS)
    assert const("kMultiThreads") == (f"({th._K6_MAX_WARPS} + "
                                      f"kProducerWarps) * 32")
