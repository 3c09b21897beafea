"""The port's sparse CSR/ELL store held against the JAX package, on the CPU.

Same seeded inputs through both packages: the ELL store built from scipy
CSC columns and from a dense ndarray (bitwise), the nonzero-iterating
histogram (the plain version of kernels K7 and K8), the sparse row
partition and the ELL bin probe (bitwise), and trees grown over the
sparse store against trees grown over the dense one.

Tolerances: int8 histograms are integer sums of the same quantized
addends with one dequantizing scale, so they are bitwise equal to JAX's
XLA path and to its Pallas kernel in interpret mode.  float32 histograms
agree to rtol 1e-5: the zero bin is rebuilt as the slot total minus the
column's stored sums, and torch and XLA add those sums in another order
(a few ulps of the total, relative to the cell); with integer gradients
every partial sum is exact and the histograms are bitwise equal.  The
partition and the probe move integers only and are bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Dataset as JDataset
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops.partition import partition_rows_sparse as j_part
from lightgbm_tpu.ops.predict import sparse_bin_lookup as j_probe

from lightgbm_tpu_torch import dataset as tdataset
from lightgbm_tpu_torch import kernels
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import (Dataset as TDataset,
                                        nnz_capacity_tier)
from lightgbm_tpu_torch.learner.rounds import RoundsTreeLearner as TRounds
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops.partition import partition_rows, \
    partition_rows_sparse
from lightgbm_tpu_torch.ops.predict import sparse_bin_lookup
from lightgbm_tpu_torch.synth import CTR_PARAMS, synth_ctr

CTR_TEST = dict(CTR_PARAMS, tree_growth="rounds")


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _ctr_store():
    """A small synth_ctr csr store (power-law columns) from both packages."""
    X, y, _ = synth_ctr(2_000, 512, 0.02)
    dj = JDataset.from_csc(X, y, j_config(CTR_TEST))
    dt = TDataset.from_csc(X, y, t_config(dict(CTR_TEST,
                                               device_type="cpu")))
    return X, y, dj, dt


@pytest.mark.parametrize("source", ["csc", "ndarray"])
def test_sparse_store_bitwise_vs_jax(source):
    X, y, _ = synth_ctr(2_000, 512, 0.02)
    if source == "csc":
        dj = JDataset.from_csc(X, y, j_config(CTR_TEST))
        dt = TDataset.from_csc(X, y, t_config(dict(CTR_TEST,
                                                   device_type="cpu")))
    else:
        Xd = X.toarray()
        dj = JDataset(Xd, y, j_config(CTR_TEST))
        dt = TDataset(Xd, y, t_config(dict(CTR_TEST, device_type="cpu")))
    assert dt.used_features == dj.used_features
    np.testing.assert_array_equal(dt.num_bins, dj.num_bins)
    for name in ("cols", "bins", "zero_bin"):
        a, b = getattr(dt.sparse, name), getattr(dj.sparse, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert dt.sparse.nnz == dj.sparse.nnz > 0
    assert dt.sparse.nnz_capacity == nnz_capacity_tier(
        int((dt.sparse.cols < dt.sparse.num_columns).sum(1).max()))
    # densify() is the dense store of the same rows, bitwise
    dense = TDataset(X.toarray(), y, t_config(dict(
        CTR_TEST, sparse_store="dense", device_type="cpu")))
    assert dense.sparse is None
    np.testing.assert_array_equal(dt.sparse.densify(np.uint8), dense.bins)


def test_from_csc_non_canonical_keeps_last_value():
    """A duplicated (row, column) keeps its last stored value, as the
    JAX package's dense scratch write does."""
    import scipy.sparse as spm
    X, y, _ = synth_ctr(600, 256, 0.05, seed=3)
    c = X.tocsc()
    indices, data, indptr = [], [], [0]
    for j in range(c.shape[1]):
        r = c.indices[c.indptr[j]:c.indptr[j + 1]]
        v = c.data[c.indptr[j]:c.indptr[j + 1]]
        if j % 3 == 0 and r.size:
            # a repeated row later in the column, with another value
            r = np.concatenate([r, r[:1]])
            v = np.concatenate([v, v[:1] * 3.0 + 1.0])
        indices.append(r)
        data.append(v)
        indptr.append(indptr[-1] + r.size)
    csc = spm.csc_matrix((np.concatenate(data), np.concatenate(indices),
                          np.asarray(indptr)), shape=X.shape)
    assert not csc.has_canonical_format
    dj = JDataset.from_csc(csc, y, j_config(CTR_TEST))
    dt = TDataset.from_csc(csc, y, t_config(dict(CTR_TEST,
                                                 device_type="cpu")))
    for name in ("cols", "bins", "zero_bin"):
        np.testing.assert_array_equal(getattr(dt.sparse, name),
                                      getattr(dj.sparse, name), name)


def test_valid_set_follows_reference_and_never_densifies():
    X, y, _ = synth_ctr(2_000, 512, 0.02)
    Xv, yv, _ = synth_ctr(400, 512, 0.02, seed=7)
    cfg = t_config(dict(CTR_TEST, device_type="cpu"))
    tdataset.reset_sparse_fallbacks()
    ds = TDataset.from_csc(X, y, cfg)
    vs = TDataset(Xv.toarray(), yv, cfg, reference=ds)
    assert vs.sparse is not None
    jd = JDataset.from_csc(X, y, j_config(CTR_TEST))
    jv = JDataset(Xv.toarray(), yv, j_config(CTR_TEST), reference=jd)
    np.testing.assert_array_equal(vs.sparse.cols, jv.sparse.cols)
    np.testing.assert_array_equal(vs.sparse.bins, jv.sparse.bins)
    assert tdataset.sparse_fallbacks() == 0
    # a consumer without a sparse path densifies, and is counted
    assert vs.bins.shape == (vs.num_features, vs.num_data)
    assert tdataset.sparse_fallbacks() == 1
    tdataset.reset_sparse_fallbacks()


def _ell_case(N, C, R, draws, B, seed, power=3.0):
    """ELL arrays with power-law columns (unique per row, front-packed),
    some all-sentinel rows, leaf ids, gradient rows and slots."""
    rng = np.random.RandomState(seed)
    cols = np.full((N, R), C, np.int32)
    bins = np.zeros((N, R), np.int32)
    for i in range(N):
        if rng.rand() < 0.05:
            continue                                   # no stored entry
        u = np.unique(np.minimum((C * rng.rand(draws) ** power
                                  ).astype(np.int64), C - 1))[:R]
        cols[i, :u.size] = u
        bins[i, :u.size] = rng.randint(0, B - 1, u.size)
    zb = rng.randint(0, 3, C).astype(np.int32)
    lid = rng.randint(0, 6, N).astype(np.int32)
    gh8 = np.zeros((8, N), np.float32)
    gh8[2] = (rng.rand(N) > 0.1).astype(np.float32)
    gh8[0] = rng.randn(N).astype(np.float32) * gh8[2]
    gh8[1] = np.abs(rng.randn(N)).astype(np.float32) * gh8[2]
    sl = np.array([0, 2, 5, -1, 4], np.int32)
    return cols, bins, zb, lid, gh8, sl


@pytest.mark.parametrize("input_dtype,gh", [
    ("int8", "real"), ("float32", "real"), ("float32", "integer")])
def test_hist_sparse_vs_jax_xla(input_dtype, gh):
    N, C, B = 1500, 96, 64
    cols, bins, zb, lid, gh8, sl = _ell_case(N, C, 32, 24, B, seed=11)
    zb[-3:] = -1                                       # padded columns
    cols[cols >= C - 3] = C                            # hold no entries
    if gh == "integer":
        rng = np.random.RandomState(2)
        gh8[0] = rng.randint(-8, 8, N) * gh8[2]
        gh8[1] = rng.randint(0, 4, N) * gh8[2]
    ref = np.asarray(jh.hist_sparse_xla(
        *[jnp.asarray(a) for a in (cols, bins, zb, lid, gh8, sl)],
        num_columns_padded=C, num_bins_padded=B, input_dtype=input_dtype))
    out = th.hist_sparse_xla(*[_t(a) for a in (cols, bins, zb, lid,
                                               gh8[:3], sl)],
                             num_columns_padded=C, num_bins_padded=B,
                             input_dtype=input_dtype).numpy()
    assert out.shape == ref.shape == (len(sl), C, 3, B)
    assert not out[:, -3:].any()
    if input_dtype == "int8" or gh == "integer":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_hist_sparse_int8_vs_pallas_interpret_skewed():
    """int8 against the TPU kernel itself (interpret mode) over its slot
    streams, with a hot column split across several stream slots."""
    N, C, B = 1024, 64, 64
    cols, bins, zb, lid, gh8, sl = _ell_case(N, C, 16, 12, B, seed=5,
                                             power=4.0)
    er, ef, ev, sc = jh.sparse_window_streams(cols, bins, C,
                                              num_bins_padded=B)
    assert np.bincount(sc[sc < C], minlength=C).max() >= 2
    ref = np.asarray(jh.hist_sparse_pallas(
        *[jnp.asarray(a) for a in (er, ef, ev, sc, zb, lid, gh8, sl)],
        num_columns_padded=C, num_bins_padded=B, input_dtype="int8",
        interpret=True))
    out = th.hist_sparse_multileaf(
        (_t(cols), _t(bins), _t(zb)), _t(lid), _t(gh8[:3]), _t(sl),
        num_columns_padded=C, num_bins_padded=B, input_dtype="int8")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_hist_sparse_matches_dense_histogram():
    """Over the store of a real synth_ctr dataset, the sparse pass equals
    the dense masked pass over the densified store (integer gradients:
    bitwise), and a CPU tensor never launches a kernel."""
    _, _, _, dt = _ctr_store()
    sp = dt.sparse
    N = dt.num_data
    rng = np.random.RandomState(4)
    lid = rng.randint(0, 5, N).astype(np.int32)
    gh = np.stack([rng.randint(-6, 6, N), rng.randint(0, 5, N),
                   np.ones(N)]).astype(np.float32)
    sl = np.array([1, 3, -1, 0], np.int32)
    B = 128
    kernels.reset_launches()
    hs = th.hist_sparse_multileaf(
        (_t(sp.cols), _t(sp.bins.astype(np.int32)), _t(sp.zero_bin)),
        _t(lid), _t(gh), _t(sl), num_columns_padded=sp.num_columns,
        num_bins_padded=B)
    hd = th.hist_multileaf_masked(_t(sp.densify(np.uint8).astype(np.int32)),
                                  _t(lid), _t(gh), _t(sl),
                                  num_bins_padded=B)
    np.testing.assert_array_equal(hs.numpy(), hd.numpy())
    assert sum(kernels.LAUNCHES.values()) == 0


def test_partition_and_probe_bitwise_vs_jax():
    _, _, dj, dt = _ctr_store()
    sp = dt.sparse
    N, C = dt.num_data, sp.num_columns
    cols, bins = sp.cols, sp.bins.astype(np.int32)
    rng = np.random.RandomState(9)
    lid = rng.randint(0, 12, N).astype(np.int32)
    S = 16
    tbl = np.zeros((7, S), np.float32)
    act = rng.rand(S) < 0.6
    tbl[0] = np.where(act, rng.choice(8, S), 0)         # hot columns
    tbl[1] = np.where(act, rng.randint(0, 20, S), 0)
    tbl[2] = np.where(act, rng.rand(S) < 0.2, 0)
    tbl[3] = np.where(act, np.arange(S) + 12, 0)
    tbl[5] = float(1 << 30)
    ref = np.asarray(j_part(jnp.asarray(cols), jnp.asarray(bins),
                            jnp.asarray(sp.zero_bin), jnp.asarray(lid),
                            jnp.asarray(tbl), num_slots=S))
    out = partition_rows_sparse(_t(cols), _t(bins), _t(sp.zero_bin),
                                _t(lid), _t(tbl)).numpy()
    np.testing.assert_array_equal(out, ref)
    dense = partition_rows(_t(sp.densify(np.uint8).astype(np.int32)),
                           _t(lid), _t(tbl)).numpy()
    np.testing.assert_array_equal(out, dense)
    col = rng.randint(0, C, N).astype(np.int32)
    col[:50] = rng.randint(0, 4, 50)
    pref = np.asarray(j_probe(jnp.asarray(cols), jnp.asarray(bins),
                              jnp.asarray(sp.zero_bin), jnp.asarray(col)))
    pout = sparse_bin_lookup(_t(cols), _t(bins), _t(sp.zero_bin),
                             _t(col)).numpy()
    np.testing.assert_array_equal(pout, pref)
    np.testing.assert_array_equal(
        pout, sp.densify(np.uint8)[col, np.arange(N)])


def _dyadic_tree(store, hist_rows="masked", input_dtype="float32"):
    X, y, _ = synth_ctr(2_000, 512, 0.02)
    cfg = t_config(dict(CTR_TEST, sparse_store=store, hist_rows=hist_rows,
                        histogram_dtype=input_dtype, num_leaves=15,
                        min_sum_hessian_in_leaf=1.0, min_data_in_leaf=5,
                        device_type="cpu"))
    ds = TDataset.from_csc(X, y, cfg)
    assert (ds.sparse is not None) == (store == "csr")
    g = torch.as_tensor(np.where(y > 0, -1.0, 1.0).astype(np.float32))
    h = torch.full((len(y),), 0.5)
    learner = TRounds(ds, cfg)
    assert learner.sparse == (store == "csr")
    return learner.train(g, h)


def test_sparse_trees_bitwise_identical_dyadic():
    """±1 gradients, 0.5 hessians: every f32 partial sum is exact, so the
    zero-bin rebuild is exact and the csr store grows the dense store's
    tree bitwise (splits, leaf values, leaf ids) — in both row feeds."""
    td, lid_d = _dyadic_tree("dense")
    n = td.num_leaves
    assert n > 2
    for hr in ("masked", "gathered"):
        ts, lid_s = _dyadic_tree("csr", hist_rows=hr)
        assert ts.num_leaves == n
        for name in ("split_feature", "threshold_in_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(ts, name)[:n - 1],
                                          getattr(td, name)[:n - 1], name)
        np.testing.assert_array_equal(ts.leaf_value[:n], td.leaf_value[:n])
        np.testing.assert_array_equal(lid_s.numpy(), lid_d.numpy())
