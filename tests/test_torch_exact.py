"""The exact leaf-wise learner and its histograms (kernels K5, K6) held
against the JAX package, on the CPU.

Same seeded inputs through both packages.  The port's histograms take
their plain versions here (CPU tensors); the JAX side runs its XLA
functions and its Pallas kernels in interpret mode, as the JAX package's
own tests do.

Tolerances: float32 histograms are summed in another order than XLA's
chunked one-hot matmul, so they agree to atol 1e-4 where a cell sums a
few dozen O(1) values (the bound of the JAX package's own interpret
tests), plus, where a cell sums hundreds (7 bins per column, the onehot
store's width), the reorder bound n * 2^-23 * sum|x| of its n values
(n float additions in any order lie within n * 2^-24 * sum|x| of the
exact sum, and both sides reorder); they agree bitwise on dyadic values,
whose partial sums are exact in any order.  Trees must match in
structure (split features, thresholds, children, leaf counts) exactly.
With real-valued gradients, leaf values agree to rtol 1e-4 and atol 1e-6,
as the rounds learner's in tests/test_torch_slice.py: the sums are added
in another order than XLA's, and a right child's sums are its parent's
total minus the left cumulative sum, so a last-bit difference of the
total becomes a relative difference of ~2e-5 in a leaf with a small
hessian (seen here: 1.7e-5).  With dyadic gradients every sum is exact
in any order, and leaf values agree bitwise.  Predictions and AUC agree
to atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lj
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Dataset as JDataset
from lightgbm_tpu.learner.serial import SerialTreeLearner as JSerial
from lightgbm_tpu.ops import histogram as jh

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import Dataset as TDataset
from lightgbm_tpu_torch.learner.fused import create_tree_learner
from lightgbm_tpu_torch.learner.serial import SerialTreeLearner as TSerial
from lightgbm_tpu_torch.learner.serial import compact_rows
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.synth import synth_higgs

PARAMS = dict(objective="binary", metric="auc", num_leaves=63, max_bin=255,
              learning_rate=0.1, min_data_in_leaf=1,
              min_sum_hessian_in_leaf=1.0, tree_growth="exact", verbose=-1)


def _same_structure(a, b):
    n = a.num_leaves
    assert b.num_leaves == n
    for name in ("split_feature", "threshold_in_bin", "threshold",
                 "decision_type", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(a, name)[:n - 1],
                                      getattr(b, name)[:n - 1], err_msg=name)
    np.testing.assert_array_equal(a.leaf_count[:n], b.leaf_count[:n])


def _gathered_case(N, F, nb, cap, live, seed, dyadic=False):
    """[N+1, F] bins with a sentinel row, padded gradients, and an index
    of `live` sorted rows padded with N up to `cap`."""
    rng = np.random.RandomState(seed)
    bins_t = np.concatenate([rng.randint(0, nb, size=(N, F)),
                             np.zeros((1, F))]).astype(np.int32)
    g, h = rng.randn(N), rng.rand(N)
    if dyadic:
        g, h = np.round(g * 64) / 64, np.round(h * 64) / 256
    g = np.concatenate([g, [0.0]]).astype(np.float32)
    h = np.concatenate([h, [0.0]]).astype(np.float32)
    idx = np.full(cap, N, np.int32)
    idx[:live] = np.sort(rng.choice(N, live, replace=False))
    return bins_t, g, h, idx


@pytest.mark.parametrize("N,F,nb,B,cap,live,dyadic", [
    (4000, 11, 250, 256, 4096, 3001, False),     # odd F, padded idx
    (5003, 40, 7, 128, 8192, 5003, False),       # odd C, onehot width
    (3000, 28, 255, 256, 2048, 2048, False),     # no padding
    (6000, 9, 250, 256, 4096, 2500, True),       # dyadic: bitwise
])
def test_histogram_from_indices_vs_jax(N, F, nb, B, cap, live, dyadic):
    bins_t, g, h, idx = _gathered_case(N, F, nb, cap, live, seed=N + F,
                                       dyadic=dyadic)
    out = th.histogram_from_indices(
        torch.as_tensor(bins_t), torch.as_tensor(g), torch.as_tensor(h),
        torch.as_tensor(idx), num_bins_padded=B).numpy()
    ref = np.asarray(jh.histogram_from_indices(
        jnp.asarray(bins_t), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(idx), num_bins_padded=B))
    # the Pallas kernel in interpret mode on the gathered rows
    vals8 = np.zeros((8, cap), np.float32)
    vals8[0], vals8[1] = g[idx], h[idx]
    vals8[2] = idx < N
    ref_p = np.asarray(jh.hist_pallas(
        jnp.asarray(bins_t[idx].T.copy()), jnp.asarray(vals8),
        num_bins_padded=B, input_dtype="float32", interpret=True))
    assert out.shape == (F, 3, B)
    if dyadic:
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, ref_p)
    else:
        absum = th.histogram_from_indices(
            torch.as_tensor(bins_t), torch.as_tensor(np.abs(g)),
            torch.as_tensor(h), torch.as_tensor(idx),
            num_bins_padded=B).numpy()
        tol = 1e-4 + absum[:, 2:3] * 2.0 ** -23 * absum
        assert (np.abs(out - ref) <= tol).all()
        assert (np.abs(out - ref_p) <= tol).all()
    # the count channel is exact whatever the order
    np.testing.assert_array_equal(out[:, 2], ref[:, 2])


@pytest.mark.parametrize("input_dtype", ["float32", "bfloat16"])
def test_hist_pallas_plain_vs_jax(input_dtype):
    rng = np.random.RandomState(4)
    F, C, B = 11, 5003, 256                        # odd F, odd C
    gb = rng.randint(0, 250, size=(F, C)).astype(np.int32)
    vals8 = np.zeros((8, C), np.float32)
    vals8[0], vals8[1] = rng.randn(C), rng.rand(C)
    vals8[2] = rng.rand(C) < 0.8
    out = th.hist_pallas(torch.as_tensor(gb), torch.as_tensor(vals8),
                         num_bins_padded=B, input_dtype=input_dtype).numpy()
    ref_p = np.asarray(jh.hist_pallas(jnp.asarray(gb), jnp.asarray(vals8),
                                      num_bins_padded=B,
                                      input_dtype=input_dtype,
                                      interpret=True))
    ref_x = np.asarray(jh.hist_xla(jnp.asarray(gb.T), jnp.asarray(vals8[:3]),
                                   num_bins_padded=B,
                                   input_dtype=input_dtype))
    np.testing.assert_allclose(out, ref_p, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out, ref_x, rtol=0, atol=1e-4)


@pytest.mark.parametrize("M,F,C,nb,B", [(24, 8, 3000, 60, 128),
                                        (128, 5, 2001, 250, 256)])
def test_hist_multileaf_plain_vs_jax(M, F, C, nb, B):
    rng = np.random.RandomState(M)
    gb = rng.randint(0, nb, size=(F, C)).astype(np.int32)
    vals = rng.randn(M, C).astype(np.float32)
    out = th.hist_multileaf(torch.as_tensor(gb), torch.as_tensor(vals),
                            num_bins_padded=B).numpy()
    ref_x = np.asarray(jh.hist_multileaf_xla(jnp.asarray(gb),
                                             jnp.asarray(vals),
                                             num_bins_padded=B))
    ref_p = np.asarray(jh.hist_pallas_multileaf(
        jnp.asarray(gb), jnp.asarray(vals), num_bins_padded=B,
        input_dtype="float32", interpret=True))
    assert out.shape == (F, M, B)
    np.testing.assert_allclose(out, ref_x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out, ref_p, rtol=0, atol=1e-4)
    # dyadic values: every order gives the same sums
    dy = (np.round(vals * 16) / 16).astype(np.float32)
    np.testing.assert_array_equal(
        th.hist_pallas_multileaf(torch.as_tensor(gb), torch.as_tensor(dy),
                                 num_bins_padded=B,
                                 input_dtype="float32").numpy(),
        np.asarray(jh.hist_multileaf_xla(jnp.asarray(gb), jnp.asarray(dy),
                                         num_bins_padded=B)))


def test_int8_coerced_to_float32_once(caplog):
    rng = np.random.RandomState(5)
    gb = rng.randint(0, 60, size=(4, 300)).astype(np.int32)
    vals = rng.randn(3, 300).astype(np.float32)
    th._INT8_COERCED = False
    a = th.hist_xla(torch.as_tensor(gb.T), torch.as_tensor(vals),
                    num_bins_padded=128, input_dtype="int8")
    b = th.hist_xla(torch.as_tensor(gb.T), torch.as_tensor(vals),
                    num_bins_padded=128, input_dtype="float32")
    th.hist_xla(torch.as_tensor(gb.T), torch.as_tensor(vals),
                num_bins_padded=128, input_dtype="int8")
    assert torch.equal(a, b)
    assert th._INT8_COERCED


def test_compact_rows_is_nonzero_with_fill():
    rng = np.random.RandomState(6)
    mask = rng.rand(1000) < 0.3
    n = int(mask.sum())
    ar = torch.arange(1000, dtype=torch.int32)
    for cap in (n, 512, 1000, 64):
        out = compact_rows(torch.as_tensor(mask), cap, 1000, ar).numpy()
        ref = np.asarray(jnp.nonzero(jnp.asarray(mask), size=cap,
                                     fill_value=1000)[0])
        np.testing.assert_array_equal(out, ref)


def _grad_hess(y, seed, dyadic=False):
    """Binary-logloss gradients at random scores; dyadic: rounded to
    multiples of 2^-4 (grad) and 2^-8 (hess), so that every sum over
    20,000 rows is exact in float32."""
    rng = np.random.RandomState(seed)
    p = 1.0 / (1.0 + np.exp(-rng.randn(len(y))))
    g, h = p - y, p * (1 - p)
    if dyadic:
        g, h = np.round(g * 16) / 16, np.round(h * 256) / 256
    return g.astype(np.float32), h.astype(np.float32)


@pytest.mark.parametrize("bagging,feature_fraction,pool,dyadic", [
    (False, 1.0, 0.0, False), (True, 1.0, 0.0, False),
    (False, 0.8, 0.0, False), (True, 0.8, 0.0, False),
    (False, 1.0, 0.1, False), (False, 1.0, 0.0, True),
    (True, 0.8, 0.0, True)])
def test_exact_tree_63_leaves_matches_jax(bagging, feature_fraction, pool,
                                          dyadic):
    X, y = synth_higgs(20000)
    params = dict(PARAMS, feature_fraction=feature_fraction,
                  histogram_pool_size=pool)
    dj = JDataset(X, y, j_config(params))
    dt = TDataset(X, y, t_config(dict(params, device_type="cpu")))
    grad, hess = _grad_hess(y, 2, dyadic)
    bag = cnt = None
    if bagging:
        rng = np.random.RandomState(3)
        cnt = 14000
        bag = np.sort(rng.choice(20000, cnt, replace=False)).astype(np.int32)
        bag = np.concatenate([bag, np.full(16384 - cnt, 20000, np.int32)])
    lj_ = JSerial(dj, j_config(params))
    lt_ = TSerial(dt, t_config(dict(params, device_type="cpu")))
    # a 0.1 MB pool keeps no per-leaf histogram: every larger child is
    # recomputed directly
    assert lt_.keep_hists == lj_.keep_hists == (pool == 0.0)
    for _ in range(2):                   # two trees: the feature draws
        tj, lid_j = lj_.train(jnp.asarray(grad), jnp.asarray(hess),
                              None if bag is None else jnp.asarray(bag), cnt)
        tt, lid_t = lt_.train(torch.as_tensor(grad), torch.as_tensor(hess),
                              None if bag is None else torch.as_tensor(bag),
                              cnt)
        assert tt.num_leaves == 63
        _same_structure(tj, tt)
        n = tt.num_leaves
        if dyadic:
            np.testing.assert_array_equal(tt.leaf_value[:n],
                                          tj.leaf_value[:n])
        else:
            np.testing.assert_allclose(tt.leaf_value[:n], tj.leaf_value[:n],
                                       rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(lid_t.numpy(), np.asarray(lid_j))
    # one read at the root and one per split whose children split on
    # (plus the direct recomputes without a pool)
    assert 2 <= lt_.last_host_syncs <= (2 * n if pool else n)


def test_factory_resolves_growth():
    X, y = synth_higgs(3000)
    ds = TDataset(X, y, t_config({"device_type": "cpu"}))
    kinds = {g: type(create_tree_learner(ds, t_config(
        {"device_type": "cpu", "tree_growth": g}))).__name__
        for g in ("exact", "auto", "rounds")}
    assert kinds == {"exact": "SerialTreeLearner",
                     "auto": "RoundsTreeLearner",
                     "rounds": "RoundsTreeLearner"}


@pytest.mark.parametrize("bagging", [False, True])
def test_train_exact_matches_jax(bagging):
    X, y = synth_higgs(10000)
    Xv, yv = synth_higgs(2000, seed=7)
    params = dict(PARAMS, num_leaves=31)
    if bagging:
        params.update(bagging_fraction=0.7, bagging_freq=1)
    out = {}
    for name, pkg, p in (("jax", lj, params),
                         ("torch", lt, dict(params, device_type="cpu"))):
        ds = pkg.Dataset(X, y)
        res = {}
        kw = {"verbose_eval": False} if pkg is lj else {}
        bst = pkg.train(p, ds, 3, valid_sets=[pkg.Dataset(Xv, yv,
                                                          reference=ds)],
                        evals_result=res, **kw)
        out[name] = (bst, res["valid_0"]["auc"])
    (bj, auc_j), (bt, auc_t) = out["jax"], out["torch"]
    assert type(bt._gbdt.learner).__name__ == "SerialTreeLearner"
    assert bt.num_trees() == bj.num_trees() == 3
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        _same_structure(a, b)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(auc_t, auc_j, rtol=0, atol=1e-5)
    # the device-walked valid scores agree with the host walk
    dev_raw = bt._gbdt.valid_sets[0][2].score[0].double().numpy()
    np.testing.assert_allclose(dev_raw, bt.predict(Xv, raw_score=True),
                               rtol=0, atol=1e-5)
    assert all(s >= 2 for s in bt._gbdt.host_syncs_per_tree)
