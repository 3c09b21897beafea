"""EFB-bundled stores in the port, held against the JAX package on the CPU.

Same seeded inputs through both packages: the bundle plan and its tables,
the bundled store and its conflict count (bitwise), the store-space split
helpers, the row partition through a bundled table (bitwise), both
learners on bundled data (the JAX package's trees), bundled against
unbundled training (lossless under zero conflicts), and valid sets
scored by walking the bundled store.

Tolerances: plans, tables, stores, predicate parameters, go-left masks
and partitions are integer data, held bitwise.  An unbundled histogram
rebuilds each packed feature's default bin as the leaf totals minus the
feature's other bins, summed in another order than XLA's: within 1e-5
of JAX's on O(1) cells.  Trees must match in structure exactly
(bundling is lossless under zero conflicts, and the default-bin rebuild
moves a sum by ulps, never a split at these shapes — JAX's own parity
test compares the same way).  Predictions of the port against the JAX
package's agree to atol 1e-5.  Bundled against unbundled predictions of
the port agree to atol 1e-4: with the same structure they differ only
through leaf values, whose sums the default-bin rebuild rounds
differently, and the plain histograms add a leaf's ~1,000 rows one at a
time in float32 (XLA's blocked matmul adds them in a tree), which moves
a leaf value by up to ~1e-5 relative (1.7e-5 seen in predictions after
6 rounds-learner iterations; JAX's own bundled/unbundled difference on
the same data is 2.8e-6).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import scipy.sparse as spm

import lightgbm_tpu as lj
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Dataset as JDataset
from lightgbm_tpu.ops import partition as jp
from lightgbm_tpu.ops import split as js

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import Dataset as TDataset
from lightgbm_tpu_torch.ops import partition as tp
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.synth import ONEHOT_PARAMS, synth_onehot

PLAN_FIELDS = ("feat_col", "feat_offset", "feat_default", "feat_nslots",
               "feat_packed", "col_num_bins")


def _mixed(n=3000, seed=2):
    """5 dense numeric columns, then 10 one-hot groups of 5."""
    rng = np.random.RandomState(seed)
    Xd = rng.randn(n, 5)
    Xs, _ = synth_onehot(n, groups=10, card=5, seed=seed + 1)
    X = np.concatenate([Xd, Xs], axis=1)
    y = (X @ rng.randn(X.shape[1]) > 0).astype(np.float64)
    return X, y


def _conflicting(n=3000, seed=4):
    """One-hot groups where 1% of the rows carry a second level: the
    plan tolerates them under max_conflict_rate, binning counts them."""
    X, y = synth_onehot(n, groups=12, card=5, seed=seed)
    rng = np.random.RandomState(seed)
    rows = rng.choice(n, n // 100, replace=False)
    X[rows, rng.randint(0, 12 * 5, size=len(rows))] = 1.0
    return X, y


def _case(name):
    if name == "onehot":
        X, y = synth_onehot(3000)
        return X, y, {}
    if name == "mixed":
        X, y = _mixed()
        return X, y, {}
    X, y = _conflicting()
    return X, y, {"max_conflict_rate": 0.05}


def _both(X, y, params, source="ndarray"):
    pj = dict(params, sparse_store="dense", verbose=-1)
    pt = dict(pj, device_type="cpu")
    if source == "csc":
        sp = spm.csr_matrix(X)
        return (JDataset.from_csc(sp, y, j_config(pj)),
                TDataset.from_csc(sp, y, t_config(pt)))
    return JDataset(X, y, j_config(pj)), TDataset(X, y, t_config(pt))


@pytest.mark.parametrize("name,source", [
    ("onehot", "ndarray"), ("mixed", "ndarray"), ("conflicts", "ndarray"),
    ("onehot", "csc"), ("conflicts", "csc")])
def test_bundled_store_bitwise_vs_jax(name, source):
    X, y, extra = _case(name)
    dj, dt = _both(X, y, extra, source)
    pj, pt = dj.bundle_plan, dt.bundle_plan
    assert pj is not None and pt is not None
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f),
                                      err_msg=f)
    assert dt.num_store_columns == dj.num_store_columns < dt.num_features
    np.testing.assert_array_equal(dt.bundle_feat_table(),
                                  dj.bundle_feat_table())
    B = 128
    for pad in (0, 32 * ((dt.num_store_columns + 31) // 32)):
        for a, b in zip(dt.unbundle_tables(B, pad), dj.unbundle_tables(B,
                                                                       pad)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dt.bins, dj.bins)
    assert dt.bins.dtype == dj.bins.dtype
    np.testing.assert_array_equal(dt.store_num_bins, dj.store_num_bins)
    assert dt.max_num_bin == dj.max_num_bin
    assert dt.bundle_conflict_rows == dj.bundle_conflict_rows
    assert (dt.bundle_conflict_rows > 0) == (name == "conflicts")
    np.testing.assert_array_equal(dt.unbundled_bins(), dj.unbundled_bins())
    # a valid set inherits its reference's plan
    vj = JDataset(X[:400], y[:400], dj.config, reference=dj)
    vt = TDataset(X[:400], y[:400], dt.config, reference=dt)
    assert vt.bundle_plan is pt
    np.testing.assert_array_equal(vt.bins, vj.bins)


def test_onehot_workload_bundles_240_features_into_40_columns():
    X, y = synth_onehot(20000)
    dt = TDataset(X, y, t_config(dict(ONEHOT_PARAMS, device_type="cpu")))
    assert dt.num_features == 240
    assert dt.num_store_columns == 40
    assert dt.bundle_conflict_rows == 0
    assert int(dt.store_num_bins.max()) == 7 and dt.max_num_bin == 7


def _all_splits(ds):
    """Every (feature, threshold bin, is-categorical) of a dataset."""
    feats, thrs = [], []
    for k, nb in enumerate(ds.num_bins):
        feats += [k] * int(nb)
        thrs += list(range(int(nb)))
    f = np.repeat(np.asarray(feats, np.int32), 2)
    t = np.repeat(np.asarray(thrs, np.int32), 2)
    c = np.tile([False, True], len(feats))
    return f, t, c


@pytest.mark.parametrize("name", ["onehot", "mixed"])
def test_bundle_predicate_and_go_left_vs_jax(name):
    X, y, extra = _case(name)
    dj, dt = _both(X, y, extra)
    f, t, c = _all_splits(dt)
    ft = dt.bundle_feat_table()
    pt = ts.bundle_predicate_params(torch.as_tensor(ft), torch.as_tensor(f),
                                    torch.as_tensor(t), torch.as_tensor(c))
    pj = js.bundle_predicate_params(jnp.asarray(ft), jnp.asarray(f),
                                    jnp.asarray(t), jnp.asarray(c))
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the predicate on the store rows, against the original-space split
    store = dt.bins.astype(np.int32)
    orig = dt.unbundled_bins().astype(np.int32)
    rng = np.random.RandomState(0)
    for i in rng.choice(len(f), 60, replace=False):
        col, T, lo, hi1, dl = (int(v[i]) for v in pt)
        row = torch.as_tensor(store[col])
        gl_t = ts.store_go_left(row, T, lo, hi1, bool(dl), bool(c[i]))
        gl_j = js.store_go_left(jnp.asarray(store[col]), T, lo, hi1,
                                bool(dl), bool(c[i]))
        np.testing.assert_array_equal(gl_t.numpy(), np.asarray(gl_j))
        want = (orig[f[i]] == t[i]) if c[i] else (orig[f[i]] <= t[i])
        np.testing.assert_array_equal(gl_t.numpy(), want)


def _store_hist(store, g, h, B):
    C, n = store.shape
    out = np.zeros((C, 3, B), np.float64)
    for c in range(C):
        for ch, v in enumerate((g, h, np.ones(n))):
            out[c, ch] = np.bincount(store[c], weights=v, minlength=B)[:B]
    return out.astype(np.float32)


@pytest.mark.parametrize("name", ["onehot", "mixed"])
def test_unbundle_hist_vs_jax(name):
    X, y, extra = _case(name)
    dj, dt = _both(X, y, extra)
    B = 128
    rng = np.random.RandomState(1)
    n = dt.num_data
    g = rng.randn(n).astype(np.float32)
    h = rng.rand(n).astype(np.float32)
    hist = _store_hist(dt.bins.astype(np.int64), g, h, B)
    totals = np.asarray([g.sum(), h.sum(), float(n)], np.float32)
    src, dmask = dt.unbundle_tables(B)
    out = ts.unbundle_hist(torch.as_tensor(hist), torch.as_tensor(src),
                           torch.as_tensor(dmask),
                           torch.as_tensor(totals)).numpy()
    ref = np.asarray(js.unbundle_hist(jnp.asarray(hist), jnp.asarray(src),
                                      jnp.asarray(dmask),
                                      jnp.asarray(totals)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # a leading batch of leaves, as the rounds learner unbundles
    two = ts.unbundle_hist(torch.as_tensor(np.stack([hist, hist * 2])),
                           torch.as_tensor(src), torch.as_tensor(dmask),
                           torch.as_tensor(np.stack([totals, totals * 2])))
    np.testing.assert_array_equal(two[0].numpy(), out)
    # and the original-feature histogram it stands for
    direct = _store_hist(dt.unbundled_bins().astype(np.int64), g, h, B)
    np.testing.assert_allclose(out, direct, rtol=0, atol=1e-3)


def test_unbundle_sentinel_survives_padded_store_columns():
    """Histograms with padded store columns (every row at bin 0 there):
    the zero sentinel of the tables must sit past the padded columns."""
    X, y, _ = _case("onehot")
    _, dt = _both(X, y, {})
    C, B, n = dt.num_store_columns, 128, dt.num_data
    Cpad = 32 * ((C + 31) // 32)
    g = np.ones(n, np.float32)
    h = np.full(n, 0.5, np.float32)
    hist = np.zeros((Cpad, 3, B), np.float32)
    hist[:C] = _store_hist(dt.bins.astype(np.int64), g, h, B)
    hist[C:, :, 0] = [g.sum(), h.sum(), float(n)]
    totals = torch.as_tensor([g.sum(), h.sum(), float(n)])
    src, dmask = dt.unbundle_tables(B, Cpad)
    out = ts.unbundle_hist(torch.as_tensor(hist), torch.as_tensor(src),
                           torch.as_tensor(dmask), totals).numpy()
    direct = _store_hist(dt.unbundled_bins().astype(np.int64), g, h, B)
    np.testing.assert_array_equal(out, direct)


@pytest.mark.parametrize("name", ["onehot", "mixed"])
def test_partition_bundled_table_bitwise_vs_jax(name):
    X, y, extra = _case(name)
    _, dt = _both(X, y, extra)
    rng = np.random.RandomState(5)
    n, L = dt.num_data, 31
    f, t, c = _all_splits(dt)
    pick = rng.choice(len(f), L, replace=False)
    new_leaf = np.arange(L, 2 * L)
    ft = torch.as_tensor(dt.bundle_feat_table())
    col, T, lo, hi1, dl = ts.bundle_predicate_params(
        ft, torch.as_tensor(f[pick]), torch.as_tensor(t[pick]),
        torch.as_tensor(c[pick]))
    tbl = np.zeros((7, 2 * L), np.float32)
    tbl[:, :L] = np.stack([col.numpy(), T.numpy(), c[pick], new_leaf,
                           lo.numpy(), hi1.numpy(), dl.numpy()])
    bins = dt.bins.astype(np.int32)
    lid = rng.randint(0, L, size=n).astype(np.int32)
    out = tp.partition_rows(torch.as_tensor(bins), torch.as_tensor(lid),
                            torch.as_tensor(tbl)).numpy()
    args = (jnp.asarray(bins), jnp.asarray(lid), jnp.asarray(tbl))
    ref_x = jp.partition_rows(*args, num_slots=2 * L, backend="xla")
    ref_p = jp.partition_rows(*args, num_slots=2 * L, backend="pallas",
                              num_bins_padded=128, interpret=True)
    np.testing.assert_array_equal(out, np.asarray(ref_x))
    np.testing.assert_array_equal(out, np.asarray(ref_p))
    assert (out >= L).any() and (out < L).any()


def _structure(bst):
    return [(t.num_leaves, t.split_feature[:t.num_leaves - 1].tolist(),
             t.threshold_in_bin[:t.num_leaves - 1].tolist(),
             t.decision_type[:t.num_leaves - 1].tolist())
            for t in bst._gbdt.models]


TRAIN = dict(objective="binary", metric="auc", num_leaves=31,
             min_data_in_leaf=5, min_sum_hessian_in_leaf=1.0,
             learning_rate=0.1, histogram_dtype="float32", verbose=-1,
             sparse_store="dense")


def _one_hot_data(n, groups, card, seed, noise=0.3):
    """tests/test_bundle.py's one-hot data: `groups` categorical
    variables one-hot encoded, labels from a seeded linear function."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card))
    for g in range(groups):
        X[np.arange(n), g * card + codes[:, g]] = 1.0
    w = rng.randn(groups * card)
    y = (X @ w + noise * rng.randn(n) > 0).astype(float)
    return X, y


@pytest.mark.parametrize("growth", ["exact", "rounds"])
def test_zero_conflict_parity(growth):
    """The JAX package's test_zero_conflict_parity (tests/test_bundle.py)
    on the port: its data and parameters, 6 iterations, bundled and
    unbundled trees of the same structure."""
    X, y = _one_hot_data(1200, 20, 6, seed=1)
    out = {}
    for eb in (True, False):
        p = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
                 verbose=-1, enable_bundle=eb, tree_growth=growth,
                 device_type="cpu")
        ds = lt.Dataset(X, y, params=p)
        bst = lt.train(p, ds, 6)
        assert (ds._inner.bundle_plan is not None) == eb
        assert ds._inner.bundle_conflict_rows == 0
        out[eb] = bst
    assert _structure(out[True]) == _structure(out[False])
    np.testing.assert_allclose(out[True].predict(X), out[False].predict(X),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("growth", ["exact", "rounds"])
def test_bundled_and_unbundled_grow_the_same_first_tree(growth):
    """A larger tree on synth_onehot: the first trees agree in structure
    and prediction.  (Later trees are not compared: the default-bin
    rebuild moves leaf values by ulps, the next gradients by as much,
    and by the third tree two candidate splits 7e-5 apart in gain can
    trade places — the JAX package's own bundled and unbundled gains
    differ by 1e-4 relative there.)"""
    X, y = synth_onehot(4000, groups=20, card=6, seed=1)
    out = {}
    for eb in (True, False):
        p = dict(TRAIN, tree_growth=growth, enable_bundle=eb,
                 device_type="cpu")
        ds = lt.Dataset(X, y, params=p)
        bst = lt.train(p, ds, 1)
        assert (ds._inner.bundle_plan is not None) == eb
        out[eb] = bst
    assert _structure(out[True]) == _structure(out[False])
    assert out[True]._gbdt.models[0].num_leaves == 31
    np.testing.assert_allclose(out[True].predict(X), out[False].predict(X),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("growth,bagging", [("exact", False),
                                            ("exact", True),
                                            ("rounds", False)])
def test_bundled_valid_scores_match_predict(growth, bagging):
    X, y = _mixed(2500, seed=6)
    Xv, yv = _mixed(600, seed=7)
    p = dict(TRAIN, tree_growth=growth, device_type="cpu")
    if bagging:
        p.update(bagging_fraction=0.7, bagging_freq=1)
    ds = lt.Dataset(X, y, params=p)
    bst = lt.train(p, ds, 5, valid_sets=[lt.Dataset(Xv, yv, reference=ds)])
    assert ds._inner.bundle_plan is not None
    dev = bst._gbdt.valid_sets[0][2].score[0].double().numpy()
    np.testing.assert_allclose(dev, bst.predict(Xv, raw_score=True),
                               rtol=0, atol=1e-5)
    # the training scores too (a bagged iteration walks the train store)
    tr = bst._gbdt.train_score.score[0].double().numpy()
    np.testing.assert_allclose(tr, bst.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("growth", ["exact", "rounds"])
def test_learners_match_jax_on_bundled_data(growth):
    X, y = synth_onehot(20000)
    Xv, yv = synth_onehot(3000, seed=7)
    params = dict(ONEHOT_PARAMS, num_leaves=63, min_sum_hessian_in_leaf=1.0,
                  tree_growth=growth, histogram_dtype="float32")
    out = {}
    for name, pkg, p in (("jax", lj, params),
                         ("torch", lt, dict(params, device_type="cpu"))):
        ds = pkg.Dataset(X, y, params=p)
        res = {}
        kw = {"verbose_eval": False} if pkg is lj else {}
        bst = pkg.train(p, ds, 3, valid_sets=[pkg.Dataset(Xv, yv,
                                                          reference=ds)],
                        evals_result=res, **kw)
        if pkg is lj:
            bst._gbdt._flush_pending()
        assert ds._inner.bundle_plan.num_columns == 40
        out[name] = (bst, res["valid_0"]["auc"])
    (bj, auc_j), (bt, auc_t) = out["jax"], out["torch"]
    assert type(bt._gbdt.learner).__name__ == \
        type(bj._gbdt.learner).__name__
    assert _structure(bt) == _structure(bj)
    assert bt._gbdt.models[0].num_leaves == 63
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(auc_t, auc_j, rtol=0, atol=1e-5)


def test_sparse_store_over_bundles_is_refused():
    X, y = synth_onehot(500)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TDataset(X, y, t_config({"device_type": "cpu",
                                 "sparse_store": "csr"}))
