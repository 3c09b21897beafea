"""The sparse store over EFB-bundled columns, held against the JAX package
on the CPU.

Same seeded inputs through both packages: the bundled csr store built by
sparsifying the dense store (`Dataset`) and straight from CSC columns
(`Dataset.from_csc`), its COO views (`sparse_entries`,
`unbundled_sparse_entries`) and `densify()` against the JAX package's
and against the port's dense bundled store; the wide sparse probe that
the port's default parameters used to refuse (a plan over >= 128
mostly-zero store columns) trained against the JAX package's rounds
learner; rounds trees over bundled csr against bundled dense; the `.bin`
cache; and the valid-set replay and `Booster.predict` over the store.

Tolerances: stores, entries, bins, zero bins and conflict counts are
integer data, held bitwise.  With dyadic gradients every histogram sum
is exact in any order, so csr and dense trees and leaf values agree
bitwise.  Against the JAX package's trees on real-valued gradients:
structure equal, leaf values within rtol 1e-4 and atol 1e-6 (a leaf's
sums added in another order, then divided by its hessian sum, as in
tests/test_torch_exact.py).  On real-valued gradients a csr tree and a
dense one can trade near-tied splits (the zero-bin rebuild reorders f32
sums), so they are compared on dyadic gradients only.  A model's
replayed valid scores agree with its `Booster.predict` to 1e-5 (the
device walk in f32 against the host's f64 walk).
"""
import numpy as np
import pytest
import scipy.sparse as spm
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Dataset as JDataset

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import profiling
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import Dataset as TDataset
from lightgbm_tpu_torch.dataset import reset_sparse_fallbacks, sparse_fallbacks
from lightgbm_tpu_torch.learner.rounds import RoundsTreeLearner


def _sparse_X(n=2048, f=160, density=0.05, seed=3):
    """tests/test_sparse.py:27's `_sparse_X` (integer values): mostly-zero
    indicator columns and one dense numeric column."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, f))
    nz = rng.rand(n, f) < density
    X[nz] = rng.randint(1, 4, int(nz.sum()))
    X[:, 0] = rng.randn(n)
    w = np.linspace(1.0, 2.0, 8)
    y = (X[:, 0] + X[:, 1:9] @ w > 1.0).astype(np.float64)
    return X, y


def _onehot_dense(n=1201, seed=7):
    """tests/test_sparse.py:714-720: 4 sparse numeric columns and a
    one-hot group of 16."""
    rng = np.random.RandomState(seed)
    dense_part = rng.randn(n, 4) * (rng.rand(n, 4) < 0.3)
    onehot = np.zeros((n, 16))
    onehot[np.arange(n), rng.randint(0, 16, n)] = rng.rand(n) + 0.5
    X = np.concatenate([dense_part, onehot], axis=1)
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 2]
         + 0.1 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _probe(n=20_000, f=3_000):
    """The wide sparse probe: 1% density, scipy's seeded draw."""
    X = spm.random(n, f, density=0.01, format="csc",
                   random_state=np.random.RandomState(0))
    y = np.asarray(X[:, :10].sum(1) > 0).ravel().astype(np.float64)
    return X, y


PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
          "verbose": -1, "enable_bundle": True, "sparse_store": "csr",
          "tree_growth": "rounds"}


def _datasets(X, y, params, route):
    """(JAX, port csr, port dense) datasets through one route: the dense
    constructor (`Dataset`) or `from_csc`."""
    pd = dict(params, sparse_store="dense")
    tp = dict(params, device_type="cpu")
    tpd = dict(pd, device_type="cpu")
    if route == "csc":
        Xc = spm.csc_matrix(X)
        return (JDataset.from_csc(Xc, y, j_config(params)),
                TDataset.from_csc(Xc, y, t_config(tp)),
                TDataset.from_csc(Xc, y, t_config(tpd)))
    return (JDataset(X, y, config=j_config(params)),
            TDataset(X, y, config=t_config(tp)),
            TDataset(X, y, config=t_config(tpd)))


@pytest.mark.parametrize("data", ["sparse_X", "onehot_dense"])
@pytest.mark.parametrize("route", ["dense", "csc"])
def test_bundled_csr_store_is_jax_bitwise(data, route):
    X, y = _sparse_X() if data == "sparse_X" else _onehot_dense()
    dj, dt, dd = _datasets(X, y, PARAMS, route)
    assert dt.bundle_plan is not None and dt.sparse is not None
    assert dd.sparse is None
    assert dt.num_store_columns == dj.num_store_columns \
        == dd.num_store_columns < dt.num_features
    for a, b in zip(dj.sparse_entries(), dt.sparse_entries()):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(dj.unbundled_sparse_entries(),
                    dt.unbundled_sparse_entries()):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(dt.sparse.zero_bin, dj.sparse.zero_bin)
    assert dt.sparse.nnz == dj.sparse.nnz
    assert dt.bundle_conflict_rows == dj.bundle_conflict_rows \
        == dd.bundle_conflict_rows
    dense = dt.sparse.densify(dt._store_dtype)
    np.testing.assert_array_equal(dense, dd.dense_bins())
    np.testing.assert_array_equal(dense, dj.sparse.densify(dj._store_dtype))
    # the per-feature view of the entries is the dense unbundled store's
    F = dt.num_features
    ri, fi, bi, zb = dt.unbundled_sparse_entries()
    unb = np.repeat(zb[:, None], dt.num_data, axis=1)
    unb[fi, ri] = bi
    np.testing.assert_array_equal(unb, dd.unbundled_bins())
    assert unb.shape[0] == F


def test_conflicting_bundles_count_like_the_dense_route():
    """A conflict budget: rows where two members of a bundle are both
    off their default keep the last-bundled member's bin on both
    routes, and both count the same conflicting rows."""
    X, y = _onehot_dense()
    rng = np.random.RandomState(4)
    rows = rng.choice(len(y), 30, replace=False)
    X[rows, 4 + rng.randint(0, 16, size=30)] = 1.0
    params = dict(PARAMS, max_conflict_rate=0.05)
    dj, dt, dd = _datasets(X, y, params, "csc")
    assert dt.bundle_conflict_rows == dj.bundle_conflict_rows \
        == dd.bundle_conflict_rows > 0
    np.testing.assert_array_equal(dt.sparse.densify(dt._store_dtype),
                                  dd.dense_bins())
    for a, b in zip(dj.sparse_entries(), dt.sparse_entries()):
        np.testing.assert_array_equal(np.asarray(a), b)


def _real_splits(t, min_gain=1e-3):
    """(feature, threshold bin) of a tree's splits whose gain clears
    `min_gain`, in node order."""
    n = t.num_leaves - 1
    keep = t.split_gain[:n] >= min_gain
    return list(zip(t.split_feature[:n][keep], t.threshold_in_bin[:n][keep]))


def test_default_params_probe_trains_like_jax():
    """The wide sparse probe with the port's stock parameters: the bundle
    plan and the csr store form (the store JAX builds), 2 iterations
    train over them with no densification, and the splits are the JAX
    package's (tree_growth=rounds, sparse_store=csr).  At 1% density a
    leaf soon holds rows of one label, and the rest of each 31-leaf tree
    splits on f32 noise: gains of ~1e-7 to 2e-5 that tie and order
    differently in the two packages (not a fault, ROADMAP.md §C).  So
    the splits whose gain clears 1e-3 are compared, in order, with their
    gains to rtol 1e-5; the whole tree is held bitwise on dyadic
    gradients in the next test."""
    X, y = _probe()
    reset_sparse_fallbacks()
    ds = lt.Dataset(X, label=y, params={"verbose": -1,
                                        "device_type": "cpu"}).construct()
    inner = ds._inner
    assert inner.bundle_plan is not None and inner.sparse is not None
    assert inner.num_store_columns >= 128
    bt = lt.train({"verbose": -1, "device_type": "cpu"}, ds, 2)
    assert type(bt._gbdt.learner).__name__ == "RoundsTreeLearner"
    assert sparse_fallbacks() == 0
    pj = {"verbose": -1, "tree_growth": "rounds", "sparse_store": "csr"}
    dsj = lj.Dataset(X, label=y, params=pj)
    bj = lj.train(pj, dsj, 2, verbose_eval=False)
    bj._gbdt._flush_pending()
    for a, b in zip(dsj._inner.sparse_entries(), inner.sparse_entries()):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert len(bj._gbdt.models) == len(bt._gbdt.models) == 3
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        assert _real_splits(a) == _real_splits(b)
        ga = a.split_gain[:a.num_leaves - 1]
        gb = b.split_gain[:b.num_leaves - 1]
        np.testing.assert_allclose(np.sort(gb[gb >= 1e-3]),
                                   np.sort(ga[ga >= 1e-3]), rtol=1e-5)


def test_probe_rounds_tree_dyadic_matches_jax():
    """One rounds tree over the probe's bundled csr store with dyadic
    gradients (every sum exact, so every gain and tie is the same in
    both packages): the JAX package's tree and leaf ids, bitwise."""
    from lightgbm_tpu.learner.rounds import RoundsTreeLearner as JRounds
    import jax.numpy as jnp
    X, y = _probe()
    params = {"verbose": -1, "tree_growth": "rounds", "sparse_store": "csr"}
    dj = JDataset.from_csc(X, y, j_config(params))
    dt = TDataset.from_csc(X, y, t_config(dict(params, device_type="cpu")))
    assert dt.bundle_plan is not None and dt.num_store_columns >= 128
    g = np.where(y > 0, -1.0, 1.0).astype(np.float32)
    h = np.full(len(y), 0.5, np.float32)
    tj, lj_ = JRounds(dj, j_config(params)).train(jnp.asarray(g),
                                                  jnp.asarray(h))
    reset_sparse_fallbacks()
    tt, lt_ = RoundsTreeLearner(dt, t_config(dict(
        params, device_type="cpu"))).train(torch.as_tensor(g),
                                           torch.as_tensor(h))
    assert sparse_fallbacks() == 0
    n = tj.num_leaves
    assert tt.num_leaves == n > 2
    for name in ("split_feature", "threshold_in_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:n - 1],
                                      getattr(tj, name)[:n - 1])
    np.testing.assert_array_equal(tt.leaf_value[:n], tj.leaf_value[:n])
    np.testing.assert_array_equal(lt_.numpy(), np.asarray(lj_))


@pytest.mark.parametrize("data", ["sparse_X", "onehot_dense"])
def test_rounds_trees_csr_equal_dense_bitwise(data):
    X, y = _sparse_X() if data == "sparse_X" else _onehot_dense()
    _, dt, dd = _datasets(X, y, PARAMS, "csc")
    g = torch.as_tensor(np.where(y > 0, -1.0, 1.0).astype(np.float32))
    h = torch.full((len(y),), 0.5, dtype=torch.float32)
    trees = {}
    reset_sparse_fallbacks()
    before = profiling.counter_value(profiling.SPARSE_NNZ_TOUCHED)
    for name, ds in (("csr", dt), ("dense", dd)):
        cfg = t_config(dict(PARAMS, device_type="cpu"))
        t, lid = RoundsTreeLearner(ds, cfg).train(g, h)
        trees[name] = (t, lid.numpy())
    assert sparse_fallbacks() == 0
    assert profiling.counter_value(profiling.SPARSE_NNZ_TOUCHED) > before
    (tc, lc), (td, ld) = trees["csr"], trees["dense"]
    n = td.num_leaves
    assert tc.num_leaves == n > 2
    for name in ("split_feature", "threshold_in_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(tc, name)[:n - 1],
                                      getattr(td, name)[:n - 1])
    np.testing.assert_array_equal(tc.leaf_value[:n], td.leaf_value[:n])
    np.testing.assert_array_equal(lc, ld)


def test_bin_cache_rederives_bundled_csr(tmp_path):
    X, y = _onehot_dense()
    p = dict(PARAMS, device_type="cpu")
    ds = TDataset(X, y, config=t_config(dict(p, sparse_store="dense")))
    path = str(tmp_path / "train.bin")
    ds.save_binary(path)
    back = TDataset.from_binary(path, t_config(p))
    assert back.bundle_plan is not None and back.sparse is not None
    fresh = TDataset(X, y, config=t_config(p))
    for a, b in zip(fresh.sparse_entries(), back.sparse_entries()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.sparse.densify(back._store_dtype),
                                  ds.dense_bins())


def test_valid_replay_and_predict_with_no_fallback():
    """Valid-set scores replayed over the bundled csr store (during
    training, and the whole model onto a valid set added after) against
    Booster.predict on the raw rows, with no densification.  The valid
    rows are training rows, which bin with 0 bundle conflicts: a row
    where two members of a bundle are both off their default keeps one
    of them in any bundled store, dense or csr, so its binned walk may
    leave the raw one (EFB's documented loss, warned at construction)."""
    X, y = _sparse_X()
    Xv, yv = X[:512], y[:512]
    p = dict(PARAMS, objective="binary", metric="auc", device_type="cpu")
    reset_sparse_fallbacks()
    ds = lt.Dataset(spm.csr_matrix(X), y, params=p)
    vs = lt.Dataset(Xv, yv, reference=ds)
    res = {}
    bst = lt.train(p, ds, 4, valid_sets=[vs], evals_result=res,
                   verbose_eval=False)
    assert ds._inner.sparse is not None
    assert ds._inner.bundle_plan is not None
    assert vs._inner.sparse is not None
    assert vs._inner.bundle_conflict_rows == 0
    assert bst._gbdt.learner.sparse
    auc = res["valid_0"]["auc"]
    assert auc[-1] > auc[0]
    # a second valid set added to the trained model: the whole-model
    # replay over its store
    bst.add_valid(lt.Dataset(Xv, yv, reference=ds), "late")
    assert sparse_fallbacks() == 0
    raw = bst.predict(Xv, raw_score=True)
    for _, _, su, _ in bst._gbdt.valid_sets:
        np.testing.assert_allclose(su.score[0].numpy(), raw, rtol=0,
                                   atol=1e-5)
    assert bst.eval_valid()[0][2] == pytest.approx(auc[-1], abs=1e-6)
    assert sparse_fallbacks() == 0
