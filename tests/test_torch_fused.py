"""The fused single-split builder and its one-leaf histograms, held
against the JAX package on the CPU.

Same seeded inputs through both packages: `histogram_full_masked` and
`histogram_full_sparse` against the JAX functions, and the port's
`FusedTreeLearner` against JAX's `FusedTreeLearner(ds, cfg, mesh=None)`
on the problem of the JAX package's tests/test_parallel.py:30-41 (1201 x
8, 15 leaves), on dense, bundled, sparse and bundled-sparse stores, with
bagging, feature_fraction, max_depth, a categorical column and without
the parent-histogram cache; the port's fused learner against its serial
learner; the learner routing; and no host read inside `build_tree`.

Tolerances: histogram counts are whole numbers, held bitwise.  Float
cells are summed in another order than XLA's (the port's plain version
adds rows one at a time with index_add_, XLA contracts a one-hot
matrix), so they agree within the reorder bound n * 2^-23 * sum|x| of
their n values; on dyadic values every partial sum is exact, and they
agree bitwise.  Trees must match in structure (split features,
thresholds, children, leaf counts) and leaf ids bitwise; leaf values
agree to rtol 1e-4 and atol 1e-6 on real-valued gradients (a leaf's
sums reordered, then divided by a small hessian, as in
tests/test_torch_exact.py) and bitwise on dyadic ones.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Dataset as JDataset
from lightgbm_tpu.learner.fused import FusedTreeLearner as JFused
from lightgbm_tpu.ops import histogram as jh

from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import Dataset as TDataset
from lightgbm_tpu_torch.dataset import reset_sparse_fallbacks, sparse_fallbacks
from lightgbm_tpu_torch.learner import fused as tf
from lightgbm_tpu_torch.learner.fused import (FusedTreeLearner,
                                              create_tree_learner,
                                              resolve_tree_learner)
from lightgbm_tpu_torch.learner.serial import SerialTreeLearner
from lightgbm_tpu_torch.ops import histogram as th

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbose": -1}


def _parallel_data(n=1201, f=8, seed=7):
    """tests/test_parallel.py's `_make_data`."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.randn(n) > 0
         ).astype(np.float64)
    return X, y


def _bundle_data(n=1201, seed=7):
    """tests/test_sparse.py:714-720: 4 sparse numeric columns and a
    one-hot group of 16 that EFB bundles."""
    rng = np.random.RandomState(seed)
    dense_part = rng.randn(n, 4) * (rng.rand(n, 4) < 0.3)
    onehot = np.zeros((n, 16))
    onehot[np.arange(n), rng.randint(0, 16, n)] = rng.rand(n) + 0.5
    X = np.concatenate([dense_part, onehot], axis=1)
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 2]
         + 0.1 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _grad_hess(y, dyadic):
    """Binary-logloss gradients at score 0 (test_parallel.py), or dyadic
    ones: multiples of 1/8 with unit hessians, exact in any order."""
    if dyadic:
        rng = np.random.RandomState(7)
        g = (rng.randint(-8, 9, size=len(y)) * 0.125).astype(np.float32)
        return g, np.ones(len(y), np.float32)
    p = 0.5
    return (((p - y) * 2.0).astype(np.float32),
            np.full(len(y), p * (1 - p) * 2.0, np.float32))


def _same_structure(a, b):
    n = a.num_leaves
    assert b.num_leaves == n
    for name in ("split_feature", "threshold_in_bin", "decision_type",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(a, name)[:n - 1],
                                      getattr(b, name)[:n - 1], err_msg=name)
    np.testing.assert_array_equal(a.leaf_count[:n], b.leaf_count[:n])


CASES = {
    "dense": ("parallel", {}, False),
    "bundled": ("bundle", {"enable_bundle": True}, True),
    "sparse": ("parallel", {"sparse_store": "csr"}, False),
    "bundled_sparse": ("bundle", {"enable_bundle": True,
                                  "sparse_store": "csr"}, True),
    "bagging": ("parallel", {}, False),
    "feature_fraction": ("parallel", {"feature_fraction": 0.6}, False),
    "max_depth": ("parallel", {"max_depth": 3}, False),
    "categorical": ("parallel", {"categorical_feature": "3"}, False),
    "no_parent_cache": ("parallel", {"histogram_pool_size": 0.001}, False),
}


def _case_data(name):
    kind, params, dyadic = CASES[name]
    X, y = _parallel_data() if kind == "parallel" else _bundle_data()
    if name == "categorical":
        # levels 0..9 of the label's interaction term, which no single
        # numeric column carries
        X = X.copy()
        X[:, 3] = np.clip(np.floor((X[:, 1] * X[:, 2] + 3) * 1.5), 0, 9)
    return X, y, dict(BASE, **params), dyadic


@pytest.mark.parametrize("name", list(CASES))
def test_fused_learner_matches_jax(name):
    X, y, params, dyadic = _case_data(name)
    cat = [3] if name == "categorical" else []
    pj = {k: v for k, v in params.items() if k != "categorical_feature"}
    dj = JDataset(X, y, config=j_config(pj), categorical_feature=cat)
    dt = TDataset(X, y, config=t_config(dict(pj, device_type="cpu")),
                  categorical_feature=cat)
    if "enable_bundle" in params:
        assert dt.bundle_plan is not None
    if params.get("sparse_store") == "csr":
        assert dt.sparse is not None and dj.sparse is not None
    g, h = _grad_hess(y, dyadic)
    bag = cnt = None
    if name == "bagging":
        rng = np.random.RandomState(3)
        cnt = 800
        bag = np.sort(rng.choice(len(y), cnt, replace=False)).astype(np.int32)
        bag = np.concatenate([bag, np.full(1024 - cnt, len(y), np.int32)])
    lj_ = JFused(dj, j_config(pj), mesh=None)
    reset_sparse_fallbacks()
    lt_ = FusedTreeLearner(dt, t_config(dict(pj, device_type="cpu")))
    assert lt_.use_bundle == lj_.use_bundle
    assert lt_.cache_parent_hist == lj_.cache_parent_hist == \
        (name != "no_parent_cache")
    for _ in range(2 if name == "feature_fraction" else 1):
        tj, lid_j = lj_.train(jnp.asarray(g), jnp.asarray(h),
                              None if bag is None else jnp.asarray(bag), cnt)
        tt, lid_t = lt_.train(torch.as_tensor(g), torch.as_tensor(h),
                              None if bag is None else torch.as_tensor(bag),
                              cnt)
        assert tt.num_leaves > 2
        _same_structure(tj, tt)
        n = tt.num_leaves
        if dyadic:
            np.testing.assert_array_equal(tt.leaf_value[:n],
                                          tj.leaf_value[:n])
        else:
            np.testing.assert_allclose(tt.leaf_value[:n], tj.leaf_value[:n],
                                       rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(lid_t.numpy(), np.asarray(lid_j))
        assert lt_.last_host_syncs == 1
    if name == "max_depth":
        assert tt.leaf_depth[:tt.num_leaves].max() <= 3
    if name == "categorical":
        assert tt.has_categorical
    assert sparse_fallbacks() == 0


@pytest.mark.parametrize("store", ["dense", "csr"])
def test_sparse_feed_assembly_matches_jax(store):
    X, y = _bundle_data()
    params = dict(BASE, enable_bundle=True, sparse_store=store)
    dj = JDataset(X, y, config=j_config(params))
    dt = TDataset(X, y, config=t_config(dict(params, device_type="cpu")))
    if store == "dense":
        assert dt.sparse is None
        return
    fj = JFused(dj, j_config(params), mesh=None)._assemble_sparse_feed()
    ft = FusedTreeLearner(dt, t_config(dict(params, device_type="cpu"))
                          )._assemble_sparse_feed()
    # the JAX feed's leading feature-shard axis is 1 on one device
    for a, b in zip(fj, ft):
        assert np.asarray(a).shape[0] == 1
        np.testing.assert_array_equal(np.asarray(a)[0], b)


def test_fused_matches_serial_learner():
    X, y = _parallel_data()
    cfg = t_config(dict(BASE, device_type="cpu"))
    ds = TDataset(X, y, config=cfg)
    g, h = (torch.as_tensor(a) for a in _grad_hess(y, False))
    ts, lid_s = SerialTreeLearner(ds, cfg).train(g, h)
    tt, lid_t = FusedTreeLearner(ds, cfg).train(g, h)
    _same_structure(ts, tt)
    n = tt.num_leaves
    np.testing.assert_allclose(tt.leaf_value[:n], ts.leaf_value[:n],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(lid_t.numpy(), lid_s.numpy())
    np.testing.assert_array_equal(np.bincount(lid_t.numpy(), minlength=n),
                                  tt.leaf_count[:n])


def test_routing_sends_cuda_exact_to_the_fused_learner():
    assert resolve_tree_learner("cuda", "exact") == "fused"
    assert resolve_tree_learner("cuda:0", "exact") == "fused"
    assert resolve_tree_learner("cpu", "exact") == "serial"
    for dev in ("cpu", "cuda"):
        for g in ("auto", "rounds"):
            assert resolve_tree_learner(dev, g) == "rounds"
    # over a mesh, as the JAX factory routes (learner/fused.py:839-901)
    for g in ("auto", "rounds", "exact"):
        assert resolve_tree_learner("cuda", g, "voting", (2, 1)) == "fused"
        assert resolve_tree_learner("cpu", g, "feature", (1, 2)) == "fused"
    for lt_, shape in (("data", (2, 1)), ("data2d", (2, 2))):
        assert resolve_tree_learner("cpu", "auto", lt_, shape) == "rounds"
        assert resolve_tree_learner("cuda", "exact", lt_, shape) == "fused"
    X, y = _parallel_data()
    ds = TDataset(X, y, config=t_config(dict(BASE, device_type="cpu")))
    learner = create_tree_learner(ds, t_config(
        dict(BASE, device_type="cpu", tree_growth="exact")))
    assert type(learner).__name__ == "SerialTreeLearner"


def test_multi_device_branches_raise():
    """The mesh learners take a sharded.mesh.Mesh (their worlds of ranks
    are tests/test_torch_parallel.py's); without a world of more than
    one rank, a distributed tree_learner warns and trains on one
    device, as the JAX factory does with one visible device."""
    X, y = _parallel_data()
    ds = TDataset(X, y, config=t_config(dict(BASE, device_type="cpu")))
    with pytest.raises(TypeError, match="Mesh"):
        FusedTreeLearner(ds, t_config(dict(BASE, device_type="cpu")),
                         mesh=object())
    for kind in ("data", "feature", "voting", "data2d"):
        with pytest.warns(UserWarning, match="one rank"):
            learner = create_tree_learner(ds, t_config(dict(
                BASE, device_type="cpu", tree_growth="exact",
                tree_learner=kind)))
        assert type(learner).__name__ == "SerialTreeLearner"


@pytest.mark.parametrize("store", ["dense", "bundled_sparse"])
def test_build_tree_makes_no_host_read(store, monkeypatch):
    """No call inside build_tree reads the device back or copies a host
    scalar to it: the tensor methods that would (`item`, `bool()`,
    `tolist`, `cpu`, `numpy`, int/float/index conversion, a Python number
    assigned into a tensor) are counted while one tree grows."""
    name = "dense" if store == "dense" else "bundled_sparse"
    X, y, params, dyadic = _case_data(name)
    cfg = t_config(dict(params, device_type="cpu"))
    ds = TDataset(X, y, config=cfg)
    learner = FusedTreeLearner(ds, cfg)
    g, h = (torch.as_tensor(a) for a in _grad_hess(y, dyadic))
    mask = learner._row_mask(None)
    fmask = learner._feature_mask()
    calls = []
    for meth in ("item", "__bool__", "tolist", "cpu", "numpy",
                 "__int__", "__float__", "__index__"):
        orig = getattr(torch.Tensor, meth)

        def spy(self, *a, _orig=orig, _m=meth, **k):
            calls.append(_m)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, meth, spy)
    # a Python number written into a CUDA tensor is a host-to-device copy
    # that waits for the card
    real_set = torch.Tensor.__setitem__

    def setitem(self, idx, value):
        if isinstance(value, (int, float, bool)):
            calls.append("__setitem__ of a Python number")
        return real_set(self, idx, value)
    monkeypatch.setattr(torch.Tensor, "__setitem__", setitem)
    arrs, leaf_id = tf.build_tree(
        learner.bins_dev, g, h, mask, learner.num_bins_dev,
        learner.is_cat_dev, fmask, learner.ftbl, learner.unb,
        **learner._kw)
    monkeypatch.undo()
    assert calls == []
    tree = tf.tree_arrays_to_host(arrs, ds, params["num_leaves"])
    assert tree.num_leaves == params["num_leaves"]


@pytest.mark.parametrize("input_dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("dyadic", [False, True])
def test_histogram_full_masked_vs_jax(input_dtype, dyadic):
    rng = np.random.RandomState(11)
    F, N, nb, B = 6, 3000, 50, 128
    bins = rng.randint(0, nb, size=(F, N)).astype(np.int32)
    if dyadic:
        g = (rng.randint(-16, 17, N) / 16.0).astype(np.float32)
        h = (rng.randint(1, 17, N) / 16.0).astype(np.float32)
    else:
        g = rng.randn(N).astype(np.float32)
        h = rng.rand(N).astype(np.float32)
    mask = (rng.rand(N) < 0.6).astype(np.float32)
    hj = np.asarray(jh.histogram_full_masked(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(mask),
        num_bins_padded=B, input_dtype=input_dtype))
    for store in (bins, (bins - 128).astype(np.int8)):
        ht = th.histogram_full_masked(
            torch.as_tensor(store), torch.as_tensor(g), torch.as_tensor(h),
            torch.as_tensor(mask), num_bins_padded=B,
            input_dtype=input_dtype).numpy()
        assert ht.shape == (F, 3, B)
        np.testing.assert_array_equal(ht[:, 2], hj[:, 2])       # counts
        if dyadic or input_dtype == "bfloat16":
            # bfloat16 operands carry 8 significant bits: their sums
            # over <= 3000 rows are exact in float32
            np.testing.assert_array_equal(ht, hj)
        else:
            absj = np.asarray(jh.histogram_full_masked(
                jnp.asarray(bins), jnp.abs(jnp.asarray(g)),
                jnp.asarray(h), jnp.asarray(mask), num_bins_padded=B))
            n = hj[:, 2]
            assert np.all(np.abs(ht[:, 0] - hj[:, 0])
                          <= n * 2.0 ** -23 * absj[:, 0] + 1e-30)
            assert np.all(np.abs(ht[:, 1] - hj[:, 1])
                          <= n * 2.0 ** -23 * absj[:, 1] + 1e-30)


@pytest.mark.parametrize("dyadic", [False, True])
def test_histogram_full_sparse_vs_jax(dyadic):
    rng = np.random.RandomState(5)
    N, R, Cp, B = 2000, 6, 40, 128
    cols = np.full((N, R), Cp, np.int32)
    binsv = np.zeros((N, R), np.int32)
    for r in range(N):
        k = rng.randint(0, R + 1)
        c = np.sort(rng.choice(Cp, k, replace=False))
        cols[r, :k] = c
        binsv[r, :k] = rng.randint(1, 60, k)
    zb = rng.randint(0, 3, Cp).astype(np.int32)
    zb[-2:] = -1                                     # padded columns
    if dyadic:
        g = (rng.randint(-16, 17, N) / 16.0).astype(np.float32)
        h = np.ones(N, np.float32)
    else:
        g = rng.randn(N).astype(np.float32)
        h = rng.rand(N).astype(np.float32)
    mask = (rng.rand(N) < 0.5).astype(np.float32)
    hj = np.asarray(jh.histogram_full_sparse(
        jnp.asarray(cols), jnp.asarray(binsv), jnp.asarray(zb),
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(mask),
        num_columns_padded=Cp, num_bins_padded=B, input_dtype="int8"))
    ht = th.histogram_full_sparse(
        torch.as_tensor(cols), torch.as_tensor(binsv), torch.as_tensor(zb),
        torch.as_tensor(g), torch.as_tensor(h), torch.as_tensor(mask),
        num_columns_padded=Cp, num_bins_padded=B,
        input_dtype="int8").numpy()
    assert ht.shape == (Cp, 3, B)
    np.testing.assert_array_equal(ht[:, 2], hj[:, 2])
    if dyadic:
        np.testing.assert_array_equal(ht, hj)
    else:
        # each cell (the zero bin included: totals minus the column's
        # stored sums) reorders at most the N masked rows' values
        bound = N * 2.0 ** -23 * np.abs(g * mask).sum()
        assert np.abs(ht[:, 0] - hj[:, 0]).max() <= bound
        bound = N * 2.0 ** -23 * np.abs(h * mask).sum()
        assert np.abs(ht[:, 1] - hj[:, 1]).max() <= bound
