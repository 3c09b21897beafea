"""The port's training slice held against the JAX package, on the CPU.

Same seeded inputs through both packages: bin mappers and the binned
store (bitwise), binary-logloss gradients, one 63-leaf tree from the
batched-rounds learner, a 5-iteration train + predict, the training
callbacks, and a JAX-trained model carried into the port.

Tolerances: the grown trees must match in structure (split features,
thresholds, children, leaf counts) exactly.  Leaf values agree to rtol
1e-4: the port's float32 histograms, root sums and cumulative sums are
added in another order than XLA's, and a right child's sums are its
parent's total minus the left cumulative sum, so a last-bit difference
of the total becomes a relative difference of up to ~1e-5 in a leaf with
a small hessian; never a split at these shapes.  Predictions and AUC
agree to atol 1e-5.  Gradients agree to rtol 1e-6 and hessians to rtol
1e-5: torch's and XLA's CPU exp may round differently in the last bit,
and the hessian |r|(1 - |r|) cancels as |r| nears 1.  A carried-over
model predicts bitwise equal, since both packages walk the same tree
arrays on the host in float64.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lj
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Dataset as JDataset
from lightgbm_tpu.learner.rounds import RoundsTreeLearner as JRounds
from lightgbm_tpu.objectives import create_objective as j_objective

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.convert import (TREE_FIELDS,
                                        booster_from_model_string,
                                        trees_from_numpy)
from lightgbm_tpu_torch.dataset import Dataset as TDataset
from lightgbm_tpu_torch.learner.rounds import RoundsTreeLearner as TRounds
from lightgbm_tpu_torch.objectives import create_objective as t_objective
from lightgbm_tpu_torch.synth import synth_higgs

PARAMS = dict(objective="binary", metric="auc", num_leaves=63, max_bin=255,
              learning_rate=0.1, min_data_in_leaf=1,
              min_sum_hessian_in_leaf=100.0, histogram_dtype="float32",
              tree_growth="rounds", verbose=-1)


def _same_structure(a, b):
    n = a.num_leaves
    assert b.num_leaves == n
    for name in ("split_feature", "threshold_in_bin", "threshold",
                 "decision_type", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(a, name)[:n - 1],
                                      getattr(b, name)[:n - 1], err_msg=name)
    np.testing.assert_array_equal(a.leaf_count[:n], b.leaf_count[:n])


def _mixed_data():
    """Numerical columns with NaNs plus one categorical column."""
    rng = np.random.RandomState(3)
    X = rng.randn(6000, 6)
    X[rng.rand(6000) < 0.1, 1] = np.nan
    X[:, 4] = rng.randint(0, 9, size=6000)
    X[:, 5] = np.round(rng.rand(6000) * 4) / 4
    return X, (rng.rand(6000) < 0.4).astype(np.float64)


@pytest.mark.parametrize("case", ["higgs", "mixed"])
def test_bin_mappers_and_store_bitwise(case):
    if case == "higgs":
        X, y = synth_higgs(20000)
        cats, params = (), dict(max_bin=255)
    else:
        X, y = _mixed_data()
        cats, params = (4,), dict(max_bin=63, enable_bundle=False)
    dj = JDataset(X, y, j_config(params), categorical_feature=cats)
    dt = TDataset(X, y, t_config(dict(params, device_type="cpu")),
                  categorical_feature=cats)
    assert dt.used_features == dj.used_features
    for mj, mt in zip(dj.mappers, dt.mappers):
        for name in ("bin_type", "num_bin", "is_trivial", "min_val",
                     "max_val", "default_bin", "sparse_rate",
                     "bin_2_categorical"):
            assert getattr(mj, name) == getattr(mt, name), name
        np.testing.assert_array_equal(mj.bin_upper_bound, mt.bin_upper_bound)
    np.testing.assert_array_equal(dt.bins, dj.bins)
    assert dt.bins.dtype == dj.bins.dtype
    np.testing.assert_array_equal(dt.num_bins, dj.num_bins)
    np.testing.assert_array_equal(dt.is_categorical, dj.is_categorical)
    # validation sets bin with the training mappers
    vj = JDataset(X[:500], y[:500], j_config(params), reference=dj)
    vt = TDataset(X[:500], y[:500], t_config(dict(params,
                                                  device_type="cpu")),
                  reference=dt)
    np.testing.assert_array_equal(vt.bins, vj.bins)


def test_binary_logloss_gradients():
    X, y = synth_higgs(5000)
    rng = np.random.RandomState(1)
    score = (rng.randn(1, 5000) * 2).astype(np.float32)
    md_j = JDataset(X, y, j_config({})).metadata
    md_t = TDataset(X, y, t_config({"device_type": "cpu"})).metadata
    oj = j_objective(j_config(dict(objective="binary")))
    oj.init(md_j, 5000)
    ot = t_objective(t_config(dict(objective="binary", device_type="cpu")))
    ot.init(md_t, 5000)
    gj, hj = oj.get_gradients(jnp.asarray(score))
    gt, ht = ot.get_gradients(torch.as_tensor(score))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("bagging,bounded,histogram_dtype", [
    (False, False, "float32"), (True, False, "float32"),
    (False, True, "float32"), (False, False, "int8"), (True, False, "int8")],
    # the float32 cases keep the ids they had before int8 joined
    ids=["False-False", "True-False", "False-True", "False-False-int8",
         "True-False-int8"])
def test_rounds_tree_63_leaves_matches_jax(bagging, bounded,
                                           histogram_dtype):
    X, y = synth_higgs(20000)
    # a small hessian floor, so the tree reaches the 63-leaf cap
    params = dict(PARAMS, hist_rows="gathered", min_sum_hessian_in_leaf=1.0,
                  histogram_dtype=histogram_dtype)
    if bounded:
        # a 0.1 MB pool holds no per-leaf histogram cache: both children
        # are histogrammed directly
        params["histogram_pool_size"] = 0.1
    dj = JDataset(X, y, j_config(params))
    dt = TDataset(X, y, t_config(dict(params, device_type="cpu")))
    rng = np.random.RandomState(2)
    p = 1.0 / (1.0 + np.exp(-rng.randn(20000)))
    grad = (p - y).astype(np.float32)
    hess = (p * (1 - p)).astype(np.float32)
    bag = None
    if bagging:
        bag = np.sort(rng.choice(20000, 14000, replace=False)).astype(
            np.int32)
        bag = np.concatenate([bag, np.full(16384 - 14000, 20000, np.int32)])
    lj_ = JRounds(dj, j_config(params))
    assert lj_.hist_rows == "gathered"
    tj, lid_j = lj_.train(jnp.asarray(grad), jnp.asarray(hess),
                          None if bag is None else jnp.asarray(bag))
    lt_ = TRounds(dt, t_config(dict(params, device_type="cpu")))
    assert lt_.hist_rows == "gathered"
    assert lt_.cache_parent_hist == lj_.cache_parent_hist == (not bounded)
    tt, lid_t = lt_.train(torch.as_tensor(grad), torch.as_tensor(hess),
                          None if bag is None else torch.as_tensor(bag))
    assert tt.num_leaves == 63
    _same_structure(tj, tt)
    n = tt.num_leaves
    np.testing.assert_allclose(tt.leaf_value[:n], tj.leaf_value[:n],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(lid_t.numpy(), np.asarray(lid_j))
    # one host read per round, one that finds no split or the cap, one
    # tree fetch
    assert 2 <= lt_.last_host_syncs <= n + 1


@pytest.fixture(scope="module")
def jax_booster():
    X, y = synth_higgs(20000)
    Xv, yv = synth_higgs(4000, seed=7)
    ds = lj.Dataset(X, y)
    res = {}
    bst = lj.train(PARAMS, ds, 5, valid_sets=[lj.Dataset(Xv, yv,
                                                         reference=ds)],
                   evals_result=res, verbose_eval=False)
    bst._gbdt._flush_pending()
    return bst, res, (X, y, Xv, yv)


def test_train_predict_matches_jax(jax_booster):
    bj, res_j, (X, y, Xv, yv) = jax_booster
    ds = lt.Dataset(X, y)
    res_t = {}
    bt = lt.train(dict(PARAMS, device_type="cpu"), ds, 5,
                  valid_sets=[lt.Dataset(Xv, yv, reference=ds)],
                  evals_result=res_t)
    assert bt.num_trees() == bj.num_trees() == 5
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        _same_structure(a, b)
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves], rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(res_t["valid_0"]["auc"],
                               res_j["valid_0"]["auc"], rtol=0, atol=1e-5)


def test_train_callbacks_match_jax():
    """Callbacks see what the JAX package's see: before-iteration ones
    first, then after-iteration ones in `order`, each with the same
    CallbackEnv fields and the iteration's evaluation list (atol 1e-5)."""
    X, y = synth_higgs(5000)
    Xv, yv = synth_higgs(1000, seed=7)

    def run(pkg, params):
        seen = []

        def before(env):
            seen.append(("before", env.iteration, env.begin_iteration,
                         env.end_iteration, env.evaluation_result_list))
        before.before_iteration = True

        def late(env):
            seen.append(("late", env.iteration, env.begin_iteration,
                         env.end_iteration, env.evaluation_result_list))
        late.order = 20

        def early(env):
            seen.append(("early", env.iteration))
        early.order = 5
        ds = pkg.Dataset(X, y)
        pkg.train(params, ds, 3,
                  valid_sets=[pkg.Dataset(Xv, yv, reference=ds)],
                  callbacks=[late, before, early])
        return seen

    sj = run(lj, PARAMS)
    st = run(lt, dict(PARAMS, device_type="cpu"))
    assert [e[:4] for e in st] == [e[:4] for e in sj]
    assert [e[0] for e in st[:3]] == ["before", "early", "late"]
    assert st[0][4] is None
    for a, b in zip(sj, st):
        if a[0] == "late":
            assert [r[:2] + r[3:] for r in b[4]] == \
                [r[:2] + r[3:] for r in a[4]]
            np.testing.assert_allclose([r[2] for r in b[4]],
                                       [r[2] for r in a[4]], rtol=0,
                                       atol=1e-5)


def test_jax_model_carried_over_predicts_bitwise(jax_booster):
    bj, _, (_, _, Xv, _) = jax_booster
    ref = bj.predict(Xv, raw_score=True)
    bt = booster_from_model_string(bj.model_to_string(), device="cpu")
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True), ref)
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
    # the per-tree arrays route
    dicts = [dict({k: getattr(t, k) for k in TREE_FIELDS},
                  max_leaves=t.max_leaves, num_leaves=t.num_leaves,
                  shrinkage=t.shrinkage, has_categorical=t.has_categorical)
             for t in bj._gbdt.models]
    bt._gbdt.models = trees_from_numpy(dicts)
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True), ref)
