"""The port's objectives and K-tree iterations held against the JAX
package, on the CPU.

Same seeded numpy inputs through both packages:

- every objective's gradients and hessians on a [K, N] score, with and
  without weights.  Bitwise where both sides run the same f32 operations
  (L2, Fair, Poisson, and the gradients of L1 and Huber).  Where an exp
  enters (the Gaussian hessian of L1 and Huber, the sigmoid of binary and
  one-vs-all, softmax), torch's and XLA's CPU exp may round differently
  in the last bit, and the differences p - 1 and |r| (sigmoid - |r|)
  cancel: rtol 1e-6 with atol 2^-22 (every such value lies in [-2, 2],
  so 2^-22 is about two ulps of its largest magnitude);
- a 5-iteration train of every objective with `tree_growth` pinned to
  rounds on both sides (the exact learner for one regression and one
  multiclass case), multiclass at num_class=3.  Trees identical in
  structure, unless the first split where two differ is an f32 gain tie
  (gains within 1e-5 relative: the packages sum the float32 histograms
  in another order); the comparison then ends at that tree, which is
  recorded.  Leaf values within rtol 1e-4 or within 1e-3 of the tree's
  largest leaf: a leaf's sums are its parent's totals less the left
  cumulative sums, so their last-bit differences grow by the parent's
  size over the leaf's hessian (Fair's first tree has a 7-row leaf with
  hessian 0.135: JAX 8.96870, the port 8.96446, their float64 sum
  8.96665).  Valid metrics within rtol 1e-4 / atol 1e-5, predictions
  within 1e-3 of their largest magnitude;
- a multiclass label set that lacks a class: that class grows no tree and
  adds JAX's default output once;
- save, load and predict bitwise; a JAX model string carried over
  predicts what JAX's Booster.predict does, bitwise (both walk the same
  trees on the host in float64).
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lj
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.objectives import create_objective as j_objective

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.objectives import create_objective as t_objective
from lightgbm_tpu_torch.objectives import objective_from_model_string


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch on one intra-op thread.  A CPU unary op such as exp
    splits a tensor over the intra-op threads in chunks of 2048; in some
    processes the chunk a worker thread computed came out up to 1.5e-4
    off in relative terms (the rows from 2000 on of a 4000-row hessian),
    which the main thread never gave, so the parity checks here keep
    torch's CPU math on the main thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


OBJECTIVES = ("regression", "regression_l1", "huber", "fair", "poisson",
              "binary", "multiclass", "multiclassova")
# objectives whose gradient and hessian run the same f32 operations in
# both packages with no exp: bitwise
BITWISE = {"regression": (True, True), "fair": (True, True),
           "poisson": (True, True), "regression_l1": (True, False),
           "huber": (True, False)}


def _labels(objective, n, rng, K=3):
    if objective in ("multiclass", "multiclassova"):
        return rng.randint(0, K, n).astype(np.float64)
    if objective == "poisson":
        return rng.poisson(2.0, n).astype(np.float64)
    if objective == "binary":
        return (rng.rand(n) < 0.4).astype(np.float64)
    return rng.randn(n) * 2.0


def _params(objective, K=3):
    p = {"objective": objective}
    if objective in ("multiclass", "multiclassova"):
        p["num_class"] = K
    return p


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_gradients_match_jax(objective, weighted):
    rng = np.random.RandomState(OBJECTIVES.index(objective) * 2 + weighted)
    N = 4000
    K = 3 if objective.startswith("multiclass") else 1
    lab = _labels(objective, N, rng)
    score = (rng.randn(K, N) * 2).astype(np.float32)
    if objective in ("huber", "regression_l1"):
        # a zero difference: jnp.sign(0) = 0 in Huber, +1 in L1
        score[0, :50] = lab[:50].astype(np.float32)
        lab[:50] = score[0, :50]
    w = (rng.rand(N) * 2).astype(np.float32) if weighted else None
    mj, mt = JMetadata(), TMetadata()
    mj.label = mt.label = lab
    mj.weights = mt.weights = w
    p = _params(objective)
    oj = j_objective(j_config(p))
    oj.init(mj, N)
    ot = t_objective(t_config(dict(p, device_type="cpu")))
    ot.init(mt, N)
    assert ot.num_tree_per_iteration == oj.num_tree_per_iteration == K
    assert ot.boost_from_average == oj.boost_from_average
    assert ot.to_string() == oj.to_string()
    assert ot.initial_score() == oj.initial_score()
    gj, hj = (np.asarray(a) for a in oj.get_gradients(jnp.asarray(score)))
    gt, ht = (a.numpy() for a in ot.get_gradients(torch.as_tensor(score)))
    assert gt.shape == ht.shape == (K, N)
    exact_g, exact_h = BITWISE.get(objective, (False, False))
    for got, ref, exact in ((gt, gj, exact_g), (ht, hj, exact_h)):
        if exact:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2.0 ** -22)
    raw = score.T.astype(np.float64)
    np.testing.assert_allclose(ot.convert_output(raw),
                               oj.convert_output(raw), rtol=1e-12)


def test_every_objective_name_is_ported():
    from lightgbm_tpu.objectives import objective_from_model_string as j_fms
    for name in OBJECTIVES + ("lambdarank",):
        cfg = dict(_params(name), device_type="cpu")
        ot = t_objective(t_config(cfg))
        oj = j_objective(j_config(_params(name)))
        assert type(ot).__name__ == type(oj).__name__
        back = objective_from_model_string(ot.to_string(),
                                           t_config({"device_type": "cpu"}))
        ref = j_fms(oj.to_string(), j_config({}))
        assert type(back).__name__ == type(ref).__name__
        assert back.to_string() == ref.to_string()
    with pytest.raises(ValueError, match="unknown objective"):
        t_objective(t_config({"device_type": "cpu"}).with_updates(
            objective="nope"))


def _data(objective, n, seed, K=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    lin = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n)
    if objective in ("multiclass", "multiclassova"):
        y = np.digitize(lin, np.quantile(lin, np.arange(1, K) / K))
    elif objective == "poisson":
        y = rng.poisson(np.exp(0.5 * lin))
    elif objective == "binary":
        y = lin > 0
    else:
        y = 2.0 * lin + 1.0
    return X, y.astype(np.float64)


_STRUCT = ("split_feature", "threshold_in_bin", "decision_type",
           "left_child", "right_child")


def _first_difference(a, b):
    """The first node whose split or children differ, else None."""
    n = min(a.num_leaves, b.num_leaves) - 1
    for i in range(n):
        if any(getattr(a, f)[i] != getattr(b, f)[i] for f in _STRUCT):
            return i
    return None if a.num_leaves == b.num_leaves else n


def _leaves_close(a, b):
    n = a.num_leaves
    np.testing.assert_array_equal(a.leaf_count[:n], b.leaf_count[:n])
    scale = float(np.abs(a.leaf_value[:n]).max())
    np.testing.assert_allclose(b.leaf_value[:n], a.leaf_value[:n],
                               rtol=1e-4, atol=1e-3 * scale)


def _compare_models(models_j, models_t):
    """Trees in order: identical in structure with close leaves, until
    one whose first differing split is an f32 gain tie.  Returns the
    number of trees compared before that tie (all of them without)."""
    assert len(models_t) == len(models_j)
    for t, (a, b) in enumerate(zip(models_j, models_t)):
        i = _first_difference(a, b)
        if i is None:
            _leaves_close(a, b)
            continue
        ga, gb = float(a.split_gain[i]), float(b.split_gain[i])
        assert abs(ga - gb) <= 1e-5 * max(abs(ga), abs(gb)), (
            f"tree {t} node {i}: JAX (feature {a.split_feature[i]}, bin "
            f"{a.threshold_in_bin[i]}, gain {ga!r}), port (feature "
            f"{b.split_feature[i]}, bin {b.threshold_in_bin[i]}, gain "
            f"{gb!r}) is no f32 gain tie")
        return t
    return len(models_j)


def _train_both(objective, growth, X, y, Xv, yv, rounds=5, num_leaves=15,
                **extra):
    params = dict(_params(objective), num_leaves=num_leaves,
                  learning_rate=0.2,
                  min_data_in_leaf=5, tree_growth=growth, verbose=-1,
                  **extra)
    out = []
    for pkg, p in ((lj, params), (lt, dict(params, device_type="cpu"))):
        ds = pkg.Dataset(X, y)
        res = {}
        kw = {} if pkg is lt else {"verbose_eval": False}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            bst = pkg.train(p, ds, rounds,
                            valid_sets=[pkg.Dataset(Xv, yv, reference=ds)],
                            evals_result=res, **kw)
        out.append((bst, res))
    return out


# the exact-learner cases grow 7-leaf trees: at 15 leaves the multiclass
# one meets an f32 gain tie in its first tree (node 6: JAX feature 1 bin
# 116, gain 21.366467; the port bin 66, gain 21.366455), and no tree
# would be compared past it
@pytest.mark.parametrize("objective,growth,leaves", [
    (o, "rounds", 15) for o in OBJECTIVES] + [
    ("regression", "exact", 7), ("multiclass", "exact", 7)])
def test_train_matches_jax(objective, growth, leaves):
    X, y = _data(objective, 3000, 11)
    Xv, yv = _data(objective, 600, 12)
    (bj, rj), (bt, rt) = _train_both(objective, growth, X, y, Xv, yv,
                                     num_leaves=leaves)
    bj._gbdt._flush_pending()
    K = bt._gbdt.K
    assert K == bj._gbdt.K == (3 if objective.startswith("multi") else 1)
    assert bt._gbdt.boost_from_average_used == \
        bj._gbdt.boost_from_average_used
    extra = 1 if bj._gbdt.boost_from_average_used else 0
    assert bt.num_trees() == bj.num_trees() == 5 * K + extra
    same = _compare_models(bj._gbdt.models, bt._gbdt.models)
    # iterations whose trees all matched
    iters = (same - extra) // K
    assert rt.keys() == rj.keys()
    for name in rj["valid_0"]:
        assert len(rt["valid_0"][name]) == len(rj["valid_0"][name]) == 5
        np.testing.assert_allclose(rt["valid_0"][name][:iters],
                                   rj["valid_0"][name][:iters], rtol=1e-4,
                                   atol=1e-5)
    pt, pj = bt.predict(Xv), bj.predict(Xv)
    assert pt.shape == pj.shape == ((600, K) if K > 1 else (600,))
    if same == bt.num_trees():
        np.testing.assert_allclose(pt, pj, rtol=0,
                                   atol=1e-3 * np.abs(pj).max())
    # the port's device-scored valid set against its host walk
    dev = bt._gbdt.valid_sets[0][2].score.double().numpy()
    host = bt.predict(Xv, raw_score=True).reshape(600, K).T
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)


def test_regression_default_trains_with_average_stump():
    """`lt.train({}, ds, 5)` trains L2 regression, the config's default,
    seeded with JAX's boost_from_average stump (the float64 label mean)."""
    X, y = _data("regression", 2000, 3)
    bst = lt.train({"device_type": "cpu", "verbose": -1}, lt.Dataset(X, y),
                   5)
    bj = lj.train({"verbose": -1, "tree_growth": "rounds"}, lj.Dataset(X, y),
                  5, verbose_eval=False)
    bj._gbdt._flush_pending()
    g = bst._gbdt
    assert type(g.objective).__name__ == "RegressionL2"
    assert g.boost_from_average_used and bst.num_trees() == 6
    stump, ref = g.models[0], bj._gbdt.models[0]
    assert stump.num_leaves == ref.num_leaves == 2
    np.testing.assert_array_equal(stump.leaf_value[:2], ref.leaf_value[:2])
    assert stump.leaf_value[0] == stump.leaf_value[1]
    np.testing.assert_allclose(stump.leaf_value[0], y.mean(), rtol=1e-7)
    assert "boost_from_average" in bst.model_to_string()


def test_missing_class_gets_default_output():
    """Labels 0 and 2 only at num_class=3: class 1 trains no tree and adds
    -log(1e10) once, as in JAX."""
    X, y = _data("multiclass", 2000, 5)
    y[y == 1] = 2
    Xv, yv = _data("multiclass", 400, 6)
    (bj, rj), (bt, rt) = _train_both("multiclass", "rounds", X, y, Xv, yv,
                                     rounds=3)
    bj._gbdt._flush_pending()
    assert bt._gbdt.class_need_train == bj._gbdt.class_need_train == \
        [True, False, True]
    assert bt._gbdt.class_default_output == bj._gbdt.class_default_output
    assert bt.num_trees() == bj.num_trees() == 9
    assert _compare_models(bj._gbdt.models, bt._gbdt.models) == 9
    assert bt._gbdt.models[1].leaf_value[0] == -np.log(1e10)
    assert bt._gbdt.models[4].leaf_value[0] == 0.0
    sc = bt._gbdt.train_score.score.double().numpy()
    np.testing.assert_allclose(sc[1], np.float32(-np.log(1e10)), rtol=0)
    np.testing.assert_allclose(rt["valid_0"]["multi_logloss"],
                               rj["valid_0"]["multi_logloss"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_save_load_predicts_bitwise(objective, tmp_path):
    X, y = _data(objective, 2000, 7)
    params = dict(_params(objective), device_type="cpu", verbose=-1,
                  num_leaves=15)
    bst = lt.train(params, lt.Dataset(X, y), 4)
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    back = lt.Booster(params={"device_type": "cpu"}, model_file=path)
    assert back._gbdt.K == bst._gbdt.K
    assert back.model_to_string() == bst.model_to_string()
    np.testing.assert_array_equal(back.predict(X), bst.predict(X))
    np.testing.assert_array_equal(back.predict(X, raw_score=True),
                                  bst.predict(X, raw_score=True))


@pytest.mark.parametrize("objective", ["regression", "multiclass"])
def test_jax_model_string_carried_over(objective):
    X, y = _data(objective, 2000, 9)
    params = dict(_params(objective), num_leaves=15, verbose=-1,
                  tree_growth="rounds")
    bj = lj.train(params, lj.Dataset(X, y), 4, verbose_eval=False)
    bj._gbdt._flush_pending()
    bt = booster_from_model_string(bj.model_to_string(), device="cpu")
    np.testing.assert_array_equal(bt.predict(X, raw_score=True),
                                  bj.predict(X, raw_score=True))
    np.testing.assert_array_equal(bt.predict(X), bj.predict(X))
