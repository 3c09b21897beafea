"""The port's training loop (`lightgbm_tpu_torch.train`, `Booster`)
against the JAX package's, on the CPU.

The probe data of ROADMAP.md §C: `RandomState(0)`, 2000 x 5 training
rows, 500 x 5 valid rows, binary with 7 leaves and AUC.  Both packages
run the exact leaf-wise learner (`tree_growth=exact`), so they grow the
same trees; AUC values agree within 1e-6.
"""
import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

PARAMS = {"objective": "binary", "num_leaves": 7, "metric": "auc",
          "verbose": -1, "tree_growth": "exact"}


@pytest.fixture(scope="module")
def probe():
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 5)
    y = (X[:, 0] + 0.3 * rng.randn(2000) > 0).astype(np.float64)
    Xv = rng.randn(500, 5)
    yv = (Xv[:, 0] > 0).astype(np.float64)
    return X, y, Xv, yv


def _train(pkg, probe, params, rounds, with_train, callbacks=()):
    """Train `pkg` on the probe with the training set first among the
    valid sets when `with_train`; returns (booster, evals_result)."""
    X, y, Xv, yv = probe
    if pkg is lt:
        params = dict(params, device_type="cpu")
    ds = pkg.Dataset(X, y, params=params)
    vs = pkg.Dataset(Xv, yv, reference=ds, params=params)
    sets, names = ([ds, vs], ["tr", "va"]) if with_train else ([vs], ["va"])
    res = {}
    kw = {"verbose_eval": False} if pkg is lj else {}
    bst = pkg.train(params, ds, rounds, valid_sets=sets, valid_names=names,
                    evals_result=res, callbacks=list(callbacks), **kw)
    return bst, res


def _same_evals(res_t, res_j):
    assert list(res_t) == list(res_j)
    for name in res_j:
        assert list(res_t[name]) == list(res_j[name])
        for metric, vals in res_j[name].items():
            assert len(res_t[name][metric]) == len(vals)
            np.testing.assert_allclose(res_t[name][metric], vals, rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_unported_boosting_type_raises(probe, boosting):
    """Fault 2 (ROADMAP.md §C): goss and dart used to train plain GBDT
    without a word; until they are ported they are refused, from the
    parameters and from a model string's first line."""
    X, y, _, _ = probe
    params = dict(PARAMS, device_type="cpu", boosting=boosting)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lt.train(params, lt.Dataset(X, y, params=params), 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lt.Booster(params=params, train_set=lt.Dataset(X, y, params=params))
    # a model string keeps its boosting type on its first line (the JAX
    # package writes it for goss and dart); "tree" still loads
    bst = lt.train(dict(PARAMS, device_type="cpu"),
                   lt.Dataset(X, y, params=PARAMS), 2)
    text = bst.model_to_string()
    assert text.split("\n", 1)[0] == "tree"
    lt.Booster(model_str=text)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lt.Booster(model_str=boosting + "\n" + text.split("\n", 1)[1])


@pytest.mark.parametrize("via", ["valid_sets", "is_training_metric"])
def test_training_set_is_evaluated_as_training(probe, via):
    """Fault 3 (ROADMAP.md §C): the training set passed in valid_sets
    was dropped.  It is evaluated each iteration under the name
    "training", ahead of the valid sets, as in the JAX engine; so it is
    with is_training_metric=True."""
    if via == "valid_sets":
        args = (PARAMS, 3, True)
    else:
        args = (dict(PARAMS, is_training_metric=True), 3, False)
    _, res_j = _train(lj, probe, *args)
    _, res_t = _train(lt, probe, *args)
    assert list(res_j) == ["training", "va"]
    assert len(res_j["training"]["auc"]) == 3
    _same_evals(res_t, res_j)


def _recorder(calls):
    def cb(env):
        calls.append((env.iteration, [(s, m, float(v), b) for s, m, v, b
                                      in env.evaluation_result_list]))
    return cb


@pytest.mark.parametrize("tree_growth", ["exact", "rounds"])
def test_iteration_without_a_split_is_evaluated(probe, tree_growth):
    """Fault 4 (ROADMAP.md §C): the iteration that finds no split broke
    before evaluation and the after-iteration callbacks.  With
    min_gain_to_split=1e9 no iteration splits: both of the port's
    learners evaluate the first iteration, call the callbacks, then
    stop, as the JAX package's exact learner does (one AUC, 0.5).
    JAX's pipelined rounds learner reports the finish one iteration
    late (two AUCs): the port does not copy that, and is held against
    the exact learner."""
    params = dict(PARAMS, min_gain_to_split=1e9)
    calls_j, calls_t = [], []
    _, res_j = _train(lj, probe, params, 3, True, [_recorder(calls_j)])
    _, res_t = _train(lt, probe, dict(params, tree_growth=tree_growth), 3,
                      True, [_recorder(calls_t)])
    assert res_j["va"]["auc"] == [0.5]
    _same_evals(res_t, res_j)
    assert [c[0] for c in calls_t] == [c[0] for c in calls_j] == [0]
    for (_, ev_t), (_, ev_j) in zip(calls_t, calls_j):
        assert [e[:2] + e[3:] for e in ev_t] == [e[:2] + e[3:] for e in ev_j]
        np.testing.assert_allclose([e[2] for e in ev_t],
                                   [e[2] for e in ev_j], rtol=0, atol=1e-6)
    _, res_rounds = _train(lj, probe, dict(params, tree_growth="rounds"), 3,
                           True)
    assert len(res_rounds["va"]["auc"]) == 2
