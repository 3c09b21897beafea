"""PMML and plot export of the port (lightgbm_tpu_torch/pmml.py,
lightgbm_tpu_torch/plotting.py) against the JAX package's, over one model
text loaded into both packages: the PMML documents are equal as strings;
with matplotlib's Agg backend, plot_importance and plot_metric draw the
same labels and values; create_tree_digraph gives the same graph source,
and both raise ImportError when graphviz cannot be imported."""
import sys

import matplotlib
matplotlib.use("Agg")

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu import pmml as jpmml

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import pmml as tpmml


def _model_text(objective, categorical):
    rng = np.random.RandomState(2)
    X = rng.randn(600, 5)
    X[:, 4] = rng.randint(0, 4, 600)
    y = (X[:, 0] + (X[:, 4] == 2) > 0.3) * 1.0
    if objective == "regression":
        y = X[:, 0] * 2 + X[:, 1] + 0.1 * rng.randn(600)
    params = {"objective": objective, "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 5, "device_type": "cpu"}
    ds = lt.Dataset(X, y, categorical_feature=[4] if categorical else "auto",
                    feature_name=[f"x{j}" for j in range(5)])
    return lt.train(params, ds, 4).model_to_string()


@pytest.fixture(scope="module")
def pair():
    text = _model_text("binary", True)
    return (lt.Booster(model_str=text, params={"device_type": "cpu"}),
            lgb.Booster(model_str=text))


@pytest.mark.parametrize("objective,categorical", [("binary", False),
                                                   ("binary", True),
                                                   ("regression", False)])
def test_pmml_matches_jax(tmp_path, objective, categorical):
    text = _model_text(objective, categorical)
    bt = lt.Booster(model_str=text, params={"device_type": "cpu"})
    bj = lgb.Booster(model_str=text)
    doc = tpmml.model_to_pmml(bt)
    assert doc == jpmml.model_to_pmml(bj)
    assert doc.count("<Segment ") == bt.num_trees()
    if categorical:
        assert 'operator="equal"' in doc
    tpmml.save_pmml(bt, str(tmp_path / "m.pmml"))
    assert (tmp_path / "m.pmml").read_text() == doc


def test_plot_importance_matches_jax(pair):
    bt, bj = pair
    at = lt.plot_importance(bt, max_num_features=4)
    aj = lgb.plot_importance(bj, max_num_features=4)
    assert [t.get_text() for t in at.get_yticklabels()] == \
        [t.get_text() for t in aj.get_yticklabels()]
    assert [p.get_width() for p in at.patches] == \
        [p.get_width() for p in aj.patches]
    assert [t.get_text() for t in at.texts] == [t.get_text()
                                                for t in aj.texts]
    assert at.get_title() == aj.get_title() == "Feature importance"


def test_plot_metric_matches_jax():
    rng = np.random.RandomState(5)
    X, Xv = rng.randn(500, 4), rng.randn(200, 4)
    y, yv = (X[:, 0] > 0) * 1.0, (Xv[:, 0] > 0) * 1.0
    params = {"objective": "binary", "metric": "binary_logloss",
              "num_leaves": 7, "verbose": -1, "device_type": "cpu"}
    ev = {}
    ds = lt.Dataset(X, y)
    lt.train(params, ds, 5, valid_sets=[lt.Dataset(Xv, yv, reference=ds)],
             evals_result=ev, verbose_eval=False)
    at, aj = lt.plot_metric(ev), lgb.plot_metric(ev)
    assert len(at.lines) == len(aj.lines) == 1
    assert np.array_equal(at.lines[0].get_xydata(), aj.lines[0].get_xydata())
    assert at.get_ylabel() == aj.get_ylabel() == "binary_logloss"
    assert at.get_legend().get_texts()[0].get_text() == \
        aj.get_legend().get_texts()[0].get_text()


def test_tree_digraph_matches_jax(pair, monkeypatch):
    bt, bj = pair
    gt = lt.create_tree_digraph(bt, tree_index=1,
                                show_info=["split_gain"])
    gj = lgb.create_tree_digraph(bj, tree_index=1,
                                 show_info=["split_gain"])
    assert gt.source == gj.source and "feature" in gt.source
    # without an importable graphviz, both raise the same ImportError
    monkeypatch.setitem(sys.modules, "graphviz", None)
    with pytest.raises(ImportError, match="graphviz is required") as et:
        lt.create_tree_digraph(bt)
    with pytest.raises(ImportError, match="graphviz is required") as ej:
        lgb.create_tree_digraph(bj)
    assert str(et.value) == str(ej.value)
