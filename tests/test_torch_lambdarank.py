"""The port's lambdarank training over the sparse store, held against the
JAX package on the CPU.

Same seeded inputs through both packages: lambdarank gradients and
hessians, NDCG@1..5, three boosting iterations of the CTR configuration
on the csr store (float32 and int8 histograms), a JAX-trained model
carried into the port, and the device-scored sparse valid set against
the host walk.

Tolerances:
- Gradients and hessians agree within 1e-6 of the largest |value| of the
  call (atol = 1e-6 * max|ref|, rtol 1e-6).  A document's lambda is the
  sum over its lower-ranked pairs minus the sum over its higher-ranked
  ones, so where the two nearly cancel the elementwise relative error is
  unbounded; torch and XLA add the pairs in another order and may round
  exp differently in the last bit.
- NDCG@k agrees to 1e-6: per-query DCG sums of at most 30 terms, added
  in another order.
- The first three trees are identical in structure (split features,
  thresholds, children, leaf counts) in float32 and in int8; no f32 gain
  tie separates them at this size.  Leaf values agree to rtol 1e-4, for
  the reason tests/test_torch_slice.py gives.
- A carried JAX model predicts bitwise equal: both walk the same trees on
  the host in float64.  The device-scored valid set (float32 sums over
  the sparse walk) agrees with the host walk to 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lj
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.metrics import NDCGMetric as JNDCG
from lightgbm_tpu.objectives import create_objective as j_objective

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import dataset as tdataset
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metrics import NDCGMetric as TNDCG
from lightgbm_tpu_torch.objectives import create_objective as t_objective
from lightgbm_tpu_torch.synth import CTR_PARAMS, synth_ctr

CPU = torch.device("cpu")


def _queries(weighted: bool):
    rng = np.random.RandomState(0)
    sizes = rng.randint(1, 30, size=40)
    n = int(sizes.sum())
    lab = rng.randint(0, 4, size=n).astype(np.float32)
    w = rng.rand(n).astype(np.float32) if weighted else None
    mds = []
    for cls in (JMetadata, TMetadata):
        md = cls(label=lab, weights=w)
        md.set_query_from_sizes(sizes)
        mds.append(md)
    return n, mds, rng


def _scores(kind, n, rng):
    if kind == "zero":                               # every doc tied
        return np.zeros((1, n), np.float32)
    if kind == "ties":                               # many ties
        return (np.round(rng.randn(1, n) * 4) / 4).astype(np.float32)
    return rng.randn(1, n).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["zero", "ties", "distinct"])
def test_lambdarank_gradients_vs_jax(kind, weighted):
    n, (mj, mt), rng = _queries(weighted)
    oj = j_objective(j_config({"objective": "lambdarank"}))
    oj.init(mj, n)
    ot = t_objective(t_config({"objective": "lambdarank",
                               "device_type": "cpu"}))
    ot.init(mt, n, CPU)
    sc = _scores(kind, n, rng)
    gj, hj = (np.asarray(a) for a in oj.get_gradients(jnp.asarray(sc)))
    gt, ht = (a.numpy() for a in ot.get_gradients(torch.as_tensor(sc)))
    assert gt.shape == gj.shape == (1, n)
    for a, b in ((gt, gj), (ht, hj)):
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())
    assert np.abs(gj).max() > 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["zero", "ties", "distinct"])
def test_ndcg_vs_jax(kind, weighted):
    n, (mj, mt), rng = _queries(weighted)
    params = {"objective": "lambdarank", "metric": "ndcg"}
    nj = JNDCG(j_config(params))
    nj.init(mj, n)
    nt = TNDCG(t_config(dict(params, device_type="cpu")))
    nt.init(mt, n, CPU)
    sc = _scores(kind, n, rng)[0]
    ref = nj.eval_device(jnp.asarray(sc[None]))
    out = nt.eval(torch.as_tensor(sc[None]))
    assert [k for k, _ in out] == [k for k, _ in ref] == [
        f"ndcg@{k}" for k in (1, 2, 3, 4, 5)]
    np.testing.assert_allclose([float(v) for _, v in out],
                               [float(v) for _, v in ref], rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def ctr_data():
    X, y, g = synth_ctr(2_000, 512, 0.02)
    Xv, yv, gv = synth_ctr(400, 512, 0.02, seed=7)
    return X, y, g, Xv.toarray(), yv, gv


def _train(pkg, params, data, **kw):
    X, y, g, Xv, yv, gv = data
    ds = pkg.Dataset(X, y, group=g, params=params)
    vs = pkg.Dataset(Xv, yv, group=gv, reference=ds)
    res = {}
    bst = pkg.train(params, ds, 3, valid_sets=[vs], evals_result=res, **kw)
    return bst, res


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_csr_lambdarank_trees_match_jax(ctr_data, dtype):
    params = dict(CTR_PARAMS, tree_growth="rounds", histogram_dtype=dtype)
    bj, rj = _train(lj, params, ctr_data, verbose_eval=False)
    bj._gbdt._flush_pending()
    tdataset.reset_sparse_fallbacks()
    bt, rt = _train(lt, dict(params, device_type="cpu"), ctr_data)
    assert bt._gbdt.train_set.sparse is not None
    assert bt._gbdt.valid_sets[0][1].sparse is not None
    assert tdataset.sparse_fallbacks() == 0
    assert bt.num_trees() == bj.num_trees() == 3
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        n = a.num_leaves
        assert b.num_leaves == n > 1
        for name in ("split_feature", "threshold_in_bin", "threshold",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n - 1],
                                          getattr(a, name)[:n - 1], name)
        np.testing.assert_array_equal(b.leaf_count[:n], a.leaf_count[:n])
        np.testing.assert_allclose(b.leaf_value[:n], a.leaf_value[:n],
                                   rtol=1e-4, atol=1e-6)
    for k in ("ndcg@1", "ndcg@3", "ndcg@5"):
        np.testing.assert_allclose(rt["valid_0"][k], rj["valid_0"][k],
                                   rtol=0, atol=1e-6)


def test_jax_lambdarank_model_carried_over(ctr_data):
    params = dict(CTR_PARAMS, tree_growth="rounds")
    bj, _ = _train(lj, params, ctr_data, verbose_eval=False)
    Xv = ctr_data[3]
    ref = bj.predict(Xv, raw_score=True)
    bt = booster_from_model_string(bj.model_to_string(), device="cpu")
    assert bt._gbdt.objective.name == "lambdarank"
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True), ref)
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))


def test_sparse_valid_scores_match_host_walk(ctr_data):
    bt, res = _train(lt, dict(CTR_PARAMS, device_type="cpu"), ctr_data)
    su = bt._gbdt.valid_sets[0][2]
    assert isinstance(su.bins_fn, tuple)           # the ELL triple
    dev = su.score[0].double().numpy()
    host = bt.predict(ctr_data[3], raw_score=True)
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)
    assert np.all(np.isfinite(res["valid_0"]["ndcg@5"]))
