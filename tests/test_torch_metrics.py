"""The port's metrics held against the JAX package's device path
(`Metric.eval_device`), on the CPU.

Seeded numpy labels, weights and [K, N] scores go through the JAX
metric's `eval_device` and the port's `eval`, for every name of JAX's
metric table (aliases included), with and without row weights.  Values
agree within rtol 1e-6: both sides reduce in float32, in another order
(XLA's and torch's CPU sums), and torch's and XLA's exp / log may round
differently in the last bit.  Each value comes back as a 0-d tensor on
the score's device, so the boosting loop fetches an iteration's metrics
in one transfer.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.metrics import _METRICS as J_METRICS
from lightgbm_tpu.metrics import create_metric as j_metric

from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metrics import _METRICS as T_METRICS
from lightgbm_tpu_torch.metrics import create_metric as t_metric


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


K = 4
RANKING = ("ndcg", "lambdarank", "map", "mean_average_precision")
MULTI = ("multi_logloss", "multiclass", "multi_error")


def _case(name, weighted, seed):
    rng = np.random.RandomState(seed)
    n = 3000
    if name in MULTI:
        label = rng.randint(0, K, n).astype(np.float64)
        score = (rng.randn(K, n) * 2).astype(np.float32)
        # ties in the argmax (the first class wins on both sides)
        score[1, :40] = score[0, :40]
    elif name in RANKING:
        label = rng.randint(0, 4, n).astype(np.float64)
        score = rng.randn(1, n).astype(np.float32)
        score[0, :60] = np.round(score[0, :60])       # tied scores
    elif name == "poisson":
        label = rng.poisson(2.0, n).astype(np.float64)
        score = rng.randn(1, n).astype(np.float32) + 1.0
    elif name in ("binary_logloss", "binary", "binary_error", "auc"):
        label = (rng.rand(n) < 0.4).astype(np.float64)
        score = (rng.randn(1, n) * 2).astype(np.float32)
        score[0, :30] = 0.0
    else:
        label = rng.randn(n) * 2.0
        score = (label + rng.randn(n) * 1.5).astype(np.float32)[None, :]
    w = (rng.rand(n) * 2).astype(np.float32) if weighted else None
    group = None
    if name in RANKING:
        sizes = rng.randint(1, 40, 200)
        sizes = sizes[np.cumsum(sizes) <= n]
        sizes = np.append(sizes, n - sizes.sum())
        group = sizes.astype(np.int64)
    return label, score, w, group


def _eval_both(name, weighted, seed, **params):
    label, score, w, group = _case(name, weighted, seed)
    n = label.size
    mj, mt = JMetadata(), TMetadata()
    mj.label = mt.label = label
    mj.weights = mt.weights = w
    if group is not None:
        mj.set_query_from_sizes(group)
        mt.set_query_from_sizes(group)
    p = dict(params, num_class=K) if name in MULTI else dict(params)
    if name in MULTI:
        p["objective"] = "multiclass"
    jm = j_metric(name, j_config(p))
    jm.init(mj, n)
    tm = t_metric(name, t_config(dict(p, device_type="cpu")))
    tm.init(mt, n, torch.device("cpu"))
    assert tm.factor_to_bigger_better == jm.factor_to_bigger_better
    rj = jm.eval_device(jnp.asarray(score))
    rt = tm.eval(torch.as_tensor(score))
    return rj, rt


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(J_METRICS))
def test_metric_matches_jax_eval_device(name, weighted):
    rj, rt = _eval_both(name, weighted, sorted(J_METRICS).index(name))
    assert [nm for nm, _ in rt] == [nm for nm, _ in rj]
    for (_, vj), (_, vt) in zip(rj, rt):
        assert isinstance(vt, torch.Tensor) and vt.dim() == 0
        np.testing.assert_allclose(float(vt), float(np.asarray(vj)),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,params", [
    ("huber", {"huber_delta": 0.7}), ("fair", {"fair_c": 2.5}),
    ("binary_logloss", {"sigmoid": 1.7}),
    ("ndcg", {"ndcg_eval_at": [1, 3, 10]}),
    ("map", {"ndcg_eval_at": [2, 7]})])
def test_metric_parameters_match_jax(name, params):
    rj, rt = _eval_both(name, True, 77, **params)
    assert [nm for nm, _ in rt] == [nm for nm, _ in rj]
    for (_, vj), (_, vt) in zip(rj, rt):
        np.testing.assert_allclose(float(vt), float(np.asarray(vj)),
                                   rtol=1e-6, atol=0)


def test_metric_table_and_clamps():
    """Every JAX metric name is in the port's table; the Poisson loss
    clamps the score at 1e-10 and multi_logloss clamps log p at
    log(1e-15), as JAX's device functions do."""
    assert set(T_METRICS) == set(J_METRICS)
    assert t_metric("none", t_config({"device_type": "cpu"})) is None
    with pytest.raises(ValueError, match="unknown metric"):
        t_metric("nope", t_config({"device_type": "cpu"}))
    n = 6
    label = np.array([0, 1, 2, 3, 1, 0], np.float64)
    for name, score in (
            ("poisson", np.array([[-3.0, 0.0, 1e-12, 2.0, -1.0, 5.0]])),
            ("multi_logloss", np.array([[60.0, -60.0, 0.0, 0.0, 0.0, 1.0]]
                                       * K) * np.arange(1, K + 1)[:, None])):
        mj, mt = JMetadata(), TMetadata()
        mj.label = mt.label = label
        p = {"num_class": K, "objective": "multiclass"} \
            if name == "multi_logloss" else {}
        jm = j_metric(name, j_config(p))
        jm.init(mj, n)
        tm = t_metric(name, t_config(dict(p, device_type="cpu")))
        tm.init(mt, n, torch.device("cpu"))
        s = score.astype(np.float32)
        vj = float(np.asarray(jm.eval_device(jnp.asarray(s))[0][1]))
        vt = float(tm.eval(torch.as_tensor(s))[0][1])
        np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=0)
