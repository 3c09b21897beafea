"""The port's online learning (lightgbm_tpu_torch/online/) and
Booster.refit on the CPU, held against the JAX package on the same
seeded inputs, mirroring tests/test_online.py and the daemon cases of
tests/test_faults.py.

Tolerance of refit leaf values against JAX's: |port - jax| <= 1e-5 *
|jax| + 1e-7.  Both sides take the same f32 gradients; the per-leaf sums
differ in their order of addition (the JAX scan's f32 one-hot einsum,
the port's float64 chunked product cast to f32), a few f32 ulps of the
gradient mass, which the relative term covers on every leaf but those
near zero after a decay blend, where the 1e-7 absolute term (below
one f32 ulp at 1) does.  On dyadic gradients both sums are exact and
the values are bitwise equal.
"""
import json
import os

import numpy as np
import pytest

import lightgbm_tpu as lj
from lightgbm_tpu.config import config_from_params as jcfg
from lightgbm_tpu.dataset import Dataset as JD
from lightgbm_tpu.online import (OnlineTrainer as JTrainer, TrafficLog as
                                 JTrafficLog, refit_gbdt as jrefit)
from lightgbm_tpu.online import append_traffic as j_append
from lightgbm_tpu.online.stream import TrafficDemux as JDemux

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import config_from_params as tcfg
from lightgbm_tpu_torch.dataset import Dataset as TD
from lightgbm_tpu_torch.diagnostics import faults
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.online import (LeafRefitter, OnlineTrainer,
                                       TrafficLog, append_traffic,
                                       refit_gbdt)
from lightgbm_tpu_torch.online.stream import TrafficDemux
from lightgbm_tpu_torch.quantize import file_sha1
from lightgbm_tpu_torch.serving import ModelRegistry, PredictionServer

CPU = {"device_type": "cpu", "verbose": -1}
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _synth(n=1500, f=10, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    z = X @ rng.randn(f)
    return X, (z > np.median(z)).astype(np.float64)


def _leaves(models):
    return [np.asarray(t.leaf_value[: t.num_leaves]).copy() for t in models]


def _assert_leaves_close(port, jax_models):
    for i, (a, b) in enumerate(zip(_leaves(port), _leaves(jax_models))):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"tree {i}")


def _port_of(jbst, params):
    """The JAX model as a port Booster on the CPU."""
    return lt.Booster(params=dict(params, **CPU),
                      model_str=jbst.model_to_string())


# -- LeafRefitter against the JAX package ----------------------------------


def _refit_case(objective):
    rng = np.random.RandomState(0)
    X = rng.randn(1800, 6)
    X2 = rng.randn(1200, 6)
    if objective == "binary":
        y = (X[:, 0] + 0.3 * rng.randn(1800) > 0).astype(float)
        y2 = (X2[:, 1] + 0.3 * rng.randn(1200) > 0).astype(float)
        p = {"objective": "binary"}
    else:
        y = np.digitize(X[:, 0] + 0.3 * rng.randn(1800), [-0.5, 0.5])
        y2 = np.digitize(X2[:, 1], [-0.5, 0.5])
        p = {"objective": "multiclass", "num_class": 3}
    p.update(num_leaves=15, min_data_in_leaf=10, verbose=-1)
    return X, y.astype(float), X2, y2.astype(float), p


@pytest.mark.parametrize("route", ["raw", "binned"])
@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_leaf_refitter_matches_jax(objective, route):
    """decay 0.3 refit on a drifted window: raw routing (leaf_idx from
    the host walk, over a streaming window against the training mappers,
    where the binned router gives the same leaves) or the binned router
    (leaf_idx None, over a batch dataset with its own mappers): the leaf
    values within the stated tolerance of JAX's."""
    X, y, X2, y2, p = _refit_case(objective)
    jb = lj.train(dict(p, tree_growth="exact"), lj.Dataset(X, y), 8)
    tb = _port_of(jb, p)
    if route == "raw":
        jbase, tbase = JD(X, y.astype(np.float32), jcfg(p)), \
            TD(X, y.astype(np.float32), tcfg(dict(p, **CPU)))
        jw, tw = JD.streaming_from(jbase), TD.streaming_from(tbase)
        for a in range(0, 1200, 500):
            jw.append_rows(X2[a:a + 500], y2[a:a + 500])
            tw.append_rows(X2[a:a + 500], y2[a:a + 500])
        jl = jb._gbdt.predict_leaf_index(X2)
        tl = tb._gbdt.predict_leaf_index(X2)
        np.testing.assert_array_equal(tl, jl)
    else:
        jw = JD(X2, y2.astype(np.float32), jcfg(p))
        tw = TD(X2, y2.astype(np.float32), tcfg(dict(p, **CPU)))
        jl = tl = None
    js = jrefit(jb._gbdt, jw, decay_rate=0.3, leaf_idx=jl)
    ts = refit_gbdt(tb._gbdt, tw, decay_rate=0.3, leaf_idx=tl)
    assert ts == js
    _assert_leaves_close(tb._gbdt.models, jb._gbdt.models)
    if route == "raw":
        # against the training mappers the binned router is exact
        np.testing.assert_array_equal(
            LeafRefitter(tb._gbdt, tw).route_binned().numpy().T, tl)


def test_refit_row_chunks_match_jax(monkeypatch):
    """Leaf sums over several fixed row chunks, and the binned router
    over several row passes, give JAX's values as one chunk does."""
    from lightgbm_tpu_torch.online import refit as R
    monkeypatch.setattr(R, "LEAF_SUM_CHUNK_BYTES", 1)    # 1,024-row chunks
    monkeypatch.setattr(R, "ROUTE_CHUNK_ROWS", 500)
    X, y, X2, y2, p = _refit_case("binary")
    jb = lj.train(dict(p, tree_growth="exact"), lj.Dataset(X, y), 8)
    tb = _port_of(jb, p)
    jw = JD(X2, y2.astype(np.float32), jcfg(p))
    tw = TD(X2, y2.astype(np.float32), tcfg(dict(p, **CPU)))
    jrefit(jb._gbdt, jw, decay_rate=0.0)
    refit_gbdt(tb._gbdt, tw, decay_rate=0.0)
    _assert_leaves_close(tb._gbdt.models, jb._gbdt.models)


def test_refit_dyadic_gradients_bitwise():
    """Dyadic labels (k/128), lr 0.5, one iteration: every gradient, sum
    and shrinkage product is exact in f32, so the port's refit on the
    training rows gives back the trained leaf values bitwise, and equals
    JAX's refit of the same model bitwise."""
    rng = np.random.RandomState(3)
    X = rng.randn(2000, 10)
    y = (rng.randint(0, 256, 2000) / 128.0).astype(np.float64)
    p = {"objective": "regression", "num_leaves": 15, "learning_rate": 0.5,
         "boost_from_average": False, "verbose": -1, "min_data_in_leaf": 20}
    tb = lt.train(dict(p, **CPU), lt.Dataset(X, y), 1)
    orig = _leaves(tb._gbdt.models)
    jb = lj.Booster(params=p, model_str=tb.model_to_string())
    inner = TD(X, y.astype(np.float32), tcfg(dict(p, **CPU)))
    refit_gbdt(tb._gbdt, inner, decay_rate=0.0, min_rows=1)
    jrefit(jb._gbdt, JD(X, y.astype(np.float32), jcfg(p)), decay_rate=0.0,
           min_rows=1)
    for a, o, j in zip(_leaves(tb._gbdt.models), orig,
                       _leaves(jb._gbdt.models)):
        np.testing.assert_array_equal(a, o)
        np.testing.assert_array_equal(a, j)


def _small_model(p=None, rounds=4, seed=5):
    X, y = _synth(800, seed=seed)
    q = dict({"objective": "binary", "num_leaves": 7,
              "min_data_in_leaf": 5}, **(p or {}), **CPU)
    return lt.train(q, lt.Dataset(X, y, params=q), rounds), X, y, q


def test_refit_decay_one_freezes_values():
    bst, X, y, q = _small_model()
    orig = _leaves(bst._gbdt.models)
    st = refit_gbdt(bst._gbdt, TD(X, (1 - y).astype(np.float32), tcfg(q)),
                    decay_rate=1.0)
    assert st["trees_refit"] == 0
    for a, o in zip(_leaves(bst._gbdt.models), orig):
        np.testing.assert_array_equal(a, o)


def test_refit_min_rows_guard_keeps_starved_leaves():
    """Leaves with fewer window rows than refit_min_rows keep their exact
    f64 values, as in JAX; the rest move."""
    bst, X, y, q = _small_model()
    orig = _leaves(bst._gbdt.models)
    Xw, yw = X[:60], (1 - y[:60]).astype(np.float32)
    leaf = bst._gbdt.predict_leaf_index(Xw)
    jb = lj.Booster(params={"verbose": -1}, model_str=bst.model_to_string())
    refit_gbdt(bst._gbdt, TD(Xw, yw, tcfg(q)), decay_rate=0.0, min_rows=15,
               leaf_idx=leaf)
    jrefit(jb._gbdt, JD(Xw, yw, jcfg(q)),
           decay_rate=0.0, min_rows=15, leaf_idx=leaf)
    moved = kept = 0
    for i, (t, o) in enumerate(zip(bst._gbdt.models, orig)):
        cnt = np.bincount(leaf[:, i], minlength=t.num_leaves)
        v = t.leaf_value[: t.num_leaves]
        np.testing.assert_array_equal(v[cnt < 15], o[cnt < 15])
        kept += int((cnt < 15).sum())
        moved += int((v != o).sum())
    assert kept and moved
    _assert_leaves_close(bst._gbdt.models, jb._gbdt.models)


def test_refit_zero_weight_rows_keep_values():
    bst, X, y, q = _small_model()
    orig = _leaves(bst._gbdt.models)
    ds = TD(X, (1 - y).astype(np.float32), tcfg(q))
    ds.metadata.weights = np.zeros(len(X), np.float32)
    refit_gbdt(bst._gbdt, ds, decay_rate=0.0, min_rows=1)
    for a, o in zip(_leaves(bst._gbdt.models), orig):
        np.testing.assert_array_equal(a, o)


def test_refit_freezes_boost_from_average_tree():
    rng = np.random.RandomState(4)
    X = rng.randn(600, 5)
    y = 3.0 + X[:, 0] + 0.1 * rng.randn(600)
    q = dict(objective="regression", num_leaves=7, **CPU)
    bst = lt.train(q, lt.Dataset(X, y, params=q), 3)
    g = bst._gbdt
    assert g.boost_from_average_used
    first = g.models[0].leaf_value.copy()
    st = refit_gbdt(g, TD(X, (y + 5).astype(np.float32), tcfg(q)),
                    decay_rate=0.0, min_rows=1)
    np.testing.assert_array_equal(g.models[0].leaf_value, first)
    assert st["trees_refit"] == len(g.models) - 1


def test_refit_requires_labels_rows_and_pointwise_objective():
    bst, X, y, q = _small_model()
    ds = TD(X, y.astype(np.float32), tcfg(q))
    ds.metadata.label = np.zeros(3, np.float32)
    with pytest.raises(LightGBMError, match="no labels"):
        refit_gbdt(bst._gbdt, ds)
    empty = TD.streaming_from(TD(X, y.astype(np.float32), tcfg(q)))
    with pytest.raises(LightGBMError, match="at least one"):
        refit_gbdt(bst._gbdt, empty)
    with pytest.raises(ValueError, match="leaf_idx"):
        refit_gbdt(bst._gbdt, TD(X, y.astype(np.float32), tcfg(q)),
                   leaf_idx=np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="decay_rate"):
        LeafRefitter(bst._gbdt, ds, decay_rate=1.5)
    rng = np.random.RandomState(0)
    Xr = rng.randn(200, 4)
    yr = rng.randint(0, 3, 200).astype(float)
    rq = dict(objective="lambdarank", num_leaves=7, min_data_in_leaf=5,
              **CPU)
    rank = lt.train(rq, lt.Dataset(Xr, yr, group=[20] * 10, params=rq), 2)
    with pytest.raises(LightGBMError, match="lambdarank"):
        refit_gbdt(rank._gbdt, TD(Xr, yr.astype(np.float32), tcfg(rq)))


# -- Booster.refit ----------------------------------------------------------


def _probe():
    """ROADMAP §C's probe data."""
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 5)
    y = (X[:, 0] + 0.3 * rng.randn(2000) > 0).astype(float)
    Xv = rng.randn(500, 5)
    yv = (Xv[:, 0] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 7, "metric": "auc",
         "verbose": -1}
    return X, y, Xv, yv, p


def test_booster_refit_matches_jax_on_probe_data():
    X, y, Xv, yv, p = _probe()
    jb = lj.train(dict(p, tree_growth="exact"), lj.Dataset(X, y), 5)
    tb = _port_of(jb, p)
    before = tb.model_to_string()
    w = np.linspace(0.5, 1.5, len(Xv))
    tn = tb.refit(Xv, 1 - yv, decay_rate=0.5, weight=w)
    jn = jb.refit(Xv, 1 - yv, decay_rate=0.5, weight=w)
    assert tb.model_to_string() == before
    assert tn is not tb and tn.num_trees() == tb.num_trees()
    np.testing.assert_allclose(tn.predict(Xv, raw_score=True),
                               jn.predict(Xv, raw_score=True),
                               rtol=0, atol=1e-5)
    assert np.abs(tn.predict(Xv, raw_score=True)
                  - tb.predict(Xv, raw_score=True)).max() > 1e-2
    with pytest.raises(ValueError, match="labels"):
        tb.refit(Xv, None)


def test_device_predict_after_refit_follows_new_leaves(monkeypatch):
    """The device predictor's stacks are keyed by tree counts, which a
    refit keeps: after an in-place refit the forced device walk answers
    with the new leaves (the host walk's), not the cached old ones."""
    X, y, Xv, yv, p = _probe()
    q = dict(p, **CPU)
    bst = lt.train(q, lt.Dataset(X, y, params=q), 5)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "1")
    before = bst.predict(Xv, raw_score=True)
    refit_gbdt(bst._gbdt, TD(Xv, (1 - yv).astype(np.float32), tcfg(q)),
               decay_rate=0.0, leaf_idx=bst._gbdt.predict_leaf_index(Xv))
    dev = bst.predict(Xv, raw_score=True)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "0")
    host = bst.predict(Xv, raw_score=True)
    assert np.abs(host - before).max() > 1e-2
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)


# -- traffic logs -------------------------------------------------------------


def _write_mixed_log(path, X, y):
    j_append(path, X[:40], y[:40], trace_ids="t-a")
    j_append(path, X[40:70], y[40:70], weight=np.full(30, 2.0),
             model_id="de", trace_ids=[f"r{i}" for i in range(30)])
    with open(path, "a") as f:
        f.write("garbage\n")
        f.write(json.dumps([1.0] + [float(v) for v in X[70]]) + "\n")
        f.write('{"features": [1.0, 2.0], "label": 1}\n')
    j_append(path, X[71:90], y[71:90], model_id="fr")
    with open(path, "a") as f:
        f.write('{"features": [1.0')          # a torn tail


def _drain(reader):
    out = []
    while True:
        got = reader.read_new()
        if got is None:
            break
        out.append((got, list(reader.last_trace_ids)))
    return out, reader.counters()


def _same(a, b):
    (ra, ca), (rb, cb) = a, b
    assert ca == cb and len(ra) == len(rb)
    for ((xa, ya, wa), ta), ((xb, yb, wb), tb) in zip(ra, rb):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        assert (wa is None) == (wb is None)
        if wa is not None:
            np.testing.assert_array_equal(wa, wb)
        assert ta == tb


@pytest.mark.parametrize("keying", [{}, {"model_filter": "de"},
                                    {"model_filter": "fr",
                                     "match_unkeyed": True}])
def test_traffic_log_rows_equal_jax(keying, tmp_path):
    X, y = _synth(100)
    path = str(tmp_path / "t.jsonl")
    _write_mixed_log(path, X, y)
    for cap in (64 << 20, 700):
        _same(_drain(TrafficLog(path, max_poll_bytes=cap, **keying)),
              _drain(JTrafficLog(path, max_poll_bytes=cap, **keying)))


def test_traffic_demux_views_equal_jax(tmp_path):
    X, y = _synth(100)
    path = str(tmp_path / "t.jsonl")
    _write_mixed_log(path, X, y)
    keys = [dict(model_filter="de"), dict(model_filter="default",
                                          match_unkeyed=True)]
    td, jd = TrafficDemux(path), JDemux(path)
    tv = [td.view(**k) for k in keys]
    jv = [jd.view(**k) for k in keys]
    for a, b in zip(tv, jv):
        _same(_drain(a), _drain(b))
    append_traffic(path, X[90:], y[90:], model_id="de")
    for a, b in zip(tv, jv):
        _same(_drain(a), _drain(b))


def test_append_traffic_writes_jax_records(tmp_path):
    X, y = _synth(20)
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    kw = dict(weight=np.arange(20.0), trace_ids=[None, "x"] * 10,
              model_id="de")
    assert append_traffic(a, X, y, **kw) == j_append(b, X, y, **kw) == 20
    assert open(a).read() == open(b).read()


# -- the daemon ---------------------------------------------------------------


def _daemon(tmp_path, mode="refit", trigger=256, extra=None, jax_too=False):
    """A port OnlineTrainer on the CPU over a model trained by the JAX
    package (and the JAX daemon on the same model when asked)."""
    X, y = _synth(1600, seed=21)
    p = {"objective": "binary", "verbose": -1, "num_leaves": 15,
         "min_data_in_leaf": 5, "online_mode": mode,
         "online_trigger_rows": trigger, "refit_decay_rate": 0.0,
         "refit_min_rows": 1, **(extra or {})}
    jb = lj.train(dict(p, tree_growth="exact"), lj.Dataset(X[:1000],
                                                           y[:1000]), 5)
    init = str(tmp_path / "init.txt")
    jb.save_model(init)
    traffic = str(tmp_path / "traffic.jsonl")
    pub = str(tmp_path / "pub.txt")
    cfg = tcfg(dict(p, **CPU))
    tr = OnlineTrainer(lt.Booster(params=dict(p, **CPU), model_file=init),
                       traffic, pub, config=cfg)
    jt = None
    if jax_too:
        jt = JTrainer(lj.Booster(params=p, model_file=init), traffic,
                      str(tmp_path / "jpub.txt"), config=jcfg(p))
    return tr, jt, X, y, traffic, pub, init, cfg


def _restart(traffic, pub, init, cfg):
    """A cold restart: a fresh booster from the initial model file."""
    return OnlineTrainer(lt.Booster(params=dict(CPU), model_file=init),
                         traffic, pub, config=cfg)


def test_online_trainer_refit_cycle_matches_jax(tmp_path):
    """One refit cycle on flipped labels, fed in two polls: the port and
    JAX daemons freeze the same mappers, publish the same generation,
    leaf values within the stated tolerance, and meta sidecars with the
    same keys."""
    tr, jt, X, y, traffic, pub, _, _ = _daemon(tmp_path, jax_too=True)
    flipped = 1.0 - y
    append_traffic(traffic, X[1000:1100], flipped[1000:1100],
                   trace_ids="t-1")
    assert tr.poll_once() is False and jt.poll_once() is False
    assert tr.pending_rows() == jt.pending_rows() == 100
    append_traffic(traffic, X[1100:1400], flipped[1100:1400])
    assert tr.poll_once() is True and jt.poll_once() is True
    meta = json.load(open(pub + ".meta.json"))
    jmeta = json.load(open(str(tmp_path / "jpub.txt.meta.json")))
    assert set(meta) == set(jmeta)
    for k in ("generation", "mode", "rows", "trigger_rows", "traffic",
              "origin_trace_ids", "capacity", "trees", "trees_refit"):
        assert meta[k] == jmeta[k], k
    assert meta["refbin_sha1"] == file_sha1(pub + ".refbin")
    ref = TD.from_binary(pub + ".refbin", tr.cfg)
    jref = JD.from_binary(str(tmp_path / "jpub.txt.refbin"), jt.cfg)
    assert ([m.feature_info() for m in ref.mappers]
            == [m.feature_info() for m in jref.mappers])
    _assert_leaves_close(
        lt.Booster(params=CPU, model_file=pub)._gbdt.models,
        lj.Booster(params={"verbose": -1},
                   model_file=str(tmp_path / "jpub.txt"))._gbdt.models)
    state = json.load(open(pub + ".state.json"))
    jstate = json.load(open(str(tmp_path / "jpub.txt.state.json")))
    assert set(state) == set(jstate)
    assert tr.pending_rows() == 0
    append_traffic(traffic, X[1400:], flipped[1400:])
    assert tr.poll_once() is False
    assert tr.refresh() is True and tr.generation == 2
    nb = lt.Booster(params=CPU, model_file=pub)
    pr = nb.predict(X[:1000])
    assert pr[flipped[:1000] > 0.5].mean() > pr[flipped[:1000] < 0.5].mean()


def test_online_trainer_continue_mode_appends_trees(tmp_path):
    tr, _, X, y, traffic, pub, _, _ = _daemon(
        tmp_path, mode="continue", extra={"num_iterations": 2})
    n0 = tr.booster.num_trees()
    append_traffic(traffic, X[1000:1400], y[1000:1400])
    assert tr.poll_once() is True
    meta = json.load(open(pub + ".meta.json"))
    assert meta["mode"] == "continue" and meta["trees_before"] == n0
    assert meta["trees_after"] == n0 + 2
    assert lt.Booster(params=CPU, model_file=pub).num_trees() == n0 + 2


def test_online_trainer_survives_bad_traffic(tmp_path):
    tr, _, X, y, traffic, pub, _, _ = _daemon(tmp_path)
    with open(traffic, "w") as f:
        f.write("garbage line\n")
        f.write('{"features": "nope", "label": 1}\n')
    assert tr.poll_once() is False
    assert tr.traffic.bad_lines == 2
    append_traffic(traffic, X[1000:1300], y[1000:1300])
    assert tr.poll_once() is True


def test_cpu_server_hot_swaps_published_generation(tmp_path):
    """A CPU PredictionServer on the daemon's publish path: the refit
    generation is adopted with cache_misses unchanged across the swap,
    its answers are the published model's, and /stats shows the online
    block with generation 1 and the refbin fingerprint."""
    tr, _, X, y, traffic, pub, init, _ = _daemon(tmp_path)
    os.replace(init, pub)
    tr.booster = lt.Booster(params=dict(CPU), model_file=pub)
    reg = ModelRegistry(pub, params=CPU, replicas=1,
                        warmup_buckets=(64, 128))
    with PredictionServer(reg, model_poll_seconds=0) as srv:
        before = srv.stats()
        assert before["online"] is None
        p_old = reg.current().predict(X[:64])
        append_traffic(traffic, X[:1200], 1.0 - y[:1200])
        assert tr.poll_once() is True
        misses = srv.stats()["cache_misses"]
        assert srv.catalog.poll_once() == 1
        st = srv.stats()
        assert st["cache_misses"] == misses
        assert st["online"]["generation"] == 1
        assert st["online"]["refbin_sha1"] == file_sha1(pub + ".refbin")
        got = reg.current().predict(X[:64])
        assert srv.stats()["cache_misses"] == misses
        want = lt.Booster(params=CPU, model_file=pub).predict(X[:64])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert np.abs(got - p_old).max() > 1e-2


# -- crash safety: the fault seams of tests/test_faults.py --------------------


def test_daemon_restart_resumes_exact_offset(tmp_path):
    tr, _, X, y, traffic, pub, init, cfg = _daemon(tmp_path)
    append_traffic(traffic, X[1000:1300], y[1000:1300])
    assert tr.poll_once() is True
    offset1 = tr.traffic.offset
    append_traffic(traffic, X[1300:1400], y[1300:1400])
    assert tr.poll_once() is False
    del tr
    tr2 = _restart(traffic, pub, init, cfg)
    assert tr2.generation == 1 and tr2.traffic.offset == offset1
    assert tr2.pending_rows() == 0
    append_traffic(traffic, X[1400:1556], y[1400:1556])
    assert tr2.poll_once() is True
    meta = json.load(open(pub + ".meta.json"))
    assert meta["generation"] == 2 and meta["rows"] == 256
    assert tr2.rows_seen == 556


def test_daemon_restart_restores_frozen_mappers_bitwise(tmp_path):
    tr, _, X, y, traffic, pub, init, cfg = _daemon(tmp_path)
    append_traffic(traffic, X[1000:1300], y[1000:1300])
    assert tr.poll_once() is True
    tr._window.append_rows(X[1300:1400], y[1300:1400])
    orig = tr._window.bins[:, :100].copy()
    del tr
    tr2 = _restart(traffic, pub, init, cfg)
    assert tr2._window is not None and tr2._mapper_fp is not None
    tr2._window.append_rows(X[1300:1400], y[1300:1400])
    np.testing.assert_array_equal(tr2._window.bins[:, :100], orig)


@pytest.mark.parametrize("seam,generation,offset_kept,meta_rows", [
    ("online.before_publish", 0, False, 300),
    ("online.after_publish", 1, True, 256),
    ("online.between_renames", 1, True, 256),
    ("online.state_write", 0, False, 300),
    ("online.publish_model", 0, False, 300),
])
def test_online_fault_seam_restart_outcome(seam, generation, offset_kept,
                                           meta_rows, tmp_path):
    """Each online.* seam kills the first publish; a cold restart then
    lands where tests/test_faults.py's daemon lands: a publish that never
    landed (or a torn sidecar) redoes its window from offset 0, one that
    landed (wholly, or with only the model renamed: the intent completes
    the meta) is adopted and its rows are not read again."""
    tr, _, X, y, traffic, pub, init, cfg = _daemon(tmp_path)
    append_traffic(traffic, X[1000:1300], y[1000:1300])
    faults.arm(f"{seam}:1")
    with pytest.raises(faults.InjectedFault):
        tr.poll_once()
    faults.reset()
    offset = tr.traffic.offset
    if seam == "online.state_write":
        with pytest.raises(ValueError):
            json.load(open(pub + ".state.json"))
    if seam == "online.between_renames":
        assert os.path.exists(pub)
        assert not os.path.exists(pub + ".meta.json")
    del tr
    tr2 = _restart(traffic, pub, init, cfg)
    assert tr2.generation == generation
    assert tr2.traffic.offset == (offset if offset_kept else 0)
    if seam == "online.between_renames":
        meta = json.load(open(pub + ".meta.json"))
        assert meta["generation"] == 1 and meta["rows"] == 300
    if offset_kept:
        append_traffic(traffic, X[1300:1556], y[1300:1556])
    assert tr2.poll_once() is True
    meta = json.load(open(pub + ".meta.json"))
    assert meta["generation"] == generation + 1
    assert meta["rows"] == meta_rows


def test_torn_traffic_append_absorbed_by_reader(tmp_path):
    tr, _, X, y, traffic, pub, _, _ = _daemon(tmp_path)
    append_traffic(traffic, X[1000:1100], y[1000:1100])
    faults.arm("traffic.append:1")
    with pytest.raises(faults.InjectedFault):
        append_traffic(traffic, X[1100:1101], y[1100:1101])
    faults.reset()
    with open(traffic, "a") as f:
        f.write("\n")                   # the next writer ends the torn line
    append_traffic(traffic, X[1101:1300], y[1101:1300])
    assert tr.poll_once() is True
    assert tr.traffic.bad_lines == 1
    assert json.load(open(pub + ".meta.json"))["rows"] == 299


def test_online_fleet_publishes_per_tenant(tmp_path):
    """OnlineFleet.from_config: one daemon a catalog tenant, every view
    over ONE shared TrafficDemux; keyed rows refresh only their tenant,
    whose sidecar names it."""
    from lightgbm_tpu_torch.online.stream import TrafficDemuxView
    from lightgbm_tpu_torch.online.trainer import OnlineFleet
    X, y = _synth(900, f=6)
    q = dict(objective="binary", num_leaves=7, min_data_in_leaf=5, **CPU)
    bst = lt.train(q, lt.Dataset(X[:600], y[:600], params=q), 3)
    paths = {}
    for mid in ("de", "fr"):
        paths[mid] = str(tmp_path / f"{mid}.txt")
        bst.save_model(paths[mid])
    traffic = str(tmp_path / "t.jsonl")
    open(traffic, "w").close()
    fleet = OnlineFleet.from_config(tcfg(dict(
        q, task="online", data=traffic, online_trigger_rows=200,
        refit_decay_rate=0.0,
        serve_models=[f"{m}={p}" for m, p in paths.items()])))
    views = [t.traffic for t in fleet.trainers]
    assert all(isinstance(v, TrafficDemuxView) for v in views)
    assert len({id(v._demux) for v in views}) == 1
    append_traffic(traffic, X[600:900], 1 - y[600:900], model_id="de")
    assert fleet.poll_once() == 1
    meta = json.load(open(paths["de"] + ".meta.json"))
    assert meta["model_id"] == "de" and meta["rows"] == 300
    assert not os.path.exists(paths["fr"] + ".meta.json")
    assert fleet.pending_rows() == 0
