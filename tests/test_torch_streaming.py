"""The port's streaming Dataset path (lightgbm_tpu_torch/dataset.py) and
sharded/sketch.py + sharded/ingest.py against the JAX package, mirroring
the streaming cases of tests/test_online.py and tests/test_ingest.py.

Binning is integer-exact, so every comparison here is bitwise: the
capacity ladder, the appended store and labels (JAX's, and the batch
construction's with the same mappers), the validation errors, the
streamed and sketched mappers (the `.refbin`/`save_binary` files written
by both packages are byte-equal), and a compacted window's first tree.
"""
import time

import numpy as np
import pytest

from lightgbm_tpu.config import config_from_params as jcfg
from lightgbm_tpu.dataset import Dataset as JD, row_capacity_tier as j_tier

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import config_from_params as tcfg
from lightgbm_tpu_torch.dataset import Dataset as TD, row_capacity_tier


def _synth(n=1500, f=10, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    z = X @ rng.randn(f)
    return X, (z > np.median(z)).astype(np.float64)


def _pair(X, y, params=None):
    """(JAX, port) reference datasets on the same rows."""
    p = dict(params or {}, verbose=-1)
    return (JD(X, y.astype(np.float32), jcfg(p)),
            TD(X, y.astype(np.float32), tcfg(dict(p, device_type="cpu"))))


def _saved_bytes(ds, path, monkeypatch):
    """save_binary's bytes, with the zip members' timestamps pinned (the
    npz container stamps the wall clock into each member header)."""
    monkeypatch.setattr(time, "localtime", lambda *a: time.gmtime(0))
    ds.save_binary(path)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n,base", [(1, 1024), (1024, 1024), (1025, 1024),
                                    (5000, 1024), (3000, 2048),
                                    (70_000, 1024), (0, 7)])
def test_row_capacity_tier_ladder(n, base):
    assert row_capacity_tier(n, base) == j_tier(n, base)
    assert row_capacity_tier(1025) == 2048


def test_streaming_append_reset_compacted_bitwise():
    """Ragged appends that cross two tiers, then reset and refill: the
    store, capacity and labels are JAX's bitwise, and the rows equal the
    batch construction's over the same mappers."""
    X, y = _synth(3000)
    jb, tb = _pair(X[:500], y[:500])
    js, ts = JD.streaming_from(jb), TD.streaming_from(tb)
    assert ts.row_capacity == js.row_capacity == 1024
    w = np.linspace(0.5, 2.0, 2500)
    for lo in range(0, 2500, 371):
        hi = min(lo + 371, 2500)
        js.append_rows(X[lo:hi], y[lo:hi], w[lo:hi])
        ts.append_rows(X[lo:hi], y[lo:hi], w[lo:hi])
        assert ts.row_capacity == js.row_capacity
        np.testing.assert_array_equal(ts.bins, np.asarray(js.bins))
    assert ts.num_data == 2500 and ts.row_capacity == 4096
    assert not ts.bins[:, 2500:].any()
    np.testing.assert_array_equal(ts.metadata.label, js.metadata.label)
    np.testing.assert_array_equal(ts.metadata.weights, js.metadata.weights)
    batch = TD(X[:2500], y[:2500].astype(np.float32), tb.config,
               reference=tb)
    c = ts.compacted()
    assert c.num_data == 2500 and c.row_capacity == 2500
    np.testing.assert_array_equal(c.bins, batch.bins)
    np.testing.assert_array_equal(c.bins, np.asarray(js.compacted().bins))
    assert c.metadata is ts.metadata
    ts.reset_rows()
    js.reset_rows()
    assert ts.num_data == 0 and ts.row_capacity == 4096
    assert not ts.bins.any() and ts.metadata.label.size == 0
    # the compacted copy outlives the reset
    np.testing.assert_array_equal(c.bins, batch.bins)
    ts.append_rows(X[2500:], y[2500:])
    js.append_rows(X[2500:], y[2500:])
    np.testing.assert_array_equal(ts.bins, np.asarray(js.bins))


def test_compacted_at_capacity_is_a_copy():
    X, y = _synth(1024)
    _, tb = _pair(X, y)
    s = TD.streaming_from(tb)
    s.append_rows(X, y)
    assert s.num_data == s.row_capacity == 1024
    c = s.compacted()
    before = c.bins.copy()
    s.reset_rows()
    np.testing.assert_array_equal(c.bins, before)
    assert before.any()


def _append_cases(X, y):
    return [
        ("wrong width", lambda s: s.append_rows(X[:10, :5], y[:10])),
        ("label length", lambda s: s.append_rows(X[10:20], y[10:15])),
        ("unlabeled into labeled", lambda s: s.append_rows(X[10:20])),
        ("weight length", lambda s: s.append_rows(X[10:20], y[10:20],
                                                  np.ones(3))),
    ]


@pytest.mark.parametrize("case", range(4))
def test_streaming_append_validation_as_jax(case):
    X, y = _synth(600)
    jb, tb = _pair(X[:300], y[:300])
    errors = []
    for D, base in ((JD, jb), (TD, tb)):
        s = D.streaming_from(base)
        s.append_rows(X[:10], y[:10])
        name, fn = _append_cases(X, y)[case]
        with pytest.raises(ValueError) as e:
            fn(s)
        errors.append(str(e.value))
        assert s.num_data == 10, name
    assert errors[0] == errors[1]


def test_streaming_weights_backfill_and_labeled_into_unlabeled():
    X, y = _synth(600)
    jb, tb = _pair(X[:300], y[:300])
    for D, base in ((JD, jb), (TD, tb)):
        s = D.streaming_from(base)
        s.append_rows(X[:10], y[:10])
        s.append_rows(X[10:20], y[10:20], weight=np.full(10, 2.0))
        s.append_rows(X[20:25], y[20:25])
        np.testing.assert_array_equal(
            s.metadata.weights, [1.0] * 10 + [2.0] * 10 + [1.0] * 5)
        u = D.streaming_from(base)
        u.append_rows(X[:10])
        with pytest.raises(ValueError, match="unlabeled dataset"):
            u.append_rows(X[10:20], y[10:20])


@pytest.mark.parametrize("chunks", [None, 97, 400])
def test_from_stream_mappers_bitwise_jax(chunks, tmp_path, monkeypatch):
    """from_stream's sketch pass (exact while the rows fit the sample
    budget): the same mappers and store as JAX's streamed construction
    and the batch one, whatever the chunking; save_binary files are
    byte-equal."""
    X, y = _synth(1800, f=8, seed=11)
    X[::7, 2] = np.nan
    X[:, 5] = np.round(X[:, 5] * 4)
    p = {"verbose": -1, "max_bin": 63}
    src = (X, y) if chunks is None else [
        (X[a:a + chunks], y[a:a + chunks]) for a in range(0, 1800, chunks)]
    js = JD.from_stream(src, jcfg(p))
    ts = TD.from_stream(src, tcfg(dict(p, device_type="cpu")))
    assert ts.num_data == 1800 and ts.row_capacity == js.row_capacity
    tc, jc = ts.compacted(), js.compacted()
    jbytes = _saved_bytes(jc, str(tmp_path / "j.bin"), monkeypatch)
    tbytes = _saved_bytes(tc, str(tmp_path / "t.bin"), monkeypatch)
    assert tbytes == jbytes
    batch = TD(X, y.astype(np.float32), tcfg(dict(p, device_type="cpu")))
    np.testing.assert_array_equal(tc.bins, batch.bins)
    assert ([m.feature_info() for m in tc.mappers]
            == [m.feature_info() for m in batch.mappers])


def test_from_stream_with_reference_and_bad_sources():
    X, y = _synth(900)
    _, tb = _pair(X, y)
    s = TD.from_stream([(X[:400], y[:400]), (X[400:], y[400:])],
                       reference=tb)
    np.testing.assert_array_equal(s.compacted().bins, tb.bins)
    with pytest.raises(TypeError, match="re-iterable"):
        TD.from_stream(iter([(X, y)]), tcfg({"device_type": "cpu"}))
    with pytest.raises(ValueError, match="no rows"):
        TD.from_stream([], tcfg({"device_type": "cpu"}))


@pytest.mark.parametrize("eps", [0.001, 0.05])
def test_bin_find_sketch_mappers_equal_jax(eps, tmp_path, monkeypatch):
    """bin_find=sketch on the dense constructor: the mappers (and the
    refbin files) equal JAX's, exact summaries (eps=0.001 holds every
    distinct value here) and compacted ones alike."""
    X, y = _synth(3000, f=6, seed=2)
    p = {"bin_find": "sketch", "sketch_eps": eps, "max_bin": 31}
    jd, td = _pair(X, y, p)
    assert ([m.feature_info() for m in td.mappers]
            == [m.feature_info() for m in jd.mappers])
    jbytes = _saved_bytes(jd, str(tmp_path / "j.bin"), monkeypatch)
    tbytes = _saved_bytes(td, str(tmp_path / "t.bin"), monkeypatch)
    assert tbytes == jbytes
    bst = lt.train(dict(p, device_type="cpu", verbose=-1,
                        objective="binary", num_leaves=7),
                   lt.Dataset(X, y), 2)
    assert bst.num_trees() == 2


def test_compacted_window_trains_the_batch_first_tree():
    """A window filled chunk by chunk and compacted trains the same first
    tree as the batch dataset over the same rows and mappers."""
    X, y = _synth(1200, seed=9)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "device_type": "cpu", "verbose": -1}
    cfg = tcfg(p)
    batch = TD(X, y.astype(np.float32), cfg)
    s = TD.streaming_from(batch, cfg, capacity=100)
    for a in range(0, 1200, 250):
        s.append_rows(X[a:a + 250], y[a:a + 250])
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    models = []
    for ds in (batch, s.compacted()):
        g = GBDT(cfg, ds)
        g.train_one_iter()
        models.append(g.save_model_to_string())
    assert models[0] == models[1]
