"""The port's serving plane on the CPU: runtime, micro-batcher, registry
and HTTP server (lightgbm_tpu_torch/serving/), mirroring
tests/test_serving.py, tests/test_serve_binned.py, tests/test_faults.py's
fleet cases and the serving cases of tests/test_predict_kernel.py.

- bucket padding never leaks; warm cache: `cache_misses` unchanged after
  warmup;
- a multi-replica CPU fleet with a fault armed through
  `diagnostics.faults` (``serve.dispatch.r0``): breaker open, exact
  retry, half-open readmission, 503 with no healthy replica;
- admission control (`ServerOverloadedError`, 503);
- hot swap under load, rollback on a bad model file;
- binned serving from a ``.refbin``: bitwise equal to raw, a refbin
  written by the JAX package read by the port and one written by the
  port read by JAX, a sha1 mismatch refused;
- one parity case sends the same requests (a malformed body and an
  unknown ``?model=`` among them) to a JAX `PredictionServer` and a port
  `PredictionServer` on one model string: status codes, answers within
  T * 2^-23 * sum|leaf| (ops/predict.py), and the key sets of /stats and
  /healthz.

Every server binds 127.0.0.1:0 inside a `with` block and every wait has
its own timeout.
"""
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as lj
from lightgbm_tpu.serving import (ModelRegistry as JRegistry,
                                  PredictionServer as JServer)

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import profiling
from lightgbm_tpu_torch.diagnostics import faults
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops import predict as TP
from lightgbm_tpu_torch.quantize import file_sha1, load_refbin
from lightgbm_tpu_torch.serving import (MicroBatcher, ModelRegistry,
                                        PredictionServer, PredictorRuntime,
                                        ServerOverloadedError,
                                        resolve_serve_replicas, row_bucket,
                                        server_from_config)
from lightgbm_tpu_torch.serving.runtime import NoHealthyReplicaError

CPU = {"device_type": "cpu", "verbose": -1}
WAIT = 60


def _data(seed=7, n=400, f=10):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    z = X @ rng.randn(f)
    return X, (z > np.median(z)).astype(float)


def _train(params=None, rounds=5, seed=7, n=400):
    X, y = _data(seed, n)
    p = dict(dict(CPU, objective="binary", num_leaves=15,
                  min_data_in_leaf=5), **(params or {}))
    ds = lt.Dataset(X, y, params=p)
    bst = lt.train(p, ds, rounds)
    return bst, X, ds


@pytest.fixture(scope="module")
def binary_model():
    bst, X, _ = _train()
    return bst, X


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    yield
    faults.reset()


def _save(bst, path):
    tmp = path + ".tmp"
    bst.save_model(tmp)
    os.replace(tmp, path)            # atomic publish


def _request(host, port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(host, port, timeout=WAIT)
    try:
        conn.request(method, path, body, headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read().decode()
    finally:
        conn.close()


def _post_rows(host, port, X, path="/predict"):
    body = "\n".join(json.dumps([float(v) for v in row]) for row in X)
    status, headers, text = _request(host, port, "POST", path, body)
    assert status == 200, text
    preds = np.array([json.loads(l) for l in text.strip().splitlines()])
    return preds, int(headers["X-Model-Generation"])


def _get_json(host, port, path):
    status, _, text = _request(host, port, "GET", path)
    assert status == 200, text
    return json.loads(text)


# -- runtime ----------------------------------------------------------------

def test_row_bucket():
    assert row_bucket(1, 16, 4096) == 16
    assert row_bucket(17, 16, 4096) == 32
    assert row_bucket(5000, 16, 4096) == 4096


def test_resolve_serve_replicas_cpu_and_cuda():
    assert len(resolve_serve_replicas(0, "cpu")) == 1
    assert len(resolve_serve_replicas(3, "cpu")) == 3
    assert len(resolve_serve_replicas(64, "cpu")) == 8
    assert all(d.type == "cpu" for d in resolve_serve_replicas(2, "cpu"))
    import torch
    if not torch.cuda.is_available():
        # no GPU visible: a cuda fleet raises, never serves on the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_serve_replicas(1, "cuda")


def test_runtime_parity_and_warm_cache(binary_model):
    bst, X = binary_model
    rt = PredictorRuntime(bst, max_batch_rows=256, min_bucket_rows=16)
    stack, meta = TP.build_ensemble(rt._trees_by_class)
    dev = TP.to_device(stack, "cpu")
    for n in (1, 3, 16, 37, 300):
        got = rt.predict(X[:n], kind="raw")
        ref = TP.predict_ensemble_any(dev, __import__("torch").as_tensor(
            X[:n], dtype=__import__("torch").float32), meta=meta)[0]
        # the server's raw answers are the predictor's, bitwise
        assert np.array_equal(got, ref.numpy().astype(np.float64))
        np.testing.assert_allclose(rt.predict(X[:n]), bst.predict(X[:n]),
                                   rtol=0, atol=1e-6)
    assert rt.buckets_compiled() == [(16, "raw"), (16, "value"),
                                     (64, "raw"), (64, "value"),
                                     (256, "raw"), (256, "value")]
    misses = rt.cache_misses
    for n in (1, 3, 16, 37, 300):
        rt.predict(X[:n])
        rt.predict(X[:n], kind="raw")
    assert rt.cache_misses == misses
    assert rt.cache_bytes() > 0


def test_runtime_padding_never_leaks(binary_model):
    bst, X = binary_model
    rt = PredictorRuntime(bst, max_batch_rows=256, min_bucket_rows=16)
    got = rt.predict(X[:37], kind="raw")
    assert got.shape == (37,)
    for i in (0, 17, 36):
        assert rt.predict(X[i:i + 1], kind="raw")[0] == got[i]
    Xg = np.vstack([X[:37], np.full((5, X.shape[1]), 1e30)])
    assert np.array_equal(rt.predict(Xg, kind="raw")[:37], got)


@pytest.mark.parametrize("kernel", ["tensorized", "walk"])
def test_runtime_multiclass_and_kernels(kernel):
    rng = np.random.RandomState(11)
    X = rng.rand(300, 6)
    y = (X[:, 0] * 3 + X[:, 1]).astype(int) % 3
    p = dict(CPU, objective="multiclass", num_class=3, num_leaves=7,
             min_data_in_leaf=5)
    bst = lt.train(p, lt.Dataset(X, y, params=p), 3)
    rt = PredictorRuntime(bst, max_batch_rows=512, predict_kernel=kernel)
    assert rt.predict_kernel == kernel
    for n in (1, 33, 300):
        got = rt.predict(X[:n])
        assert got.shape == (n, 3)
        np.testing.assert_allclose(got, bst.predict(X[:n]), rtol=0,
                                   atol=1e-6)
    other = PredictorRuntime(bst, predict_kernel="walk" if kernel ==
                             "tensorized" else "tensorized")
    assert np.array_equal(other.predict(X, kind="raw"),
                          rt.predict(X, kind="raw"))


def test_runtime_identity_objective_shares_raw_program():
    rng = np.random.RandomState(3)
    X = rng.rand(200, 5)
    p = dict(CPU, objective="regression", num_leaves=7, min_data_in_leaf=5)
    bst = lt.train(p, lt.Dataset(X, X @ rng.randn(5), params=p), 3)
    rt = PredictorRuntime(bst, max_batch_rows=64)
    rt.warmup([10])
    np.testing.assert_allclose(rt.predict(X[:10]), bst.predict(X[:10]),
                               rtol=0, atol=1e-6)
    assert rt.buckets_compiled() == [(16, "raw")]
    assert rt.cache_misses == 1


def test_runtime_rejects_bad_input(binary_model):
    bst, X = binary_model
    rt = PredictorRuntime(bst, max_batch_rows=64)
    with pytest.raises(LightGBMError):
        rt.predict(np.zeros((3, 2)))
    with pytest.raises(ValueError):
        rt.predict(X[:2], kind="leaf")
    assert rt.predict(np.zeros((0, X.shape[1]))).shape == (0,)
    Xw = np.hstack([X[:4], np.full((4, 3), 1e30)])
    assert np.array_equal(rt.predict(Xw), rt.predict(X[:4]))
    with pytest.raises(LightGBMError, match="no trees"):
        PredictorRuntime(lt.Booster(params=CPU, model_str=(
            "tree\nnum_class=1\nmax_feature_idx=1\n\n")))


# -- fleet: breaker, retry, probe -------------------------------------------

def _fleet(replicas, threshold=3, probe_after=None):
    bst, X, _ = _train(seed=41, rounds=3)
    rt = PredictorRuntime(bst, max_batch_rows=64, replicas=replicas,
                          failure_threshold=threshold,
                          probe_after=probe_after)
    rt.warmup([64])
    return rt, X


def test_multi_replica_dispatch_and_exact_retry():
    rt, X = _fleet(replicas=2)
    assert rt.replica_count == 2
    expected = rt.predict(X[:64])
    for _ in range(4):
        assert np.array_equal(rt.predict(X[:64]), expected)
    assert all(d > 0 for d in rt.replica_dispatches())
    faults.arm("serve.dispatch.r0")            # replica 0 always throws
    for _ in range(6):
        assert np.array_equal(rt.predict(X[:64]), expected)
    assert rt.chunk_retries >= 1
    assert faults.fired("serve.dispatch.r0") == rt.chunk_retries
    misses = rt.cache_misses
    rt.predict(X[:64])
    assert rt.cache_misses == misses            # retries never build


def test_breaker_opens_then_half_open_probe_readmits():
    rt, X = _fleet(replicas=2, threshold=2, probe_after=3)
    expected = rt.predict(X[:64])
    faults.arm("serve.dispatch.r0")
    for _ in range(6):
        assert np.array_equal(rt.predict(X[:64]), expected)
    health = {h["index"]: h for h in rt.replica_health()}
    assert health[0]["state"] == "broken"
    assert rt.healthy_count() == 1
    faults.disarm()                             # the replica recovered
    for _ in range(8):
        assert np.array_equal(rt.predict(X[:64]), expected)
    health = {h["index"]: h for h in rt.replica_health()}
    assert health[0]["state"] == "healthy"
    assert health[0]["probes"] >= 1
    assert rt.healthy_count() == 2


def test_no_healthy_replica_and_single_replica_error():
    rt, X = _fleet(replicas=2, threshold=1)
    faults.arm("serve.dispatch")                # every replica throws
    with pytest.raises(faults.InjectedFault):
        rt.predict(X[:64])
    assert rt.healthy_count() == 0
    with pytest.raises(NoHealthyReplicaError):
        rt.predict(X[:64])
    faults.reset()
    rt1, X = _fleet(replicas=1, threshold=5)
    faults.arm("serve.dispatch:1")
    with pytest.raises(faults.InjectedFault):
        rt1.predict(X[:64])
    assert rt1.predict(X[:64]).shape == (64,)


def test_server_503_when_no_replica_is_healthy(tmp_path):
    bst, X = _train(seed=3, rounds=2)[:2]
    path = str(tmp_path / "m.txt")
    _save(bst, path)
    reg = ModelRegistry(path, params=CPU, max_batch_rows=64, replicas=2,
                        failure_threshold=1)
    faults.arm("serve.dispatch")
    with PredictionServer(reg, flush_deadline_ms=1,
                          model_poll_seconds=0) as srv:
        body = json.dumps([float(v) for v in X[0]])
        codes = [_request(srv.host, srv.port, "POST", "/predict",
                          body)[0] for _ in range(3)]
        assert codes[0] == 500 and codes[-1] == 503
        status, headers, _ = _request(srv.host, srv.port, "POST",
                                      "/predict", body)
        assert status == 503 and headers.get("Retry-After") == "1"


# -- micro-batcher -----------------------------------------------------------

def test_batcher_coalesces_and_isolates_malformed(binary_model):
    bst, X = binary_model
    rt = PredictorRuntime(bst, max_batch_rows=256)
    mb = MicroBatcher(rt, max_batch_rows=256, flush_deadline_ms=50)
    try:
        futs = [mb.submit(X[i:i + 3]) for i in range(0, 30, 3)]
        bad = mb.submit(np.zeros((2, 3)))     # too few features
        for i, f in zip(range(0, 30, 3), futs):
            np.testing.assert_allclose(f.result(timeout=WAIT),
                                       bst.predict(X[i:i + 3]), rtol=0,
                                       atol=1e-6)
        with pytest.raises(LightGBMError):
            bad.result(timeout=WAIT)
        assert mb.batches_flushed <= 3
    finally:
        mb.close()


def test_batcher_admission_control(binary_model):
    _, X = binary_model
    release, entered = threading.Event(), threading.Event()

    class SlowRuntime:
        generation = 1

        def predict(self, Xq, kind="value"):
            entered.set()
            release.wait(timeout=WAIT)
            return np.zeros(Xq.shape[0])

    mb = MicroBatcher(SlowRuntime(), max_batch_rows=8, flush_deadline_ms=0,
                      max_pending_rows=16, workers=1)
    try:
        first = mb.submit(X[:8])
        assert entered.wait(timeout=WAIT)      # the worker holds it
        futs = [mb.submit(X[:8]), mb.submit(X[:8])]
        with pytest.raises(ServerOverloadedError):
            mb.submit(X[:8])
        assert mb.rejected == 1
        release.set()
        for f in [first] + futs:
            f.result(timeout=WAIT)
        assert mb.submit(X[:32]).result(timeout=WAIT).shape == (32,)
    finally:
        release.set()
        mb.close()


# -- registry / hot swap ----------------------------------------------------

def test_hot_swap_under_load_and_rollback(tmp_path, binary_model):
    bst_a, X = binary_model
    bst_b = _train({"num_leaves": 31}, rounds=10, seed=13)[0]
    preds_a, preds_b = bst_a.predict(X[:32]), bst_b.predict(X[:32])
    assert np.abs(preds_a - preds_b).max() > 1e-4
    path = str(tmp_path / "model.txt")
    _save(bst_a, path)
    reg = ModelRegistry(path, params=CPU, max_batch_rows=256)
    assert reg.generation == 1
    mb = MicroBatcher(reg, max_batch_rows=256, flush_deadline_ms=1)
    stop = threading.Event()
    violations = []

    def hammer():
        while not stop.is_set():
            got = mb.submit(X[:32]).result(timeout=WAIT)
            if not (np.allclose(got, preds_a, atol=1e-6)
                    or np.allclose(got, preds_b, atol=1e-6)):
                violations.append(got)

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)
        _save(bst_b, path)
        assert reg.maybe_reload() is True
        assert reg.generation == 2
        time.sleep(0.05)
        with open(path, "w") as f:
            f.write("this is not a model\n")
        assert reg.maybe_reload() is False
        assert reg.generation == 2
        assert reg.swap_failures == 1
        assert reg.last_swap_error
        assert reg.maybe_reload() is False     # the bad signature is kept
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
        mb.close()
    assert not any(t.is_alive() for t in threads)
    assert not violations
    np.testing.assert_allclose(reg.current().predict(X[:32]), preds_b,
                               rtol=0, atol=1e-6)


def test_swap_warms_previous_buckets(tmp_path, binary_model):
    bst, X = binary_model
    path = str(tmp_path / "model.txt")
    _save(bst, path)
    reg = ModelRegistry(path, params=CPU, max_batch_rows=256)
    reg.current().predict(X[:37])
    old = reg.current().buckets_compiled()
    _save(bst, path)
    assert reg.maybe_reload() is True
    new_rt = reg.current()
    new = set(new_rt.buckets_compiled())
    assert new >= set(old)
    misses = new_rt.cache_misses
    new_rt.predict(X[:37])
    new_rt.predict(X[:37], kind="raw")
    assert new_rt.cache_misses == misses


# -- the HTTP server ---------------------------------------------------------

def test_server_end_to_end_and_warm_stats(tmp_path, binary_model):
    bst, X = binary_model
    path = str(tmp_path / "model.txt")
    _save(bst, path)
    reg = ModelRegistry(path, params=CPU, max_batch_rows=256)
    with PredictionServer(reg, flush_deadline_ms=2,
                          model_poll_seconds=0) as srv:
        health = _get_json(srv.host, srv.port, "/healthz")
        assert health["status"] == "ok" and health["generation"] == 1
        preds, gen = _post_rows(srv.host, srv.port, X[:20])
        assert gen == 1
        np.testing.assert_allclose(preds, bst.predict(X[:20]), rtol=0,
                                   atol=1e-6)
        raw, _ = _post_rows(srv.host, srv.port, X[:20],
                            "/predict?raw_score=1")
        assert np.array_equal(raw, reg.current().predict(X[:20], "raw"))
        before = _get_json(srv.host, srv.port, "/stats")
        for _ in range(10):
            _post_rows(srv.host, srv.port, X[:20])
        after = _get_json(srv.host, srv.port, "/stats")
        assert after["cache_misses"] == before["cache_misses"]
        assert after["cache_hits"] >= before["cache_hits"] + 10
        assert after["requests"] >= before["requests"] + 10
        assert after["latency_ms"]["count"] > 0
        assert after["process"]["backend"] in ("cpu", "cuda")
        status, _, _ = _request(srv.host, srv.port, "POST", "/predict",
                                "not json")
        assert status == 400
        metrics = _request(srv.host, srv.port, "GET", "/metrics")[2]
        assert "lgbt_serve_requests_total" in metrics
        assert 'lgbt_serve_requests_total{model="default"}' in metrics
        _post_rows(srv.host, srv.port, X[:5])
    with pytest.raises(OSError):
        _request(srv.host, srv.port, "GET", "/healthz")


def test_server_sheds_load_with_503(tmp_path, binary_model):
    bst, X = binary_model
    path = str(tmp_path / "model.txt")
    _save(bst, path)
    reg = ModelRegistry(path, params=CPU, max_batch_rows=256)
    with PredictionServer(reg, flush_deadline_ms=2, model_poll_seconds=0,
                          max_pending_rows=1) as srv:
        gate, entered = threading.Event(), threading.Event()
        real = reg.current().predict

        def slow(Xq, kind="value"):
            entered.set()
            gate.wait(timeout=WAIT)
            return real(Xq, kind)
        reg.current().predict = slow
        body = json.dumps([float(v) for v in X[0]])
        out = []
        t = threading.Thread(target=lambda: out.append(_request(
            srv.host, srv.port, "POST", "/predict", body)[0]))
        t.start()
        assert entered.wait(timeout=WAIT)    # the first is in flight
        t2 = threading.Thread(target=lambda: out.append(_request(
            srv.host, srv.port, "POST", "/predict", body)[0]))
        t2.start()
        deadline = time.monotonic() + WAIT   # the second queues: 1 row
        while srv.batcher.queue_depth < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.batcher.queue_depth == 1
        status = _request(srv.host, srv.port, "POST", "/predict", body)[0]
        gate.set()
        t.join(timeout=WAIT)
        t2.join(timeout=WAIT)
        assert status == 503
        assert sorted(out) == [200, 200]


def test_server_from_config(tmp_path, binary_model):
    from lightgbm_tpu_torch.config import config_from_params
    bst, X = binary_model
    path = str(tmp_path / "model.txt")
    _save(bst, path)
    cfg = config_from_params({"input_model": path, "device_type": "cpu",
                              "serve_port": 0, "max_pending_rows": 64,
                              "model_poll_seconds": 0, "verbose": -1})
    with server_from_config(cfg) as srv:
        assert srv.batcher.max_pending_rows == 64
        assert srv.registry.current().device_type == "cpu"
        preds, _ = _post_rows(srv.host, srv.port, X[:4])
        np.testing.assert_allclose(preds, bst.predict(X[:4]), rtol=0,
                                   atol=1e-6)


# -- binned serving ---------------------------------------------------------

def _binned_model(seed=9, categorical=False):
    rng = np.random.RandomState(seed)
    X = rng.rand(700, 6)
    if categorical:
        X[:, 2] = rng.randint(0, 5, 700)
    X[rng.rand(*X.shape) < 0.02] = np.nan
    z = np.nan_to_num(X) @ rng.randn(6)
    return X, (z > np.median(z)).astype(float)


@pytest.mark.parametrize("categorical", [False, True])
def test_binned_equals_raw_bitwise(categorical):
    X, y = _binned_model(categorical=categorical)
    p = dict(CPU, objective="binary", num_leaves=15, min_data_in_leaf=5)
    ds = lt.Dataset(X, y, params=p,
                    categorical_feature=[2] if categorical else "auto")
    bst = lt.train(p, ds, 6)
    Xq = X.copy()
    Xq[:5, 2] = 7.0                          # an unseen category / value
    Xq[5:9] = np.nan
    rt_raw = PredictorRuntime(bst)
    rt_bin = PredictorRuntime(bst, quantize="binned", refbin=ds._inner)
    assert rt_bin.variant == "binned"
    for kind in ("value", "raw"):
        assert np.array_equal(rt_raw.predict(Xq, kind=kind),
                              rt_bin.predict(Xq, kind=kind))
    assert rt_bin._buf_dtype == np.uint8
    before = profiling.counter_value(profiling.SERVE_QUANTIZE_BYTES_IN)
    rt_bin.predict(X[:40])
    assert profiling.counter_value(
        profiling.SERVE_QUANTIZE_BYTES_IN) - before == 40 * 6


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_refbin_read_across_packages(tmp_path, writer):
    X, y = _binned_model(seed=12)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbose": -1}
    mp = str(tmp_path / "model.txt")
    if writer == "jax":
        ds = lj.Dataset(X, y, params=p)
        bst = lj.train(p, ds, 5)
        bst.save_model(mp)
        ds.save_refbin(mp + ".refbin")
        # the port reads the JAX sidecar: mappers equal, bitwise serving
        rb = load_refbin(mp + ".refbin")
        ref = ds.construct()._inner
    else:
        ds = lt.Dataset(X, y, params=dict(p, device_type="cpu"))
        bst = lt.train(dict(p, device_type="cpu"), ds, 5)
        bst.save_model(mp)
        ds.save_refbin(mp + ".refbin")
        from lightgbm_tpu.quantize import load_refbin as j_load_refbin
        rb = j_load_refbin(mp + ".refbin")
        ref = ds._inner
    assert rb.num_data == 0
    assert list(rb.used_features) == list(ref.used_features)
    for a, b in zip(rb.mappers, ref.mappers):
        assert np.array_equal(np.asarray(a.bin_upper_bound),
                              np.asarray(b.bin_upper_bound))
        assert a.num_bin == b.num_bin and a.bin_type == b.bin_type
    reg = ModelRegistry(mp, params=CPU, serve_quantize="binned")
    raw = ModelRegistry(mp, params=CPU, serve_quantize="raw")
    assert reg.current().variant == "binned"
    assert np.array_equal(reg.current().predict(X[:50]),
                          raw.current().predict(X[:50]))
    # JAX serves the same sidecar binned
    jreg = JRegistry(mp, params={"verbose": -1}, replicas=1,
                     serve_quantize="binned")
    assert jreg.current().variant == "binned"
    np.testing.assert_allclose(jreg.current().predict(X[:50]),
                               reg.current().predict(X[:50]), rtol=0,
                               atol=1e-6)


def test_registry_refbin_missing_torn_and_sha1(tmp_path):
    X, y = _binned_model(seed=10)
    p = dict(CPU, objective="binary", num_leaves=15, min_data_in_leaf=5)
    ds = lt.Dataset(X, y, params=p)
    bst = lt.train(p, ds, 4)
    mp = str(tmp_path / "model.txt")
    bst.save_model(mp)
    with pytest.raises(FileNotFoundError, match="refbin"):
        ModelRegistry(mp, params=CPU, serve_quantize="binned")
    assert ModelRegistry(mp, params=CPU).current().variant == "raw"
    ds.save_refbin(mp + ".refbin")
    reg = ModelRegistry(mp, params=CPU, serve_quantize="binned")
    want = reg.current().predict(X[:30])
    # a torn sidecar refuses the swap; the old generation serves
    bst2 = lt.train(p, ds, 6)
    bst2.save_model(mp)
    blob = open(mp + ".refbin", "rb").read()
    with open(mp + ".refbin", "wb") as f:
        f.write(blob[: len(blob) // 2])
    assert reg.poll_once() is False
    assert reg.current().generation == 1 and reg.swap_failures == 1
    assert np.array_equal(reg.current().predict(X[:30]), want)
    ds.save_refbin(mp + ".refbin")
    assert reg.maybe_reload(force=True) is True
    assert reg.current().generation == 2
    # a sha1 mismatch against the publish meta is refused
    with open(mp + ".meta.json", "w") as f:
        json.dump({"generation": 1, "refbin_sha1": "0" * 40}, f)
    with pytest.raises(LightGBMError, match="sha1"):
        ModelRegistry(mp, params=CPU, serve_quantize="binned")
    with open(mp + ".meta.json", "w") as f:
        json.dump({"generation": 1,
                   "refbin_sha1": file_sha1(mp + ".refbin")}, f)
    assert ModelRegistry(mp, params=CPU, serve_quantize="binned"
                         ).current().variant == "binned"


def test_binary_dataset_round_trip(tmp_path):
    X, y = _binned_model(seed=14)
    p = dict(CPU, objective="binary")
    ds = lt.Dataset(X, y, params=p).construct()
    path = str(tmp_path / "d.bin")
    ds._inner.save_binary(path)
    from lightgbm_tpu_torch.config import config_from_params
    back = lt.dataset.Dataset.from_binary(path, config_from_params(p))
    assert np.array_equal(back.bins, ds._inner.bins)
    assert np.array_equal(back.metadata.label, ds._inner.metadata.label)
    # the JAX package reads the port's cache
    jd = lj.dataset.Dataset.from_binary(path)
    assert np.array_equal(jd.bins, ds._inner.bins)


# -- the port's server against the JAX package's ----------------------------

def _stats_keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("models", "groups",
                                               "phase_totals_s"):
            out |= _stats_keys(v, prefix + k + ".")
    return out


def test_server_parity_with_jax(tmp_path):
    rng = np.random.RandomState(21)
    X = rng.rand(600, 8)
    y = (X @ rng.randn(8) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbose": -1}
    bj = lj.train(p, lj.Dataset(X, y, params=p), 8)
    mp = str(tmp_path / "model.txt")
    bj.save_model(mp)
    trees = lt.Booster(params=CPU, model_file=mp)._gbdt.models
    bound = len(trees) * 2.0 ** -23 * sum(
        float(np.abs(t.leaf_value[:t.num_leaves]).max()) for t in trees)
    rows = "\n".join(json.dumps([float(v) for v in r]) for r in X[:25])
    cases = [("POST", "/predict", rows), ("POST", "/predict?raw_score=1",
                                          rows),
             ("POST", "/predict", json.dumps({"rows": X[:3].tolist()})),
             ("POST", "/predict", "not json"),
             ("POST", "/predict?model=nope", rows),
             ("POST", "/predict?model=bad%20id", rows),
             ("POST", "/elsewhere", rows), ("GET", "/nowhere", None)]
    results = []
    jreg = JRegistry(mp, params={"verbose": -1}, replicas=1)
    treg = ModelRegistry(mp, params=CPU, replicas=1)
    with JServer(jreg, model_poll_seconds=0, flush_deadline_ms=1) as js, \
            PredictionServer(treg, model_poll_seconds=0,
                             flush_deadline_ms=1) as ts:
        for srv in (js, ts):
            out = [_request(srv.host, srv.port, m, path, body)
                   for m, path, body in cases]
            stats = _get_json(srv.host, srv.port, "/stats")
            health = _get_json(srv.host, srv.port, "/healthz")
            results.append((out, stats, health))
    (jout, jstats, jhealth), (tout, tstats, thealth) = results
    assert [r[0] for r in tout] == [r[0] for r in jout]
    assert [r[0] for r in tout][:3] == [200, 200, 200]
    for (_, _, jt), (_, _, tt) in zip(jout[:3], tout[:3]):
        a = np.array([json.loads(l) for l in jt.strip().splitlines()])
        b = np.array([json.loads(l) for l in tt.strip().splitlines()])
        assert np.all(np.abs(a - b) <= bound + 1e-7)
    assert _stats_keys(tstats) == _stats_keys(jstats)
    assert set(thealth) == set(jhealth)
    assert set(tstats["models"]["default"]) == set(
        jstats["models"]["default"])
