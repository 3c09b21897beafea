"""The port's multi-tenant catalog and co-stacked serving on the CPU
(lightgbm_tpu_torch/serving/catalog.py, superstack.py), mirroring
tests/test_catalog.py and tests/test_costack.py.

- two and three tenants routed by ``?model=``, by the body field and by
  ``X-Model-Id``; an unknown id is 404, a malformed one 400;
- co-stacked answers bitwise equal to per-tenant (solo) dispatch, raw
  and binned, binary and multiclass, stacked and segment kernels;
- per-tenant /stats blocks and labeled /metrics series;
- LRU eviction under ``serve_cache_budget_mb``;
- a shadow canary adopted after ``serve_shadow_requests`` comparisons.

Raw scores compare bitwise.  Transformed values ("value") compare
bitwise where both sides ran the transform over the same row positions,
and within 1e-7 otherwise: on the CPU, torch's sigmoid takes a
vectorized exp for whole vectors and a scalar one for a tail, so the
same row can differ in its last bit between two batch sizes (the GPU's
elementwise kernels have no such tail; chip_smoke.py phase 15 holds
values bitwise there).
"""
import http.client
import json
import threading

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import profiling
from lightgbm_tpu_torch.serving import (MicroBatcher, ModelCatalog,
                                        ModelRegistry, PredictionServer)
from lightgbm_tpu_torch.serving.runtime import resolve_runtime

CPU = {"device_type": "cpu", "verbose": -1}
WAIT = 60


def _train(seed, features=10, rounds=4, leaves=15, num_class=None):
    rng = np.random.RandomState(seed)
    X = rng.rand(500, features)
    if num_class:
        y = np.argmax(X[:, :num_class] + 0.1 * rng.rand(500, num_class),
                      axis=1).astype(float)
        p = {"objective": "multiclass", "num_class": num_class}
    else:
        z = X @ rng.randn(features)
        y = (z > np.median(z)).astype(float)
        p = {"objective": "binary"}
    p.update(CPU, num_leaves=leaves, min_data_in_leaf=5)
    ds = lt.Dataset(X, y, params=p)
    bst = lt.train(p, ds, rounds)
    assert bst.num_trees() > 0
    return bst, ds, X


def _publish(root, mid, seed, refbin=False, **kw):
    bst, ds, X = _train(seed, **kw)
    path = str(root / f"{mid}.txt")
    bst.save_model(path)
    if refbin:
        ds.save_refbin(path + ".refbin")
    return path, bst, X


def _solo(bst, quantize="raw", refbin=None):
    kw = {"refbin": refbin} if refbin is not None else {}
    return resolve_runtime(bst, serve_quantize=quantize, **kw)


def _mixed_round(cat, jobs, kind="value"):
    futs = {mid: cat.submit(Xm, kind=kind, model_id=mid)[1]
            for mid, Xm in jobs.items()}
    return {mid: f.result(timeout=WAIT) for mid, f in futs.items()}


def _assert_solo(got, want, kind):
    if kind == "raw":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    root = tmp_path_factory.mktemp("three")
    return {mid: _publish(root, mid, seed)
            for mid, seed in (("alpha", 7), ("beta", 8), ("gamma", 9))}


def _catalog(pubs, **kw):
    kw.setdefault("serve_quantize", "raw")
    return ModelCatalog({mid: p for mid, (p, _b, _x) in pubs.items()},
                        params=CPU, **kw)


def _post(srv, body, path="/predict", headers=None):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=WAIT)
    try:
        conn.request("POST", path, body, headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read().decode()
    finally:
        conn.close()


def _get(srv, path):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=WAIT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def _predict_rows(srv, X, model=None, via="body"):
    rows = [[float(v) for v in r] for r in X]
    headers, path = {}, "/predict"
    if model is not None and via == "body":
        body = json.dumps({"rows": rows, "model": model})
    else:
        body = "\n".join(json.dumps(r) for r in rows)
        if via == "query" and model is not None:
            path += f"?model={model}"
        elif via == "header" and model is not None:
            headers["X-Model-Id"] = model
    status, hdrs, text = _post(srv, body, path, headers)
    assert status == 200, text
    return (np.array([json.loads(l) for l in text.strip().splitlines()]),
            hdrs)


# -- routing and accounting ---------------------------------------------------

def test_catalog_routing_and_per_model_accounting(three):
    cat = _catalog(three, costack=False)
    X = three["alpha"][2][:12]
    refs = {mid: b.predict(X) for mid, (_p, b, _x) in three.items()}
    with PredictionServer(catalog=cat, model_poll_seconds=0) as srv:
        got, hdrs = _predict_rows(srv, X)
        np.testing.assert_allclose(got, refs["alpha"], rtol=0, atol=1e-6)
        assert hdrs["X-Model-Id"] == "alpha"
        for via in ("body", "query", "header"):
            for mid in ("beta", "gamma"):
                got, hdrs = _predict_rows(srv, X, model=mid, via=via)
                np.testing.assert_allclose(got, refs[mid], rtol=0,
                                           atol=1e-6)
                assert hdrs["X-Model-Id"] == mid
        status, _h, text = _post(srv, json.dumps({"rows": [[0.0] * 10],
                                                  "model": "nope"}))
        assert status == 404 and "nope" in text
        status, _h, _t = _post(srv, json.dumps({"rows": [[0.0] * 10],
                                                "model": "bad id!"}))
        assert status == 400
        health = json.loads(_get(srv, "/healthz")[1])
        assert set(health["models"]) == {"alpha", "beta", "gamma"}
        stats = json.loads(_get(srv, "/stats")[1])
        assert stats["default_model"] == "alpha"
        models = stats["models"]
        assert models["beta"]["requests"] >= 3
        assert models["beta"]["rows"] >= 36
        assert models["beta"]["latency_ms"]["count"] >= 3
        assert models["alpha"]["default"] is True
        assert models["gamma"]["generation"] == 1
        text = _get(srv, "/metrics")[1]
        assert 'lgbt_serve_requests_total{model="beta"}' in text
        assert 'lgbt_serve_model_generation{model="gamma"} 1' in text
        assert 'lgbt_serve_latency_ms{model="beta",quantile="0.99"}' in text


def test_lru_eviction_honors_budget(three, monkeypatch):
    from lightgbm_tpu_torch.serving.runtime import PredictorRuntime
    # one MiB an entry, so a 2 MiB budget holds two single-bucket tenants
    monkeypatch.setattr(PredictorRuntime, "_exe_bytes",
                        lambda self, bucket: 1 << 20)
    cat = _catalog(three, cache_budget_mb=2, costack=False)
    try:
        X = three["alpha"][2][:8]
        evict0 = profiling.counter_value(profiling.SERVE_CACHE_EVICTIONS)
        for mid in ("alpha", "beta", "gamma"):
            cat.submit(X, model_id=mid)[1].result(timeout=WAIT)
        cat.enforce_budget()
        sizes = cat.cache_bytes()
        assert sizes["gamma"] > 0                  # MRU keeps its cache
        assert sum(sizes.values()) <= 2 << 20
        assert (profiling.counter_value(profiling.SERVE_CACHE_EVICTIONS)
                > evict0)
        evicted = [m for m in ("alpha", "beta") if sizes[m] == 0]
        assert evicted
        got = cat.submit(X, model_id=evicted[0])[1].result(timeout=WAIT)
        np.testing.assert_allclose(got, three[evicted[0]][1].predict(X),
                                   rtol=0, atol=1e-6)
    finally:
        cat.close()
    cat = _catalog(three, costack=False)           # no budget: no eviction
    try:
        assert cat.enforce_budget() == 0
    finally:
        cat.close()


def test_shadow_canary_adopts_after_quorum(tmp_path):
    bst_a, _, X = _train(7)
    bst_b, _, _ = _train(13, leaves=31, rounds=8)
    path = str(tmp_path / "m.txt")
    bst_a.save_model(path)
    reg = ModelRegistry(path, params=CPU, max_batch_rows=256,
                        model_id="shadowed", shadow_fraction=1.0,
                        shadow_requests=3)
    mb = MicroBatcher(reg, max_batch_rows=256, flush_deadline_ms=1,
                      model_id="shadowed")
    try:
        preds_a, preds_b = bst_a.predict(X[:16]), bst_b.predict(X[:16])
        bst_b.save_model(path)
        assert reg.poll_once() is False            # staged, not swapped
        assert reg.generation == 1
        state = reg.shadow_state()
        assert state["generation"] == 2 and state["required"] == 3
        for _ in range(20):
            got = mb.submit(X[:16]).result(timeout=WAIT)
            if reg.generation == 2:
                break
            np.testing.assert_allclose(got, preds_a, rtol=0, atol=1e-6)
        assert reg.generation == 2
        assert reg.shadow_state() is None
        got = mb.submit(X[:16]).result(timeout=WAIT)
        np.testing.assert_allclose(got, preds_b, rtol=0, atol=1e-6)
        assert profiling.counter_value(profiling.labeled(
            profiling.SERVE_SHADOW_ADOPTIONS, model="shadowed")) >= 1
    finally:
        mb.close()


# -- co-stacking -----------------------------------------------------------

@pytest.mark.parametrize("kernel", ["stacked", "segment"])
@pytest.mark.parametrize("tenants", [2, 3])
def test_mixed_batch_bitwise_binary(tmp_path, tenants, kernel):
    pubs = {mid: _publish(tmp_path, mid, seed)
            for mid, seed in list((("alpha", 11), ("beta", 12),
                                   ("gamma", 13)))[:tenants]}
    cat = _catalog(pubs, flush_deadline_ms=5.0, costack_kernel=kernel)
    try:
        assert len(cat._groups) == 1
        (group,) = cat._groups.values()
        assert sorted(group.member_ids) == sorted(pubs)
        assert group.runtime.costack_kernel == kernel
        Xq = pubs["alpha"][2][:16]
        assert np.abs(pubs["alpha"][1].predict(Xq)
                      - pubs["beta"][1].predict(Xq)).max() > 1e-4
        jobs = {mid: pubs[mid][2][16:16 + 8 + 3 * i]
                for i, mid in enumerate(pubs)}
        for kind in ("value", "raw"):
            got = _mixed_round(cat, jobs, kind=kind)
            for mid, (_p, bst, _X) in pubs.items():
                want = _solo(bst).predict(jobs[mid], kind=kind)
                _assert_solo(got[mid], want, kind)
    finally:
        cat.close()


def test_mixed_batch_bitwise_multiclass(tmp_path):
    pubs = {mid: _publish(tmp_path, mid, seed, num_class=3)
            for mid, seed in (("m1", 21), ("m2", 22))}
    cat = _catalog(pubs)
    try:
        assert len(cat._groups) == 1
        jobs = {mid: pubs[mid][2][:12] for mid in pubs}
        for kind in ("value", "raw"):
            got = _mixed_round(cat, jobs, kind=kind)
            for mid, (_p, bst, _X) in pubs.items():
                want = _solo(bst).predict(jobs[mid], kind=kind)
                assert got[mid].shape == (12, 3)
                _assert_solo(got[mid], want, kind)
    finally:
        cat.close()


@pytest.mark.parametrize("kernel", ["stacked", "segment"])
def test_mixed_batch_bitwise_binned(tmp_path, kernel):
    pubs = {"w6": _publish(tmp_path, "w6", 31, refbin=True, features=6),
            "w9": _publish(tmp_path, "w9", 32, refbin=True, features=9)}
    cat = _catalog(pubs, serve_quantize="binned", costack_kernel=kernel)
    try:
        assert len(cat._groups) == 1
        group = next(iter(cat._groups.values()))
        assert group.runtime.variant == "binned"
        jobs = {mid: pubs[mid][2][:10 + 3 * i]
                for i, mid in enumerate(pubs)}
        got = _mixed_round(cat, jobs, kind="raw")
        for mid, (path, bst, _X) in pubs.items():
            want = _solo(bst, "binned", path + ".refbin").predict(
                jobs[mid], kind="raw")
            assert np.array_equal(got[mid], want)
            raw = _solo(bst).predict(jobs[mid], kind="raw")
            assert np.array_equal(got[mid], raw)    # binned == raw
    finally:
        cat.close()


def test_hot_swap_restacks_only_its_group(tmp_path):
    pubs = {mid: _publish(tmp_path, mid, seed)
            for mid, seed in (("a", 41), ("b", 42))}
    cat = _catalog(pubs)
    try:
        group = next(iter(cat._groups.values()))
        old = group.runtime
        X = pubs["a"][2][:8]
        before = cat.submit(X, model_id="b", kind="raw")[1].result(
            timeout=WAIT)
        new_b, _, _ = _train(43, rounds=6)
        new_b.save_model(pubs["b"][0])
        assert cat.poll_once() == 1
        assert group.runtime is not old and group.restacks == 1
        got = cat.submit(X, model_id="b", kind="raw")[1].result(
            timeout=WAIT)
        assert np.array_equal(got, _solo(new_b).predict(X, kind="raw"))
        assert not np.array_equal(got, before)
        # tenant a keeps its answers
        a = cat.submit(X, model_id="a", kind="raw")[1].result(timeout=WAIT)
        assert np.array_equal(a, _solo(pubs["a"][1]).predict(X, "raw"))
    finally:
        cat.close()


def test_http_server_demuxes_costacked_tenants(tmp_path):
    pubs = {mid: _publish(tmp_path, mid, seed)
            for mid, seed in (("left", 111), ("right", 112))}
    cat = _catalog(pubs)
    want = {mid: _solo(bst).predict(pubs[mid][2][:8], kind="raw")
            for mid, (_p, bst, _X) in pubs.items()}
    errs = []
    with PredictionServer(catalog=cat, model_poll_seconds=0) as srv:
        def client(mid):
            try:
                got, _ = _predict_rows(srv, pubs[mid][2][:8], model=mid,
                                       via="query")
                np.testing.assert_allclose(
                    got, pubs[mid][1].predict(pubs[mid][2][:8]), rtol=0,
                    atol=1e-6)
                body = "\n".join(json.dumps([float(v) for v in r])
                                 for r in pubs[mid][2][:8])
                status, _h, text = _post(
                    srv, body, f"/predict?model={mid}&raw_score=1")
                got = np.array([json.loads(l)
                                for l in text.strip().splitlines()])
                assert status == 200 and np.array_equal(got, want[mid])
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=client, args=(mid,))
                   for mid in pubs for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        stats = json.loads(_get(srv, "/stats")[1])
        (gid,) = stats["groups"]
        assert sorted(stats["groups"][gid]["members"]) == ["left", "right"]
        assert stats["models"]["left"]["group"] == gid
        assert json.loads(_get(srv, "/healthz")[1])["groups"] == 1
