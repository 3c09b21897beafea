"""The port's router tier (lightgbm_tpu_torch/router/) on the CPU,
mirroring tests/test_router.py: consistent-hash placement held key for
key against the JAX package's ring, the per-backend circuit breakers
(open, route around, half-open probe, readmit), transport-vs-answer
relay semantics, the health sweep, fleet /stats and /metrics, and
routed answers from the port's PredictionServers on the CPU, bitwise
the direct answers.

Stub backends are stdlib HTTP servers (the router knows nothing of the
serving stack); transport failures come from the ``route.backend.b<N>``
fault seams; every listener is torn down in a finally or a `with`.
"""
import http.client
import json
import threading
from http.server import BaseHTTPRequestHandler

import numpy as np
import pytest

from lightgbm_tpu.router import HashRing as JHashRing

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.diagnostics import faults
from lightgbm_tpu_torch.httpd import SeveringHTTPServer
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.router import (HashRing, NoHealthyBackendError,
                                       RouterServer, router_from_config)
from lightgbm_tpu_torch.serving import ModelRegistry, PredictionServer


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


class _StubBackend:
    """A stand-in serving process: answers /predict with its own name
    (so tests can see WHERE the router sent a request), echoes the
    forwarded model/trace headers, and serves a configurable /healthz
    payload in the enriched catalog shape (models / published / stale)."""

    def __init__(self, name, health=None, port=0):
        self.name = name
        self.health = health or {"status": "ok", "generation": 1,
                                 "models": {}, "published": {},
                                 "stale": []}
        self.served = []        # X-Model-Id of each proxied /predict
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code, obj, hdrs=()):
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                for k, v in hdrs:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self._send(200, outer.health)
                elif path == "/stats":
                    self._send(200, {"backend": outer.name})
                else:
                    self._send(404, {"error": "nope"})

            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                mid = self.headers.get("X-Model-Id")
                outer.served.append(mid)
                if mid == "missing":    # a backend ANSWER, not a failure
                    self._send(404, {"error": "unknown model missing"})
                    return
                self._send(200, {
                    "backend": outer.name, "model": mid,
                    "trace": self.headers.get("X-Trace-Id"),
                    "body": body.decode()},
                    hdrs=(("X-Model-Id", mid or "default"),
                          ("X-Model-Generation", "7"),
                          ("X-Trace-Id",
                           self.headers.get("X-Trace-Id") or "t-none")))

        # SeveringHTTPServer so stop() looks like a process kill even
        # to the router's pooled keep-alive connections
        self.httpd = SeveringHTTPServer(("127.0.0.1", port), H)
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        self.port = self.httpd.server_address[1]
        self._t = threading.Thread(target=self.httpd.serve_forever,
                                   daemon=True)
        self._t.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.close_client_connections()
        self.httpd.server_close()
        self._t.join(timeout=10)


def _router(stubs, **kw):
    """RouterServer over stub backends; background health loop off so
    every breaker transition in a test is an explicit call."""
    kw.setdefault("health_interval_ms", 0)
    overrides = kw.pop("overrides", None)
    return RouterServer([s.addr for s in stubs], overrides, **kw)


def _post(host, port, body, path="/predict", headers=None):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("POST", path, body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read().decode()
    finally:
        conn.close()


def _get(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def _router(stubs, **kw):
    """RouterServer over stub backends; background health loop off so
    every breaker transition in a test is an explicit call."""
    kw.setdefault("health_interval_ms", 0)
    overrides = kw.pop("overrides", None)
    return RouterServer([s.addr for s in stubs], overrides, **kw)


def _post(host, port, body, path="/predict", headers=None):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("POST", path, body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read().decode()
    finally:
        conn.close()


def _get(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


# -- consistent-hash placement -------------------------------------------


@pytest.mark.parametrize("fleet", [1, 2, 3, 5, 8])
def test_hash_ring_places_keys_as_jax(fleet):
    """1,000 tenant keys land on the same backend as under the JAX
    package's ring, with the whole fleet alive and with one drained."""
    addrs = [f"127.0.0.1:{9000 + i}" for i in range(fleet)]
    ring, jring = HashRing(addrs), JHashRing(addrs)
    keys = [f"tenant-{i}" for i in range(1000)] + ["default", "de", ""]
    assert [ring.place(k) for k in keys] == [jring.place(k) for k in keys]
    alive = addrs[1:]
    assert ([ring.place(k, alive=alive) for k in keys]
            == [jring.place(k, alive=alive) for k in keys])


def test_hash_ring_add_remove_moves_only_one_backends_tenants():
    keys = [f"tenant-{i}" for i in range(300)]
    three = HashRing(["h0:1", "h1:1", "h2:1"])
    four = HashRing(["h0:1", "h1:1", "h2:1", "h3:1"])
    moved = [k for k in keys if three.place(k) != four.place(k)]
    assert moved and all(four.place(k) == "h3:1" for k in moved)
    assert len(moved) < len(keys) / 2
    for k in keys:
        assert (four.place(k, alive=["h0:1", "h1:1", "h2:1"])
                == three.place(k))
    assert three.place("x", alive=[]) is None


def test_router_from_config_needs_a_fleet():
    with pytest.raises(LightGBMError):
        router_from_config(config_from_params({"task": "route"}))


# -- routing + relay semantics -------------------------------------------


def test_router_routes_sticky_and_relays_headers():
    stubs = [_StubBackend("s0"), _StubBackend("s1")]
    rt = _router(stubs, overrides={"pinned": stubs[1].addr})
    try:
        with rt:
            # sticky: one tenant's requests all land on ONE backend
            for _ in range(5):
                status, hdrs, text = _post(
                    rt.host, rt.port, "[1.0]", path="/predict?model=beta")
                assert status == 200
            assert (len(stubs[0].served) == 5) != (len(stubs[1].served) == 5)
            # relay: the backend's model/generation/trace headers come
            # back through untouched
            assert hdrs["X-Model-Id"] == "beta"
            assert hdrs["X-Model-Generation"] == "7"
            # explicit placement override beats the hash
            status, _h, text = _post(rt.host, rt.port, "[1.0]",
                                     path="/predict?model=pinned")
            assert status == 200
            assert json.loads(text)["backend"] == "s1"
            # model-id precedence: query > body field > header
            status, _h, text = _post(
                rt.host, rt.port, json.dumps({"rows": [[1.0]],
                                              "model": "bodymid"}),
                path="/predict?model=querymid",
                headers={"X-Model-Id": "headermid"})
            assert json.loads(text)["model"] == "querymid"
            status, _h, text = _post(
                rt.host, rt.port, json.dumps({"rows": [[1.0]],
                                              "model": "bodymid"}),
                headers={"X-Model-Id": "headermid"})
            assert json.loads(text)["model"] == "bodymid"
            status, _h, text = _post(rt.host, rt.port, "[1.0]",
                                     headers={"X-Model-Id": "headermid"})
            assert json.loads(text)["model"] == "headermid"
            # the client's trace id flows through to the backend
            status, hdrs, text = _post(rt.host, rt.port, "[1.0]",
                                       headers={"X-Trace-Id": "t-42"})
            assert json.loads(text)["trace"] == "t-42"
            assert hdrs["X-Trace-Id"] == "t-42"
            # malformed model id: rejected AT the router (400)
            before = sum(len(s.served) for s in stubs)
            status, _h, _t = _post(rt.host, rt.port, "[1.0]",
                                   path="/predict?model=bad%20id!")
            assert status == 400
            assert sum(len(s.served) for s in stubs) == before
            # unknown path: 404 at the router
            status, _h, _t = _post(rt.host, rt.port, "", path="/nope")
            assert status == 404
            # a backend 4xx is an ANSWER: relayed verbatim, breaker
            # untouched (transport-vs-answer rule)
            status, _h, text = _post(rt.host, rt.port, "[1.0]",
                                     path="/predict?model=missing")
            assert status == 404 and "missing" in text
            assert rt.healthy_count() == 2
            # router's own health endpoint
            status, text = _get(rt.host, rt.port, "/healthz")
            assert status == 200
            health = json.loads(text)
            assert health == {"status": "ok", "backends": 2, "healthy": 2}
    finally:
        for s in stubs:
            s.stop()


def test_router_503_carries_retry_after():
    stubs = [_StubBackend("s0"), _StubBackend("s1")]
    rt = _router(stubs, failure_threshold=1)
    try:
        with rt:
            # every backend transport-fails: first pick opens its
            # breaker, the single retry opens the other's -> 503
            faults.arm("route.backend:*")
            status, hdrs, text = _post(rt.host, rt.port, "[1.0]")
            assert status == 503
            assert hdrs["Retry-After"] == "1"
            assert "failed" in json.loads(text)["error"]
            assert rt.healthy_count() == 0
            _status, text = _get(rt.host, rt.port, "/healthz")
            assert json.loads(text)["status"] == "degraded"
            faults.reset()
            # admission shed at the router's own inflight cap
            rt.max_inflight = 1
            rt._inflight = 1
            status, hdrs, _t = _post(rt.host, rt.port, "[1.0]")
            assert status == 503 and hdrs["Retry-After"] == "1"
            assert "max_inflight" in _t
            rt._inflight = 0
            rt.max_inflight = 0
    finally:
        for s in stubs:
            s.stop()


# -- breaker state machine (proxy-level, no listener needed) -------------


def _proxy(rt, model="m", body=b"[1.0]"):
    return rt.proxy(model, body, "", {"X-Model-Id": model})


def test_breaker_opens_routes_around_probes_and_readmits():
    """The full cycle under live traffic only (health loop off):
    consecutive transport failures open the breaker, traffic re-places
    onto the healthy backend, PROBE_AFTER route-arounds earn ONE
    half-open probe, and its success sends the tenant home."""
    stubs = [_StubBackend("s0"), _StubBackend("s1")]
    rt = _router(stubs, failure_threshold=2,
                 overrides={"m": stubs[0].addr})
    b0 = rt._backends[stubs[0].addr]
    try:
        # two failing dispatches to the home backend; each request is
        # retried onto s1 so the CLIENT never sees a failure
        faults.arm("route.backend.b0:1-2")
        for _ in range(2):
            status, _h, text = _proxy(rt)
            assert status == 200
            assert json.loads(text)["backend"] == "s1"
        assert b0.broken and rt.healthy_count() == 1
        # route-arounds: home is open, traffic re-places to s1; the
        # PROBE_AFTER'th skip dispatches ONE live probe to s0 (the
        # fault plan is exhausted, so the probe succeeds -> readmit)
        for i in range(rt.PROBE_AFTER):
            status, _h, text = _proxy(rt)
            assert status == 200
            expect = "s0" if i == rt.PROBE_AFTER - 1 else "s1"
            assert json.loads(text)["backend"] == expect
        assert not b0.broken and b0.probes == 1
        # drain reversed: the tenant is home again
        _status, _h, text = _proxy(rt)
        assert json.loads(text)["backend"] == "s0"
    finally:
        rt._httpd.server_close()
        for s in stubs:
            s.stop()


def test_retry_is_never_consumed_as_halfopen_probe():
    """A request that already paid
    one transport failure must NOT be re-dispatched into a DIFFERENT
    broken backend as its half-open probe — clients never pay for
    fleet convalescence.  The probe happens later, on a fresh request."""
    stubs = [_StubBackend("s0"), _StubBackend("s1")]
    rt = _router(stubs, failure_threshold=1,
                 overrides={"m": stubs[0].addr})
    b0 = rt._backends[stubs[0].addr]
    try:
        # open s0's breaker (retry keeps the client green)
        faults.arm("route.backend.b0:1")
        assert _proxy(rt)[0] == 200
        assert b0.broken
        # park the skip count ONE route-around short of a probe, then
        # make the healthy backend fail its next dispatch once (hit
        # numbering for a site starts when it is first armed)
        b0.skips = rt.PROBE_AFTER - 2
        faults.arm("route.backend.b1:1")
        with pytest.raises(NoHealthyBackendError):
            _proxy(rt)
        # the retry crossed PROBE_AFTER on the broken home but was
        # FORBIDDEN to probe it: no probe happened, s0 stays open
        assert b0.skips >= rt.PROBE_AFTER - 1
        assert b0.probes == 0 and b0.broken
        # a FRESH request (not a retry) is allowed to probe -> readmit
        status, _h, text = _proxy(rt)
        assert status == 200
        assert json.loads(text)["backend"] == "s0"
        assert b0.probes == 1 and not b0.broken
    finally:
        rt._httpd.server_close()
        for s in stubs:
            s.stop()


def test_interleaved_multibackend_failures_zero_client_errors():
    """Two of three backends fail at interleaved times; every client
    request keeps answering 200 off the survivors, and readmission
    brings exactly the recovered backend back."""
    stubs = [_StubBackend("s0"), _StubBackend("s1"), _StubBackend("s2")]
    rt = _router(stubs, failure_threshold=1,
                 overrides={"m": stubs[0].addr})
    b0, b1, b2 = (rt._backends[s.addr] for s in stubs)
    # a second tenant whose consistent-hash home is s1, so both broken
    # backends carry live tenants during the interleaving
    k1 = next(k for k in (f"t{i}" for i in range(100))
              if rt._place_home(k) == stubs[1].addr)
    try:
        # s0 goes down hard; its tenant survives via the retry
        faults.arm("route.backend.b0:*")
        assert _proxy(rt)[0] == 200
        assert b0.broken
        # then s1 dies WHILE s0 is still broken
        faults.arm("route.backend.b1:*")
        status, _h, text = _proxy(rt, model=k1)
        assert status == 200
        assert b1.broken
        # interleaved steady load on BOTH displaced tenants: every
        # request answers 200 off the survivor.  Half-open probes to
        # the still-dead backends fire along the way and fail — the
        # retry (never itself a probe) keeps the client green.
        for i in range(20):
            status, _h, text = _proxy(rt, model=("m" if i % 2 else k1))
            assert status == 200             # ZERO client-visible errors
            assert json.loads(text)["backend"] == "s2"
        assert b0.broken and b1.broken and not b2.broken
        # s0 recovers (its fault plan cleared; s1 stays dead): the next
        # PROBE_AFTER route-arounds earn the probe that readmits s0 —
        # and ONLY s0
        faults.reset()
        faults.arm("route.backend.b1:*")
        b0.skips = 0
        for _ in range(rt.PROBE_AFTER + 1):
            assert _proxy(rt)[0] == 200
        assert not b0.broken and b1.broken
        assert rt.healthy_count() == 2
        # steady state: tenant back home on s0
        _s, _h, text = _proxy(rt)
        assert json.loads(text)["backend"] == "s0"
    finally:
        rt._httpd.server_close()
        for s in stubs:
            s.stop()


# -- health sweep + fleet staleness --------------------------------------


def test_health_sweep_staleness_and_real_restart_readmission():
    h0 = {"status": "ok", "generation": 3,
          "models": {"m": 3, "x": 1}, "published": {"m": 2, "x": 1},
          "stale": []}
    h1 = {"status": "ok", "generation": 3,
          "models": {"m": 3, "x": 1}, "published": {"m": 1, "x": 1},
          "stale": ["x"]}
    stubs = [_StubBackend("s0", health=h0), _StubBackend("s1", health=h1)]
    rt = _router(stubs, failure_threshold=2)
    try:
        rt.probe_backends_once()
        models = rt._fleet_models()
        # s1's published "m" generation trails the fleet max -> stale;
        # "x" staleness is s1's own pending-publish self-report
        assert models["m"]["stale_backends"] == [stubs[1].addr]
        assert models["x"]["stale_backends"] == [stubs[1].addr]
        assert models["m"]["live"] == {stubs[0].addr: 3,
                                       stubs[1].addr: 3}
        assert models["m"]["published"][stubs[0].addr] == 2
        assert models["m"]["placed"] in (stubs[0].addr, stubs[1].addr)
        # kill s1 for real: connection-refused transport failures open
        # its breaker after failure_threshold sweeps
        port = stubs[1].port
        stubs[1].stop()
        rt.probe_backends_once()
        rt.probe_backends_once()
        assert rt.healthy_count() == 1
        # restart on the same port: one sweep readmits it
        stubs[1] = _StubBackend("s1", health=h1, port=port)
        rt.probe_backends_once()
        assert rt.healthy_count() == 2
    finally:
        rt._httpd.server_close()
        for s in stubs:
            s.stop()


# -- fleet /stats + /metrics aggregation ---------------------------------


def test_router_stats_and_metrics_aggregation():
    h0 = {"status": "ok", "generation": 1, "models": {"m": 1},
          "published": {"m": 1}, "stale": []}
    stubs = [_StubBackend("s0", health=h0), _StubBackend("s1", health=h0)]
    rt = _router(stubs)
    try:
        with rt:
            rt.probe_backends_once()
            for _ in range(3):
                assert _post(rt.host, rt.port, "[1.0]",
                             path="/predict?model=m")[0] == 200
            status, text = _get(rt.host, rt.port, "/stats")
            assert status == 200
            stats = json.loads(text)
            assert stats["healthy"] == 2
            assert set(stats["backends"]) == {s.addr for s in stubs}
            for addr, snap in stats["backends"].items():
                assert snap["healthy"] is True
                # each healthy backend's own /stats rides along
                assert snap["stats"]["backend"] in ("s0", "s1")
            assert sum(s["dispatches"]
                       for s in stats["backends"].values()) >= 3
            assert stats["models"]["m"]["placed"] in stats["backends"]
            assert stats["requests"] >= 3
            assert stats["latency_ms"]["count"] >= 3
            # /metrics: router counters + per-backend AND per-model
            # labeled series in one exposition
            status, text = _get(rt.host, rt.port, "/metrics")
            assert status == 200
            assert "lgbt_router_requests_total" in text
            assert 'lgbt_router_requests_total{model="m"}' in text
            assert 'lgbt_route_backend_healthy{backend="b0"} 1' in text
            assert 'lgbt_route_backend_healthy{backend="b1"} 1' in text
            assert ('lgbt_route_model_generation{backend="b0",model="m"} 1'
                    in text)
            assert "lgbt_route_healthy_backends 2" in text
    finally:
        for s in stubs:
            s.stop()


# -- the port's serving plane behind the router ---------------------------


CPU = {"device_type": "cpu", "verbose": -1}


def _model(tmp_path):
    rng = np.random.RandomState(3)
    X = rng.rand(600, 6)
    y = (X @ rng.randn(6) > 0).astype(float)
    bst = lt.train(dict(CPU, objective="binary", num_leaves=15),
                   lt.Dataset(X, y), 10)
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    return path, X


def _rows(X, lo, n=16):
    return "\n".join(json.dumps([float(v) for v in r]) for r in X[lo:lo + n])


def test_routed_answers_bitwise_direct(tmp_path):
    """Two port PredictionServers on the CPU behind router_from_config:
    every routed answer is bitwise the direct answer of the backend it
    was placed on, X-Model-Id comes back, and a backend stopped under
    load costs the client nothing; restarted on its port, the health
    sweep readmits it."""
    path, X = _model(tmp_path)
    regs = [ModelRegistry(path, params=CPU, replicas=1) for _ in range(2)]
    servers = [PredictionServer(r, model_poll_seconds=0) for r in regs]
    for s in servers:
        s.start()
    addrs = [f"127.0.0.1:{s.port}" for s in servers]
    rt = router_from_config(config_from_params({
        "task": "route", "route_backends": ",".join(addrs),
        "route_port": 0, "serve_host": "127.0.0.1",
        "route_health_interval_ms": 0}))
    try:
        with rt:
            for lo in range(0, 160, 16):
                body = _rows(X, lo)
                st, hdrs, routed = _post(rt.host, rt.port, body)
                assert st == 200 and hdrs["X-Model-Id"] == "default"
                for s in servers:
                    ds, _h, direct = _post(s.host, s.port, body)
                    assert ds == 200 and direct == routed
            home = rt.ring.place("default")
            i = addrs.index(home)
            port = servers[i].port
            servers[i].stop()
            for lo in range(0, 160, 16):
                st, _h, routed = _post(rt.host, rt.port, _rows(X, lo))
                assert st == 200
            assert rt.healthy_count() == 1
            regs[i] = ModelRegistry(path, params=CPU, replicas=1)
            servers[i] = PredictionServer(regs[i], host="127.0.0.1",
                                          port=port, model_poll_seconds=0)
            servers[i].start()
            rt.probe_backends_once()
            assert rt.healthy_count() == 2
            st, text = _get(rt.host, rt.port, "/stats")
            assert st == 200 and json.loads(text)["healthy"] == 2
    finally:
        for s in servers:
            s.stop()
