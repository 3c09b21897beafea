"""Stdlib-only HTTP router fronting M backend serving processes.

A copy of lightgbm_tpu/router/server.py (standard library only).  It
runs in front of a fleet of PredictionServer backends (the JAX
package's ``task=route`` in front of ``task=serve`` processes):

- ``POST /predict`` — the request's model id (``?model=`` query param,
  ``"model"`` object-body field, or ``X-Model-Id`` header — the same
  precedence the backends apply) picks a backend by explicit placement
  override or consistent hash (placement.HashRing), and the request is
  proxied there verbatim — body, query string, trace/model headers in,
  status + payload + ``X-Model-Id`` / ``X-Model-Generation`` /
  ``X-Trace-Id`` headers back out.  A request that names no model
  places under the key ``"default"`` (every backend's unkeyed tenant),
  so unkeyed traffic is sticky too.
- per-backend **circuit breakers** — the serving fleet's replica state
  machine (serving/runtime.py) one level up: `failure_threshold`
  CONSECUTIVE transport failures open a backend's breaker; open
  backends are routed around (their tenants re-place onto the next
  healthy backend clockwise — draining re-placement, in-flight
  requests finish on the old backend); after ``PROBE_AFTER``
  route-arounds ONE live request is dispatched as a half-open probe
  (single-flight, count-based — no wall clock, chaos-deterministic),
  and a success readmits the backend.  A failed dispatch is retried
  ONCE on a different healthy backend with probing disabled — a retry
  is never consumed as a half-open probe.
- **health loop** — every `route_health_interval_ms` each backend's
  ``/healthz`` is probed; the parsed body (model ids, live + published
  generations, self-reported stale tenants) feeds the fleet /stats
  view, probe successes readmit open breakers, and probe failures
  open them without waiting for live traffic.  0 = no background
  probing; the count-based live-traffic probes still readmit.
- ``GET /stats`` — the fleet view: per-backend breaker health,
  dispatch/inflight counters and last health payload, the placement
  table, per-model staleness across backends, router counters, and
  each healthy backend's own /stats embedded.
- ``GET /metrics`` — Prometheus text exposition merging the router's
  counters with per-backend AND per-model labeled series.

Transport failures (connect/timeout/protocol) are the ROUTER's
failures and drive the breakers; any HTTP response from a backend —
including a 4xx/5xx — is a backend ANSWER and relays to the client
verbatim.  This module deliberately imports none of the serving stack
(no numpy, no torch): a router process is plumbing and must start in
milliseconds.
"""
from __future__ import annotations

import json
import re
import socket
import threading
import time
import socketserver
from http.client import HTTPException
from typing import Dict, List, Optional, Tuple

from .. import log, profiling, telemetry
from ..httpd import SeveringHTTPServer
from ..config import MODEL_ID_RE, Config, parse_route_backends
from ..diagnostics import faults, locksan
from ..log import LightGBMError
from .placement import HashRing, _point

# same charset as serving/server.py's ingress validation — duplicated
# (not imported) so the router never pulls the numpy/torch serving stack
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")

# response headers relayed from backend to client (anything else —
# Date, Server, Connection — is per-hop and re-minted by this server)
_RELAY_HEADERS = ("Content-Type", "X-Model-Id", "X-Model-Generation",
                  "X-Trace-Id", "Retry-After")
_RELAY_HEADERS_LC = {h.lower(): h for h in _RELAY_HEADERS}

# transport-level dispatch failures: the backend did not ANSWER.
# InjectedFault rides along so the chaos suite can open breakers at the
# route.backend seams without real process kills.
_TRANSPORT_ERRORS = (OSError, HTTPException, faults.InjectedFault)


class _BackendConn:
    """One pooled raw-socket backend connection speaking the same
    minimal HTTP/1.1 subset as the ingress handler (see _Handler).

    Not http.client: ``getresponse()`` parses response headers through
    email.parser and builds an HTTPResponse object per round-trip —
    the same few hundred GIL-bound microseconds the ingress rewrite
    removed, paid again on the egress leg.  TCP_NODELAY because the
    proxied request still leaves as header bytes + body bytes and must
    never sit out a delayed-ACK period behind Nagle."""

    __slots__ = ("sock", "rfile", "host", "port")

    def __init__(self, host: str, port: int, timeout: float):
        self.host, self.port = host, port
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb", buffering=64 << 10)

    def close(self) -> None:
        for closer in (self.rfile.close, self.sock.close):
            try:
                closer()
            except OSError:
                pass

    def _read_chunked(self) -> bytes:
        chunks = []
        while True:
            size_line = self.rfile.readline(1024)
            if not size_line:
                raise HTTPException("connection closed mid-chunk")
            size = int(size_line.split(b";", 1)[0], 16)
            if size == 0:
                while self.rfile.readline(65537) not in (b"\r\n", b"\n",
                                                         b""):
                    pass                     # drain trailers
                return b"".join(chunks)
            chunk = self.rfile.read(size + 2)   # chunk + CRLF
            if len(chunk) != size + 2:
                raise HTTPException("truncated chunk")
            chunks.append(chunk[:-2])

    def roundtrip(self, method: str, path: str, body: Optional[bytes],
                  headers: Dict[str, str]):
        """One request/response.  Returns ``(status, lowercase-header
        dict, payload, reusable)``; raises OSError/HTTPException when
        the backend did not answer a complete response."""
        parts = [f"{method} {path} HTTP/1.1\r\n"
                 f"Host: {self.host}:{self.port}\r\n"]
        parts += [f"{k}: {v}\r\n" for k, v in headers.items()]
        if body is not None:
            parts.append(f"Content-Length: {len(body)}\r\n")
        parts.append("\r\n")
        head = "".join(parts).encode("latin-1")
        self.sock.sendall(head + body if body else head)
        line = self.rfile.readline(65537)
        bits = line.split(None, 2)
        if len(bits) < 2 or not bits[1].isdigit():
            raise HTTPException(f"bad status line {line!r}")
        status = int(bits[1])
        hdrs: Dict[str, str] = {}
        while True:
            h = self.rfile.readline(65537)
            if h in (b"\r\n", b"\n"):
                break
            if not h:
                raise HTTPException("connection closed in headers")
            k, sep, v = h.partition(b":")
            if sep:
                hdrs[k.strip().lower().decode("latin-1")] = \
                    v.strip().decode("latin-1")
        reusable = (bits[0] == b"HTTP/1.1" and
                    hdrs.get("connection", "").lower() != "close")
        length = hdrs.get("content-length")
        if length is not None:
            payload = self.rfile.read(int(length))
            if len(payload) != int(length):
                raise HTTPException("truncated response body")
        elif hdrs.get("transfer-encoding", "").lower() == "chunked":
            payload = self._read_chunked()
        else:
            payload = self.rfile.read()      # body runs to EOF
            reusable = False
        return status, hdrs, payload, reusable


class NoHealthyBackendError(RuntimeError):
    """No healthy backend can take this request (all breakers open, or
    the one retry also failed at the transport layer) — HTTP 503 +
    Retry-After at the router."""


class BackendState:
    """Per-backend breaker + health bookkeeping — the serving replica
    state machine (serving/runtime.py `_Replica`) one level up, same
    fields, same count-based transitions."""

    __slots__ = ("index", "addr", "host", "port", "inflight",
                 "dispatches", "failures", "broken", "skips", "probes",
                 "last_health", "req_key", "fail_key")

    def __init__(self, index: int, addr: str):
        self.index = index
        self.addr = addr
        host, _, port = addr.rpartition(":")
        self.host, self.port = host, int(port)
        # labeled registry keys precomputed once: labeled() formats a
        # sorted f-string per call, and these two are per-request
        self.req_key = profiling.labeled(profiling.ROUTER_REQUESTS,
                                         backend=f"b{index}")
        self.fail_key = profiling.labeled(
            profiling.ROUTER_BACKEND_FAILURES, backend=f"b{index}")
        self.inflight = 0       # proxied requests on the wire right now
        self.dispatches = 0     # total proxied requests sent here
        self.failures = 0       # CONSECUTIVE transport failures
        self.broken = False     # breaker open: no traffic except probes
        self.skips = 0          # route-arounds since broken/last probe
        self.probes = 0         # half-open probes dispatched
        self.last_health = None  # parsed /healthz body of the last good probe

    def label(self) -> str:
        """Prometheus label value for this backend (index-shaped —
        ``host:port`` is not label-charset-safe; /stats maps it back)."""
        return f"b{self.index}"


_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 503: "Service Unavailable"}


class _Handler(socketserver.StreamRequestHandler):
    """Minimal bytes-level HTTP/1.1 ingress.

    Not BaseHTTPRequestHandler: its email.parser header parse and
    many-small-writes response path cost several hundred GIL-bound
    microseconds per request — most of the routing hop's entire <5%
    p99 budget.  The router speaks a tiny
    fixed subset (POST /predict plus three GET endpoints), so ingress
    reduces to a request-line split, header partition on b":", a body
    read of Content-Length bytes, and ONE pre-assembled response
    write.  Per-hop headers (Date, Server) are deliberately not
    minted — no client of this tier reads them."""

    rbufsize = 64 << 10   # one buffered read drains typical requests
    wbufsize = 0          # _SocketWriter: each write is one sendall

    def setup(self):
        super().setup()
        # the response leaves in one write, but large payloads still
        # split across send() calls — keep Nagle off regardless
        self.connection.setsockopt(socket.IPPROTO_TCP,
                                   socket.TCP_NODELAY, 1)

    def handle(self):
        try:
            while self._handle_one():
                pass
        except OSError:
            pass    # client hung up, or stop() severed the socket

    def _send(self, code: int, payload: bytes,
              content_type: str = "application/json",
              headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        parts = [f"HTTP/1.1 {code} {_REASONS.get(code, 'OK')}\r\n"
                 f"Content-Type: {content_type}\r\n"
                 f"Content-Length: {len(payload)}\r\n"]
        parts += [f"{k}: {v}\r\n" for k, v in headers]
        if not self._keep:
            parts.append("Connection: close\r\n")
        parts.append("\r\n")
        self.wfile.write("".join(parts).encode("latin-1") + payload)

    def _send_json(self, code: int, obj,
                   headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        self._send(code, (json.dumps(obj) + "\n").encode(),
                   headers=headers)

    def _handle_one(self) -> bool:
        line = self.rfile.readline(65537)
        if not line or line in (b"\r\n", b"\n"):
            return False                 # clean EOF between requests
        self._keep = False               # malformed requests never linger
        try:
            method, target, version = line.split()
        except ValueError:
            self._send(400, b'{"error": "malformed request line"}\n')
            return False
        headers: Dict[str, str] = {}
        while True:
            h = self.rfile.readline(65537)
            if h in (b"\r\n", b"\n", b""):
                break
            if len(headers) >= 128:
                self._send(400, b'{"error": "too many headers"}\n')
                return False
            k, sep, v = h.partition(b":")
            if sep:
                headers[k.strip().lower().decode("latin-1")] = \
                    v.strip().decode("latin-1")
        self._keep = (version == b"HTTP/1.1"
                      and headers.get("connection", "").lower() != "close")
        if headers.get("expect", "").lower() == "100-continue":
            self.wfile.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        # drain the body FIRST: keep-alive would otherwise parse
        # leftover body bytes as the connection's next request line
        # after an early 404/400 (serving/server.py discipline)
        length = headers.get("content-length")
        if length is not None:
            try:
                body = self.rfile.read(int(length))
            except ValueError:
                self._keep = False
                self._send(400, b'{"error": "bad Content-Length"}\n')
                return False
        else:
            body = b""
            if method == b"POST":
                self._keep = False       # unknown body length
        path, _, query = target.decode("latin-1").partition("?")
        rt: "RouterServer" = self.server.router
        if method == b"POST":
            self._do_post(rt, path, query, headers, body)
        elif method == b"GET":
            self._do_get(rt, path)
        else:
            self._send(405, b'{"error": "method not allowed"}\n')
        return self._keep

    def _do_get(self, rt: "RouterServer", path: str) -> None:
        if path == "/healthz":
            healthy = rt.healthy_count()
            self._send_json(200, {
                "status": "ok" if healthy else "degraded",
                "backends": len(rt.ring.backends),
                "healthy": healthy})
        elif path == "/stats":
            self._send_json(200, rt.stats())
        elif path == "/metrics":
            self._send(200, rt.metrics_text().encode(),
                       content_type="text/plain; version=0.0.4; "
                                    "charset=utf-8")
        else:
            self._send_json(404, {"error": f"unknown path {path}"})

    def _do_post(self, rt: "RouterServer", path: str, query: str,
                 headers: Dict[str, str], body: bytes) -> None:
        if path != "/predict":
            self._send_json(404, {"error": f"unknown path {path}"})
            return
        # model id: query param > body object field > header — resolved
        # HERE (not just at the backend) because the id decides which
        # backend sees the request at all.  The body is parsed only
        # when the cheaper sources are absent, it looks like the
        # object form, AND a C-level substring scan says a "model" key
        # can exist at all — a json.loads of every multi-KB row
        # payload would put a GIL-bound parse on the routing hot path
        # (the routing hop's <5% p99 budget).
        from urllib.parse import parse_qs
        qs = parse_qs(query)
        raw_mid = qs["model"][0] if "model" in qs else None
        if (raw_mid is None and body[:16].lstrip()[:1] == b"{"
                and b'"model"' in body):
            try:
                mid = json.loads(body).get("model")
                raw_mid = str(mid) if mid else None
            except (ValueError, UnicodeDecodeError):
                raw_mid = None               # backends parse-error it
        if raw_mid is None:
            raw_mid = headers.get("x-model-id")
        if raw_mid is not None and not MODEL_ID_RE.match(raw_mid):
            self._send_json(400, {"error": (
                "malformed model id (must match [A-Za-z0-9._-]{1,64})")})
            return
        # trace ingress mirrors the backends: validate, mint when
        # telemetry is on, forward so the backend's spans join OUR trace
        raw_tid = headers.get("x-trace-id")
        trace_id = (raw_tid if raw_tid is not None
                    and _TRACE_ID_RE.match(raw_tid) else None)
        if trace_id is None and telemetry.enabled():
            trace_id = telemetry.new_trace_id()
        fwd = {"Content-Type": headers.get("content-type",
                                           "application/json")}
        if trace_id:
            fwd["X-Trace-Id"] = trace_id
        if raw_mid:
            fwd["X-Model-Id"] = raw_mid
        try:
            status, rhdrs, payload = rt.proxy(
                raw_mid, body, query, fwd, trace_id=trace_id)
        except NoHealthyBackendError as e:
            profiling.count(profiling.ROUTER_REJECTED)
            self._send_json(503, {"error": str(e)},
                            headers=(("Retry-After", "1"),))
            return
        ctype = rhdrs.pop("Content-Type", "application/json")
        self._send(status, payload, content_type=ctype,
                   headers=tuple(rhdrs.items()))


class RouterServer:
    """HTTP router + backend health loop, with clean teardown (context
    manager) so tests never leak a listener — the `PredictionServer`
    lifecycle shape, one level up."""

    # route-arounds before an open-breaker backend earns ONE in-flight
    # half-open probe (count-based: deterministic under chaos specs,
    # and self-scaling — probes are frequent exactly when traffic is)
    PROBE_AFTER = 8

    def __init__(self, backends, overrides: Optional[Dict[str, str]] = None,
                 *, host: str = "127.0.0.1", port: int = 0,
                 health_interval_ms: float = 1000.0,
                 backend_timeout_ms: float = 30000.0,
                 max_inflight: int = 0, failure_threshold: int = 3,
                 group_spread: int = 1):
        if not backends:
            raise LightGBMError(
                "the router needs at least one backend: set "
                "route_backends=host:port,...")
        self.ring = HashRing(backends)
        self.overrides = dict(overrides or {})
        self.health_interval_s = max(float(health_interval_ms), 0.0) / 1e3
        self.backend_timeout_s = max(float(backend_timeout_ms), 1.0) / 1e3
        self.max_inflight = int(max_inflight)
        self.failure_threshold = max(int(failure_threshold), 1)
        self.group_spread = max(int(group_spread), 1)
        self._lock = locksan.lock("route.server")
        # model id -> co-stack group key, merged from the backends'
        # /healthz "group_keys" payloads (see _placement_key)
        self._group_keys: Dict[str, str] = {}
        self._backends: Dict[str, BackendState] = {
            addr: BackendState(i, addr)
            for i, addr in enumerate(self.ring.backends)}
        self._inflight = 0
        # per-model labeled-counter keys, formatted once per tenant
        self._model_req_keys: Dict[str, str] = {}
        # per-thread backend keep-alive connections (see _dispatch)
        self._conn_pool = threading.local()
        self._httpd = SeveringHTTPServer((host, port), _Handler)
        self._httpd.router = self
        self.host, self.port = self._httpd.server_address[:2]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- placement + breaker -------------------------------------------

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for b in self._backends.values() if not b.broken)

    def _placement_key(self, model_id: Optional[str]) -> str:
        """The key a tenant hashes the ring with: its co-stack group
        key when the health sweeps have reported one (so compatible
        tenants land on the SAME backend and actually co-stack there),
        the model id otherwise.  group_spread > 1 salts the group key
        with the tenant's own hash point modulo the spread, trading
        strict co-location for load spread across that many cohorts —
        tenants in the same cohort still co-stack."""
        key = model_id or "default"
        gk = self._group_keys.get(key)
        if gk is None:
            return key
        if self.group_spread > 1:
            return f"{gk}#{_point(key) % self.group_spread}"
        return gk

    def _place_home(self, model_id: Optional[str]) -> str:
        """The tenant's home backend over the FULL fleet (overrides
        first, ring over the placement key otherwise) — liveness is
        applied by _pick, so a drained tenant returns home on
        readmission."""
        key = model_id or "default"
        home = self.overrides.get(key)
        if home is None:
            home = self.ring.place(self._placement_key(key))
        return home

    def _pick(self, model_id: Optional[str], exclude: Optional[str] = None,
              allow_probe: bool = True) -> BackendState:
        """Choose a backend and charge it one in-flight dispatch.

        Healthy home wins; an open-breaker home counts a skip and may
        be selected as the single-flight half-open probe (never on a
        retry — allow_probe=False there); otherwise the tenant
        re-places clockwise among healthy backends (ROUTER_REHASHES).
        Raises NoHealthyBackendError when nothing can take it."""
        key = model_id or "default"
        with self._lock:
            home = self._backends[self._place_home(model_id)]
            chosen: Optional[BackendState] = None
            if home.addr != exclude and not home.broken:
                chosen = home
            else:
                if home.broken and home.addr != exclude:
                    home.skips += 1
                    if (allow_probe and home.skips >= self.PROBE_AFTER
                            and home.inflight == 0):
                        # half-open: ONE live request probes the broken
                        # backend; its success readmits, its failure
                        # restarts the skip window
                        home.skips = 0
                        home.probes += 1
                        profiling.count(profiling.ROUTER_BACKEND_PROBES)
                        chosen = home
                if chosen is None:
                    alive = [b.addr for b in self._backends.values()
                             if not b.broken and b.addr != exclude]
                    # re-place by the PLACEMENT key: every tenant of a
                    # drained group re-hashes to the same survivor, so
                    # the group re-forms (one build) instead of
                    # scattering into G solo tenants
                    replaced = self.ring.place(self._placement_key(key),
                                               alive)
                    if replaced is not None:
                        if home.broken:
                            profiling.count(profiling.ROUTER_REHASHES)
                        chosen = self._backends[replaced]
            if chosen is None:
                raise NoHealthyBackendError(
                    f"no healthy backend for model "
                    f"{key!r} ({len(self._backends)} configured, "
                    f"{sum(1 for b in self._backends.values() if not b.broken)}"
                    " healthy)")
            chosen.inflight += 1
            chosen.dispatches += 1
            return chosen

    def _note_success(self, b: BackendState, dispatched: bool = True) -> None:
        with self._lock:
            if dispatched:
                b.inflight -= 1
            b.failures = 0
            if b.broken:
                b.broken = False
                profiling.count(profiling.ROUTER_BACKEND_READMITTED)
                readmitted = True
            else:
                readmitted = False
        if readmitted:
            log.info(f"router: backend {b.addr} readmitted")
            telemetry.event("route.breaker", backend=b.addr,
                            state="closed")

    def _note_failure(self, b: BackendState, error: BaseException,
                      dispatched: bool = True) -> None:
        with self._lock:
            if dispatched:
                b.inflight -= 1
            profiling.count(profiling.ROUTER_BACKEND_FAILURES)
            profiling.count(b.fail_key)
            if b.broken:
                # a failed half-open probe: stay open, earn a fresh
                # PROBE_AFTER window before the next probe
                b.skips = 0
                opened = False
            else:
                b.failures += 1
                opened = b.failures >= self.failure_threshold
                if opened:
                    b.broken = True
                    b.skips = 0
                    profiling.count(profiling.ROUTER_BACKEND_BROKEN)
        if opened:
            log.warning(f"router: backend {b.addr} circuit-broken after "
                        f"{self.failure_threshold} consecutive failures "
                        f"({type(error).__name__}: {error})")
            telemetry.event("route.breaker", backend=b.addr, state="open",
                            error=str(error))

    # -- proxying -------------------------------------------------------

    def _dispatch(self, b: BackendState, method: str, path: str,
                  body: Optional[bytes] = None,
                  headers: Optional[Dict[str, str]] = None):
        """One HTTP round-trip to backend ``b``.  Raises a
        _TRANSPORT_ERRORS member when the backend did not answer; any
        HTTP response (any status) returns ``(status, headers,
        payload)``."""
        faults.check("route.backend")
        faults.check(f"route.backend.{b.label()}")
        # per-thread keep-alive pool: a fresh TCP connection per proxy
        # would make the routing hop pay connect + a new backend
        # handler thread on EVERY request — that alone blows the <5%
        # p99 budget.  One cached connection
        # per (handler thread, backend); a request that fails on a
        # CACHED connection retries once on a fresh one below the
        # fault seam, because a stale keep-alive socket (backend
        # restarted, idle close) is not a backend failure — scoring is
        # idempotent, so the re-send is safe.
        pool = self._conn_pool.__dict__.setdefault("conns", {})
        conn = pool.pop(b.addr, None)
        pooled = conn is not None
        for attempt in (0, 1):
            if conn is None:
                conn = _BackendConn(b.host, b.port,
                                    self.backend_timeout_s)
            try:
                status, hdrs, payload, reusable = conn.roundtrip(
                    method, path, body, headers or {})
            except _TRANSPORT_ERRORS:
                conn.close()
                conn = None
                if attempt == 0 and pooled:
                    continue    # stale cached socket, not the backend
                raise
            rhdrs = {_RELAY_HEADERS_LC[k]: v for k, v in hdrs.items()
                     if k in _RELAY_HEADERS_LC}
            if reusable:
                pool[b.addr] = conn
            else:
                conn.close()
            return status, rhdrs, payload

    def proxy(self, model_id: Optional[str], body: bytes, query: str,
              fwd_headers: Dict[str, str],
              trace_id: Optional[str] = None):
        """Route one /predict request: place, dispatch, and on a
        transport failure retry ONCE on a different healthy backend
        with probing disabled.  Returns ``(status, relay-headers,
        payload)``; raises NoHealthyBackendError for the 503 path."""
        profiling.count(profiling.ROUTER_REQUESTS)
        mkey = model_id or "default"
        mk = self._model_req_keys.get(mkey)
        if mk is None:    # benign race: duplicate format, same value
            mk = self._model_req_keys[mkey] = profiling.labeled(
                profiling.ROUTER_REQUESTS, model=mkey)
        profiling.count(mk)
        with self._lock:
            if self.max_inflight and self._inflight >= self.max_inflight:
                # shed load HERE instead of stacking proxy threads on
                # slow backends (the handler adds Retry-After)
                raise NoHealthyBackendError(
                    f"router at max_inflight={self.max_inflight} "
                    "(route_max_inflight); retry with backoff")
            self._inflight += 1
        path = "/predict" + (f"?{query}" if query else "")
        t0 = time.monotonic()
        try:
            with telemetry.span("route.request", trace_id=trace_id,
                                model=model_id or "default") as sp:
                b = self._pick(model_id)
                profiling.count(b.req_key)
                try:
                    status, rhdrs, payload = self._dispatch(
                        b, "POST", path, body=body, headers=fwd_headers)
                except _TRANSPORT_ERRORS as e:
                    self._note_failure(b, e)
                    # ONE retry on a different healthy backend.
                    # allow_probe=False: a retry must never be consumed
                    # as the half-open probe of ANOTHER broken backend
                    # — the client would pay for fleet convalescence.
                    profiling.count(profiling.ROUTER_RETRIES)
                    b2 = self._pick(model_id, exclude=b.addr,
                                    allow_probe=False)
                    try:
                        status, rhdrs, payload = self._dispatch(
                            b2, "POST", path, body=body,
                            headers=fwd_headers)
                    except _TRANSPORT_ERRORS as e2:
                        self._note_failure(b2, e2)
                        raise NoHealthyBackendError(
                            f"backends {b.addr} and {b2.addr} both "
                            f"failed ({type(e2).__name__}: {e2}); "
                            "retry with backoff") from e2
                    self._note_success(b2)
                    sp.set(backend=b2.addr, retried=True, status=status)
                    return status, rhdrs, payload
                self._note_success(b)
                sp.set(backend=b.addr, status=status)
                return status, rhdrs, payload
        finally:
            profiling.observe("router/latency_ms",
                              (time.monotonic() - t0) * 1e3)
            with self._lock:
                self._inflight -= 1

    # -- health loop ----------------------------------------------------

    def probe_backends_once(self) -> None:
        """One health sweep: GET /healthz on every backend (broken ones
        included — readmitting a restarted backend is the point).  The
        deterministic entry the tests call directly; the background
        loop is just this on a timer."""
        for b in list(self._backends.values()):
            try:
                status, _hdrs, payload = self._dispatch(b, "GET", "/healthz")
                if status != 200:
                    raise HTTPException(f"healthz answered {status}")
                health = json.loads(payload or b"{}")
            except (*_TRANSPORT_ERRORS, ValueError) as e:
                self._note_failure(b, e, dispatched=False)
                continue
            with self._lock:
                b.last_health = health
                # merge, don't replace: each backend only knows ITS
                # tenants' group keys; the union is the fleet map that
                # steers placement (stale keys for unpublished tenants
                # are harmless — they just keep steering consistently)
                gk = health.get("group_keys")
                if isinstance(gk, dict):
                    self._group_keys.update(
                        {str(m): str(k) for m, k in gk.items()})
            self._note_success(b, dispatched=False)

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            try:
                self.probe_backends_once()
            except Exception as e:           # never kill the loop
                log.warning(f"router health sweep failed: {e}")

    # -- observability --------------------------------------------------

    def _fleet_models(self) -> Dict[str, dict]:
        """Per-model fleet view from the backends' last /healthz
        payloads: placement, per-backend live + published generations,
        and which backends are stale for the model (self-reported
        pending publish, or a published generation behind the fleet
        max — the partially-swapped-fleet signal the health probes
        exist to catch)."""
        with self._lock:
            snaps = [(b.addr, b.last_health)
                     for b in self._backends.values() if b.last_health]
        models: Dict[str, dict] = {}
        for addr, health in snaps:
            self_stale = set(health.get("stale") or ())
            published = health.get("published") or {}
            for mid, gen in (health.get("models") or {}).items():
                m = models.setdefault(mid, {"placed": None, "live": {},
                                            "published": {},
                                            "stale_backends": []})
                m["live"][addr] = gen
                m["published"][addr] = published.get(mid)
                if mid in self_stale:
                    m["stale_backends"].append(addr)
        for mid, m in models.items():
            m["placed"] = self._place_home(mid)
            known = [g for g in m["published"].values() if g is not None]
            if known:
                newest = max(known)
                for addr, g in m["published"].items():
                    if (g is None or g < newest) \
                            and addr not in m["stale_backends"]:
                        m["stale_backends"].append(addr)
            m["stale_backends"].sort()
        return models

    def stats(self) -> dict:
        """The operator's fleet view, including each healthy backend's
        own /stats embedded (the aggregation a fleet dashboard scrapes
        once instead of M times)."""
        with self._lock:
            backs = {b.addr: {
                "index": b.index,
                "label": b.label(),
                "healthy": not b.broken,
                "inflight": b.inflight,
                "dispatches": b.dispatches,
                "failures": b.failures,
                "skips": b.skips,
                "probes": b.probes,
                "health": b.last_health,
            } for b in self._backends.values()}
            broken = [a for a, s in backs.items() if not s["healthy"]]
        for addr, snap in backs.items():
            if addr in broken:
                continue
            b = self._backends[addr]
            try:
                status, _h, payload = self._dispatch(b, "GET", "/stats")
                if status == 200:
                    snap["stats"] = json.loads(payload)
            except (*_TRANSPORT_ERRORS, ValueError) as e:
                snap["stats_error"] = f"{type(e).__name__}: {e}"
        return {
            "backends": backs,
            "healthy": len(backs) - len(broken),
            "models": self._fleet_models(),
            # per-backend co-stack group counts from the health sweep
            # (serving /healthz "groups"): how many co-stacked groups
            # each backend's tenants share — the fleet-wide view of
            # cross-model batching
            "groups": {addr: (snap["health"] or {}).get("groups")
                       for addr, snap in backs.items()
                       if snap["health"] is not None},
            # the co-stack placement map the ring hashes with (merged
            # from the health sweeps) and its spread knob — the fleet
            # view of WHY same-group tenants share a home backend
            "group_keys": dict(self._group_keys),
            "group_spread": self.group_spread,
            "overrides": dict(self.overrides),
            "inflight": self._inflight,
            "max_inflight": self.max_inflight,
            "requests": profiling.counter_value(profiling.ROUTER_REQUESTS),
            "retries": profiling.counter_value(profiling.ROUTER_RETRIES),
            "rejected": profiling.counter_value(profiling.ROUTER_REJECTED),
            "rehashes": profiling.counter_value(profiling.ROUTER_REHASHES),
            "backend_failures": profiling.counter_value(
                profiling.ROUTER_BACKEND_FAILURES),
            "backend_broken": profiling.counter_value(
                profiling.ROUTER_BACKEND_BROKEN),
            "backend_readmitted": profiling.counter_value(
                profiling.ROUTER_BACKEND_READMITTED),
            "backend_probes": profiling.counter_value(
                profiling.ROUTER_BACKEND_PROBES),
            "latency_ms": profiling.summary("router/latency_ms"),
            "process": telemetry.process_info(),
        }

    def _gauges(self) -> dict:
        """Live fleet gauges for /metrics: fleet totals, per-backend
        health/inflight series, and per-(backend, model) generation
        series merged from the health payloads — the serving plane's
        labeled-series contract carried one level up."""
        with self._lock:
            backends = list(self._backends.values())
            g = {
                "route.fleet_size": len(backends),
                "route.healthy_backends": sum(
                    1 for b in backends if not b.broken),
                "route.inflight": self._inflight,
                "route.inflight_cap": self.max_inflight,
            }
            for b in backends:
                g[profiling.labeled("route.backend_healthy",
                                    backend=b.label())] = 0 if b.broken else 1
                g[profiling.labeled("route.backend_inflight",
                                    backend=b.label())] = b.inflight
                for mid, gen in ((b.last_health or {}).get("models")
                                 or {}).items():
                    g[profiling.labeled("route.model_generation",
                                        backend=b.label(),
                                        model=mid)] = gen
        return g

    def metrics_text(self) -> str:
        return telemetry.prometheus_text(self._gauges())

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "RouterServer":
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="lgbt-route-http", daemon=True)
        t.start()
        self._threads.append(t)
        if self.health_interval_s > 0:
            h = threading.Thread(target=self._health_loop,
                                 name="lgbt-route-health", daemon=True)
            h.start()
            self._threads.append(h)
        log.info(f"routing on http://{self.host}:{self.port} over "
                 f"{len(self.ring.backends)} backends "
                 f"({', '.join(self.ring.backends)})")
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.close_client_connections()
        self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def router_from_config(cfg: Config) -> RouterServer:
    """Build (not start) a RouterServer from CLI/config parameters."""
    backends, overrides = parse_route_backends(cfg.route_backends)
    if not backends:
        raise LightGBMError("task=route needs a backend fleet: set "
                            "route_backends=host:port,... "
                            "(model_id=host:port entries pin placement)")
    return RouterServer(
        backends, overrides, host=cfg.serve_host, port=cfg.route_port,
        health_interval_ms=cfg.route_health_interval_ms,
        backend_timeout_ms=cfg.route_backend_timeout_ms,
        max_inflight=cfg.route_max_inflight,
        failure_threshold=cfg.replica_failure_threshold,
        group_spread=cfg.route_group_spread)


def route_from_config(cfg: Config) -> None:
    """Blocking ``task=route`` entry: route until SIGINT/SIGTERM."""
    import signal

    router = router_from_config(cfg)
    done = threading.Event()

    def _on_term(_signum, _frame):
        done.set()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass
    with router:
        try:
            done.wait()
        except KeyboardInterrupt:
            pass
    log.info("routing stopped")
