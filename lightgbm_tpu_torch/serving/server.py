"""Stdlib-only JSON-lines HTTP scoring endpoint.

Port of lightgbm_tpu/serving/server.py.  Endpoints:
- ``POST /predict`` — body is JSON lines, one row per line: a JSON array
  of feature values, or ``{"features": [...]}``.  A single JSON object
  ``{"rows": [[...], ...]}`` is also accepted.  Response is JSON lines,
  one prediction per input row (a number, or an array for multiclass).
  ``?raw_score=1`` returns raw margins.  On a multi-tenant catalog
  (docs/serving.md "Multi-tenant catalog") the request routes by model
  id — ``?model=<id>`` query param, ``"model"`` object-body field, or
  ``X-Model-Id`` header; no id = the default tenant (the single-model
  contract), an unknown id = 404.  The response names the tenant that
  scored it (``X-Model-Id``) and its generation
  (``X-Model-Generation``).  A trace id rides in via the
  ``X-Trace-Id`` header or a ``"trace_id"`` field in the object body
  (one is generated when telemetry is on and none arrives); the
  response echoes it as ``X-Trace-Id``, and the request's whole path —
  ingress span → batcher dispatch → replica execution — shares it
  (docs/Observability.md).
- ``GET /healthz`` — liveness + active model generation.
- ``GET /stats`` — request/row/batch counters, prepared-entry cache
  hits/misses, latency percentiles, queue depth, swap history, the
  profiling phase totals, and the ``process`` block (uptime, RSS, device
  backend/devices, version, telemetry config).
- ``GET /metrics`` — Prometheus text exposition of the profiling
  registry + serve gauges (telemetry.prometheus_text).

Requests flow HTTP handler → MicroBatcher → PredictorRuntime, with
ModelRegistry hot-swapping generations underneath.  The entry points
are `PredictionServer`, `server_from_config` and `serve_from_config`,
which ``python -m lightgbm_tpu_torch task=serve`` runs (application.py).
"""
from __future__ import annotations

import json
import re
import threading
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler
from typing import Optional, Tuple

import numpy as np

from .. import log, profiling, telemetry
from ..diagnostics import locksan, sanitize
from ..httpd import SeveringHTTPServer
from ..config import MODEL_ID_RE, Config, parse_serve_models
from ..log import LightGBMError
from .batcher import ServerOverloadedError
from .catalog import ModelCatalog, UnknownModelError
from .registry import ModelRegistry
from .runtime import NoHealthyReplicaError


def _parse_predict_body(body: bytes) -> Tuple[np.ndarray, Optional[str],
                                              Optional[str]]:
    """Rows plus the optional ``trace_id`` and ``model`` fields of the
    object form (the body-level model id routes multi-tenant catalogs;
    JSON-lines bodies route via the query param / X-Model-Id header)."""
    text = body.decode("utf-8").strip()
    if not text:
        raise ValueError("empty request body")
    obj = None
    trace_id: Optional[str] = None
    model_id: Optional[str] = None
    if text.startswith("{"):
        try:                                 # whole-body object form,
            obj = json.loads(text)           # pretty-printed or not
        except json.JSONDecodeError:
            obj = None                       # fall through to JSON lines
    if obj is not None:
        tid = obj.get("trace_id")
        if tid:
            trace_id = str(tid)
        mid = obj.get("model")
        if mid:
            model_id = str(mid)
        if "rows" in obj:
            rows = obj["rows"]
        elif "features" in obj:
            rows = [obj["features"]]
        else:
            raise ValueError('object body needs "rows" or "features"')
    else:
        rows = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            rows.append(item["features"] if isinstance(item, dict) else item)
    X = np.asarray(rows, dtype=np.float64)
    if X.ndim != 2:
        raise ValueError("rows must all have the same feature count")
    return X, trace_id, model_id


# client-supplied trace ids must be header-safe and bounded before they
# are echoed or persisted (see do_POST)
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")


class _Handler(BaseHTTPRequestHandler):
    server_version = "lightgbm-tpu-torch-serve"
    protocol_version = "HTTP/1.1"
    # response headers + payload leave in separate small writes; with
    # Nagle on, that write-write pattern can stall a whole delayed-ACK
    # period (~40ms) per request at the tail — TCP_NODELAY is table
    # stakes for a latency-gated scoring endpoint
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):       # route per-request chatter
        log.debug(f"http {fmt % args}")      # away from stderr

    def _respond(self, code: int, payload: bytes,
                 content_type: str = "application/json",
                 headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _respond_json(self, code: int, obj,
                      headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        self._respond(code, (json.dumps(obj) + "\n").encode(),
                      headers=headers)

    def do_GET(self):
        srv: "PredictionServer" = self.server.prediction_server
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            # liveness PLUS swap freshness: live generations per tenant,
            # the published generation each model's .meta.json sidecar
            # names on disk, and the tenants whose on-disk model no
            # longer matches the loaded signature ("stale" — a pending
            # or refused swap).  A router tier's health probe reads
            # these to tell a partially-swapped backend from a healthy
            # one.
            models, published, stale = {}, {}, []
            for mid in srv.catalog.ids():
                reg = srv.catalog.get(mid).registry
                models[mid] = reg.generation
                meta = srv._read_json_sidecar(
                    reg.model_path + ".meta.json", "online meta")
                published[mid] = (meta or {}).get("generation")
                if reg.pending_publish():
                    stale.append(mid)
            self._respond_json(200, {
                "status": "ok",
                "generation": srv.registry.generation,
                "models": models,
                "published": published,
                "stale": stale,
                # co-stack group count: the router's health sweep
                # surfaces per-backend executable-sharing at /stats
                "groups": len(srv.catalog._groups),
                # per-tenant co-stack compatibility keys: the router's
                # co-stack-aware placement hashes THESE (not tenant
                # ids) so same-key tenants land on one backend and
                # actually group (docs/Router.md)
                "group_keys": srv.catalog.group_keys()})
        elif path == "/stats":
            self._respond_json(200, srv.stats())
        elif path == "/metrics":
            # Prometheus text exposition; the scrape drains any pending
            # deferred device counters (it pays the sync, by contract)
            self._respond(200, srv.metrics_text().encode(),
                          content_type="text/plain; version=0.0.4; "
                                       "charset=utf-8")
        else:
            self._respond_json(404, {"error": f"unknown path {path}"})

    def do_POST(self):
        srv: "PredictionServer" = self.server.prediction_server
        # drain the body FIRST: keep-alive (HTTP/1.1) would otherwise
        # parse leftover body bytes as the connection's next request
        # line after an early 404/400
        if "Content-Length" not in self.headers:
            self.close_connection = True     # unknown body length
            body = b""
        else:
            body = self.rfile.read(int(self.headers["Content-Length"]))
        path, _, query = self.path.partition("?")
        if path != "/predict":
            self._respond_json(404, {"error": f"unknown path {path}"})
            return
        trace_id = None
        try:
            from urllib.parse import parse_qs
            X, body_trace, body_model = _parse_predict_body(body)
            # trace ingress: header first, then the body field; with
            # telemetry on and neither present, this server MINTS the id
            # so the request is traceable end-to-end regardless of the
            # client.  Ids are VALIDATED at ingress: the body field is
            # attacker-shaped bytes echoed into the X-Trace-Id response
            # header (CR/LF there is header injection) and written into
            # spans/the traffic log — a malformed id is dropped, not
            # propagated.
            raw_tid = self.headers.get("X-Trace-Id") or body_trace
            trace_id = (raw_tid if raw_tid is not None
                        and _TRACE_ID_RE.match(raw_tid) else None)
            if trace_id is None and telemetry.enabled():
                trace_id = telemetry.new_trace_id()
            qs = parse_qs(query)
            raw = (qs["raw_score"][0] in ("1", "true")
                   if "raw_score" in qs else srv.default_raw)
            kind = "raw" if raw else "value"
            # model routing (multi-tenant catalog): query param > body
            # field > X-Model-Id header; absent = the default tenant.
            # Validated like trace ids — the id is echoed into a
            # response header and labels the per-model metric series.
            raw_mid = (qs["model"][0] if "model" in qs else None) \
                or body_model or self.headers.get("X-Model-Id")
            if raw_mid is not None and not MODEL_ID_RE.match(raw_mid):
                self._respond_json(400, {"error": (
                    "malformed model id (must match "
                    "[A-Za-z0-9._-]{1,64})")})
                return
            tenant = srv.catalog.get(raw_mid)
            model_id = tenant.model_id
            with telemetry.span("serve.request", trace_id=trace_id,
                                rows=int(X.shape[0]), kind=kind,
                                model=model_id) as sp:
                _tenant, fut = srv.catalog.submit(
                    X, kind=kind, model_id=model_id, trace_id=trace_id,
                    parent_id=sp.span_id)
                preds = fut.result(timeout=srv.request_timeout_s)
                # the generation that actually scored this batch
                # (pinned by the flusher), not whatever is live at
                # response time
                generation = getattr(fut, "generation",
                                     tenant.registry.generation)
                sp.set(generation=generation)
        except UnknownModelError as e:
            self._respond_json(404, {"error": str(e)})
            return
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._respond_json(400, {"error": str(e)})
            return
        except _FutureTimeout:               # serve_request_timeout_ms
            profiling.count("serve.timeouts")
            self._respond_json(504, {"error": (
                "request timed out after "
                f"{srv.request_timeout_s * 1e3:g} ms "
                "(serve_request_timeout_ms); the batch may still be "
                "scoring — retry with backoff")})
            return
        except (ServerOverloadedError, NoHealthyReplicaError) as e:
            # shed load: admission control or a fully circuit-broken
            # fleet — 503 tells the client to retry, unlike a raw 500,
            # and Retry-After paces router- and client-level backoff so
            # a recovering fleet is not hammered flat
            self._respond_json(503, {"error": str(e)},
                               headers=(("Retry-After", "1"),))
            return
        except LightGBMError as e:
            self._respond_json(400, {"error": str(e)})
            return
        except Exception as e:               # scoring/internal failure
            self._respond_json(500, {"error": str(e)})
            return
        lines = "".join(
            json.dumps(p.tolist() if isinstance(p, np.ndarray) else float(p))
            + "\n" for p in preds)
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonlines")
        self.send_header("X-Model-Generation", str(generation))
        self.send_header("X-Model-Id", model_id)
        if trace_id:
            self.send_header("X-Trace-Id", trace_id)
        out = lines.encode()
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)


class PredictionServer:
    """HTTP server + model catalog + model-poll thread, with clean
    teardown (context manager) so tests never leak a listener.

    Accepts either a single `ModelRegistry` (wrapped as a one-tenant
    catalog — the pre-catalog contract, bit-for-bit) or an explicit
    `ModelCatalog` for multi-tenant serving.  Each tenant owns its
    batcher (one flusher per predictor replica — continuous batching),
    admission budget, and swap/canary machinery."""

    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 catalog: Optional[ModelCatalog] = None,
                 host: str = "127.0.0.1",
                 port: int = 0, max_batch_rows: int = 4096,
                 flush_deadline_ms: float = 5.0,
                 model_poll_seconds: float = 10.0,
                 default_raw: bool = False, max_pending_rows: int = 0,
                 request_timeout_ms: float = 120000.0):
        if (registry is None) == (catalog is None):
            raise ValueError("PredictionServer needs exactly one of "
                             "registry= or catalog=")
        if catalog is None:
            catalog = ModelCatalog.from_registry(
                registry, max_batch_rows=max_batch_rows,
                flush_deadline_ms=flush_deadline_ms,
                max_pending_rows=max_pending_rows)
        self.catalog = catalog
        self.default_raw = default_raw
        self.model_poll_seconds = float(model_poll_seconds)
        # /predict waiters give up (HTTP 504) after this long; the
        # Config key is serve_request_timeout_ms
        self.request_timeout_s = max(float(request_timeout_ms), 1.0) / 1e3
        self._httpd = SeveringHTTPServer((host, port), _Handler)
        self._httpd.prediction_server = self
        self.host, self.port = self._httpd.server_address[:2]
        self._stop = threading.Event()
        self._threads = []

    # the single-model attribute surface (tests, benches, operators'
    # scripts) stays: `registry`/`batcher` are the DEFAULT tenant's
    @property
    def registry(self) -> ModelRegistry:
        return self.catalog.default().registry

    @property
    def batcher(self):
        return self.catalog.default().batcher

    @staticmethod
    def _read_json_sidecar(path: str, what: str):
        """Load an optional JSON sidecar.  Missing is normal (None); a
        file that EXISTS but does not parse is an operator-relevant
        failure — logged with the exception class/message and counted,
        never silently swallowed."""
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            profiling.count("registry/meta_failures")
            log.warning(f"unreadable {what} sidecar {path} "
                        f"({type(e).__name__}: {e})")
            return None

    @classmethod
    def _model_meta(cls, model_path: str):
        """The online trainer's ``<model>.meta.json`` sidecar (generation
        provenance: refresh mode, rows, publish time) merged with its
        ``.state.json`` daemon state (traffic offset/skip counters, last
        refresh outcome) under ``daemon`` — or None when the model is
        not published by an online loop."""
        meta = cls._read_json_sidecar(model_path + ".meta.json",
                                      "online meta")
        state = cls._read_json_sidecar(model_path + ".state.json",
                                       "online daemon state")
        if state is not None:
            meta = dict(meta or {})
            meta["daemon"] = state
        return meta

    def _serve_gauges(self) -> dict:
        """Live fleet gauges for the /metrics exposition — the state a
        counter cannot carry (current queue depth, healthy replicas,
        the generation in service).  The unlabeled gauges describe the
        DEFAULT tenant (the single-model contract); the catalog's
        per-model labeled series ride alongside."""
        runtime = self.registry.current()
        g = {
            "serve.queue_depth": self.batcher.queue_depth,
            "serve.pending_rows_cap": self.batcher.max_pending_rows,
            "serve.batch_workers": self.batcher.workers,
            "serve.replicas": getattr(runtime, "replica_count", 1),
            "serve.healthy_replicas": (runtime.healthy_count()
                                       if hasattr(runtime, "healthy_count")
                                       else 1),
            "serve.model_generation": self.registry.generation,
            "serve.swaps": self.registry.swaps,
        }
        g.update(self.catalog.gauges())
        return g

    def metrics_text(self) -> str:
        return telemetry.prometheus_text(self._serve_gauges())

    def stats(self) -> dict:
        """The operator view.  Top-level fields keep describing the
        DEFAULT tenant plus the fleet-wide counters (the pre-catalog
        contract); the ``models`` block carries per-tenant SLO
        accounting (requests/rows/p99/queue/rejections), swap + canary
        state, and executable-cache residency."""
        runtime = self.registry.current()
        return {
            "generation": self.registry.generation,
            "default_model": self.catalog.default_id,
            "models": self.catalog.tenant_stats(),
            # cross-model co-stack groups (docs/serving.md "Cross-model
            # batching"): which tenants share one compiled executable,
            # restack/compile churn, shared-fleet health
            "groups": self.catalog.group_stats(),
            # uptime / RSS / backend / version / telemetry config — the
            # operator's "which process is this" block
            "process": telemetry.process_info(),
            "model_path": self.registry.model_path,
            # generation metadata an online trainer published beside
            # the model (the JAX package's online/trainer.py), if any
            "online": self._model_meta(self.registry.model_path),
            "requests": profiling.counter_value("serve.requests"),
            "rows": profiling.counter_value("serve.rows"),
            "batches": profiling.counter_value("serve.batches"),
            "queue_depth": self.batcher.queue_depth,
            "cache_hits": profiling.counter_value("serve.cache_hit"),
            "cache_misses": profiling.counter_value("serve.cache_miss"),
            "compile_seconds": profiling.counter_value(
                "serve.compile_seconds"),
            "generation_cache": {
                "hits": runtime.cache_hits,
                "misses": runtime.cache_misses,
                "buckets": [list(k) for k in runtime.buckets_compiled()],
            },
            # the fleet view: replica count, per-replica dispatch
            # counters (least-loaded balance evidence), kernel in use,
            # and per-replica circuit-breaker health + failover counters
            "replicas": {
                "count": getattr(runtime, "replica_count", 1),
                "healthy": (runtime.healthy_count()
                            if hasattr(runtime, "healthy_count") else 1),
                "dispatches": (runtime.replica_dispatches()
                               if hasattr(runtime, "replica_dispatches")
                               else []),
                "health": (runtime.replica_health()
                           if hasattr(runtime, "replica_health") else []),
                "chunk_retries": getattr(runtime, "chunk_retries", 0),
                "broken_total": profiling.counter_value(
                    profiling.SERVE_REPLICA_BROKEN),
                "readmitted_total": profiling.counter_value(
                    profiling.SERVE_REPLICA_READMITTED),
                "predict_kernel": getattr(runtime, "predict_kernel",
                                          "walk"),
                # the request-path kernel variant actually in service
                # ("binned" = ingress quantization + integer traversal)
                "serve_quantize": getattr(runtime, "variant", "raw"),
            },
            "quantize_bytes_in": profiling.counter_value(
                profiling.SERVE_QUANTIZE_BYTES_IN),
            "binned_requests": profiling.counter_value(
                profiling.SERVE_BINNED_REQUESTS),
            "batch_workers": self.batcher.workers,
            "rejected": self.batcher.rejected,
            "timeouts": profiling.counter_value("serve.timeouts"),
            "latency_ms": profiling.summary("serve.latency_ms"),
            "queue_depth_seen": profiling.summary("serve.queue_depth"),
            "swaps": self.registry.swaps,
            "swap_failures": self.registry.swap_failures,
            "last_swap_error": self.registry.last_swap_error,
            "phase_totals_s": {k: round(v, 6)
                               for k, v in profiling.timings().items()
                               if k.startswith("serve/")},
            # LockSanitizer verdict (diagnostics/locksan.py): armed
            # under LIGHTGBM_TPU_LOCKSAN/BENCH_SANITIZE, lock_cycles
            # MUST stay 0 — a nonzero here is a latent ABBA deadlock
            # witnessed on this process's actual acquisitions
            "locksan": {
                "armed": locksan.armed(),
                "lock_acquires": profiling.counter_value(
                    sanitize.LOCK_ACQUIRES),
                "lock_waits": profiling.counter_value(
                    sanitize.LOCK_WAITS),
                "lock_cycles": profiling.counter_value(
                    sanitize.LOCK_CYCLES),
                "lock_hold_ms": profiling.summary(sanitize.LOCK_HOLD_MS),
                "cycles": locksan.cycles()[:4],
            },
        }

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "PredictionServer":
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="lgbt-serve-http", daemon=True)
        t.start()
        self._threads.append(t)
        if self.model_poll_seconds > 0:
            p = threading.Thread(target=self._poll_loop,
                                 name="lgbt-serve-poll", daemon=True)
            p.start()
            self._threads.append(p)
        log.info(f"serving on http://{self.host}:{self.port} "
                 f"(generation {self.registry.generation})")
        return self

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.model_poll_seconds):
            try:
                self.catalog.poll_once()     # every tenant's path
            except Exception as e:           # never kill the poll loop
                log.warning(f"model poll failed: {e}")

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        # sever established keep-alive connections so an in-process
        # stop looks like a process kill to clients holding pooled
        # connections (the router's breaker contract depends on it)
        self._httpd.close_client_connections()
        self._httpd.server_close()
        self.catalog.close()
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self) -> "PredictionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def catalog_models_from_config(cfg: Config) -> "dict":
    """The ``{model id: path}`` map a config describes: `serve_models`
    entries, plus `input_model` as the ``default`` tenant when set
    (requests that name no model land there — the single-model
    contract).  With only `serve_models`, the FIRST entry is the
    default."""
    models = parse_serve_models(cfg.serve_models)
    if cfg.input_model:
        dup = models.get("default")
        if dup is not None and dup != cfg.input_model:
            # refusing beats silently serving the wrong file: both
            # sources claim the default tenant with different models
            raise LightGBMError(
                "input_model and a serve_models entry both name the "
                f"'default' tenant with different paths "
                f"({cfg.input_model!r} vs {dup!r}); rename the entry "
                "or drop input_model")
        merged = {"default": cfg.input_model}
        for mid, path in models.items():
            if mid != "default":
                merged[mid] = path
        return merged
    if not models:
        raise LightGBMError("task=serve needs a model: set "
                            "input_model=<file> and/or "
                            "serve_models=id=path,...")
    return models


def server_from_config(cfg: Config) -> PredictionServer:
    """Build (not start) a PredictionServer from CLI/config parameters:
    one catalog tenant per `serve_models` entry (plus `input_model` as
    the default tenant), shared serving knobs across tenants."""
    models = catalog_models_from_config(cfg)
    catalog = ModelCatalog(
        models, params={"verbose": cfg.verbose,
                        "device_type": cfg.device_type},
        default_id=next(iter(models)),
        cache_budget_mb=cfg.serve_cache_budget_mb,
        num_iteration=cfg.num_iteration_predict,
        max_batch_rows=cfg.max_batch_rows,
        min_bucket_rows=cfg.min_bucket_rows,
        flush_deadline_ms=cfg.flush_deadline_ms,
        max_pending_rows=cfg.max_pending_rows,
        predict_kernel=cfg.predict_kernel,
        replicas=cfg.serve_replicas,
        failure_threshold=cfg.replica_failure_threshold,
        serve_quantize=cfg.serve_quantize,
        shadow_fraction=cfg.serve_shadow_fraction,
        shadow_requests=cfg.serve_shadow_requests,
        shadow_max_divergence=cfg.serve_shadow_max_divergence,
        costack=cfg.serve_costack,
        costack_kernel=cfg.costack_kernel,
        costack_segment_trees=cfg.costack_segment_trees)
    return PredictionServer(
        catalog=catalog, host=cfg.serve_host, port=cfg.serve_port,
        model_poll_seconds=cfg.model_poll_seconds,
        request_timeout_ms=cfg.serve_request_timeout_ms,
        default_raw=cfg.is_predict_raw_score)


def serve_from_config(cfg: Config) -> None:
    """Blocking ``task=serve`` entry: serve until SIGINT/SIGTERM."""
    import signal

    server = server_from_config(cfg)
    server.catalog.install_sighup()
    done = threading.Event()

    def _on_term(_signum, _frame):
        done.set()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass
    with server:
        try:
            done.wait()
        except KeyboardInterrupt:
            pass
    log.info("serving stopped")
