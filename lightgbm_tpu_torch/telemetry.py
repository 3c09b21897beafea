"""Telemetry: structured span tracing and Prometheus exposition.

Port of lightgbm_tpu/telemetry.py.  Standard library only, apart from
the device gauges, which ask torch.cuda.

- **Structured spans** (`span(name, **attrs)`): a lock-guarded context
  manager emitting one JSON line per span to the configured sink —
  trace-id/span-id/parent-id, monotonic-clock durations, wall-clock
  start timestamps, the process role and thread name.  Nesting is
  tracked per thread; cross-thread hops carry the ids explicitly
  (``trace_id=`` / ``parent_id=`` kwargs, `trace_context`,
  `call_in_context`), which is how one `/predict` request's trace id
  rides MicroBatcher → replica dispatch.
- **Point events** (`event(name, **attrs)`): zero-duration records in
  the same stream (breaker transitions, shadow-canary verdicts).
- **Prometheus text exposition** (`prometheus_text()`): renders the
  `profiling` registry — monotone counters (every canonical constant
  always present), `observe()` reservoirs as summary quantiles — plus
  live gauges (process RSS/uptime, device memory, caller-supplied serve
  gauges).  One scrape takes ONE locked snapshot of the registry, and
  pending `count_deferred` device totals are drained at the scrape.
  `MetricsServer` serves it standalone on ``metrics_port``; the serving
  server mounts the same text at its own ``/metrics``.

Cost contract: with no sink configured, `span()` returns ONE shared
no-op singleton (no allocation) and `event()` returns after a single
cached boolean check — nothing is formatted, nothing is written.
Enabled, every record is host-side formatting plus one locked file
append: no device op and no device read.  Enabling telemetry also
forces the TIMETAG phase accumulators on (`profiling.force_phases`).

Configuration: ``telemetry_path`` Config key or the
``LIGHTGBM_TPU_TELEMETRY`` env var; ``metrics_port``.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import uuid
from typing import Callable, Dict, Iterator, Optional, Tuple

ENV_VAR = "LIGHTGBM_TPU_TELEMETRY"

_lock = threading.Lock()          # guards the sink (writes + swap)
_enabled = False                  # the ONE cached check of the off path
_path: Optional[str] = None
_sink = None                      # open append handle, under _lock
_process = "main"                 # role stamped into every record
_START_UNIX = time.time()
_START_MONO = time.monotonic()

_tls = threading.local()          # per-thread span context stack


# -- identity -----------------------------------------------------------


def new_trace_id() -> str:
    """A fresh 32-hex trace id (random; never derived from the clock)."""
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def _ctx_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current() -> Optional[Tuple[str, Optional[str]]]:
    """The calling thread's (trace_id, span_id) context, or None.  Hand
    it across threads with `call_in_context` / `trace_context` — thread
    locals do not follow work into executor pools."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def current_trace_id() -> Optional[str]:
    ctx = current()
    return ctx[0] if ctx else None


def current_span_id() -> Optional[str]:
    ctx = current()
    return ctx[1] if ctx else None


# -- enable / disable ---------------------------------------------------


def enabled() -> bool:
    return _enabled


def configure(path: str, process: Optional[str] = None) -> None:
    """Point the span sink at ``path`` (JSONL, append) and enable
    tracing.  Also forces the TIMETAG phase accumulators on so
    per-iteration phase wall-clock flows without the env switch."""
    global _enabled, _path, _sink
    if process is not None:
        set_process(process)
    with _lock:
        if _sink is None or _path != path:
            if _sink is not None:
                try:
                    _sink.close()
                except OSError:
                    pass
            _sink = open(path, "a", encoding="utf-8")
            _path = path
        # same-path reconfigure still re-enables: a sink write failure
        # degrades to disabled (_write), and an explicit configure()
        # must be able to bring telemetry back
        _enabled = True
    from . import profiling
    profiling.force_phases(True)


def set_process(role: str) -> None:
    """Stamp a process role (train/serve/online/...) into every record
    — the pid lane of the chrome-trace view."""
    global _process
    _process = str(role)


def reset() -> None:
    """Disable tracing and close the sink (tests call this so one
    test's telemetry config can never leak into the next)."""
    global _enabled, _path, _sink
    with _lock:
        if _sink is not None:
            try:
                _sink.close()
            except OSError:
                pass
        _sink = None
        _path = None
        _enabled = False
    from . import profiling
    profiling.force_phases(False)


def config_in_effect() -> Dict[str, object]:
    """What the /stats ``process`` block reports."""
    return {"enabled": _enabled, "path": _path, "process": _process}


# -- record sink --------------------------------------------------------


def _write(record: dict) -> None:
    global _enabled
    line = json.dumps(record, separators=(",", ":"), default=str)
    with _lock:
        sink = _sink
        if sink is None:
            return
        try:
            sink.write(line + "\n")
            sink.flush()
        except (OSError, ValueError):
            # a dead sink (disk full, closed fd) must degrade to
            # disabled, never take the serving/training loop down
            _enabled = False


# -- spans --------------------------------------------------------------


class _NoopSpan:
    """The disabled path: ONE module-level instance, handed out for
    every `span()` call — no allocation, no formatting, no file."""
    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_t0", "_ts", "status", "error")

    def __init__(self, name: str, trace_id: Optional[str],
                 parent_id: Optional[str], attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.span_id = _new_span_id()
        self.status = "ok"
        self.error = None

    def set(self, **attrs) -> None:
        """Attach attrs discovered mid-span (e.g. the resumed
        iteration, the swapped generation)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        ctx = current()
        if self.trace_id is None:
            self.trace_id = ctx[0] if ctx else new_trace_id()
        if self.parent_id is None and ctx is not None:
            self.parent_id = ctx[1]
        _ctx_stack().append((self.trace_id, self.span_id))
        self._ts = time.time()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ms = (time.monotonic() - self._t0) * 1e3
        stack = _ctx_stack()
        if stack and stack[-1][1] == self.span_id:
            stack.pop()
        if exc is not None:
            self.status = "error"
            self.error = f"{exc_type.__name__}: {exc}"
        rec = {"kind": "span", "name": self.name, "trace": self.trace_id,
               "span": self.span_id, "parent": self.parent_id,
               "proc": _process,
               "thread": threading.current_thread().name,
               "ts": round(self._ts, 6), "dur_ms": round(dur_ms, 3),
               "status": self.status}
        if self.error:
            rec["error"] = self.error
        if self.attrs:
            rec["attrs"] = self.attrs
        _write(rec)
        return False


def span(name: str, *, trace_id: Optional[str] = None,
         parent_id: Optional[str] = None, **attrs):
    """A traced operation.  Use as a context manager::

        with telemetry.span("serve.request", rows=n) as sp:
            ...
            sp.set(generation=g)

    Trace id resolves: explicit ``trace_id=`` kwarg > the thread's
    current context > a fresh id.  Parent resolves: explicit
    ``parent_id=`` > the thread's current span.  Disabled: returns the
    shared no-op singleton (one cached check, zero allocation)."""
    if not _enabled:
        return _NOOP
    return _Span(name, trace_id, parent_id, attrs)


def event(name: str, *, trace_id: Optional[str] = None,
          parent_id: Optional[str] = None, **attrs) -> None:
    """A zero-duration record in the span stream (iteration records,
    breaker transitions, fault firings)."""
    if not _enabled:
        return
    ctx = current()
    if trace_id is None:
        trace_id = ctx[0] if ctx else new_trace_id()
    if parent_id is None and ctx is not None:
        parent_id = ctx[1]
    rec = {"kind": "event", "name": name, "trace": trace_id,
           "span": _new_span_id(), "parent": parent_id, "proc": _process,
           "thread": threading.current_thread().name,
           "ts": round(time.time(), 6), "dur_ms": 0.0}
    if attrs:
        rec["attrs"] = attrs
    _write(rec)


class _TraceContext:
    """Adopt an explicit (trace_id, span_id) as the thread's context —
    the cross-thread/cross-process propagation primitive."""
    __slots__ = ("_ctx",)

    def __init__(self, trace_id: str, span_id: Optional[str] = None):
        self._ctx = (trace_id, span_id)

    def __enter__(self):
        _ctx_stack().append(self._ctx)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _ctx_stack()
        if stack and stack[-1] is self._ctx:
            stack.pop()
        return False


def trace_context(trace_id: str, span_id: Optional[str] = None):
    """``with trace_context(tid): ...`` — spans inside inherit ``tid``."""
    if not _enabled or trace_id is None:
        return _NOOP
    return _TraceContext(trace_id, span_id)


def call_in_context(ctx: Optional[Tuple[str, Optional[str]]],
                    fn: Callable, *args, **kwargs):
    """Run ``fn`` under a context captured on another thread with
    `current()` (executor-pool workers do not inherit thread locals)."""
    if ctx is None or not _enabled:
        return fn(*args, **kwargs)
    with _TraceContext(ctx[0], ctx[1]):
        return fn(*args, **kwargs)


# -- Prometheus text exposition -----------------------------------------

_METRIC_PREFIX = "lgbt_"
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_]")
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))
# a labeled registry key (profiling.labeled): base{label="value",...}
_LABELED_KEY = re.compile(r"^(?P<base>[^{]+)\{(?P<labels>.*)\}$")


def sanitize_metric_name(name: str) -> str:
    """``serve.chunk_retries`` → ``lgbt_serve_chunk_retries`` (both the
    ``.`` and ``/`` spellings in the registry collapse to ``_``)."""
    s = _BAD_CHARS.sub("_", name).strip("_")
    s = re.sub(r"__+", "_", s)
    return _METRIC_PREFIX + s


def _split_labels(name: str) -> Tuple[str, str]:
    """Split a registry key into (base name, rendered label body).

    ``serve.requests{model="de"}`` → ``("serve.requests",
    'model="de"')``; label NAMES are sanitized to the Prometheus
    charset and VALUES get quote/backslash escaping, so one malformed
    key can never corrupt the whole exposition."""
    m = _LABELED_KEY.match(name)
    if m is None:
        return name, ""
    parts = []
    for pair in m.group("labels").split(","):
        k, _, v = pair.partition("=")
        v = v.strip().strip('"')
        v = v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
        k = _BAD_CHARS.sub("_", k.strip()) or "label"
        parts.append(f'{k}="{v}"')
    return m.group("base"), ",".join(parts)


def _families(values: Dict[str, float]) -> "Dict[str, list]":
    """Group registry entries into metric families: {base name:
    [(label body, value), ...]} with unlabeled series first, so HELP
    and TYPE are emitted once per FAMILY even when a name exports both
    a fleet-wide series and per-model labeled series."""
    fams: Dict[str, list] = {}
    for name in values:
        base, labels = _split_labels(name)
        fams.setdefault(base, []).append((labels, values[name]))
    for series in fams.values():
        series.sort(key=lambda s: (s[0] != "", s[0]))
    return fams


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _current_rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def _peak_rss_bytes() -> Optional[int]:
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, OSError):
        return None


def _device_gauges() -> Dict[str, float]:
    """Device-memory gauges of the current CUDA device (absent on a
    host without one).  A scrape must never raise."""
    out: Dict[str, float] = {}
    try:
        import torch
        if not torch.cuda.is_available():
            return out
        out["process.device_count"] = float(torch.cuda.device_count())
        out["device.bytes_in_use"] = float(torch.cuda.memory_allocated())
        out["device.peak_bytes_in_use"] = float(
            torch.cuda.max_memory_allocated())
        free, total = torch.cuda.mem_get_info()
        out["device.bytes_limit"] = float(total)
    except Exception:  # noqa: BLE001 — a scrape must never raise
        pass
    return out


def process_gauges() -> Dict[str, float]:
    g: Dict[str, float] = {
        "process.uptime_seconds": round(time.monotonic() - _START_MONO, 3),
        "process.start_time_seconds": round(_START_UNIX, 3),
    }
    rss = _current_rss_bytes()
    if rss is not None:
        g["process.resident_memory_bytes"] = float(rss)
    peak = _peak_rss_bytes()
    if peak is not None:
        g["process.peak_resident_memory_bytes"] = float(peak)
    g.update(_device_gauges())
    return g


def prometheus_text(gauges: Optional[Dict[str, float]] = None) -> str:
    """The /metrics payload (Prometheus text exposition format 0.0.4).

    One locked snapshot of the profiling registry (counters incl. every
    canonical constant, reservoirs as summary quantiles) + live gauges.
    Pending `count_deferred` device totals drain here — the scrape pays
    the sync, the hot path never does."""
    from . import profiling
    from .diagnostics import sanitize
    counters, summaries = profiling.snapshot()
    for name in profiling.CANONICAL_COUNTERS:
        counters.setdefault(name, 0.0)
    # LockSanitizer counters (diagnostics/locksan.py) are canonical the
    # same way: a scrape always shows lgbt_sanitize_lock_cycles_total,
    # so "0" is an observed verdict, not a missing series
    for name in (sanitize.LOCK_ACQUIRES, sanitize.LOCK_WAITS,
                 sanitize.LOCK_CYCLES):
        counters.setdefault(name, 0.0)
    lines = []
    cfams = _families(counters)
    for base in sorted(cfams):
        m = sanitize_metric_name(base) + "_total"
        lines.append(f"# HELP {m} counter {base!r} (lightgbm_tpu_torch profiling)")
        lines.append(f"# TYPE {m} counter")
        for labels, v in cfams[base]:
            suffix = f"{{{labels}}}" if labels else ""
            lines.append(f"{m}{suffix} {_fmt(max(v, 0.0))}")
    sfams = _families(summaries)
    for base in sorted(sfams):
        m = sanitize_metric_name(base)
        lines.append(f"# HELP {m} summary of {base!r} samples")
        lines.append(f"# TYPE {m} summary")
        for labels, s in sfams[base]:
            for q, key in _QUANTILES:
                if key in s:
                    qlab = (f'{labels},quantile="{q}"' if labels
                            else f'quantile="{q}"')
                    lines.append(f"{m}{{{qlab}}} {_fmt(s[key])}")
            suffix = f"{{{labels}}}" if labels else ""
            lines.append(f"{m}_count{suffix} {_fmt(s.get('count', 0))}")
    merged = process_gauges()
    merged.update(gauges or {})
    gfams = _families({k: v for k, v in merged.items() if v is not None})
    for base in sorted(gfams):
        m = sanitize_metric_name(base)
        lines.append(f"# HELP {m} gauge {base!r}")
        lines.append(f"# TYPE {m} gauge")
        for labels, v in gfams[base]:
            suffix = f"{{{labels}}}" if labels else ""
            lines.append(f"{m}{suffix} {_fmt(v)}")
    return "\n".join(lines) + "\n"


# -- standalone /metrics server (trainer / online daemon) ---------------


class MetricsServer:
    """A stdlib HTTP listener serving `prometheus_text()` at /metrics
    (plus /healthz) — the scrape surface for process roles that have no
    HTTP server of their own (``metrics_port`` Config key).  The
    serving fleet mounts the same payload on its own endpoint
    instead."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 gauges_fn: Optional[Callable[[], Dict[str, float]]] = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.gauges_fn = gauges_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "lightgbm-tpu-metrics"

            def log_message(self, fmt, *args):
                pass                            # scrapes are chatty

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    try:
                        extra = outer.gauges_fn() if outer.gauges_fn else None
                        body = prometheus_text(extra).encode()
                    except Exception as e:  # noqa: BLE001
                        body = f"# scrape failed: {e}\n".encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    body = b'{"status": "ok"}\n'
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="lgbt-metrics", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(port: int, host: str = "127.0.0.1",
                         gauges_fn: Optional[Callable[[], Dict[str, float]]]
                         = None) -> MetricsServer:
    """Build + start a MetricsServer; caller owns ``.close()``."""
    srv = MetricsServer(port, host=host, gauges_fn=gauges_fn).start()
    from . import log
    log.info(f"telemetry: /metrics on http://{srv.host}:{srv.port}")
    return srv


# -- /stats process block ----------------------------------------------


def process_info() -> Dict[str, object]:
    """The /stats ``process`` block: uptime, RSS high-water mark, the
    device backend + kind/count, package version, telemetry config in
    effect."""
    info: Dict[str, object] = {
        "role": _process,
        "uptime_s": round(time.monotonic() - _START_MONO, 3),
        "pid": os.getpid(),
        "version": "unknown",
        "telemetry": config_in_effect(),
    }
    rss = _current_rss_bytes()
    info["rss_mb"] = round(rss / 1e6, 1) if rss is not None else 0.0
    peak = _peak_rss_bytes()
    info["peak_rss_mb"] = round(peak / 1e6, 1) if peak is not None else 0.0
    try:
        import lightgbm_tpu_torch
        info["version"] = lightgbm_tpu_torch.__version__
    except Exception:  # noqa: BLE001 — partial import during bootstrap
        pass
    info.update(_device_info())
    return info


def _device_info() -> Dict[str, object]:
    """backend / device_count / device_kind of the /stats process block:
    the CUDA devices torch sees, or the CPU."""
    try:
        import torch
        if torch.cuda.is_available():
            return {"backend": "cuda",
                    "device_count": torch.cuda.device_count(),
                    "device_kind": torch.cuda.get_device_name(0)}
        return {"backend": "cpu", "device_count": 1, "device_kind": "cpu"}
    except Exception:  # noqa: BLE001 — torch not importable
        return {"backend": "uninitialized", "device_count": 0,
                "device_kind": "none"}


# env bootstrap: LIGHTGBM_TPU_TELEMETRY=<path> enables at import, the
# same pattern as profiling's LIGHTGBM_TPU_TIMETAG switch.  An
# unwritable path degrades to disabled with a warning — an env var must
# never make the package unimportable (the explicit `telemetry_path`
# config key, by contrast, raises: the user asked for a sink that
# cannot exist).
if os.environ.get(ENV_VAR):
    try:
        configure(os.environ[ENV_VAR])
    except OSError as _e:
        import sys as _sys
        print(f"[LightGBM-TPU] [Warning] telemetry disabled: cannot open "
              f"{ENV_VAR}={os.environ[ENV_VAR]!r} ({_e})",
              file=_sys.stderr)
