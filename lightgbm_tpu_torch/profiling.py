"""Phase-bucketed wall-clock tracing, host ranges and the always-on
counters.

Port of lightgbm_tpu/profiling.py (the reference TIMETAG subsystem:
std::chrono accumulators over boosting/bagging/tree/score/metric phases,
gbdt.cpp:20-29,50-60, logged at teardown), plus the always-on counters
and sample reservoirs the serving plane reports at /stats and /metrics.

Every `phase` and `range` opens a host range `lgbt::<name>` (names in
RANGES) that torch.profiler records as a plain host operation, with no
copy on the device's timeline: the boosting phases `boosting` (the
objective's gradients), `bagging`, `tree`, `score`, `metric`; the rounds
learner's `learner.histogram`, `learner.split_search`,
`learner.partition` and `learner.round` (the round loop's own work and
the tree's fetch); a Dataset construct's `dataset.binning` and
`dataset.store`; the serving `serve/execute` and `serve/swap`.  Phase
seconds are host seconds around asynchronous launches: which phase
holds the device idle, or launched a kernel, comes from a device trace
of these ranges (any `torch.profiler.profile` with CPU and CUDA
activities), not from the accumulators.

Enable the phase accumulators with LIGHTGBM_TPU_TIMETAG=1; totals print
at interpreter exit or via `report()`.  `count_deferred` accumulates a
device scalar without a host read; the pending totals come to the host
in one `torch.stack(...).cpu()` on the next read of the counters.
"""
from __future__ import annotations

import atexit
import math
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import nullcontext
from typing import Deque, Dict, Tuple

ENABLED = os.environ.get("LIGHTGBM_TPU_TIMETAG", "0") not in ("0", "", "false")

# telemetry.configure() flips this so the phase accumulators run (and
# feed per-iteration records + /metrics) whenever span tracing is on,
# without requiring the LIGHTGBM_TPU_TIMETAG env switch too
_PHASES_FORCED = False


def force_phases(on: bool = True) -> None:
    """Force the phase accumulators on regardless of the TIMETAG env
    switch (telemetry.configure does; telemetry.reset undoes)."""
    global _PHASES_FORCED
    _PHASES_FORCED = bool(on)

_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)

# Always-on counters and bounded sample reservoirs (the serving layer's
# request/cache/latency metrics flow through these regardless of the
# TIMETAG switch — a production /stats endpoint cannot depend on a debug
# env var).  Guarded by one lock: serving increments from many threads.
_lock = threading.Lock()
_counters: Dict[str, float] = defaultdict(float)
_samples: Dict[str, Deque[float]] = {}
_SAMPLE_CAP = 4096
# one pending device scalar per name (count_deferred accumulates
# DEVICE-side, so an arbitrarily long training run holds exactly one
# live buffer per counter), folded into _counters on read
_deferred: Dict[str, object] = {}

# Canonical robustness counters (docs/Robustness.md), fed through
# count() by the serving fleet's failover machinery and the registry:
#  - REGISTRY_SWAP_FAILURES: hot-swap candidates rejected (corrupt/torn
#    model files, failed warmups) — the old generation kept serving.
#  - serve.replica_failures / serve.replica_broken /
#    serve.replica_readmitted / serve.replica_probes: per-event breaker
#    transitions; serve.chunk_retries counts failed chunks re-run on a
#    healthy replica.  All surfaced at the server's /stats endpoint so
#    silent degradation is an operator-visible signal.
REGISTRY_SWAP_FAILURES = "registry/swap_failures"
SERVE_CHUNK_RETRIES = "serve.chunk_retries"
SERVE_REPLICA_FAILURES = "serve.replica_failures"
SERVE_REPLICA_BROKEN = "serve.replica_broken"
SERVE_REPLICA_READMITTED = "serve.replica_readmitted"
SERVE_REPLICA_PROBES = "serve.replica_probes"

# Canonical binned-inference counters (docs/serving.md "Binned
# inference"), fed through count() by the serving runtime's ingress
# quantization (serve_quantize=binned):
#  - SERVE_QUANTIZE_BYTES_IN: bytes of the quantized uint8/uint16
#    request buffers shipped to the device — ~4x below what the same
#    rows cost as f32, the memory-bandwidth win of fixed-point
#    traversal.
#  - SERVE_BINNED_REQUESTS: predict() calls that ran the binned kernel
#    variant (raw-variant runtimes count nothing here).
SERVE_QUANTIZE_BYTES_IN = "serve/quantize_bytes_in"
SERVE_BINNED_REQUESTS = "serve/binned_requests"

# Canonical multi-tenant catalog counters (docs/serving.md
# "Multi-tenant catalog"), fed through count() by the ModelCatalog's
# LRU budget enforcement and the registries' shadow-canary machinery:
#  - SERVE_CACHE_EVICTIONS: compiled executables dropped to fit the
#    `serve_cache_budget_mb` device-memory budget (the churn metric —
#    an evicted tenant's next request rebuilds).
#  - SERVE_SHADOW_SCORED: requests double-scored on a staged candidate
#    generation (stable answered the client; the candidate's answer
#    only fed the divergence log).
#  - SERVE_SHADOW_ADOPTIONS / SERVE_SHADOW_REJECTIONS: canary verdicts
#    — candidates promoted to stable after `serve_shadow_requests`
#    comparisons vs candidates discarded (divergence over the gate, or
#    a candidate that could not score).
SERVE_CACHE_EVICTIONS = "serve/cache_evictions"
SERVE_SHADOW_SCORED = "serve/shadow_scored"
SERVE_SHADOW_ADOPTIONS = "serve/shadow_adoptions"
SERVE_SHADOW_REJECTIONS = "serve/shadow_rejections"

# Cross-model co-stacked serving (serving/superstack.py,
# docs/serving.md "Cross-model batching"):
#  - SERVE_GROUP_COMPILES: prepared entries (the JAX package's compiled
#    executables, serving/runtime.py) built for a GROUP's shared
#    super-stack (the per-group labeled series rides the same name) —
#    the quantity co-stacking divides by the group size.
#  - SERVE_GROUP_RESTACKS: super-stack rebuilds after a member tenant's
#    hot swap (cache-transplanting restacks included; only restacks
#    whose program changed also show up as group compiles).
#  - SERVE_GROUP_SEGMENT_ROWS / SERVE_GROUP_STACKED_ROWS: mixed-batch
#    rows demuxed through a group executable, split by the RESOLVED
#    costack kernel — segment (per-row tree-segment gather: node math
#    ~1x a solo tenant's) vs stacked (walk-all: ~G x node math where
#    launch overhead hides it).  The per-group labeled series ride the
#    same names; summed they equal the grouped share of serve.rows.
#  - SERVE_GROUP_QUANTIZE_SHARED: rows a binned group quantized ONCE
#    against its members' shared refbin mapper set at ingress instead
#    of once per member job — the host-CPU dedup of the shared ingress
#    quantizer (rows also counted in SERVE_QUANTIZE_BYTES_IN by bytes).
SERVE_GROUP_COMPILES = "serve/group_compiles"
SERVE_GROUP_RESTACKS = "serve/group_restacks"
SERVE_GROUP_SEGMENT_ROWS = "serve/group_segment_rows"
SERVE_GROUP_STACKED_ROWS = "serve/group_stacked_rows"
SERVE_GROUP_QUANTIZE_SHARED = "serve/group_quantize_shared"

# Canonical router-tier counters (router/server.py), fed through count()
# by the router fronting M backend serving processes:
#  - ROUTER_REQUESTS: /predict requests accepted by the router (the
#    per-model and per-backend labeled series ride the same base name).
#  - ROUTER_RETRIES: proxied dispatches that failed at the transport
#    layer and were re-run once on a different healthy backend.
#  - ROUTER_REJECTED: requests shed with 503 — the `route_max_inflight`
#    admission cap, or no healthy backend placeable for the model.
#  - ROUTER_BACKEND_FAILURES / ROUTER_BACKEND_BROKEN /
#    ROUTER_BACKEND_READMITTED / ROUTER_BACKEND_PROBES: per-event
#    transitions of the per-backend circuit breakers.
#  - ROUTER_REHASHES: requests whose placement (override target or
#    ring-home backend) was open-breaker and re-placed onto the next
#    healthy backend clockwise.
ROUTER_REQUESTS = "router/requests"
ROUTER_RETRIES = "router/retries"
ROUTER_REJECTED = "router/rejected"
ROUTER_BACKEND_FAILURES = "router/backend_failures"
ROUTER_BACKEND_BROKEN = "router/backend_broken"
ROUTER_BACKEND_READMITTED = "router/backend_readmitted"
ROUTER_BACKEND_PROBES = "router/backend_probes"
ROUTER_REHASHES = "router/rehashes"

# The learners' tree/* counters (the JAX package's names):
#  - HIST_ROWS_TOUCHED: rows the rounds learner's histogram passes
#    read, summed over passes (N for a masked pass, the live rows of a
#    gathered one).
#  - SPARSE_NNZ_TOUCHED: stored (column, bin) entries its masked passes
#    over the sparse store read, summed over passes; the dense
#    equivalent is rows touched x store columns.
#  - SPARSE_FALLBACKS: times a sparse store materialized its dense
#    [C, N] matrix for a consumer without a sparse path (the labeled
#    series names the consumer); a csr run keeps it at 0.
#  - HIST_EXCHANGE_BYTES: the bytes of a mesh rank's histogram
#    collectives, as sharded/mesh.py counts them: the reduced histogram
#    it keeps a pass (the full [K, C, 3, B] tensor under psum, its
#    column slice under psum_scatter, the voted features' under
#    voting), the root's column 0 where it is reduced alone, and the
#    int8 quantization scales' maxima.
#  - SPLIT_RECORDS_BYTES: a mesh rank's bytes of the best-split
#    records it all_gathers (the psum_scatter exchange's
#    [nd, K, 11] f32 a search, the feature axis's [df, K, 11]; 0 under
#    a data-axis psum).
# On a mesh the row and entry counts are the rank's own passes.
HIST_ROWS_TOUCHED = "tree/hist_rows_touched"
HIST_EXCHANGE_BYTES = "tree/hist_exchange_bytes"
SPLIT_RECORDS_BYTES = "tree/split_records_bytes"
SPARSE_NNZ_TOUCHED = "tree/sparse_nnz_touched"
SPARSE_FALLBACKS = "tree/sparse_fallbacks"

# Every canonical counter constant of this module, in one tuple: the
# Prometheus exposition (telemetry.prometheus_text) seeds each of these
# at 0 so a scrape always covers the full canonical set.
CANONICAL_COUNTERS = (
    HIST_ROWS_TOUCHED, HIST_EXCHANGE_BYTES, SPLIT_RECORDS_BYTES,
    SPARSE_NNZ_TOUCHED, SPARSE_FALLBACKS,
    REGISTRY_SWAP_FAILURES, SERVE_CHUNK_RETRIES, SERVE_REPLICA_FAILURES,
    SERVE_REPLICA_BROKEN, SERVE_REPLICA_READMITTED, SERVE_REPLICA_PROBES,
    SERVE_QUANTIZE_BYTES_IN, SERVE_BINNED_REQUESTS,
    SERVE_CACHE_EVICTIONS, SERVE_SHADOW_SCORED, SERVE_SHADOW_ADOPTIONS,
    SERVE_SHADOW_REJECTIONS, SERVE_GROUP_COMPILES, SERVE_GROUP_RESTACKS,
    SERVE_GROUP_SEGMENT_ROWS, SERVE_GROUP_STACKED_ROWS,
    SERVE_GROUP_QUANTIZE_SHARED,
    ROUTER_REQUESTS, ROUTER_RETRIES, ROUTER_REJECTED,
    ROUTER_BACKEND_FAILURES, ROUTER_BACKEND_BROKEN,
    ROUTER_BACKEND_READMITTED, ROUTER_BACKEND_PROBES, ROUTER_REHASHES,
)


def labeled(name: str, **labels) -> str:
    """Registry key for a LABELED counter/reservoir series.

    ``labeled("serve.requests", model="de")`` returns
    ``serve.requests{model="de"}``, which `telemetry.prometheus_text`
    renders as the Prometheus series
    ``lgbt_serve_requests_total{model="de"}`` — one metric FAMILY with
    one series per label set, instead of a name-mangled counter per
    tenant.  Label values must be identifier-shaped (the multi-tenant
    catalog validates model ids against ``[A-Za-z0-9._-]{1,64}`` before
    they reach here)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


# Every host range the program opens, as `phase` and `range` name them;
# torch.profiler records each as `lgbt::<name>`.
RANGES = (
    "boosting", "bagging", "tree", "score", "metric",
    "learner.histogram", "learner.split_search", "learner.partition",
    "learner.round",
    "dataset.binning", "dataset.store",
    "serve/execute", "serve/swap",
)
RANGE_PREFIX = "lgbt::"
_RANGE_LABELS = {n: RANGE_PREFIX + n for n in RANGES}


def _host_range_type():
    """torch's FUNCTION-scope RecordFunction guard, a private API: when a
    profiler runs, a plain host operation of the given name (no user
    annotation, so no copy on the device's timeline); when none runs,
    under a microsecond.  Where this torch lacks it, ranges are no-ops."""
    try:
        from torch._C._profiler import _RecordFunctionFast
    except ImportError:
        return lambda _label: nullcontext()
    return _RecordFunctionFast


_host_range = _host_range_type()


class _Timed:
    """A range that also adds its host seconds to the phase totals;
    `seconds` holds them after the block."""
    __slots__ = ("name", "seconds", "_rng", "_t0")

    def __init__(self, name: str, rng) -> None:
        self.name, self._rng = name, rng

    def __enter__(self) -> "_Timed":
        self._rng.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        with _lock:
            _totals[self.name] += self.seconds
            _counts[self.name] += 1
        self._rng.__exit__(*exc)
        return False


def range(name: str):
    """The host range `lgbt::<name>` (a name of RANGES), with no
    accumulator: the learner's inner phases, which leave the TIMETAG
    totals, and so each `train.iteration` record's phases, as they
    are."""
    return _host_range(_RANGE_LABELS[name])


def phase(name: str, force: bool = False):
    """The host range `lgbt::<name>` (a name of RANGES), accumulating its
    wall-clock under `name` when enabled, or always with `force=True`
    (serving phases, a Dataset's construct).  It never synchronises the
    device: it takes the host clock around launches that may still be
    running, which is also what the JAX package's phases measure around
    its asynchronous dispatches."""
    rng = range(name)
    if not (ENABLED or force or _PHASES_FORCED):
        return rng
    return _Timed(name, rng)


def add(name: str, seconds: float, force: bool = False) -> None:
    if ENABLED or force or _PHASES_FORCED:
        with _lock:
            _totals[name] += seconds
            _counts[name] += 1


def count(name: str, inc: float = 1.0) -> None:
    """Bump an always-on counter (thread-safe)."""
    with _lock:
        _counters[name] += inc


def count_deferred(name: str, value) -> None:
    """Accumulate a DEVICE scalar tensor against a counter without a
    host read (a hot loop must not stall on a metrics fetch).
    Accumulation happens on the device (`+` is asynchronous), so one
    tensor per name stays live; the total is folded into the counter on
    the next counter_value()/counters() read, where the caller has
    chosen to pay the read."""
    with _lock:
        prev = _deferred.get(name)
        _deferred[name] = value if prev is None else prev + value


def _drain_deferred_locked() -> None:
    """Fold pending device totals into _counters; caller holds _lock.
    ONE host copy for every pending counter of a device (a float() a
    name would be one device read each)."""
    if not _deferred:
        return
    import torch
    by_device: Dict[object, list] = {}
    for name, val in _deferred.items():
        by_device.setdefault(val.device, []).append(name)
    for names in by_device.values():
        vals = torch.stack([_deferred[n].reshape(()).to(torch.float64)
                            for n in names]).cpu().tolist()
        for name, val in zip(names, vals):
            _counters[name] += float(val)
    _deferred.clear()


def counter_value(name: str) -> float:
    with _lock:
        _drain_deferred_locked()
        return _counters.get(name, 0.0)


def counters(prefix: str = "", sync: bool = True) -> Dict[str, float]:
    with _lock:
        if sync:
            _drain_deferred_locked()
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def counters_nosync(prefix: str = "") -> Dict[str, float]:
    """Host-visible counter values WITHOUT draining the deferred device
    totals — safe on the pipelined training path (no device sync).
    `count_deferred` accumulations lag until the next counters()/
    snapshot() read pays the sync; counters recorded with count() are
    exact.  The per-iteration training telemetry reads through here."""
    return counters(prefix, sync=False)


def observe(name: str, value: float) -> None:
    """Record one sample into a bounded reservoir (for percentiles)."""
    with _lock:
        dq = _samples.get(name)
        if dq is None:
            dq = _samples[name] = deque(maxlen=_SAMPLE_CAP)
        dq.append(value)


def _summary_of(vals) -> Dict[str, float]:
    """Nearest-rank percentiles (ceil(p*n)-1) over pre-sorted samples.
    The previous ``int(p * n)`` indexing overshot nearest-rank by one
    position — p50 of [1, 2] returned 2 and p99 of 100 samples returned
    the max — which matters because p99 is the SLO number the serve
    bench gates on."""
    if not vals:
        return {"count": 0}

    def q(p: float) -> float:
        return vals[min(len(vals) - 1, max(0, math.ceil(p * len(vals)) - 1))]

    return {"count": len(vals), "p50": q(0.50), "p95": q(0.95),
            "p99": q(0.99), "max": vals[-1]}


def summary(name: str) -> Dict[str, float]:
    """count/p50/p95/p99/max over the retained samples of `name` — p99
    is the serving SLO metric the sustained-QPS bench gates on."""
    with _lock:
        vals = sorted(_samples.get(name, ()))
    return _summary_of(vals)


def snapshot() -> Tuple[Dict[str, float], Dict[str, Dict[str, float]]]:
    """ONE locked snapshot of the whole registry for a /metrics scrape:
    (counters, {name: summary}) — deferred device totals drain here
    (the scrape pays the sync, same contract as counters())."""
    with _lock:
        # the drain reads device buffers under _lock by contract: the
        # scrape pays the one read so hot paths never do
        _drain_deferred_locked()
        ctrs = dict(_counters)
        sums = {name: _summary_of(sorted(dq))
                for name, dq in _samples.items()}
    return ctrs, sums


def timings() -> Dict[str, float]:
    """Phase totals without printing (the /stats view of the TIMETAG
    accumulators)."""
    with _lock:
        return dict(_totals)


def report() -> Dict[str, float]:
    """Totals per phase; also printed when TIMETAG is on (reference logs
    at destructor time)."""
    with _lock:
        totals = dict(_totals)
        counts = dict(_counts)
    if ENABLED and totals:
        print("[LightGBM-TPU] [Info] ===== timer totals =====", flush=True)
        for name in sorted(totals, key=totals.get, reverse=True):
            print(f"[LightGBM-TPU] [Info] {name}: {totals[name]:.4f}s "
                  f"({counts[name]} calls)", flush=True)
    return totals


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
        _counters.clear()
        _samples.clear()
        _deferred.clear()


if ENABLED:
    atexit.register(report)
