"""Warm predictor runtime for online scoring.

Port of lightgbm_tpu/serving/runtime.py.  Online traffic is millions of
small, odd-shaped requests against one slowly-changing model.  The
runtime keeps the model on the device and the request path warm:

- request rows are bucketed to powers of two between
  ``min_bucket_rows`` and ``max_batch_rows`` and padded up, so every
  shape in the wild lands on one of O(log) warm entries;
- the JAX package AOT-compiles one executable per (replica, model
  generation, row bucket, output kind).  Eager PyTorch has no compile
  step, so the port keeps a PREPARED ENTRY there instead: the traversal
  program bound to its bucket and output kind, built and run once on a
  zero buffer of the bucket when first asked for (`_build`).  The cache,
  its hit/miss counters, ``serve.compile_seconds`` (the build and that
  first run) and the estimated entry bytes keep the JAX package's names,
  so warmup still guarantees that no live request is an entry's first
  launch;
- the ensemble traversal is the ``predict_kernel`` dial
  (ops/predict.py): ``tensorized`` (what `auto` resolves to) walks every
  tree of every class in one traversal; ``walk`` one a class;
- the model is REPLICATED across devices (`replicas`): each replica owns
  its copy of the stacks, moved once to its device, and its own entry
  cache; requests dispatch to the least-loaded replica.  With
  ``device_type=cuda`` the replicas are ``cuda:0..n-1`` of the visible
  GPUs (none visible raises); with ``device_type=cpu`` (the tests) up to
  8 replicas all on the CPU, standing in for the JAX tests' 8 virtual
  host devices;
- the padded chunk is copied to the replica's device once a dispatch and
  the answer comes back in one copy.  The JAX package donates the
  request buffer to XLA on accelerators; PyTorch has no counterpart;
- with ``serve_quantize=binned`` every chunk quantizes to uint8 bin ids
  at ingress and the traversal compares integer bins end to end
  (ops/predict.predict_ensemble_quantized): the request buffer ships 4x
  smaller and scores stay bit-identical to the raw kernel by
  construction (quantize.py);
- the sigmoid/softmax output transform runs on the device ("value"
  kind), so the host only sees finished predictions.

Replica health: every dispatch failure counts against its replica;
after ``failure_threshold`` CONSECUTIVE failures the replica's circuit
breaker opens and it stops receiving traffic.  A failed chunk is retried
ONCE on the least-loaded healthy replica — never on the CPU — so one bad
device degrades capacity, not availability.  Broken replicas readmit
through a half-open probe: after ``probe_after`` dispatches were routed
around a broken replica, one live request probes it.  With ZERO healthy
replicas, dispatch raises `NoHealthyReplicaError` (HTTP 503).
"""
from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import log, profiling, telemetry
from ..diagnostics import faults, locksan
from ..log import LightGBMError

OUTPUT_KINDS = ("value", "raw")

# replicas a CPU runtime may hold (the JAX tests' 8 virtual host devices)
MAX_CPU_REPLICAS = 8


class NoHealthyReplicaError(LightGBMError):
    """Every replica's circuit breaker is open — shed load (HTTP 503)."""


class _ReplicaFailure(Exception):
    """Internal: a dispatch failed on a specific replica (carries the
    replica index so the retry can exclude it)."""

    def __init__(self, replica_index: int, error: BaseException):
        super().__init__(f"replica {replica_index} failed: {error}")
        self.replica_index = replica_index
        self.error = error


def row_bucket(n: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest power-of-two bucket >= n within [min_bucket, max_bucket]."""
    b = max(1, min_bucket)
    while b < n and b < max_bucket:
        b <<= 1
    return min(b, max_bucket)


def resolve_runtime(booster, *, serve_quantize: str = "auto",
                    refbin=None, **kw) -> "PredictorRuntime":
    """Build a PredictorRuntime honoring the ``serve_quantize`` dial —
    the ONE place the auto/binned/raw policy lives.

    ``raw`` → raw-feature runtime.  ``binned`` → binned runtime; ANY
    failure (missing/invalid sidecar, unrepresentable thresholds)
    propagates.  ``auto`` → binned whenever the refbin source yields a
    valid mapper set, raw otherwise (one log line says why).  ``refbin``
    may be a sidecar path, a Dataset, or a zero-arg callable returning
    either — the registry defers its sha-validated sidecar load into the
    try this way.
    """
    import os

    from ..config import SERVE_QUANTIZE_MODES
    if serve_quantize not in SERVE_QUANTIZE_MODES:
        raise ValueError(f"unknown serve_quantize: {serve_quantize!r}; "
                         f"use one of {SERVE_QUANTIZE_MODES}")
    if serve_quantize != "raw":
        try:
            rb = refbin() if callable(refbin) else refbin
            if rb is None:
                raise LightGBMError(
                    "no .refbin frozen-mapper sidecar (Dataset."
                    "save_refbin)")
            if isinstance(rb, str) and not os.path.exists(rb):
                raise LightGBMError(f"no .refbin sidecar at {rb}")
            return PredictorRuntime(booster, quantize="binned",
                                    refbin=rb, **kw)
        except Exception as e:
            if serve_quantize == "binned":
                raise
            log.info("serve_quantize=auto: serving raw features "
                     f"({type(e).__name__}: {e})")
    return PredictorRuntime(booster, **kw)


def resolve_serve_replicas(replicas: int = 0,
                           device_type: str = "cuda") -> List[torch.device]:
    """The devices a serving fleet replicates onto.

    ``device_type=cuda``: ``cuda:0..n-1`` of the visible GPUs — every one
    for ``0`` (auto), else the first ``replicas`` (capped at the count).
    No visible GPU raises: the fleet never carries on on the CPU.
    ``device_type=cpu`` (the tests): one replica for ``0``, else
    ``replicas`` of them (capped at MAX_CPU_REPLICAS), all on the CPU.
    """
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type=cuda but no CUDA device is "
                               "visible; pass device_type=cpu to serve "
                               "on the CPU")
        n = torch.cuda.device_count()
        n = n if replicas <= 0 else min(replicas, n)
        return [torch.device("cuda", i) for i in range(n)]
    if device_type != "cpu":
        raise ValueError(f"unknown device_type: {device_type!r}")
    n = 1 if replicas <= 0 else min(replicas, MAX_CPU_REPLICAS)
    return [torch.device("cpu")] * n


def _on_device(device: torch.device):
    """The dispatch's CUDA device context (one a dispatch, never held
    across dispatches); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _stacks_to(host_stacks, device):
    from ..ops.predict import to_device
    if isinstance(host_stacks, list):
        return [to_device(s, device) for s in host_stacks]
    return to_device(host_stacks, device)


def _stack_trees(host_stacks) -> int:
    """Trees of a stack, or of a walk kernel's per-class stacks."""
    if isinstance(host_stacks, list):
        return sum(s.leaf_value.shape[0] for s in host_stacks
                   if s is not None)
    return int(host_stacks.class_id.shape[0])


class _Replica:
    """One device's copy of the model: its stacks on that device plus
    its own entry cache and dispatch/health bookkeeping."""
    __slots__ = ("index", "device", "stacks", "compiled", "exe_bytes",
                 "inflight", "dispatches", "failures", "broken", "skips",
                 "probes")

    def __init__(self, index: int, device, stacks):
        self.index = index
        self.device = device
        self.stacks = stacks
        self.compiled: Dict[Tuple[int, str, str], object] = {}
        # estimated device bytes per entry (same keys as `compiled`) —
        # what the catalog's serve_cache_budget_mb LRU accounting sums
        self.exe_bytes: Dict[Tuple[int, str, str], int] = {}
        self.inflight = 0
        self.dispatches = 0
        self.failures = 0       # CONSECUTIVE dispatch failures
        self.broken = False     # circuit breaker open
        self.skips = 0          # dispatches routed around while broken
        self.probes = 0         # half-open probes attempted


def _sigmoid_fn(sig: float):
    return lambda raw: torch.sigmoid(sig * raw)


def _softmax_classes(raw: torch.Tensor) -> torch.Tensor:
    """Softmax over the class rows of [K, N], the class sum added in
    class order (a reduction over dim 0 may split by the row count)."""
    e = torch.exp(raw - raw.max(dim=0).values)
    s = e[0]
    for k in range(1, e.shape[0]):
        s = s + e[k]
    return e / s


class PredictorRuntime:
    """Warm predictor for one model generation.

    Immutable once built: hot swap creates a fresh runtime for the next
    generation and atomically replaces the reference (registry.py), so
    in-flight requests keep scoring against a consistent model.
    """

    # dispatches routed AROUND a broken replica before one live request
    # probes it (half-open); count-based so chaos runs are deterministic
    PROBE_AFTER = 8

    def __init__(self, booster, *, num_iteration: int = -1,
                 max_batch_rows: int = 4096, min_bucket_rows: int = 16,
                 generation: int = 0, predict_kernel: Optional[str] = None,
                 replicas: int = 0, failure_threshold: int = 3,
                 probe_after: Optional[int] = None,
                 quantize: str = "raw", refbin=None,
                 model_id: Optional[str] = None):
        from ..ops.predict import resolve_predict_kernel

        gbdt = booster._gbdt if hasattr(booster, "_gbdt") else booster
        if not gbdt.models:
            raise LightGBMError("cannot build a PredictorRuntime from a "
                                "model with no trees")
        if max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        min_bucket_rows = max(1, min(min_bucket_rows, max_batch_rows))
        self.generation = generation
        # catalog tenant id (None outside the multi-tenant catalog):
        # stamps replica spans and the per-model telemetry labels
        self.model_id = model_id
        self.max_batch_rows = int(max_batch_rows)
        self.min_bucket_rows = int(min_bucket_rows)
        self.objective = gbdt.objective
        self.K = max(1, gbdt.K)
        self.num_features = gbdt.max_feature_idx + 1
        cfg = getattr(gbdt, "config", None)
        # the model's own config carries the dials the serving entry
        # point does not pass explicitly
        if predict_kernel is None:
            predict_kernel = getattr(cfg, "predict_kernel", "auto")
        self.device_type = getattr(cfg, "device_type", "cuda")
        self.predict_kernel = resolve_predict_kernel(predict_kernel)
        used = gbdt._num_used_models(num_iteration)
        # request-path quantization: "binned" rebins the model against
        # the frozen refbin mapper set, quantizes every chunk at ingress,
        # and traverses integer bins end to end
        if quantize not in ("raw", "binned"):
            raise ValueError("PredictorRuntime quantize must be 'raw' or "
                             f"'binned', got {quantize!r} (the auto "
                             "resolution happens in resolve_runtime)")
        self._quantizer = None
        self.variant = quantize
        if quantize == "binned":
            from ..quantize import (FeatureQuantizer, load_refbin,
                                    rebin_models_for_serving)
            if refbin is None:
                raise LightGBMError(
                    "binned serving needs a refbin mapper set (a .refbin "
                    "sidecar path or a Dataset)")
            if isinstance(refbin, str):
                refbin = load_refbin(refbin)
            if refbin.num_total_features != self.num_features:
                raise LightGBMError(
                    f"refbin mapper set covers "
                    f"{refbin.num_total_features} features, the model "
                    f"expects {self.num_features}")
            rebin_models_for_serving(gbdt.models[:used], refbin)
            self._quantizer = FeatureQuantizer(refbin.mappers,
                                               refbin.used_features)
            if self.predict_kernel != "tensorized":
                log.info("serve_quantize=binned traverses the tensorized "
                         "binned stack; the predict_kernel="
                         f"{self.predict_kernel} dial applies to raw "
                         "serving only")
        host_stacks = self._build_host_stacks(gbdt, used)
        # the per-chunk device buffer: quantized bins over the used
        # features, or the raw f32 feature matrix
        if self._quantizer is not None:
            self._buf_dtype = self._quantizer.dtype
            self._buf_cols = self._quantizer.num_columns
        else:
            self._buf_dtype = np.float32
            self._buf_cols = self.num_features
        self._device_value = self._device_value_fn()
        self._init_fleet(host_stacks, replicas, failure_threshold,
                         probe_after)

    def _init_fleet(self, host_stacks, replicas: int,
                    failure_threshold: int,
                    probe_after: Optional[int]) -> None:
        """Replica fleet + dispatch bookkeeping, shared verbatim by the
        cross-model GroupRuntime (serving/superstack.py)."""
        self._trees = _stack_trees(host_stacks)
        # the fleet: one model copy + entry cache per device; a stack
        # that cannot be placed raises here
        self.replicas: List[_Replica] = [
            _Replica(i, dev, _stacks_to(host_stacks, dev))
            for i, dev in enumerate(resolve_serve_replicas(
                replicas, self.device_type))]
        # persistent chunk fan-out pool (threads spawn on demand), sized
        # to the fleet and shared across concurrent requests
        self._fanout = (ThreadPoolExecutor(
            max_workers=len(self.replicas),
            thread_name_prefix="lgbt-serve-fanout")
            if len(self.replicas) > 1 else None)
        self._lock = locksan.lock("serve.runtime")
        self._rr = 0                  # round-robin tie-break cursor
        self.cache_hits = 0
        self.cache_misses = 0
        self.failure_threshold = max(1, int(failure_threshold))
        self.probe_after = max(1, int(self.PROBE_AFTER if probe_after
                                      is None else probe_after))
        self.chunk_retries = 0

    @property
    def replica_count(self) -> int:
        return len(self.replicas)

    def replica_dispatches(self) -> List[int]:
        """Per-replica dispatch counts (the /stats fleet view)."""
        with self._lock:
            return [r.dispatches for r in self.replicas]

    def replica_health(self) -> List[dict]:
        """Per-replica breaker state (the /stats `replicas.health`)."""
        with self._lock:
            return [{"index": r.index,
                     "state": "broken" if r.broken else "healthy",
                     "consecutive_failures": r.failures,
                     "dispatches": r.dispatches,
                     "skips_since_broken": r.skips,
                     "probes": r.probes}
                    for r in self.replicas]

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if not r.broken)

    # -- model stacking -------------------------------------------------

    def _build_host_stacks(self, gbdt, used: int):
        """Host-numpy ensemble stacks, moved once to each replica.

        binned: ONE stack over every class with thresholds in bin space
        — the perfect layout for shallow numerical ensembles, the SoA
        otherwise; the same layout rule as the raw path, so the two
        variants make the same choice for a model.  tensorized: ONE
        stack over every class.  walk: one TreeStack a class (None for a
        never-trained class, whose raw row stays 0).
        """
        from ..ops.predict import build_ensemble, stack_trees
        trees_by_class = [
            [gbdt.models[i] for i in range(used) if i % self.K == k]
            for k in range(self.K)]
        # kept for co-stacking (serving/superstack.py): a GroupRuntime
        # stacks exactly the tree set this runtime scores solo
        self._trees_by_class = trees_by_class
        if self.variant == "binned" or self.predict_kernel == "tensorized":
            stack, meta = build_ensemble(trees_by_class,
                                         binned=self.variant == "binned")
            self._meta = meta
            return stack
        self._meta = None
        stacks: List = []
        self._depths: List[int] = []
        for trees in trees_by_class:
            stacks.append(stack_trees(trees, binned=False) if trees
                          else None)
            self._depths.append(max(max((t.max_depth_grown for t in trees),
                                        default=1), 1))
        return stacks

    # -- the program ----------------------------------------------------

    def _device_value_fn(self):
        """Device-side raw→prediction transform of the "value" kind, or
        None: identity transforms share the raw program, and objectives
        with no device form convert on the host."""
        from ..objectives import Objective

        obj = self.objective
        if obj is None or type(obj).convert_output is Objective.convert_output:
            return None                                  # identity: use raw
        name = getattr(obj, "name", "")
        if name in ("binary", "multiclassova"):
            return _sigmoid_fn(float(obj.sigmoid))
        if name == "multiclass":
            return _softmax_classes
        return None                                      # host conversion

    def _run_kind(self, kind: str) -> str:
        """The entry kind a request actually runs: "value" maps to the
        raw program whenever no device transform is fused."""
        return kind if kind == "raw" or self._device_value is not None \
            else "raw"

    def _raw_fn(self):
        """The ensemble traversal, (stacks, X) -> [K, rows]."""
        if self.variant == "binned":
            from ..ops.predict import predict_ensemble_quantized
            meta = self._meta
            return lambda stacks, Xb: predict_ensemble_quantized(
                stacks, Xb, meta=meta)
        if self.predict_kernel == "tensorized":
            from ..ops.predict import predict_ensemble_any
            meta = self._meta
            return lambda stacks, X: predict_ensemble_any(stacks, X,
                                                          meta=meta)
        from ..ops.predict import ensemble_raw
        depths = tuple(self._depths)
        return lambda stacks, X: ensemble_raw(stacks, X, depths=depths)

    def _program(self, kind: str):
        """The program of one output kind, (stacks, X) -> [K, rows].
        GroupRuntime overrides this with the grouped traversal;
        everything downstream (the entry cache, warmup, dispatch) is
        shared."""
        raw_fn = self._raw_fn()
        device_value = self._device_value if kind == "value" else None

        def fn(stacks, X):
            raw = raw_fn(stacks, X)                        # [K, bucket]
            if device_value is not None:
                raw = device_value(raw)
            return raw
        return fn

    def _device_buffer(self, X: np.ndarray, device) -> torch.Tensor:
        """The padded chunk on the replica's device, in one copy.  A
        uint16 bin buffer ships as int32 (torch's uint16 has too few
        device ops)."""
        X = X.astype(self._buf_dtype, copy=False)
        if X.dtype == np.uint16:
            X = X.astype(np.int32)
        return torch.as_tensor(X, device=device)

    def _build(self, replica: _Replica, bucket: int, kind: str):
        """Prepare the entry of one (replica, bucket, kind): the program
        bound to its bucket and kind, run once on a zero buffer of the
        bucket so its first launch is not a live request's (the JAX
        package compiles its executable here)."""
        fn = self._program(kind)
        t0 = time.perf_counter()
        zeros = np.zeros((bucket, self._buf_cols), self._buf_dtype)
        with _on_device(replica.device):
            fn(replica.stacks,
               self._device_buffer(zeros, replica.device)).cpu()
        dt = time.perf_counter() - t0
        profiling.add("serve/compile", dt, force=True)
        profiling.count("serve.compile_seconds", dt)
        return fn

    def _exe_bytes(self, bucket: int) -> int:
        """Estimated device bytes one entry keeps live while it runs —
        what the catalog's serve_cache_budget_mb accounting charges: the
        JAX package's analytic floor, the request buffer, the output and
        the [T, bucket] node (int64) and value (f32) temporaries."""
        in_bytes = bucket * self._buf_cols * np.dtype(self._buf_dtype).itemsize
        return int(in_bytes + self.K * bucket * 4
                   + self._trees * bucket * (8 + 4))

    def _get_executable(self, replica: _Replica, bucket: int, kind: str):
        # the kernel VARIANT is part of the key: a binned and a raw entry
        # at the same (bucket, kind) are different programs over
        # different buffer dtypes and must never collide
        key = (bucket, kind, self.variant)
        with self._lock:
            exe = replica.compiled.get(key)
            if exe is not None:
                self.cache_hits += 1
                profiling.count("serve.cache_hit")
                return exe
        # build outside the lock; the double-build race just wastes one
        # build, never corrupts
        exe = self._build(replica, bucket, kind)
        with self._lock:
            winner = replica.compiled.setdefault(key, exe)
            replica.exe_bytes.setdefault(key, self._exe_bytes(bucket))
            self.cache_misses += 1
            profiling.count("serve.cache_miss")
        return winner

    # -- introspection --------------------------------------------------

    def buckets_compiled(self) -> List[Tuple[int, str]]:
        """Distinct (bucket, kind) pairs prepared on ANY replica (the
        kernel variant is uniform per runtime and elided — swap warmup
        carries buckets across variants)."""
        with self._lock:
            keys = set()
            for r in self.replicas:
                keys.update((b, k) for b, k, _v in r.compiled)
            return sorted(keys)

    def cache_bytes(self) -> int:
        """Estimated device bytes of this runtime's entries across every
        replica — what the catalog's LRU accounting sums per tenant."""
        with self._lock:
            return sum(sum(r.exe_bytes.values()) for r in self.replicas)

    def evict_executables(self) -> int:
        """Drop every entry (every replica) — the catalog's LRU budget
        enforcement.  The stacks stay on the device, so the tenant keeps
        serving; its next request rebuilds its bucket (counted as churn
        through serve/cache_evictions and the cache-miss counters)."""
        with self._lock:
            n = sum(len(r.compiled) for r in self.replicas)
            for r in self.replicas:
                r.compiled.clear()
                r.exe_bytes.clear()
        if n:
            profiling.count(profiling.SERVE_CACHE_EVICTIONS, n)
            if self.model_id is not None:
                profiling.count(profiling.labeled(
                    profiling.SERVE_CACHE_EVICTIONS,
                    model=self.model_id), n)
            log.info(f"serving cache evicted {n} prepared entries"
                     + (f" (model {self.model_id})" if self.model_id
                        else "")
                     + " to honor serve_cache_budget_mb")
        return n

    def warmup(self, buckets: Sequence[int] = (),
               kinds: Sequence[str] = OUTPUT_KINDS) -> None:
        """Prepare + run the given row buckets on EVERY replica for
        every kind (identity objectives share one program), so the first
        real request after a (re)load never pays a build.  Used by
        ModelRegistry before a hot swap goes live."""
        buckets = sorted({row_bucket(b, self.min_bucket_rows,
                                     self.max_batch_rows)
                          for b in (buckets or (1,))})
        run_kinds = sorted({self._run_kind(k) for k in kinds})
        for replica in self.replicas:
            for b in buckets:
                for kind in run_kinds:
                    # bin 0 is a valid bin everywhere, so the all-zeros
                    # buffer warms the binned variant too
                    zeros = np.zeros((b, self._buf_cols), self._buf_dtype)
                    self._run_compiled(b, kind, zeros, replica=replica)

    # -- prediction -----------------------------------------------------

    def _pick_replica(self, exclude: FrozenSet[int] = frozenset(),
                      allow_probe: bool = True) -> _Replica:
        """Least-loaded HEALTHY dispatch with a round-robin tie-break.

        Broken replicas are routed around; each route-around bumps
        their skip counter, and once it reaches ``probe_after`` the
        next request becomes that replica's half-open probe (a probe
        failure retries on a healthy replica like any other failure).
        Raises NoHealthyReplicaError when no replica is dispatchable.
        """
        with self._lock:
            n = len(self.replicas)
            best = probe = None
            for off in range(n):
                r = self.replicas[(self._rr + off) % n]
                if r.index in exclude:
                    continue
                if r.broken:
                    r.skips += 1
                    if (allow_probe and probe is None
                            and r.skips >= self.probe_after
                            and r.inflight == 0):    # single-flight probe
                        probe = r
                    continue
                if best is None or r.inflight < best.inflight:
                    best = r
            if probe is not None:
                probe.skips = 0
                probe.probes += 1
                profiling.count(profiling.SERVE_REPLICA_PROBES)
                best = probe
            if best is None:
                raise NoHealthyReplicaError(
                    f"no healthy predictor replica ({n} total, "
                    f"{len(exclude)} excluded); retry later")
            self._rr = (best.index + 1) % n
            best.inflight += 1
            best.dispatches += 1
            return best

    def _note_success(self, replica: _Replica) -> None:
        readmitted = False
        with self._lock:
            replica.failures = 0
            if replica.broken:
                replica.broken = False
                replica.skips = 0
                readmitted = True
                profiling.count(profiling.SERVE_REPLICA_READMITTED)
        if readmitted:
            log.info(f"serving replica {replica.index} readmitted "
                     "(half-open probe succeeded)")
            telemetry.event("serve.breaker", replica=replica.index,
                            state="closed",
                            generation=self.generation)

    def _note_failure(self, replica: _Replica, error: BaseException) -> None:
        with self._lock:
            replica.failures += 1
            profiling.count(profiling.SERVE_REPLICA_FAILURES)
            opened = (not replica.broken
                      and replica.failures >= self.failure_threshold)
            reopened = replica.broken
            if opened:
                replica.broken = True
                replica.skips = 0
                profiling.count(profiling.SERVE_REPLICA_BROKEN)
            if reopened:
                replica.skips = 0     # probe failed: wait another window
        if opened:
            log.warning(
                f"serving replica {replica.index} circuit-broken after "
                f"{replica.failures} consecutive failures "
                f"({type(error).__name__}: {error}); traffic fails over "
                "to the surviving replicas")
        if opened or reopened:
            telemetry.event("serve.breaker", replica=replica.index,
                            state="open" if opened else "probe_failed",
                            error=f"{type(error).__name__}: {error}",
                            generation=self.generation)

    def _run_compiled(self, bucket: int, kind: str, Xpad: np.ndarray,
                      replica: Optional[_Replica] = None,
                      exclude: FrozenSet[int] = frozenset()):
        pinned = replica is not None
        if replica is None:
            # a retry (non-empty exclude) must land on a HEALTHY replica
            replica = self._pick_replica(exclude,
                                         allow_probe=not exclude)
        else:                          # warmup pins the replica itself
            with self._lock:
                replica.inflight += 1
                replica.dispatches += 1
        try:
            with telemetry.span("serve.replica", replica=replica.index,
                                bucket=bucket, kind=kind,
                                variant=self.variant,
                                generation=self.generation,
                                **({"model": self.model_id}
                                   if self.model_id is not None else {})):
                # chaos seams: a dispatch raising (any replica / THIS
                # replica) is the circuit breaker's trigger condition
                faults.check("serve.dispatch")
                faults.check(f"serve.dispatch.r{replica.index}")
                exe = self._get_executable(replica, bucket, kind)
                with _on_device(replica.device):
                    out = exe(replica.stacks,
                              self._device_buffer(Xpad, replica.device))
                    # the one device→host copy of the chunk
                    res = out.cpu().numpy().astype(np.float64)
        except Exception as e:
            self._note_failure(replica, e)
            if pinned:                 # warmup: surface the raw error
                raise
            raise _ReplicaFailure(replica.index, e) from e
        else:
            self._note_success(replica)
            return res
        finally:
            with self._lock:
                replica.inflight -= 1

    def _predict_chunk(self, X: np.ndarray, kind: str) -> np.ndarray:
        if self._quantizer is not None:
            # ingress quantization on the host: raw f64 rows → original
            # per-feature bins (numpy, thread-safe under the fan-out pool)
            X = self._quantizer.quantize(X)
            profiling.count(profiling.SERVE_QUANTIZE_BYTES_IN, X.nbytes)
        n = X.shape[0]
        bucket = row_bucket(n, self.min_bucket_rows, self.max_batch_rows)
        if n < bucket:
            # pad rows carry bin 0 / feature 0.0 — sliced off below
            X = np.pad(X, ((0, bucket - n), (0, 0)))
        try:
            out = self._run_compiled(bucket, kind, X)
        except _ReplicaFailure as f:
            # retry ONCE on a healthy replica other than the one that
            # failed; warmup covers every replica, so the retry never
            # builds on the request path
            with self._lock:
                self.chunk_retries += 1
            profiling.count(profiling.SERVE_CHUNK_RETRIES)
            try:
                out = self._run_compiled(bucket, kind, X,
                                         exclude=frozenset(
                                             {f.replica_index}))
            except NoHealthyReplicaError:
                if self.healthy_count() == 0:
                    raise              # total outage: 503, retryable
                # only the exclusion emptied the pool (single-replica
                # fleet, breaker not yet open): surface the real error
                raise f.error from f
            except _ReplicaFailure as f2:
                raise f2.error from f2
        return out[:, :n]

    def predict(self, X: np.ndarray, kind: str = "value") -> np.ndarray:
        """Score [n, F] rows; returns the same shapes as Booster.predict
        ([n] for K==1, [n, K] otherwise).

        Arbitrary n: full ``max_batch_rows`` slabs plus one bucketed
        remainder, so every executed shape hits a warm entry.  Each
        chunk dispatches to the least-loaded replica independently — and
        concurrently on a multi-replica fleet.
        """
        if kind not in OUTPUT_KINDS:
            raise ValueError(
                f"unknown output kind {kind!r}; use one of {OUTPUT_KINDS} "
                "(leaf indices go through Booster.predict(pred_leaf=True))")
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[1] > self.num_features:
            # wider input is legal (reference predictor semantics: extra
            # trailing columns are ignored)
            X = np.ascontiguousarray(X[:, :self.num_features])
        elif X.shape[1] < self.num_features:
            raise LightGBMError(
                f"request has {X.shape[1]} features, model expects "
                f"{self.num_features}")
        n = X.shape[0]
        if n == 0:
            return (np.zeros(0) if self.K == 1
                    else np.zeros((0, self.K)))
        if self._quantizer is not None:
            profiling.count(profiling.SERVE_BINNED_REQUESTS)
        run_kind = self._run_kind(kind)
        starts = range(0, n, self.max_batch_rows)
        with profiling.phase("serve/execute", force=True):
            if len(starts) == 1 or self._fanout is None:
                parts = [self._predict_chunk(X[a:a + self.max_batch_rows],
                                             run_kind)
                         for a in starts]
            else:
                # chunks dispatch CONCURRENTLY (each picks the
                # least-loaded replica); the caller's span context rides
                # into the pool threads explicitly
                ctx = telemetry.current()
                parts = list(self._fanout.map(
                    lambda a: telemetry.call_in_context(
                        ctx, self._predict_chunk,
                        X[a:a + self.max_batch_rows], run_kind),
                    starts))
        raw = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        out = raw[0] if self.K == 1 else raw.T
        if (kind == "value" and run_kind == "raw"
                and self.objective is not None):
            out = self.objective.convert_output(out)
        profiling.count("serve.rows", n)
        return out
