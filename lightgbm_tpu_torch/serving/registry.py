"""Versioned model registry with atomic hot-swap.

Port of lightgbm_tpu/serving/registry.py.  Production serving replaces
models under load.  The registry owns the
active (generation, PredictorRuntime) pair and swaps it atomically:

- `maybe_reload()` polls the model file's (mtime_ns, size, meta sha1)
  signature — driven by the server's poll thread every
  `model_poll_seconds`, or forced immediately via SIGHUP
  (`install_sighup()`; a forced reload also bypasses any shadow
  canary and discards a pending candidate — the operator's escape
  hatch);
- an incoming model is fully loaded AND warmed (every row bucket the
  outgoing runtime had prepared is prepared and run for the new
  generation) BEFORE the reference flips, so the first request after a
  swap is as warm as the last one before it;
- a model that fails to load or warm is rolled back: the old runtime
  keeps serving, the bad file signature is remembered so the poll loop
  does not retry-spin on it, and `registry/swap_failures` is counted
  (exception class + message logged and kept as `last_swap_error`);
- under ``serve_quantize=binned`` the model's ``.refbin`` frozen-mapper
  sidecar is part of the swap: missing, torn, or sha1-mismatched (vs
  the publish meta's ``refbin_sha1``) sidecars REFUSE the swap through
  the same rollback path — the old generation keeps serving and the
  failure is /stats-visible.  ``auto`` falls back to raw-feature
  serving instead of refusing.

Readers never lock: `current()` is one attribute read; in-flight batches
that pinned the previous runtime finish on it untouched.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import log, profiling, telemetry
from ..diagnostics import locksan
from ..log import LightGBMError
from .runtime import OUTPUT_KINDS, PredictorRuntime


def _file_signature(path: str) -> Tuple[int, int, Optional[str]]:
    """(mtime_ns, size, meta sha1) — the change detector of the poll.

    mtime alone cannot tell two publishes landing within one mtime tick
    apart, and (mtime_ns, size) still cannot when the republished model
    happens to be byte-size-identical (a leaf refit frequently is).
    The online trainer rewrites ``<model>.meta.json`` on EVERY publish
    (generation, timestamps), so hashing that small sidecar closes the
    same-second window; models published without a meta sidecar keep
    the (mtime_ns, size) resolution, documented in docs/serving.md."""
    st = os.stat(path)
    meta_sha: Optional[str] = None
    try:
        with open(path + ".meta.json", "rb") as f:
            meta_sha = hashlib.sha1(f.read()).hexdigest()
    except OSError:
        pass
    return (st.st_mtime_ns, st.st_size, meta_sha)


class ModelRegistry:
    def __init__(self, model_path: str, params: Optional[dict] = None, *,
                 num_iteration: int = -1, max_batch_rows: int = 4096,
                 min_bucket_rows: int = 16,
                 warmup_buckets: Sequence[int] = (1,),
                 warmup_kinds: Sequence[str] = OUTPUT_KINDS,
                 predict_kernel: Optional[str] = None, replicas: int = 0,
                 failure_threshold: int = 3,
                 serve_quantize: str = "auto",
                 model_id: Optional[str] = None,
                 shadow_fraction: float = 0.0,
                 shadow_requests: int = 32,
                 shadow_max_divergence: float = -1.0,
                 warm_initial: bool = True):
        from ..config import SERVE_QUANTIZE_MODES
        self.model_path = model_path
        self.params = dict(params or {})
        self.num_iteration = num_iteration
        self.max_batch_rows = max_batch_rows
        self.min_bucket_rows = min_bucket_rows
        # BOTH output kinds warm by default: a value-only warmup left
        # the first raw request compiling on the request path
        self.warmup_kinds = tuple(warmup_kinds)
        self.predict_kernel = predict_kernel
        self.replicas = replicas
        self.failure_threshold = failure_threshold
        if serve_quantize not in SERVE_QUANTIZE_MODES:
            raise ValueError(f"unknown serve_quantize: {serve_quantize!r};"
                             f" use one of {SERVE_QUANTIZE_MODES}")
        self.serve_quantize = serve_quantize
        # catalog tenant id (None for plain single-model registries):
        # rides into the runtime's spans and the per-model counters
        self.model_id = model_id
        # co-stacked tenant (serving/superstack.py): this registry's
        # solo runtime holds stacks but serves no direct traffic — the
        # catalog's GroupRuntime does — so warming its executables on
        # swaps would pay one compile per tenant and defeat the whole
        # point of grouping.  The catalog flips this after grouping and
        # warms the GROUP instead (restack path); shadow candidates
        # compile lazily on their first off-request-path comparison.
        self.costacked = False
        self.warmup_buckets = tuple(warmup_buckets)
        # shadow canary (docs/serving.md "Multi-tenant catalog"): with
        # fraction > 0, a republished model is STAGED as a candidate
        # and double-scored on 1/fraction of requests before adoption;
        # 0 keeps the immediate hot-swap
        self.shadow_fraction = float(shadow_fraction)
        self.shadow_requests = max(1, int(shadow_requests))
        self.shadow_max_divergence = float(shadow_max_divergence)
        self._candidate: Optional[PredictorRuntime] = None
        self._candidate_sig: Optional[Tuple[int, int, Optional[str]]] = None
        self._candidate_trace: Optional[str] = None
        self._shadow_lock = locksan.lock("serve.registry.shadow")  # shadow counters +
        # candidate identity.  Lock ORDER: _lock → _shadow_lock (the
        # staging branch and the verdict both nest that way; nothing
        # acquires _lock while holding _shadow_lock).  The hot
        # per-batch shadow path takes _shadow_lock ALONE, and the
        # verdict's _lock acquire is non-blocking, so a minutes-long
        # candidate load can never stall a flusher thread
        self._shadow_tick = 0
        self._shadow_scored = 0
        self._shadow_max_div = 0.0
        self.last_swap_error: Optional[str] = None
        self._lock = locksan.lock("serve.registry")  # serializes WRITERS only
        self._failed_sig: Optional[Tuple[int, int, Optional[str]]] = None
        self._hup_pending = False
        # stat BEFORE loading (like maybe_reload): a file replaced during
        # a minutes-long load/warmup must look changed on the next poll
        self._sig = _file_signature(model_path)
        runtime = self._load(generation=1)
        if warm_initial:
            runtime.warmup(warmup_buckets, self.warmup_kinds)
        self._runtime = runtime
        self.swaps = 0
        self.swap_failures = 0

    # -- reader side ----------------------------------------------------

    def current(self) -> PredictorRuntime:
        """The active runtime — a single atomic reference read."""
        return self._runtime

    @property
    def generation(self) -> int:
        return self._runtime.generation

    # -- writer side ----------------------------------------------------

    def _load(self, generation: int) -> PredictorRuntime:
        from ..basic import Booster
        from .runtime import resolve_runtime
        booster = Booster(model_file=self.model_path, params=self.params)
        # binned serving: the model's .refbin frozen-mapper sidecar is
        # loaded fresh at every swap (it may be republished with the
        # model) and validated — sha1 against the publish meta inside
        # _load_refbin, feature coverage / threshold representability
        # inside the runtime build.  serve_quantize=binned makes ANY
        # failure refuse the swap (maybe_reload keeps the old
        # generation serving); =auto falls back to the raw kernel.
        return resolve_runtime(
            booster, serve_quantize=self.serve_quantize,
            refbin=self._load_refbin,
            num_iteration=self.num_iteration,
            max_batch_rows=self.max_batch_rows,
            min_bucket_rows=self.min_bucket_rows,
            generation=generation,
            predict_kernel=self.predict_kernel,
            replicas=self.replicas,
            failure_threshold=self.failure_threshold,
            model_id=self.model_id)

    def _load_refbin(self):
        """The model's ``.refbin`` sidecar, checked against the publish
        meta's ``refbin_sha1`` fingerprint when the model was published
        by the online trainer (offline models carry no meta — the
        sidecar is then trusted on its own format/consistency checks).
        NOTE: a swap refused over a torn sidecar is remembered by the
        MODEL file's signature; republishing only the sidecar needs a
        SIGHUP (or the next model publish) to retry."""
        from ..quantize import load_refbin
        expected = None
        try:
            with open(self.model_path + ".meta.json") as f:
                expected = json.load(f).get("refbin_sha1")
        except (OSError, ValueError):
            expected = None
        return load_refbin(self.model_path + ".refbin",
                           expected_sha1=expected)

    def pending_publish(self) -> bool:
        """True when the model file on disk no longer matches the
        signature the live generation loaded — a publish has landed
        that this process has not swapped in yet (poll window), or
        refused (swap failure).  /healthz reports tenants in this state
        as ``stale`` so the router tier's health probes can tell a
        partially-swapped backend from a live one (docs/Router.md)."""
        return _file_signature(self.model_path) != self._sig

    def _publish_trace_id(self) -> Optional[str]:
        """The publishing refresh's trace id from the online trainer's
        ``.meta.json`` sidecar (None for models published any other
        way, or with telemetry off).  The sidecar is renamed AFTER the
        model file; a poll landing inside that window (or after a crash
        between the renames) would read the PREVIOUS refresh's sidecar
        — attributing this swap to the wrong trace — so a sidecar older
        than the model is not adopted."""
        if not telemetry.enabled():
            return None
        meta_path = self.model_path + ".meta.json"
        try:
            if (os.stat(meta_path).st_mtime_ns
                    < os.stat(self.model_path).st_mtime_ns):
                return None
            with open(meta_path) as f:
                tid = json.load(f).get("trace_id")
            return str(tid) if tid else None
        except (OSError, ValueError):
            return None

    def maybe_reload(self, force: bool = False) -> bool:
        """Swap in the model file if it changed; True iff a swap landed.

        Failure of ANY stage (read, parse, stack, warmup) keeps the
        old generation serving.
        """
        with self._lock:
            if self._hup_pending:
                self._hup_pending = False
                force = True
            try:
                sig = _file_signature(self.model_path)
            except OSError:
                # mid-replace; don't lose a SIGHUP-forced reload — the
                # next poll tick must retry with force
                self._hup_pending = self._hup_pending or force
                return False
            if not force and (sig == self._sig or sig == self._failed_sig):
                return False
            old = self._runtime
            # a FORCED reload (SIGHUP / poll_once(force=True)) is the
            # operator's escape hatch and swaps immediately — without
            # it, a low-traffic tenant's canary could stay staged
            # indefinitely (the quorum needs live requests) with no
            # way to promote a publish short of a restart
            shadow = self.shadow_fraction > 0.0 and not force
            trace_id = self._publish_trace_id()
            attrs = ({"model": self.model_id}
                     if self.model_id is not None else {})
            try:
                # the swap span ADOPTS the publishing refresh's trace id
                # (the online trainer stamps it into the .meta.json
                # sidecar), closing the serve→train→serve loop: one
                # grep for that id finds traffic → window → refit →
                # publish → this hot-swap
                with telemetry.span(
                        "serve.swap", trace_id=trace_id,
                        generation=old.generation + 1,
                        model_path=self.model_path,
                        **(dict(attrs, staged=True) if shadow
                           else attrs)), \
                        profiling.phase("serve/swap", force=True):
                    runtime = self._load(generation=old.generation + 1)
                    # warm every bucket the outgoing generation served,
                    # for BOTH this registry's warmup kinds and whatever
                    # kinds actually saw traffic (so no post-swap request
                    # of either output kind compiles on the request path).
                    # Co-stacked tenants skip this: their traffic runs on
                    # the group's executable, which the catalog restack
                    # warms (or cache-transplants) after this swap lands.
                    if not self.costacked:
                        buckets = ({b for b, _k in old.buckets_compiled()}
                                   or {1})
                        kinds = ({k for _b, k in old.buckets_compiled()}
                                 | set(self.warmup_kinds))
                        runtime.warmup(sorted(buckets), sorted(kinds))
            except Exception as e:
                # a corrupt/torn candidate model must be LOUD and
                # visible at /stats, not a silent skip: exception class
                # + message into the log, the canonical
                # registry/swap_failures counter, and last_swap_error
                # for the stats endpoint (docs/Robustness.md)
                self.swap_failures += 1
                self._failed_sig = sig
                self.last_swap_error = f"{type(e).__name__}: {e}"
                profiling.count(profiling.REGISTRY_SWAP_FAILURES)
                log.warning(f"model hot-swap failed, keeping generation "
                            f"{old.generation} "
                            f"({self.last_swap_error})")
                return False
            if shadow:
                # shadow canary: STAGE the warmed candidate instead of
                # swapping — stable keeps answering every client, and
                # maybe_shadow double-scores a weighted fraction of
                # traffic on the candidate until the verdict
                with self._shadow_lock:
                    replaced = self._candidate is not None
                    self._candidate = runtime
                    self._candidate_sig = sig
                    self._candidate_trace = trace_id
                    self._shadow_tick = 0
                    self._shadow_scored = 0
                    self._shadow_max_div = 0.0
                self._sig = sig
                self._failed_sig = None
                if replaced:
                    log.info("shadow canary: a newer publish replaced "
                             "the pending candidate before its verdict")
                log.info(f"staged candidate generation "
                         f"{runtime.generation} for shadow canary "
                         f"({self.model_path}): adoption after "
                         f"{self.shadow_requests} shadowed comparisons")
                telemetry.event("serve.shadow", trace_id=trace_id,
                                state="staged",
                                generation=runtime.generation, **attrs)
                return False
            with self._shadow_lock:
                # an immediate swap supersedes any pending candidate:
                # letting it linger would hand a stale generation to a
                # later canary verdict
                stale = self._candidate
                self._candidate = None
            if stale is not None:
                log.info("discarding pending shadow candidate "
                         "(superseded by a forced immediate swap)")
            self._runtime = runtime          # the atomic swap
            self._sig = sig
            self._failed_sig = None
            self.last_swap_error = None
            self.swaps += 1
            profiling.count("serve.swap")
            log.info(f"hot-swapped model to generation "
                     f"{runtime.generation} ({self.model_path})")
            return True

    # -- shadow canary --------------------------------------------------

    def _model_labels(self) -> dict:
        return ({"model": self.model_id}
                if self.model_id is not None else {})

    def cache_bytes(self) -> int:
        """Estimated executable bytes this MODEL holds on device:
        stable runtime plus any staged shadow candidate (warmed at
        staging — without counting it, a fleet of pending canaries
        could sit at ~2x the configured cache budget invisibly)."""
        total = self._runtime.cache_bytes()
        cand = self._candidate
        if cand is not None:
            total += cand.cache_bytes()
        return total

    def evict_executables(self) -> int:
        """Evict the stable runtime's AND any staged candidate's
        executable caches (the catalog's LRU budget enforcement).  An
        evicted tenant keeps serving — its next request, shadow
        comparison, or post-adoption request rebuilds (churn)."""
        n = self._runtime.evict_executables()
        cand = self._candidate
        if cand is not None:
            n += cand.evict_executables()
        return n

    def shadow_state(self) -> Optional[dict]:
        """The /stats view of a pending canary, or None."""
        with self._shadow_lock:
            cand = self._candidate
            if cand is None:
                return None
            return {"generation": cand.generation,
                    "scored": self._shadow_scored,
                    "required": self.shadow_requests,
                    "fraction": self.shadow_fraction,
                    "max_divergence": self._shadow_max_div,
                    "divergence_gate": self.shadow_max_divergence}

    def maybe_shadow(self, X, kind: str, stable_preds,
                     requests: int = 1) -> None:
        """Post-result hook of the batcher's flush: double-score this
        batch on the staged candidate, log the per-request divergence,
        and deliver the canary verdict once ``shadow_requests``
        comparisons accumulated.  Sampling is REQUEST-weighted at
        batch granularity: the tick advances by the batch's request
        count, so ~``shadow_fraction`` of requests get their batch
        shadowed regardless of how many coalesce per flush (a pure
        per-batch tick would under-shadow by the batching factor).
        Runs AFTER the clients' futures resolved, so stable-path
        latency never includes the candidate's scoring.  No-op (one
        attribute read) without a pending candidate."""
        cand = self._candidate
        if cand is None:
            return
        with self._shadow_lock:
            if self._candidate is not cand:    # replaced underneath
                return
            period = max(1, int(round(1.0 / self.shadow_fraction)))
            self._shadow_tick += max(1, int(requests))
            if self._shadow_tick < period:
                return
            self._shadow_tick -= period
        try:
            cand_preds = cand.predict(X, kind=kind)
            div = (float(np.max(np.abs(np.asarray(cand_preds)
                                       - np.asarray(stable_preds))))
                   if len(X) else 0.0)
        except Exception as e:  # noqa: BLE001 — a candidate that
            # cannot score is the canary's whole point: reject it
            self._shadow_verdict(cand, adopt=False,
                                 reason=f"candidate scoring failed "
                                        f"({type(e).__name__}: {e})")
            return
        labels = self._model_labels()
        profiling.count(profiling.SERVE_SHADOW_SCORED)
        if labels:
            profiling.count(profiling.labeled(
                profiling.SERVE_SHADOW_SCORED, **labels))
        profiling.observe(profiling.labeled("serve.shadow_divergence",
                                            **labels), div)
        with self._shadow_lock:
            if self._candidate is not cand:
                return
            self._shadow_scored += 1
            self._shadow_max_div = max(self._shadow_max_div, div)
            scored = self._shadow_scored
            max_div = self._shadow_max_div
        telemetry.event("serve.shadow", trace_id=self._candidate_trace,
                        state="scored", generation=cand.generation,
                        rows=int(len(X)), kind=kind,
                        divergence=round(div, 9), scored=scored,
                        required=self.shadow_requests, **labels)
        if scored < self.shadow_requests:
            return
        gate = self.shadow_max_divergence
        if gate >= 0.0 and max_div > gate:
            self._shadow_verdict(cand, adopt=False,
                                 reason=f"max divergence {max_div:g} > "
                                        f"gate {gate:g} over "
                                        f"{scored} shadowed comparisons")
        else:
            self._shadow_verdict(cand, adopt=True)

    def _shadow_verdict(self, cand: PredictorRuntime, adopt: bool,
                        reason: str = "") -> None:
        """Promote or discard the candidate — exactly once per staged
        candidate, whichever thread's shadow request crossed the bar.
        The verdict runs under the WRITER lock (then re-checks the
        candidate under the shadow lock — same _lock→_shadow_lock
        order as maybe_reload's staging), so an adoption can never
        interleave with a concurrent reload: generation numbers stay
        unique per model, and the swap bookkeeping fields have one
        writer at a time.  The acquire is NON-blocking: a reload
        holding the lock can take minutes (load + warmup), and the
        flusher thread delivering this verdict must never stall behind
        it — a busy lock defers the verdict to the next shadowed
        comparison (the quorum only grows), or moots it entirely when
        that reload replaces the candidate."""
        labels = self._model_labels()
        if not self._lock.acquire(blocking=False):
            return                           # retry on the next shadow
        try:
            with self._shadow_lock:
                if self._candidate is not cand:
                    return                   # raced: verdict delivered
                self._candidate = None
                trace_id = self._candidate_trace
                scored = self._shadow_scored
                max_div = self._shadow_max_div
                sig = getattr(self, "_candidate_sig", None)
            if adopt:
                # re-stamp against the CURRENT stable (a forced swap
                # may have landed since staging) so generations stay
                # strictly increasing and unique
                cand.generation = self._runtime.generation + 1
                self._runtime = cand         # the atomic swap
                self.last_swap_error = None
                self.swaps += 1
            else:
                # the rejected file's signature is remembered so the
                # poll does not restage it every tick; a healed
                # republish (or SIGHUP force) retries
                self._failed_sig = sig
                self.swap_failures += 1
                self.last_swap_error = f"shadow canary rejected: {reason}"
            stable_gen = self._runtime.generation
        finally:
            self._lock.release()
        if adopt:
            profiling.count("serve.swap")
            profiling.count(profiling.SERVE_SHADOW_ADOPTIONS)
            if labels:
                profiling.count(profiling.labeled(
                    profiling.SERVE_SHADOW_ADOPTIONS, **labels))
            log.info(f"shadow canary adopted generation "
                     f"{cand.generation} after {scored} shadowed "
                     f"comparisons (max divergence {max_div:g}, "
                     f"{self.model_path})")
            telemetry.event("serve.shadow", trace_id=trace_id,
                            state="adopted", generation=cand.generation,
                            scored=scored,
                            max_divergence=round(max_div, 9), **labels)
        else:
            profiling.count(profiling.REGISTRY_SWAP_FAILURES)
            profiling.count(profiling.SERVE_SHADOW_REJECTIONS)
            if labels:
                profiling.count(profiling.labeled(
                    profiling.SERVE_SHADOW_REJECTIONS, **labels))
            log.warning(f"shadow canary REJECTED candidate generation "
                        f"{cand.generation} ({reason}); generation "
                        f"{stable_gen} keeps serving "
                        f"({self.model_path})")
            telemetry.event("serve.shadow", trace_id=trace_id,
                            state="rejected", generation=cand.generation,
                            scored=scored, reason=reason,
                            max_divergence=round(max_div, 9), **labels)

    # -- triggers -------------------------------------------------------

    def install_sighup(self) -> bool:
        """SIGHUP → force reload on the next poll tick (bypassing any
        shadow canary — the operator's escape hatch).  Only possible
        from the main thread; returns False (mtime polling still works)
        otherwise."""

        def _mark():
            self._hup_pending = True

        return install_sighup_handler(_mark, self.poll_once)

    def poll_once(self) -> bool:
        # maybe_reload consumes _hup_pending itself, under the lock
        return self.maybe_reload()


def install_sighup_handler(mark, reload_fn) -> bool:
    """Install the serving SIGHUP convention, shared by ModelRegistry
    and ModelCatalog: the handler runs ``mark()`` SYNCHRONOUSLY (the
    force flag must be set even if the reload thread never gets to
    run), then the possibly minutes-long reload off-thread — SIGHUP
    must work with mtime polling disabled, and the handler itself must
    never block the main thread on a compile.  Main thread only;
    returns False where signals cannot be installed (polling still
    works)."""
    if threading.current_thread() is not threading.main_thread():
        return False

    def _on_hup(_signum, _frame):
        mark()
        threading.Thread(target=reload_fn, daemon=True,
                         name="lgbt-serve-hup").start()

    try:
        signal.signal(signal.SIGHUP, _on_hup)
    except (ValueError, OSError, AttributeError):
        return False
    return True
