"""Micro-batching request queue with continuous admission.

Port of lightgbm_tpu/serving/batcher.py (standard library and numpy;
unchanged apart from the imports).  Online traffic arrives as many small
concurrent requests; the device wants few large shape-stable batches.
The batcher bridges the two: requests queue up and flusher threads
coalesce them until either ``max_batch_rows`` are pending or the OLDEST
request has waited ``flush_deadline_ms`` — the classic
latency/throughput dial of accelerator serving stacks.

Batching is CONTINUOUS, not coalesce-then-flush: a batch keeps admitting
arriving requests right up to the moment it is taken for dispatch, and
with ``workers > 1`` (one flusher per predictor replica) the next batch
forms and dispatches while earlier ones are still scoring — the fleet
never idles behind a single in-flight batch.  One runtime reference is
pinned per flush, so every request in a batch scores against a single
model generation even while a hot swap lands mid-flight.

Deadline math uses the injectable monotonic clock ``_now`` (defaults to
``time.monotonic``): wall-clock jumps (NTP steps, manual clock changes)
can neither stall a batch past its deadline nor double-flush one.

``max_pending_rows`` adds admission control: once that many rows are
queued, further ``submit``s shed load with ServerOverloadedError
instead of growing an unbounded queue (the HTTP layer maps it to 503;
a request below the high-water mark always admits, however large — the
runtime chunks it — so the queue is bounded by cap + one request).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, List, Optional

import numpy as np

from .. import log, profiling, telemetry
from ..diagnostics import locksan
from ..log import LightGBMError

# monotonic clock for ALL deadline math — module-level and injectable so
# the regression test can drive it; time.time() here would let a wall
# clock stepping backwards park a batch forever
_now = time.monotonic


class ServerOverloadedError(LightGBMError):
    """Queue beyond max_pending_rows — shed load (HTTP 503)."""


class _Request:
    __slots__ = ("X", "kind", "future", "t_enqueue", "trace_id",
                 "parent_id", "model_id")

    def __init__(self, X: np.ndarray, kind: str,
                 trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 model_id: Optional[str] = None):
        self.X = X
        self.kind = kind
        self.future: Future = Future()
        self.t_enqueue = _now()
        # trace propagation across the queue: the flusher thread cannot
        # inherit the HTTP handler thread's span context, so the ids
        # ride the request object explicitly
        self.trace_id = trace_id
        self.parent_id = parent_id
        # originating tenant on a SHARED (cross-model) batcher: selects
        # the request's tree segment in the group runtime and charges
        # its labeled accounting series.  None on per-tenant batchers
        # (the batcher-level model_id covers every request).
        self.model_id = model_id


class MicroBatcher:
    """Coalesce concurrent predict requests into bucketed runtime calls.

    `source` is anything with a ``current()`` returning the active
    PredictorRuntime (a ModelRegistry), or a runtime itself.  `workers`
    is the number of concurrent flusher threads — size it to the
    runtime's replica count so every replica can have a batch in flight.
    """

    def __init__(self, source, *, max_batch_rows: int = 4096,
                 flush_deadline_ms: float = 5.0, workers: int = 1,
                 max_pending_rows: int = 0,
                 model_id: Optional[str] = None,
                 pending_caps: Optional[dict] = None):
        self._source = source
        self.max_batch_rows = max(1, int(max_batch_rows))
        self.flush_deadline_s = max(0.0, float(flush_deadline_ms)) / 1e3
        self.max_pending_rows = max(0, int(max_pending_rows))
        self.workers = max(1, int(workers))
        # catalog tenant id: when set, every fleet-wide counter this
        # batcher bumps also bumps its per-model labeled series (the
        # /metrics `{model="..."}` accounting), and max_pending_rows is
        # this tenant's OWN admission budget — one hot tenant sheds its
        # own load instead of starving the fleet
        self.model_id = model_id
        self._labels = ({"model": model_id} if model_id is not None
                        else None)
        # SHARED (cross-model) batcher: admission stays PER TENANT —
        # each tenant's pending rows are tracked separately and checked
        # against its own cap (``pending_caps`` override, else
        # ``max_pending_rows``), so a hot tenant saturating the shared
        # queue sheds ITS load while quiet neighbors keep admitting
        self.pending_caps = dict(pending_caps or {})
        self._pending_by_model: dict = {}
        self._cond = locksan.condition("serve.batcher")
        self._queue: Deque[_Request] = deque()
        self._rows_pending = 0
        self._closed = False
        self.batches_flushed = 0
        self.rejected = 0
        self._threads = [
            threading.Thread(target=self._loop,
                             name=f"lgbt-serve-batcher-{i}", daemon=True)
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    # -- client side ----------------------------------------------------

    def submit(self, X: np.ndarray, kind: str = "value",
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               model_id: Optional[str] = None) -> Future:
        """Enqueue one request; the Future resolves to its predictions
        (Booster.predict shapes) or raises the scoring error.
        ``trace_id``/``parent_id`` tie the request's dispatch records to
        the caller's span (the HTTP handler passes its ingress ids).
        ``model_id`` names the originating tenant on a shared
        cross-model batcher (admission and accounting stay per
        tenant)."""
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.ndim != 2 or X.shape[0] == 0:
            raise LightGBMError("predict request must be a non-empty "
                                "[rows, features] matrix")
        mid = model_id if model_id is not None else self.model_id
        labels = ({"model": mid} if mid is not None else None)
        cap = (self.pending_caps.get(mid, self.max_pending_rows)
               if mid is not None else self.max_pending_rows)
        req = _Request(X, kind, trace_id, parent_id, model_id)
        with self._cond:
            if self._closed:
                raise LightGBMError("batcher is closed")
            # high-water-mark check: reject only when the queue is
            # already at/over the cap, so a single request larger than
            # the cap still lands on an idle server (the runtime chunks
            # arbitrarily large batches); the queue stays bounded by
            # cap + one request.  On a shared batcher the check runs
            # against the TENANT's own pending rows.
            pending = (self._pending_by_model.get(mid, 0)
                       if model_id is not None else self._rows_pending)
            if cap and pending >= cap:
                self.rejected += 1
                profiling.count("serve.rejected")
                if labels:
                    profiling.count(profiling.labeled("serve.rejected",
                                                      **labels))
                raise ServerOverloadedError(
                    f"serving queue full ({pending} rows "
                    f"pending, cap {cap}"
                    + (f", model {mid}" if mid else "") + "); retry later")
            self._queue.append(req)
            self._rows_pending += X.shape[0]
            if model_id is not None:
                self._pending_by_model[model_id] = (
                    self._pending_by_model.get(model_id, 0) + X.shape[0])
            depth = len(self._queue)
            self._cond.notify_all()
        profiling.count("serve.requests")
        profiling.observe("serve.queue_depth", depth)
        if labels:
            profiling.count(profiling.labeled("serve.requests",
                                              **labels))
            profiling.count(profiling.labeled("serve.rows",
                                              **labels),
                            X.shape[0])
            profiling.observe(profiling.labeled("serve.queue_depth",
                                                **labels), depth)
        return req.future

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def pending_rows_for(self, model_id: str) -> int:
        """One tenant's pending rows on a shared batcher (its /stats
        queue view — the global queue_depth spans every tenant)."""
        with self._cond:
            return self._pending_by_model.get(model_id, 0)

    def cap_for(self, model_id: str) -> int:
        """One tenant's admission cap (override or the shared default)."""
        return self.pending_caps.get(model_id, self.max_pending_rows)

    def close(self) -> None:
        """Stop accepting work, flush what is queued, join the threads."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=30)

    # -- flusher side ---------------------------------------------------

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until a batch is due (rows cap reached, deadline hit, or
        close); None means closed-and-drained.  The batch admits every
        request that arrives before it is taken — admission closes at
        dispatch, not at first-request time."""
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                self._cond.wait()
            deadline = self._queue[0].t_enqueue + self.flush_deadline_s
            while (self._rows_pending < self.max_batch_rows
                   and not self._closed):
                remaining = deadline - _now()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
                if not self._queue:
                    # another worker (or close) drained it — go around
                    return None if self._closed else []
                # the oldest request may have changed under a concurrent
                # worker; recompute so this batch's deadline tracks ITS
                # oldest member, not a dispatched one's
                deadline = self._queue[0].t_enqueue + self.flush_deadline_s
            batch: List[_Request] = []
            rows = 0
            while self._queue:
                nxt = self._queue[0].X.shape[0]
                if batch and rows + nxt > self.max_batch_rows:
                    break
                req = self._queue.popleft()
                rows += req.X.shape[0]
                if req.model_id is not None:
                    left = (self._pending_by_model.get(req.model_id, 0)
                            - req.X.shape[0])
                    if left > 0:
                        self._pending_by_model[req.model_id] = left
                    else:
                        self._pending_by_model.pop(req.model_id, None)
                batch.append(req)
            self._rows_pending -= rows
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            if batch:
                self._flush(batch)

    def _flush(self, batch: List[_Request]) -> None:
        # pin ONE runtime for the whole batch: no request ever spans a
        # half-swapped model
        try:
            runtime = (self._source.current()
                       if hasattr(self._source, "current") else self._source)
        except Exception as e:                     # registry load failure
            for req in batch:
                req.future.set_exception(e)
            return
        if hasattr(runtime, "predict_mixed"):
            self._flush_mixed(batch, runtime)
            return
        with self._cond:
            # flusher threads race on this read-modify-write; the stats
            # endpoints read it live
            self.batches_flushed += 1
        profiling.count("serve.batches")
        # group by (kind, feature width) so a malformed request only
        # fails its own group, never the neighbors that batched with it
        groups: dict = {}
        for req in batch:
            groups.setdefault((req.kind, req.X.shape[1]), []).append(req)
        for (kind, _f), reqs in groups.items():
            X = (reqs[0].X if len(reqs) == 1
                 else np.concatenate([r.X for r in reqs], axis=0))
            # the batch span runs under the OLDEST member's trace (its
            # deadline shaped the flush); every member's own trace gets
            # a `serve.dispatch` event naming the batch trace below, so
            # any single trace id still reconstructs its whole path
            leader = reqs[0]
            try:
                with telemetry.span(
                        "serve.batch", trace_id=leader.trace_id,
                        parent_id=leader.parent_id, kind=kind,
                        rows=int(X.shape[0]), requests=len(reqs)):
                    preds = runtime.predict(X, kind=kind)
            except Exception as e:
                for req in reqs:
                    req.future.set_exception(e)
                continue
            now = _now()
            generation = getattr(runtime, "generation", 0)
            off = 0
            for req in reqs:
                n = req.X.shape[0]
                # stamp the scoring generation before set_result so a
                # waiter that wakes on result() always sees it
                req.future.generation = generation
                req.future.set_result(preds[off:off + n])
                off += n
                wait_ms = (now - req.t_enqueue) * 1e3
                profiling.observe("serve.latency_ms", wait_ms)
                if self._labels:
                    profiling.observe(
                        profiling.labeled("serve.latency_ms",
                                          **self._labels), wait_ms)
                telemetry.event(
                    "serve.dispatch", trace_id=req.trace_id,
                    parent_id=req.parent_id, rows=n, kind=kind,
                    generation=generation,
                    batch_trace=leader.trace_id,
                    batch_requests=len(reqs),
                    wait_ms=round(wait_ms, 3))
            # shadow canary (registry.maybe_shadow): double-score this
            # group on a staged candidate AFTER every client's future
            # resolved — stable-path latency never includes it.  One
            # attribute read when no candidate is pending.
            shadow = getattr(self._source, "maybe_shadow", None)
            if shadow is not None:
                try:
                    shadow(X, kind, preds, requests=len(reqs))
                except Exception as e:  # noqa: BLE001 — the canary
                    # must never take the flusher down
                    log.warning(f"shadow scoring failed: "
                                f"{type(e).__name__}: {e}")

    def _flush_mixed(self, batch: List[_Request], runtime) -> None:
        """Dispatch one CROSS-MODEL batch on a GroupRuntime: every
        request carries its tenant, the group scores the mixed rows in
        one launch per chunk, and the demuxed per-request answers are
        charged — latency, dispatch events, shadow comparisons — to
        each request's OWN tenant, never to the group."""
        with self._cond:
            # same read-modify-write race as _flush: workers > 1 means
            # concurrent mixed flushes
            self.batches_flushed += 1
        profiling.count("serve.batches")
        # group by kind only: member widths differ legitimately (each
        # request validates against its own tenant's feature contract
        # inside predict_mixed), so width is not a batching boundary
        groups: dict = {}
        for req in batch:
            groups.setdefault(req.kind, []).append(req)
        for kind, reqs in groups.items():
            jobs = []
            routable = []
            for req in reqs:
                g = runtime.member_index.get(req.model_id)
                if g is None:
                    # the tenant left this group between enqueue and
                    # flush (a restack regrouped it) — fail THIS
                    # request; the client's retry re-routes correctly
                    req.future.set_exception(LightGBMError(
                        f"model {req.model_id!r} is no longer served "
                        "by this co-stack group; retry"))
                    continue
                jobs.append((g, req.X))
                routable.append(req)
            if not jobs:
                continue
            rows = int(sum(X.shape[0] for _g, X in jobs))
            leader = routable[0]
            try:
                with telemetry.span(
                        "serve.batch", trace_id=leader.trace_id,
                        parent_id=leader.parent_id, kind=kind,
                        rows=rows, requests=len(routable),
                        group=runtime.model_id):
                    outs = runtime.predict_mixed(jobs, kind=kind)
            except Exception as e:
                for req in routable:
                    req.future.set_exception(e)
                continue
            now = _now()
            generation = getattr(runtime, "generation", 0)
            for req, out in zip(routable, outs):
                req.future.generation = generation
                req.future.set_result(out)
                wait_ms = (now - req.t_enqueue) * 1e3
                profiling.observe("serve.latency_ms", wait_ms)
                if req.model_id is not None:
                    profiling.observe(
                        profiling.labeled("serve.latency_ms",
                                          model=req.model_id), wait_ms)
                telemetry.event(
                    "serve.dispatch", trace_id=req.trace_id,
                    parent_id=req.parent_id, rows=req.X.shape[0],
                    kind=kind, generation=generation,
                    model=req.model_id, group=runtime.model_id,
                    batch_trace=leader.trace_id,
                    batch_requests=len(routable),
                    wait_ms=round(wait_ms, 3))
            # per-MEMBER shadow canaries, after every future resolved:
            # each tenant's staged candidate double-scores only its own
            # rows, against its own stable answers, on its own solo
            # candidate runtime — a neighbor's canary never sees this
            # tenant's traffic
            shadow = getattr(self._source, "shadow_member", None)
            if shadow is None:
                continue
            by_member: dict = {}
            for req, out in zip(routable, outs):
                by_member.setdefault(req.model_id, []).append(
                    (req.X, out))
            for mid, pairs in by_member.items():
                try:
                    Xm = (pairs[0][0] if len(pairs) == 1 else
                          np.concatenate([p[0] for p in pairs], axis=0))
                    pm = (pairs[0][1] if len(pairs) == 1 else
                          np.concatenate([p[1] for p in pairs], axis=0))
                    shadow(mid, Xm, kind, pm, requests=len(pairs))
                except Exception as e:  # noqa: BLE001 — the canary
                    # must never take the flusher down
                    log.warning(f"shadow scoring failed for {mid}: "
                                f"{type(e).__name__}: {e}")
