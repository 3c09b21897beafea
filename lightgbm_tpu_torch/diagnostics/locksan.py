"""Runtime lock sanitizer for the threaded serving plane.

A copy of lightgbm_tpu/diagnostics/locksan.py (standard library and the
port's profiling registry).  It records the acquisition orders and the
contention the serving fleet actually shows under load.  The shim
follows the faults.py arming model: the ``lock()`` / ``rlock()`` /
``condition()`` factories check one module flag at CREATION time and
hand back the plain stdlib primitive when off, so a disarmed serving
process runs the exact objects it always did.  Armed
(``LIGHTGBM_TPU_LOCKSAN=1`` or ``BENCH_SANITIZE=1``, read at import;
``arm()`` programmatically), each factory returns an instrumented
wrapper that records:

- the per-thread HELD-LOCK STACK and the global acquisition-order
  graph: acquiring B while holding A inserts the edge A→B; an edge
  whose reverse path already exists is a lock-ORDER CYCLE — the latent
  ABBA deadlock — counted in ``sanitize/lock_cycles`` with the witness
  path kept in ``cycles()``.  Detection happens at edge-insert time,
  BEFORE blocking on the inner lock, so a would-deadlock acquire still
  reports its cycle.
- contention: an acquire that finds the lock busy counts one
  ``sanitize/lock_waits`` and lands its wait in the
  ``sanitize/lock_wait_ms`` reservoir (per-lock labeled series ride
  the same base name);
- hold time: outermost release lands in ``sanitize/lock_hold_ms``.

Counters flow through the always-on profiling registry, so the serving
/stats and /metrics endpoints expose them.

Non-blocking acquires (``acquire(blocking=False)``) insert no order
edges — a try-lock cannot deadlock (registry._shadow_verdict).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from .. import profiling
from .sanitize import (LOCK_ACQUIRES, LOCK_CYCLES, LOCK_HOLD_MS,
                       LOCK_WAIT_MS, LOCK_WAITS)

ENV_VAR = "LIGHTGBM_TPU_LOCKSAN"

_armed = False

# sanitizer-internal state; _meta guards the order graph and evidence.
# _meta is ALWAYS innermost (nothing is acquired under it), so the
# sanitizer cannot itself create an ordering hazard.
_meta = threading.Lock()
_edges: Dict[str, Set[str]] = {}           # a -> {b}: b acquired under a
_edge_sites: Dict[Tuple[str, str], str] = {}   # first witness per edge
_cycles: List[dict] = []                   # bounded evidence
_tls = threading.local()                   # .stack: [(name, t_acquire)]


def arm() -> None:
    """Make the factories hand out instrumented locks from now on.
    Locks created while disarmed stay plain — arm before the stack is
    built (the serving entry points read the env at import)."""
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def armed() -> bool:
    return _armed


def arm_from_env(env: str = ENV_VAR) -> bool:
    """(Re)arm from ``LIGHTGBM_TPU_LOCKSAN`` (the chip-queue flag) or
    ``BENCH_SANITIZE`` (every sanitized bench window); True iff armed."""
    on = any(os.environ.get(v, "0") not in ("0", "", "false")
             for v in (env, "BENCH_SANITIZE"))
    if on:
        arm()
    return on


def reset() -> None:
    """Clear the order graph and evidence (between test scenarios).
    Per-thread held stacks are left alone — callers must not reset
    while locks are held."""
    with _meta:
        _edges.clear()
        _edge_sites.clear()
        _cycles.clear()


def cycles() -> List[dict]:
    """Witnessed lock-order cycles: {"edge": (a, b), "path": [...],
    "thread": name} — the evidence block serving benches embed."""
    with _meta:
        return list(_cycles)


def order_graph() -> Dict[str, Set[str]]:
    with _meta:
        return {a: set(bs) for a, bs in _edges.items()}


def _stack() -> List[Tuple[str, float]]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _path(src: str, dst: str) -> Optional[List[str]]:
    """A path src→…→dst in the order graph, or None.  Caller holds
    _meta.  Iterative DFS — the graph is a handful of named locks."""
    seen = {src}
    trail = [[src]]
    while trail:
        cur = trail.pop()
        node = cur[-1]
        if node == dst:
            return cur
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                trail.append(cur + [nxt])
    return None


def _note_acquired(name: str) -> None:
    """Held-stack + order-graph bookkeeping for one OUTERMOST acquire
    intent.  Called before blocking so a real deadlock still reports."""
    st = _stack()
    profiling.count(LOCK_ACQUIRES)
    if st:
        with _meta:
            for held, _t0 in st:
                if held == name or name in _edges.get(held, ()):
                    continue
                # new edge held→name: a reverse path name→…→held in the
                # existing graph means some thread acquires in the
                # opposite order — a lock-order cycle
                back = _path(name, held)
                _edges.setdefault(held, set()).add(name)
                if back is not None:
                    profiling.count(LOCK_CYCLES)
                    if len(_cycles) < 32:
                        _cycles.append({
                            "edge": (held, name),
                            "path": back + [name],
                            "thread": threading.current_thread().name})


class _SanLock:
    """Instrumented Lock/RLock wrapper.  Exposes the stdlib lock
    interface plus the ``_release_save`` / ``_acquire_restore`` /
    ``_is_owned`` hooks, so a ``threading.Condition`` built ON a
    sanitized rlock keeps RLock recursion AND routes its wait-time
    release/reacquire through the sanitizer's bookkeeping."""

    def __init__(self, name: str, inner, reentrant: bool):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant

    # -- core interface -------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        depth = getattr(_tls, "depth", None)
        if depth is None:
            depth = _tls.depth = {}
        d = depth.get(self.name, 0)
        if d and self._reentrant:          # re-entry: no new edges
            got = self._inner.acquire(blocking, timeout)
            if got:
                depth[self.name] = d + 1
            return got
        if not blocking:
            # a try-lock cannot deadlock: no order edges, no wait
            got = self._inner.acquire(False)
            if got:
                profiling.count(LOCK_ACQUIRES)
                depth[self.name] = d + 1
                _stack().append((self.name, time.perf_counter()))
            return got
        _note_acquired(self.name)
        t0 = time.perf_counter()
        got = self._inner.acquire(False)
        if not got:
            profiling.count(LOCK_WAITS)
            got = self._inner.acquire(True, timeout)
            wait_ms = (time.perf_counter() - t0) * 1000.0
            profiling.observe(LOCK_WAIT_MS, wait_ms)
            profiling.observe(
                profiling.labeled(LOCK_WAIT_MS, lock=self.name), wait_ms)
        if got:
            depth[self.name] = d + 1
            _stack().append((self.name, time.perf_counter()))
        return got

    def release(self) -> None:
        depth = getattr(_tls, "depth", {})
        d = depth.get(self.name, 0)
        self._inner.release()
        if d > 1:
            depth[self.name] = d - 1
            return
        depth.pop(self.name, None)
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == self.name:
                _name, t0 = st.pop(i)
                hold_ms = (time.perf_counter() - t0) * 1000.0
                profiling.observe(LOCK_HOLD_MS, hold_ms)
                profiling.observe(
                    profiling.labeled(LOCK_HOLD_MS, lock=self.name),
                    hold_ms)
                break

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration ------------------------------------------
    # threading.Condition lifts these from its lock when present; the
    # inner rlock's versions handle recursion state, the wrapper keeps
    # the held-stack honest across the wait's release/reacquire window.
    def _release_save(self):
        # Condition.wait drops ALL recursion levels at once: clear the
        # wrapper bookkeeping first, then delegate the real release to
        # the inner lock in one shot
        depth = getattr(_tls, "depth", {})
        depth.pop(self.name, None)
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == self.name:
                _name, t0 = st.pop(i)
                hold_ms = (time.perf_counter() - t0) * 1000.0
                profiling.observe(LOCK_HOLD_MS, hold_ms)
                profiling.observe(
                    profiling.labeled(LOCK_HOLD_MS, lock=self.name),
                    hold_ms)
                break
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        depth = getattr(_tls, "depth", None)
        if depth is None:
            depth = _tls.depth = {}
        _note_acquired(self.name)
        depth[self.name] = depth.get(self.name, 0) + 1
        _stack().append((self.name, time.perf_counter()))

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def lock(name: str):
    """A named mutex: plain ``threading.Lock`` when disarmed, the
    instrumented shim when armed.  ``name`` keys the order graph and
    the per-lock labeled hold/wait series ("serve.batcher",
    "route.server", …) — keep it identifier-shaped."""
    if not _armed:
        return threading.Lock()
    return _SanLock(name, threading.Lock(), reentrant=False)


def rlock(name: str):
    if not _armed:
        return threading.RLock()
    return _SanLock(name, threading.RLock(), reentrant=True)


def condition(name: str):
    """A named ``threading.Condition``: the stdlib one (over its
    default RLock) when disarmed, one built on an instrumented rlock
    when armed — waiters' release/reacquire flows through the shim via
    the ``_release_save``/``_acquire_restore`` hooks."""
    if not _armed:
        return threading.Condition()
    return threading.Condition(rlock(name))


def check() -> None:
    """Assert NO lock-order cycles were witnessed process-wide.  The
    serving benches call this after printing their JSON (so the
    evidence always lands in the chip-queue log first) — the runtime
    half of the 0-retrace/0-transfer steady-state contract."""
    cyc = cycles()
    assert not cyc, (
        f"LockSanitizer: {len(cyc)} lock-order cycle(s) witnessed "
        f"(latent ABBA deadlock): {cyc[:4]}")


def report() -> dict:
    """JSON-ready evidence block (the serving benches embed this
    beside HotPathSanitizer.report())."""
    with _meta:
        return {
            "armed": _armed,
            "locks": sorted(set(_edges)
                            | {b for bs in _edges.values() for b in bs}),
            "order_edges": sorted((a, b) for a, bs in _edges.items()
                                  for b in bs),
            "cycles": list(_cycles[:8]),
        }


arm_from_env()
