"""Deterministic fault injection at named seams.

A copy of lightgbm_tpu/diagnostics/faults.py (standard library only).
Robustness claims ("the fleet survives a throwing replica") are only as
good as the failures they were tested against.  This registry lets the
tests inject failures at NAMED SEAMS in the product code,
deterministically:

- every seam is a (site, sequence) pair — the Nth time execution
  reaches ``site`` — with no wall clock and no global RNG involved, so
  a chaos run is exactly reproducible from its spec string;
- the product code carries one cheap call per seam (``check(site)`` /
  ``fire(site)``); with nothing armed the cost is one dict check and
  the registry never allocates;
- torn-write seams (``torn_write``/``torn_copy``) simulate a process
  dying mid-write: HALF the payload lands at the destination path, then
  ``InjectedFault`` raises — the caller's recovery path, not its happy
  path, meets the file.

Arming:

- environment: ``LIGHTGBM_TPU_FAULTS="site:1,3;other:2-4;every.hit:*"``
  (read once at import; ``arm_from_env()`` re-reads);
- programmatic: ``faults.arm("serve.dispatch.r0:1-3")`` — tests arm and
  ``reset()`` around each scenario.

Spec grammar: ``site:seqs`` groups separated by ``;``; ``seqs`` is a
comma list of 1-based sequence numbers and ``a-b`` ranges, or ``*``
(every hit).  A bare ``site`` means ``site:*``.

Sites wired into the port: ``serve.dispatch`` / ``serve.dispatch.r<N>``
— a replica dispatch (any / replica N) raises before executing
(serving/runtime.py).  The JAX package's training, router and online
seams come with those modules.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, FrozenSet, Optional, Union

ENV_VAR = "LIGHTGBM_TPU_FAULTS"


class InjectedFault(Exception):
    """An injected failure (simulated crash/exception at a named seam)."""

    def __init__(self, site: str, seq: int):
        super().__init__(f"injected fault at {site} (hit #{seq})")
        self.site = site
        self.seq = seq


_lock = threading.Lock()
# site -> armed sequence numbers (frozenset), or None meaning EVERY hit
_plan: Dict[str, Optional[FrozenSet[int]]] = {}
_hits: Dict[str, int] = {}
_fired: Dict[str, int] = {}


def parse_spec(spec: str) -> Dict[str, Optional[FrozenSet[int]]]:
    """``"a:1,3-5;b:*;c"`` -> {"a": {1,3,4,5}, "b": None, "c": None}."""
    plan: Dict[str, Optional[FrozenSet[int]]] = {}
    for group in spec.replace("\n", ";").split(";"):
        group = group.strip()
        if not group:
            continue
        site, _, seqs = group.partition(":")
        site = site.strip()
        if not site:
            raise ValueError(f"empty site in fault spec group {group!r}")
        seqs = seqs.strip()
        if not seqs or seqs == "*":
            plan[site] = None
            continue
        nums = set()
        for part in seqs.split(","):
            part = part.strip()
            if not part:
                continue
            a, _, b = part.partition("-")
            lo = int(a)
            hi = int(b) if b else lo
            if lo < 1 or hi < lo:
                raise ValueError(f"bad sequence range {part!r} in fault "
                                 f"spec for site {site!r} (1-based)")
            nums.update(range(lo, hi + 1))
        prev = plan.get(site)
        if site in plan and prev is None:
            continue                       # "*" already covers everything
        plan[site] = frozenset(nums | set(prev or ()))
    return plan


def arm(spec: Union[str, Dict[str, Optional[FrozenSet[int]]]]) -> None:
    """Merge a spec into the active plan (hit counters keep running)."""
    plan = parse_spec(spec) if isinstance(spec, str) else dict(spec)
    with _lock:
        for site, seqs in plan.items():
            existing = _plan.get(site, frozenset())
            if seqs is None or existing is None:
                _plan[site] = None
            else:
                _plan[site] = frozenset(existing | seqs)


def arm_from_env() -> bool:
    """(Re)arm from ``LIGHTGBM_TPU_FAULTS``; True iff a spec was found."""
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return False
    arm(spec)
    return True


def disarm() -> None:
    """Drop the plan; hit counters keep their values (reset() clears)."""
    with _lock:
        _plan.clear()


def reset() -> None:
    """Clear plan AND counters — call between chaos scenarios."""
    with _lock:
        _plan.clear()
        _hits.clear()
        _fired.clear()


def armed() -> bool:
    return bool(_plan)


def fire(site: str) -> bool:
    """Record one hit at ``site``; True iff this (site, sequence) is
    armed.  The sequence is 1-based and counted whether or not a plan
    is active, so a spec armed mid-run still addresses hits by absolute
    sequence — use reset() for a fresh numbering."""
    if not _plan:
        return False                       # fast path: nothing armed
    with _lock:
        if site not in _plan:
            return False
        seq = _hits.get(site, 0) + 1
        _hits[site] = seq
        seqs = _plan[site]
        hit = seqs is None or seq in seqs
        if hit:
            _fired[site] = _fired.get(site, 0) + 1
    if hit:
        # a firing is an operator-relevant incident: it lands in the
        # span stream (under the current trace when one is active) so a
        # chaos run's timeline shows WHICH request/refresh met the
        # injected failure.  Emitted outside the lock; import is local
        # because this module must stay importable with zero deps.
        from .. import telemetry
        telemetry.event("fault.fired", site=site, seq=seq)
    return hit


def check(site: str) -> None:
    """Raise InjectedFault when this hit of ``site`` is armed."""
    if fire(site):
        raise InjectedFault(site, _hits.get(site, 0))


def torn_write(site: str, path: str, payload: Union[str, bytes]) -> None:
    """Torn-write seam: when this hit of ``site`` is armed, write HALF
    of ``payload`` to ``path`` (simulating a crash mid-write of the
    destination file) and raise InjectedFault.  No-op otherwise — the
    caller proceeds with its normal (atomic) write."""
    if not fire(site):
        return
    data = payload.encode() if isinstance(payload, str) else payload
    with open(path, "wb") as f:
        f.write(data[: max(1, len(data) // 2)])
    raise InjectedFault(site, _hits.get(site, 0))


def torn_copy(site: str, src: str, dst: str) -> None:
    """Like torn_write, but the payload is the current content of
    ``src`` (for writers that stage through a file, e.g. model saves)."""
    if not fire(site):
        return
    with open(src, "rb") as f:
        data = f.read()
    with open(dst, "wb") as f:
        f.write(data[: max(1, len(data) // 2)])
    raise InjectedFault(site, _hits.get(site, 0))


def hits(site: str) -> int:
    with _lock:
        return _hits.get(site, 0)


def fired(site: str) -> int:
    with _lock:
        return _fired.get(site, 0)


def snapshot() -> Dict[str, Dict[str, int]]:
    """Per-site {hits, fired} — the chaos bench's evidence block."""
    with _lock:
        sites = set(_hits) | set(_fired) | set(_plan)
        return {s: {"hits": _hits.get(s, 0), "fired": _fired.get(s, 0)}
                for s in sorted(sites)}


arm_from_env()
