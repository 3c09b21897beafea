"""Runtime retrace and host-sync sanitizer for the training and serving
hot paths, and the counter names of the lock sanitizer.

Port of lightgbm_tpu/diagnostics/sanitize.py: `sanitize_enabled`, the
`sanitize/*` counter names and `HotPathSanitizer`.  The JAX module caught
implicit host<->device transfers with `jax.transfer_guard` and retraces
with jax's compile log.  In PyTorch the same two hazards are:

- a synchronising CUDA call inside the loop (`.item()`, `.cpu()`,
  `bool()` of a tensor, a boolean-mask index, `nonzero`, a blocking
  host->device copy): each one stalls the host until the card drains.
  Inside a post-warmup `step()` on a machine with a CUDA device,
  `torch.cuda.set_sync_debug_mode("error")` is armed, so the violating
  call raises; the step counts it in `sanitize/implicit_transfers`.
  A deliberate transfer (the one packed read of a finished tree, a
  per-tree upload drawn on the host) runs inside `explicit_transfer()`,
  which lifts the guard for its block, as `jax.device_get` /
  `jax.device_put` stayed legal under the JAX guard.
- a compile inside the loop: the port compiles only its CUDA kernel
  libraries (kernels.py: one nvcc build a source, one load each), so a
  build or load event inside a post-warmup step counts in
  `sanitize/retraces`; every nvcc build in the window counts in
  `sanitize/compiles_total`.

`DivergenceSanitizer` is the cross-rank fingerprint audit of the mesh
learners.  The JAX class compared the per-device copies of each
replicated array inside one process; here the copies live in the ranks'
processes, so each rank digests (sha1) the bytes of the replicated tree
state it already read to the host — the packed tree vector of the
tree's one read and the leaf counts — the digests are all_gathered over
the world, and equal digests count `sanitize/divergence_checks`, unequal
ones `sanitize/divergences` and (strict, the default) raise.
`maybe_check_divergence` runs it under the same BENCH_SANITIZE switch.

Lock-sanitizer counters (diagnostics/locksan.py):
- LOCK_ACQUIRES: outermost acquisitions seen by the instrumented shim;
- LOCK_WAITS: acquisitions that found the lock busy and had to block
  (the wait itself lands in LOCK_WAIT_MS);
- LOCK_CYCLES: lock-ORDER cycles detected at acquire time, the latent
  ABBA deadlock (must stay 0);
- LOCK_HOLD_MS / LOCK_WAIT_MS: bounded sample reservoirs (per-lock
  labeled series ride the same names).
"""
from __future__ import annotations

import contextlib
from contextlib import contextmanager
from typing import Iterator

from .. import profiling

RETRACES = "sanitize/retraces"
IMPLICIT_TRANSFERS = "sanitize/implicit_transfers"
COMPILES_TOTAL = "sanitize/compiles_total"
DIVERGENCE_CHECKS = "sanitize/divergence_checks"
DIVERGENCES = "sanitize/divergences"

LOCK_ACQUIRES = "sanitize/lock_acquires"
LOCK_WAITS = "sanitize/lock_waits"
LOCK_CYCLES = "sanitize/lock_cycles"
LOCK_HOLD_MS = "sanitize/lock_hold_ms"
LOCK_WAIT_MS = "sanitize/lock_wait_ms"

# the message of the error torch raises under sync debug mode "error"
_SYNC_MARKER = "called a synchronizing CUDA operation"

def sanitize_enabled(env: str = "BENCH_SANITIZE") -> bool:
    """One truthiness rule for the BENCH_SANITIZE gates."""
    import os
    return os.environ.get(env, "0") not in ("0", "", "false")


def _is_transfer_guard_error(e: BaseException) -> bool:
    return _SYNC_MARKER in str(e)


@contextmanager
def explicit_transfer() -> Iterator[None]:
    """A deliberate host<->device transfer: inside a guarded step, lift
    the sync guard for this block and restore it after.  Outside a
    guarded step (and on the CPU) it changes nothing."""
    import torch
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    if prev == 0:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _digest_words(x) -> "np.ndarray":
    """sha1 of an array's bytes as 3 int64 words (zero-padded)."""
    import hashlib

    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        with explicit_transfer():
            x = x.detach().cpu().numpy()
    buf = np.ascontiguousarray(np.asarray(x)).tobytes()
    d = hashlib.sha1(buf).digest() + bytes(4)
    return np.frombuffer(d, np.int64).copy()


def _replica_digests(mesh, value: dict) -> list:
    """[(name, [digest hex of each rank])] of every entry of `value`:
    this rank's digests all_gathered over the mesh's world."""
    import numpy as np
    import torch
    names = list(value)
    words = np.stack([_digest_words(value[k]) for k in names])  # [n, 3]
    t = torch.as_tensor(words, device=mesh.collective_device())
    with explicit_transfer():
        allw = mesh.all_gather(t).cpu().numpy()             # [W, n, 3]
    return [(k, [allw[r, i].tobytes().hex()[:40]
                 for r in range(allw.shape[0])])
            for i, k in enumerate(names)]


class DivergenceSanitizer:
    """Cross-rank replication checker of the mesh learners.

    The mesh learners keep the growth loop's control flow and the tree
    replicated: the split records after the exchange, the leaf counts,
    the packed tree.  A rank-local value leaking into that state gives
    ranks trees that silently disagree, and collectives that no longer
    pair up (a deadlock).  ``check(mesh, name, value)`` digests every
    entry of `value` (a dict of host arrays or tensors) on every rank
    and compares the all_gathered digests: identical -> one
    ``sanitize/divergence_checks`` tick an entry; any mismatch ->
    ``sanitize/divergences`` and (strict, the default) an AssertionError
    naming the entry and the ranks' digests."""

    def __init__(self, label: str = "growth-loop", strict: bool = True):
        self.label = label
        self.strict = strict
        self.checks = 0
        self.divergences = 0
        self.evidence = []

    def check(self, mesh, name: str, value: dict) -> int:
        """Compare the ranks' digests of `value`.  Returns the number of
        NEW divergences found."""
        before = self.divergences
        for key, digs in _replica_digests(mesh, value):
            self.checks += 1
            profiling.count(DIVERGENCE_CHECKS)
            if len(set(digs)) > 1:
                self.divergences += 1
                profiling.count(DIVERGENCES)
                ev = (name, key, [(r, d[:12]) for r, d in enumerate(digs)])
                if len(self.evidence) < 16:
                    self.evidence.append(ev)
                if self.strict:
                    raise AssertionError(
                        f"cross-rank divergence [{self.label}] in "
                        f"'{name}/{key}': a replicated growth-loop value "
                        f"differs across ranks {ev[2]} — a rank-local "
                        "value leaked into replicated state")
        return self.divergences - before

    def report(self) -> dict:
        return {"label": self.label,
                "divergence_checks": self.checks,
                "divergences": self.divergences,
                "evidence": self.evidence[:4]}


_divergence = None


def divergence_sanitizer() -> DivergenceSanitizer:
    """The process-wide strict instance the learner hooks feed."""
    global _divergence
    if _divergence is None:
        _divergence = DivergenceSanitizer(label="hot-path")
    return _divergence


def maybe_check_divergence(mesh, name: str, value: dict) -> None:
    """Hot-loop hook (every mesh learner calls it after each tree's
    read): no-op unless BENCH_SANITIZE is on, else a strict cross-rank
    replication check of `value`."""
    if not sanitize_enabled():
        return
    divergence_sanitizer().check(mesh, name, value)


def _build_events():
    from .. import kernels
    return kernels.BUILD_EVENTS


class HotPathSanitizer:
    """Context manager asserting the zero-retrace / zero-implicit-
    transfer contract of a steady-state loop.

    Usage::

        with HotPathSanitizer(warmup=1) as san:
            for _ in range(iters):
                with san.step():
                    bst.update()
        assert san.retraces == 0 and san.implicit_transfers == 0

    ``warmup`` steps may build kernels freely and run unguarded; a build
    in any later step counts as a retrace.  A guard violation inside a
    post-warmup ``step()`` increments the counter and, with
    ``strict=False`` (default), is swallowed so one run can report the
    total instead of dying at the first violation — the violating
    iteration's work is aborted where it raised, so non-strict mode is
    for measuring breakage, not for training through it.  The guard is
    always JAX's "disallow" (sync debug mode "error"); the JAX class's
    ``guard`` and ``d2d_guard`` levels have no caller here, and a
    device-to-device copy never synchronises the host in PyTorch.
    """

    def __init__(self, warmup: int = 1, strict: bool = False,
                 label: str = "hot_path"):
        self.warmup = int(warmup)
        self.guard = "disallow"
        self.strict = strict
        self.label = label
        self.steps = 0
        self.retraces = 0
        self.implicit_transfers = 0
        self.compiles_total = 0
        self.trace_events = 0
        self.compile_names = []
        self.divergence_checks = 0
        self.divergences = 0
        self._div0 = (0.0, 0.0)
        self.lock_acquires = 0
        self.lock_waits = 0
        self.lock_cycles = 0
        self._lock0 = (0.0, 0.0, 0.0)
        self._ev0 = 0

    # -- lifecycle ------------------------------------------------------
    def __enter__(self) -> "HotPathSanitizer":
        self._ev0 = len(_build_events())
        self._div0 = (profiling.counter_value(DIVERGENCE_CHECKS),
                      profiling.counter_value(DIVERGENCES))
        self._lock0 = (profiling.counter_value(LOCK_ACQUIRES),
                       profiling.counter_value(LOCK_WAITS),
                       profiling.counter_value(LOCK_CYCLES))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        ev = _build_events()[self._ev0:]
        self.trace_events = len(ev)
        self.compiles_total = sum(1 for kind, _ in ev if kind == "build")
        self.compile_names = [name for _, name in ev][:64]
        profiling.count(RETRACES, self.retraces)
        profiling.count(IMPLICIT_TRANSFERS, self.implicit_transfers)
        profiling.count(COMPILES_TOTAL, self.compiles_total)
        self.divergence_checks = int(
            profiling.counter_value(DIVERGENCE_CHECKS) - self._div0[0])
        self.divergences = int(
            profiling.counter_value(DIVERGENCES) - self._div0[1])
        self.lock_acquires = int(
            profiling.counter_value(LOCK_ACQUIRES) - self._lock0[0])
        self.lock_waits = int(
            profiling.counter_value(LOCK_WAITS) - self._lock0[1])
        self.lock_cycles = int(
            profiling.counter_value(LOCK_CYCLES) - self._lock0[2])
        return False

    # -- per-iteration accounting --------------------------------------
    @contextmanager
    def step(self) -> Iterator[None]:
        """One hot-loop iteration.  Warmup steps run unguarded (a first
        call builds and loads kernels and uploads constants); later
        steps run with the sync guard armed on a CUDA machine and count
        kernel builds as retraces."""
        import torch
        before = len(_build_events())
        guarded = self.steps >= self.warmup
        armed = guarded and torch.cuda.is_available()
        try:
            with contextlib.ExitStack() as stack:
                if armed:
                    prev = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("error")
                    stack.callback(torch.cuda.set_sync_debug_mode, prev)
                yield
        except Exception as e:   # noqa: BLE001 — classify, then re-raise
            if guarded and _is_transfer_guard_error(e):
                self.implicit_transfers += 1
                if self.strict:
                    raise
            else:
                raise
        finally:
            self.steps += 1
            new = len(_build_events()) - before
            if self.steps > self.warmup and new:
                self.retraces += new

    # -- reporting ------------------------------------------------------
    def report(self) -> dict:
        """JSON-ready summary, with the JAX package's keys."""
        return {
            "label": self.label,
            "guard": self.guard,
            "steps": self.steps,
            "warmup": self.warmup,
            "retraces_after_warmup": self.retraces,
            "implicit_transfers": self.implicit_transfers,
            "trace_events_total": self.trace_events,
            "compiles_total": self.compiles_total,
            "divergence_checks": self.divergence_checks,
            "divergences": self.divergences,
            "lock_acquires": self.lock_acquires,
            "lock_waits": self.lock_waits,
            "lock_cycles": self.lock_cycles,
            "retrace_names": self.compile_names[-8:] if self.retraces else [],
        }

    def check(self) -> None:
        """Raise with a diagnostic when the zero/zero/zero contract is
        broken (retraces, implicit transfers, cross-shard divergences,
        lock-order cycles)."""
        if self.retraces or self.implicit_transfers or self.divergences \
                or self.lock_cycles:
            from . import locksan
            raise AssertionError(
                f"hot-path sanitizer [{self.label}]: "
                f"{self.retraces} retrace(s), "
                f"{self.implicit_transfers} implicit transfer(s), "
                f"{self.divergences} cross-shard divergence(s) and "
                f"{self.lock_cycles} lock-order cycle(s) after "
                f"{self.warmup} warmup step(s) over {self.steps} steps; "
                f"recent builds: {self.compile_names[-8:]}; "
                f"lock cycles: {locksan.cycles()[:4]}")


@contextmanager
def fused_tree_steps(san: HotPathSanitizer) -> Iterator[None]:
    """Run every FusedTreeLearner.train (one tree) inside one
    `san.step()`, so the fused builder's trees are the steps the
    sanitizer checks."""
    from ..learner.fused import FusedTreeLearner
    real = FusedTreeLearner.train

    def train(self, *a, **k):
        with san.step():
            return real(self, *a, **k)
    FusedTreeLearner.train = train
    try:
        yield
    finally:
        FusedTreeLearner.train = real
