"""Consistent-hash tenant→backend placement.

A copy of lightgbm_tpu/router/placement.py: every key lands on the same
backend as under the JAX package's ring.

A hash ring with virtual nodes — `VNODES` sha1 points per backend, so
arcs are evenly sized without any RNG or wall clock and the ring is
identical across processes and runs.  ``place(model_id, alive)``
hashes the model id onto the ring and walks clockwise to the first
point owned by an alive backend, which yields both router properties
in one mechanism:

- **stability** — adding or removing ONE backend moves only the
  tenants whose arcs it owned (~1/M of them); every other tenant keeps
  its backend;
- **draining re-placement** — an open-breaker backend simply drops out
  of ``alive``: its tenants land on the next backend clockwise, and
  return home the moment the breaker closes, with no state to migrate
  (backends are model-stateless; each loads from its own model path).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Optional, Set, Tuple


def _point(key: str) -> int:
    """64-bit ring position of ``key`` (sha1 — stable across runs,
    unlike hash())."""
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


class HashRing:
    """Static ring over the configured backend fleet; liveness is a
    per-call filter, not ring surgery, so placement under failures and
    placement under reconfiguration are the same walk."""

    VNODES = 64          # points per backend: arc-size variance ~1/sqrt(64)

    def __init__(self, backends: Iterable[str]):
        self.backends: Tuple[str, ...] = tuple(backends)
        pts = sorted((_point(f"{b}#{i}"), b)
                     for b in self.backends for i in range(self.VNODES))
        self._points = [p for p, _ in pts]
        self._owners = [b for _, b in pts]

    def place(self, key: str,
              alive: Optional[Iterable[str]] = None) -> Optional[str]:
        """The backend owning ``key``, restricted to ``alive`` backends
        (None = all configured).  None when no alive backend exists."""
        if not self.backends:
            return None
        alive_set: Set[str] = set(
            self.backends if alive is None else alive)
        if not alive_set:
            return None
        start = bisect.bisect_right(self._points, _point(key))
        n = len(self._points)
        for off in range(n):
            owner = self._owners[(start + off) % n]
            if owner in alive_set:
                return owner
        return None
