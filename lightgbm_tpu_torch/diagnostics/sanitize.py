"""Counter names of the lock sanitizer (diagnostics/locksan.py), as
lightgbm_tpu/diagnostics/sanitize.py defines them; the serving /stats
and /metrics endpoints read them.  The JAX module's hot-path sanitizer
(recompile and host-sync checks) is ROADMAP.md §A item 15.

- LOCK_ACQUIRES: outermost acquisitions seen by the instrumented shim;
- LOCK_WAITS: acquisitions that found the lock busy and had to block
  (the wait itself lands in LOCK_WAIT_MS);
- LOCK_CYCLES: lock-ORDER cycles detected at acquire time, the latent
  ABBA deadlock (must stay 0);
- LOCK_HOLD_MS / LOCK_WAIT_MS: bounded sample reservoirs (per-lock
  labeled series ride the same names).
"""
LOCK_ACQUIRES = "sanitize/lock_acquires"
LOCK_WAITS = "sanitize/lock_waits"
LOCK_CYCLES = "sanitize/lock_cycles"
LOCK_HOLD_MS = "sanitize/lock_hold_ms"
LOCK_WAIT_MS = "sanitize/lock_wait_ms"
