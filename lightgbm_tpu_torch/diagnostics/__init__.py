"""Diagnostics of the serving plane: the deterministic fault-injection
registry (`faults`), the runtime lock sanitizer (`locksan`) and the
names of its counters (`sanitize`).  All three are standard library
only, copies of lightgbm_tpu/diagnostics/."""
