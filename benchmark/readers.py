"""The arithmetic behind the metric files of metrics/: each reads one
number from a finished run, or returns None where the run has nothing
for it to read."""
from __future__ import annotations

from statistics import mean
from typing import Optional

from . import spec


def setup_s(run) -> float:
    return run.setup_s


def iter_s(run) -> Optional[float]:
    return run.seconds / run.iterations if run.iterations else None


def construct_s(run) -> float:
    return run.construct_s


def job_start_s(run) -> Optional[float]:
    return run.job_start_s


def syncs_per_tree(run) -> Optional[float]:
    s = run.syncs_per_tree
    return float(mean(s)) if s else None


def launches_per_iter(run) -> Optional[float]:
    if (run.trace is None or not run.slice_iterations
            or not run.trace.launches):
        return None
    return run.trace.launches / run.slice_iterations


def idle_pct(run) -> Optional[float]:
    if run.trace is None or not run.slice_s:
        return None
    busy = run.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.slice_s)


def roofline_pct(run, step: str) -> Optional[float]:
    """The step's least time over the device time of its kernels, in the
    profiled slice; None where none of its kernels ran."""
    if run.trace is None:
        return None
    t = run.trace.kernel_s(spec.kernel_names(step))
    if t <= 0:
        return None
    return 100.0 * run.hist_least_s() / t


def mfu_pct(run) -> Optional[float]:
    """The least time of the profiled slice's iterations, on average, over
    the window's measured time an iteration."""
    it = iter_s(run)
    least = run.iter_least_s()
    if it is None or least is None:
        return None
    return 100.0 * least / it
