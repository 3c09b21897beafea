"""Which phase of the program's training iteration each idle gap of the
device and each kernel launch of the profiled slice belongs to.

The program opens a host range `lgbt::<name>` around each phase
(lightgbm_tpu_torch/profiling.py); the profiler records it as a plain
host operation on the slice's clock.  At every instant the phase is the
innermost range open on the host: a range's self time, its interval
less the part its child ranges cover.  The parents `tree` and `bagging`
and any range outside PHASES attribute nothing: what they hold counts
as unattributed, as does what no range holds.

Idle: the complement of the union of device intervals between the
slice's first and last device activity, each gap split exactly at the
ranges' boundaries; the slice's seconds outside that span are idle under
no phase.  Launches: the host's kernel-launch API calls, each
given to the phase open when it starts.
"""
from __future__ import annotations

import bisect
import heapq
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

PREFIX = "lgbt::"

# metric phase -> the program's range it reads
PHASES = {
    "objective.gradients": "boosting",
    "learner.histogram": "learner.histogram",
    "learner.split_search": "learner.split_search",
    "learner.partition": "learner.partition",
    "learner.round": "learner.round",
    "score.update": "score",
    "metric.eval": "metric",
}

LAUNCH_APIS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernel", "cuLaunchKernelEx"))

Segment = Tuple[float, float, Optional[str]]


def segments(ranges: List[Tuple[str, float, float]]) -> List[Segment]:
    """(start, end, range name) pieces of the time the ranges cover, each
    named by the innermost range open in it: the latest started, and of
    two started together the shorter."""
    marks = sorted([(b, 0, i) for i, (_, _, b) in enumerate(ranges)]
                   + [(a, 1, i) for i, (_, a, _) in enumerate(ranges)])
    open_, heap, out = set(), [], []
    prev = None
    for t, kind, i in marks:
        while heap and heap[0][2] not in open_:
            heapq.heappop(heap)
        if heap and prev is not None and t > prev:
            out.append((prev, t, ranges[heap[0][2]][0]))
        prev = t
        if kind:
            open_.add(i)
            heapq.heappush(heap, (-ranges[i][1], ranges[i][2], i))
        else:
            open_.discard(i)
    return out


def idle_intervals(device: List[Tuple[str, float, float]]
                   ) -> List[Tuple[float, float]]:
    gaps, end = [], None
    for a, b in sorted((a, b) for _, a, b in device):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


@dataclass
class Attribution:
    idle_s: Dict[Optional[str], float]     # metric phase (None: none)
    launches: Dict[Optional[str], int]
    seen: frozenset                       # metric phases with a range


def attribute(trace) -> Optional[Attribution]:
    """The slice's idle seconds and launches by metric phase; None where
    the slice holds no program range or no device activity."""
    by_range = {r: p for p, r in PHASES.items()}
    ranges = [(n[len(PREFIX):], a, b) for n, a, b in trace.host
              if n.startswith(PREFIX)]
    if not ranges or not trace.device:
        return None
    segs = [(a, b, by_range.get(n)) for a, b, n in segments(ranges)]
    idle: Dict[Optional[str], float] = {p: 0.0 for p in [*PHASES, None]}
    j = 0
    for ga, gb in idle_intervals(trace.device):
        covered = 0.0
        while j < len(segs) and segs[j][1] <= ga:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < gb:
            a, b, p = segs[k]
            ov = min(b, gb) - max(a, ga)
            if ov > 0:
                covered += ov
                idle[p] += ov * 1e-6
            k += 1
        idle[None] += (gb - ga - covered) * 1e-6
    starts = [s[0] for s in segs]
    launches: Dict[Optional[str], int] = {p: 0 for p in [*PHASES, None]}
    for n, a, _ in trace.host:
        if n in LAUNCH_APIS:
            i = bisect.bisect_right(starts, a) - 1
            launches[segs[i][2] if i >= 0 and a < segs[i][1] else None] += 1
    seen = frozenset(by_range[n] for n, _, _ in ranges if n in by_range)
    return Attribution(idle, launches, seen)


def _per_iter(run, field: str, phase: str) -> Optional[float]:
    if run.trace is None or not run.slice_iterations:
        return None
    at = attribute(run.trace)
    if at is None or phase not in at.seen:
        return None
    return getattr(at, field)[phase] / run.slice_iterations


def idle_s(run, phase: str) -> Optional[float]:
    """Device idle seconds an iteration while `phase` is innermost."""
    return _per_iter(run, "idle_s", phase)


def launches_per_iter(run, phase: str) -> Optional[float]:
    """Kernel launches an iteration begun while `phase` is innermost."""
    return _per_iter(run, "launches", phase)


def unattributed_idle_pct(run) -> Optional[float]:
    """The slice's device idle under none of the phases, as a share of
    its seconds: `device.idle_pct.train`'s idle (which also counts the
    slice's seconds before its first and after its last device
    activity) less what the phases hold, so that the two add up."""
    if run.trace is None or not run.slice_s:
        return None
    at = attribute(run.trace)
    if at is None:
        return None
    held = sum(v for p, v in at.idle_s.items() if p is not None)
    return 100.0 * (run.slice_s - run.trace.busy_s - held) / run.slice_s


def dataset_s(step: str) -> Optional[float]:
    """Host seconds of the process's Dataset constructs in `step`
    (`binning` or `store`), from the program's phase totals."""
    prof = sys.modules.get("lightgbm_tpu_torch.profiling")
    if prof is None:
        return None
    return prof.timings().get(f"dataset.{step}")
