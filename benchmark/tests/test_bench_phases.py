"""benchmark/phases.py: idle seconds and launches by phase on a trace
built by hand, worked out by hand, and the program's ranges in a small
traced run of the higgs cell on the CPU, so that the reader's names and
the program's cannot drift apart."""
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import phases, spec
from benchmark.trace import Trace

# host ranges (us): boosting, then tree > learner.round > histogram,
# split search and partition, then score; no range over 70-75, then metric
RANGES = [("boosting", 0, 10), ("tree", 10, 60), ("learner.round", 12, 58),
          ("learner.histogram", 15, 25), ("learner.split_search", 25, 35),
          ("learner.partition", 40, 50), ("score", 60, 70),
          ("metric", 75, 90)]
# device intervals (two overlap, as on two streams)
DEVICE = [(0, 4), (8, 9), (13, 16), (20, 22), (30, 41), (31, 33), (45, 46),
          (52, 65), (68, 69), (76, 80), (85, 86), (88, 95), (100, 101)]
# idle gaps: 4-8 boosting; 9-13 boosting 1, tree alone 2, round 1; 16-20
# histogram; 22-30 histogram 3, split search 5; 41-45 partition; 46-52
# partition 4, round 2; 65-68 score; 69-76 score 1, none 5, metric 1;
# 80-85 and 86-88 metric; 95-100 none
IDLE_US = {"objective.gradients": 5, "learner.round": 3,
           "learner.histogram": 7, "learner.split_search": 5,
           "learner.partition": 8, "score.update": 4, "metric.eval": 8,
           None: 12}
# (host API, start us): 11 in tree alone, 72 and 96 under no range; 40
# opens the partition
LAUNCHES = [("cudaLaunchKernel", 1), ("cudaLaunchKernel", 11),
            ("cudaLaunchKernel", 14), ("cudaLaunchKernel", 16),
            ("cudaLaunchKernel", 26), ("cuLaunchKernel", 30),
            ("cudaLaunchKernel", 40), ("cudaLaunchKernel", 51),
            ("cudaLaunchKernel", 61), ("cudaLaunchKernel", 72),
            ("cudaLaunchKernel", 80), ("cudaLaunchKernelExC", 96)]
LAUNCH_COUNT = {"objective.gradients": 1, "learner.round": 2,
                "learner.histogram": 1, "learner.split_search": 2,
                "learner.partition": 1, "score.update": 1,
                "metric.eval": 1, None: 3}
SLICE_US = 110
ITERATIONS = 2


def _trace(ranges=RANGES, device=DEVICE):
    host = [(phases.PREFIX + n, float(a), float(b)) for n, a, b in ranges]
    host += [(n, float(t), t + 0.5) for n, t in LAUNCHES]
    host += [("aten::add", 26.0, 27.0), ("cudaMemcpyAsync", 62.0, 63.0)]
    return Trace([("k", float(a), float(b)) for a, b in device], host)


def _run(trace):
    return SimpleNamespace(trace=trace, slice_iterations=ITERATIONS,
                           slice_s=SLICE_US * 1e-6)


def test_idle_and_launches_by_phase_by_hand():
    at = phases.attribute(_trace())
    assert at.idle_s == pytest.approx({k: v * 1e-6
                                       for k, v in IDLE_US.items()})
    assert at.launches == LAUNCH_COUNT
    total_idle = sum(b - a
                     for a, b in phases.idle_intervals(_trace().device))
    assert total_idle == 52
    assert sum(at.idle_s.values()) == pytest.approx(total_idle * 1e-6)
    assert sum(at.launches.values()) == len(LAUNCHES)


def test_readers_per_iteration():
    run = _run(_trace())
    for p in phases.PHASES:
        assert phases.idle_s(run, p) == pytest.approx(
            IDLE_US[p] * 1e-6 / ITERATIONS)
        assert phases.launches_per_iter(run, p) == LAUNCH_COUNT[p] / 2
    # the slice's 9 us past the last device activity are idle too
    assert phases.unattributed_idle_pct(run) == pytest.approx(
        100.0 * (IDLE_US[None] + SLICE_US - 101) / SLICE_US)
    # the phases and the rest add up to the slice's idle
    held = sum(phases.idle_s(run, p) for p in phases.PHASES) * ITERATIONS
    rest = run.slice_s * phases.unattributed_idle_pct(run) / 100.0
    assert held + rest == pytest.approx(run.slice_s - run.trace.busy_s)
    m = spec.reader("learner.partition.idle_s.train")
    assert m.read(run) == pytest.approx(8e-6 / ITERATIONS)


def test_nothing_to_read_gives_none():
    no_ranges = _run(Trace([("k", 0.0, 1.0)], [("cudaLaunchKernel", 0, 1)]))
    no_device = _run(_trace(device=[]))
    no_learner = _run(_trace(ranges=[r for r in RANGES
                                     if not r[0].startswith("learner")]))
    for run in (no_ranges, no_device, _run(None)):
        assert phases.idle_s(run, "score.update") is None
        assert phases.launches_per_iter(run, "score.update") is None
        assert phases.unattributed_idle_pct(run) is None
    assert phases.idle_s(no_learner, "learner.histogram") is None
    assert phases.idle_s(no_learner, "score.update") == pytest.approx(2e-6)


def test_segments_innermost_and_equal_starts():
    segs = phases.segments([("outer", 0, 10), ("inner", 0, 4),
                            ("late", 6, 10)])
    assert segs == [(0, 4, "inner"), (4, 6, "outer"), (6, 10, "late")]


def test_program_ranges_in_a_traced_cpu_run():
    bench = spec.load()
    cell = spec.cell(bench, "higgs.train")
    cfg = dict(spec.config(bench, cell), rows=6000, valid_rows=1000)
    traffic = spec.traffic(cell)
    run = spec.loop(traffic).run(cfg, traffic, 2 ** 31 + 5, 0.5, True,
                                 torch.device("cpu"), {},
                                 time.perf_counter())
    names = {n for n, _, _ in run.trace.host}
    for rng in phases.PHASES.values():
        assert phases.PREFIX + rng in names, rng
    # no device activity on the CPU: the trace's readers have nothing
    assert phases.idle_s(run, "learner.histogram") is None
    for step in ("binning", "store"):
        assert phases.dataset_s(step) > 0
