"""The port's host ranges (profiling.RANGES), on the CPU.

Each `profiling.phase` and `profiling.range` opens `lgbt::<name>`,
which torch.profiler records as a plain host operation (no user
annotation, so no copy on a device's timeline).  Training under the
profiler shows every training range, the rounds learner's inside
`lgbt::tree`, a bounded number of them an iteration; a Dataset's
construct adds `dataset.binning` and `dataset.store` to the phase
totals whatever the TIMETAG and telemetry switches say, equal to its
`setup_seconds`.  The learner's ranges accumulate nothing, so the
TIMETAG totals (and a `train.iteration` record's phases) keep the JAX
package's keys.
"""
import sys

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import profiling

PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 31,
          "tree_growth": "rounds", "device_type": "cpu", "verbose": -1}
ITERATIONS = 3
# ranges a training iteration may open on the rounds learner: the five
# boosting phases, and the learner's a round and a chunk of leaves
MAX_RANGES_PER_ITERATION = 100
LEARNER = ("learner.histogram", "learner.split_search",
           "learner.partition", "learner.round")
SERVING = ("serve/execute", "serve/swap")


def _data(n, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rs.randn(n) > 0)
    return X, y.astype(np.float64)


@pytest.fixture
def timetag_off(monkeypatch):
    monkeypatch.setattr(profiling, "ENABLED", False)
    monkeypatch.setattr(profiling, "_PHASES_FORCED", False)


def _ranges(prof):
    return [e for e in prof.events()
            if e.name.startswith(profiling.RANGE_PREFIX)]


def _profiled_training():
    X, y = _data(4000)
    Xv, yv = _data(800, seed=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train = lt.Dataset(X, y, params=PARAMS).construct()
        valid = lt.Dataset(Xv, yv, reference=train,
                           params=PARAMS).construct()
        bst = lt.train(PARAMS, train, ITERATIONS, valid_sets=[valid],
                       verbose_eval=False)
    assert type(bst._gbdt.learner).__name__ == "RoundsTreeLearner"
    assert bst.current_iteration() == ITERATIONS
    return _ranges(prof)


def test_training_opens_every_range_as_a_plain_host_op(timetag_off):
    ranges = _profiled_training()
    names = {e.name[len(profiling.RANGE_PREFIX):] for e in ranges}
    assert names == set(profiling.RANGES) - set(SERVING)
    assert not [e.name for e in ranges if e.is_user_annotation]
    trees = [(e.time_range.start, e.time_range.end) for e in ranges
             if e.name == "lgbt::tree"]
    assert len(trees) == ITERATIONS
    learner = [e for e in ranges
               if e.name[len(profiling.RANGE_PREFIX):] in LEARNER]
    for e in learner:
        assert any(a <= e.time_range.start and e.time_range.end <= b
                   for a, b in trees), e.name
    in_training = [e for e in ranges if not e.name.startswith("lgbt::data")]
    assert len(in_training) / ITERATIONS < MAX_RANGES_PER_ITERATION


def test_construct_phases_accumulate_with_timetag_and_telemetry_off(
        timetag_off):
    before = profiling.timings()
    X, y = _data(3000)
    train = lt.Dataset(X, y, params=PARAMS).construct()
    valid = lt.Dataset(X[:500], y[:500], reference=train,
                       params=PARAMS).construct()
    after = profiling.timings()
    for step in ("binning", "store"):
        key = f"dataset.{step}"
        want = (train._inner.setup_seconds[step]
                + valid._inner.setup_seconds[step])
        assert want > 0
        assert after[key] - before.get(key, 0.0) == pytest.approx(
            want, rel=1e-9, abs=1e-12)
    # the boosting phases stay off
    assert "tree" not in after or after["tree"] == before.get("tree")


def test_learner_ranges_leave_the_phase_totals_alone(timetag_off,
                                                     monkeypatch):
    monkeypatch.setattr(profiling, "_PHASES_FORCED", True)
    before = profiling.timings()
    X, y = _data(2000)
    lt.train(PARAMS, lt.Dataset(X, y, params=PARAMS), 2, verbose_eval=False)
    grown = set(profiling.timings()) - set(before)
    assert not grown & set(LEARNER)
    assert {"boosting", "tree", "score"} <= set(profiling.timings())


def test_phase_times_its_block_and_range_does_not():
    with profiling.phase("dataset.store", force=True) as p:
        pass
    assert p.seconds >= 0.0
    with profiling.range("learner.round") as r:
        pass
    assert r is None
    with pytest.raises(KeyError):
        profiling.range("no.such.range")


def test_ranges_fall_back_to_no_ops_without_the_private_api(monkeypatch):
    # a None entry in sys.modules makes the import raise ImportError
    monkeypatch.setitem(sys.modules, "torch._C._profiler", None)
    make = profiling._host_range_type()
    monkeypatch.setattr(profiling, "_host_range", make)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.range("learner.histogram"):
            pass
        with profiling.phase("tree", force=True) as p:
            pass
    assert p.seconds >= 0.0
    assert not _ranges(prof)


def test_device_trace_exporter_is_gone():
    assert not hasattr(profiling, "device_trace")
