"""The hot-path sanitizer of the port, held against the JAX package's on
the CPU.

`HotPathSanitizer` keeps the JAX class's contract: warm-up steps run
unguarded and may compile, a guard violation inside a later step counts
as an implicit transfer (swallowed unless strict), a compile in a later
step counts as a retrace, `report()` carries the JAX keys and `check()`
raises on any violation.  In the port a violation is the error torch
raises for a synchronising CUDA call under sync debug mode "error" (on
the card; tests/test_torch_kernels_cuda.py arms it there), and a
compile is a kernel library build or load (kernels.BUILD_EVENTS).
Exact comparisons throughout: the counters and keys are integers and
strings.
"""
import pytest

from lightgbm_tpu.diagnostics import sanitize as js

from lightgbm_tpu_torch import kernels, profiling
from lightgbm_tpu_torch.diagnostics import sanitize as ts

SYNC_ERROR = "called a synchronizing CUDA operation"


def test_counter_names_match_jax():
    for name in ("RETRACES", "IMPLICIT_TRANSFERS", "COMPILES_TOTAL",
                 "DIVERGENCE_CHECKS", "DIVERGENCES", "LOCK_ACQUIRES",
                 "LOCK_WAITS", "LOCK_CYCLES", "LOCK_HOLD_MS",
                 "LOCK_WAIT_MS"):
        assert getattr(ts, name) == getattr(js, name)


@pytest.mark.parametrize("value", ["", "0", "1", "false", "true", "yes",
                                   "False", "no", None])
def test_sanitize_enabled_matches_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("BENCH_SANITIZE", raising=False)
    else:
        monkeypatch.setenv("BENCH_SANITIZE", value)
    assert ts.sanitize_enabled() == js.sanitize_enabled()
    monkeypatch.setenv("OTHER_GATE", value or "")
    assert ts.sanitize_enabled("OTHER_GATE") == \
        js.sanitize_enabled("OTHER_GATE")


def test_report_keys_match_jax():
    with js.HotPathSanitizer(warmup=1) as sj:
        with sj.step():
            pass
    with ts.HotPathSanitizer(warmup=1) as st:
        with st.step():
            pass
    assert list(st.report()) == list(sj.report())
    r = st.report()
    assert r["steps"] == 1 and r["warmup"] == 1
    assert r["guard"] == "disallow" and r["label"] == "hot_path"
    assert r["retraces_after_warmup"] == r["implicit_transfers"] == 0
    st.check()


def test_violation_after_warmup_counts_and_check_raises():
    before = profiling.counter_value(ts.IMPLICIT_TRANSFERS)
    with ts.HotPathSanitizer(warmup=1, label="tree") as san:
        for i in range(4):
            with san.step():
                if i >= 2:
                    raise RuntimeError(SYNC_ERROR)
    assert san.steps == 4
    assert san.implicit_transfers == 2
    assert profiling.counter_value(ts.IMPLICIT_TRANSFERS) - before == 2
    with pytest.raises(AssertionError, match=r"\[tree\].*2 implicit"):
        san.check()


def test_warmup_violation_and_other_errors_propagate():
    with ts.HotPathSanitizer(warmup=1) as san:
        # a warm-up step is unguarded: the error is the caller's
        with pytest.raises(RuntimeError, match="synchronizing"):
            with san.step():
                raise RuntimeError(SYNC_ERROR)
        with pytest.raises(ValueError):
            with san.step():
                raise ValueError("not a guard error")
    assert san.implicit_transfers == 0 and san.steps == 2


def test_strict_reraises():
    with ts.HotPathSanitizer(warmup=0, strict=True) as san:
        with pytest.raises(RuntimeError, match="synchronizing"):
            with san.step():
                raise RuntimeError(SYNC_ERROR)
    assert san.implicit_transfers == 1


def test_builds_after_warmup_are_retraces(monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_EVENTS", list(kernels.BUILD_EVENTS))
    with ts.HotPathSanitizer(warmup=1) as san:
        with san.step():
            kernels.BUILD_EVENTS.append(("build", "histogram"))
            kernels.BUILD_EVENTS.append(("load", "histogram"))
        with san.step():
            pass
        with san.step():
            kernels.BUILD_EVENTS.append(("load", "lookup"))
    assert san.retraces == 1
    assert san.compiles_total == 1 and san.trace_events == 3
    r = san.report()
    assert r["retraces_after_warmup"] == 1
    assert r["retrace_names"] == ["histogram", "histogram", "lookup"]
    with pytest.raises(AssertionError, match="1 retrace"):
        san.check()


def test_explicit_transfer_is_inert_on_the_cpu():
    with ts.HotPathSanitizer(warmup=0) as san:
        with san.step():
            with ts.explicit_transfer():
                pass
    assert san.implicit_transfers == 0


def test_counters_land_in_the_registry():
    before = {n: profiling.counter_value(n) for n in
              (ts.RETRACES, ts.COMPILES_TOTAL, ts.IMPLICIT_TRANSFERS)}
    with ts.HotPathSanitizer(warmup=0) as san:
        with san.step():
            raise RuntimeError(SYNC_ERROR)
    assert profiling.counter_value(ts.IMPLICIT_TRANSFERS) \
        - before[ts.IMPLICIT_TRANSFERS] == 1
    assert profiling.counter_value(ts.RETRACES) == before[ts.RETRACES]
    assert profiling.counter_value(ts.COMPILES_TOTAL) \
        == before[ts.COMPILES_TOTAL]
