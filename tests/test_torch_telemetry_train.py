"""Training telemetry of the port against the JAX package, on the CPU.

`telemetry_path` in params (and in a config file or on the command line)
turns the span sink on through `config_from_params`, as in the JAX
package (ROADMAP.md §C fault 11: the port's key did nothing).  Training
then writes one `train.iteration` record a completed iteration
(iteration, trees, rows, seconds, the TIMETAG phase deltas and the
`tree/*` counter deltas), one `train.eval` record an evaluation, and the
`train.checkpoint` / `train.resume` spans.

Both packages grow the same learner here (`tree_growth=exact`: JAX's CPU
default, the serial learner in the port), on the §C probe data and on
`RandomState(3)` 300 x 8 (tests/test_telemetry.py's data).  Record
names, counts and every field but the timings are equal; eval values
agree within 1e-5.  The phases' key sets are equal; the counters' keys
too, except those named in COUNTER_KEYS_ONLY_IN with their reason.

No record reads the device: `profiling._drain_deferred_locked` (the
one place that folds device totals into the registry) is patched to
raise through whole runs with telemetry on, the CPU stand-in for "adds
no device read" (the card's check is chip_smoke.py phase 20a).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu import profiling as jprof
from lightgbm_tpu import telemetry as jtel

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import profiling as tprof
from lightgbm_tpu_torch import telemetry as ttel
from lightgbm_tpu_torch.config import config_from_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `tree/*` counter keys that a record of one package can carry and the
# other's cannot, with the reason.  On the exact learner both count
# nothing under tree/, so the probe's keys are equal (empty).
COUNTER_KEYS_ONLY_IN = {
    "port": {
        "hist_rows_touched": (
            "the port's rounds learner adds the rows its histogram passes "
            "read to the registry with profiling.count, from the round's "
            "one batched host read; the JAX rounds learner accumulates "
            "them on the device with count_deferred, which a record reads "
            "without draining (no device read), so its key appears only "
            "after a drain"),
    },
    "jax": {},
}


@pytest.fixture(autouse=True)
def _fresh():
    """Telemetry off and empty registries around every test: a record's
    counter keys are those of its package's process-wide registry."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for m in (ttel, jtel, tprof, jprof):
        m.reset()
    yield
    for m in (ttel, jtel):
        m.reset()
    torch.set_num_threads(torch_threads)


def _records(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _named(recs, name):
    return [r for r in recs if r["name"] == name]


def _probe():
    """ROADMAP.md §C's probe data."""
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 5)
    y = (X[:, 0] + 0.3 * rng.randn(2000) > 0).astype(np.float64)
    Xv = rng.randn(500, 5)
    yv = (Xv[:, 0] > 0).astype(np.float64)
    return X, y, Xv, yv


PROBE_PARAMS = {"objective": "binary", "num_leaves": 7, "verbose": -1,
                "tree_growth": "exact"}


def _strip(rec):
    """A record's comparable part: its name, status and every attribute
    but the timings."""
    attrs = {k: v for k, v in rec.get("attrs", {}).items()
             if k not in ("seconds", "phases", "counters", "results")}
    return rec["name"], rec.get("status"), attrs


def assert_records_match(jax_recs, port_recs):
    """Same names in the same order, the same non-timing fields, the same
    phase key sets, counter keys as COUNTER_KEYS_ONLY_IN allows, and
    eval values within 1e-5."""
    assert [r["name"] for r in port_recs] == [r["name"] for r in jax_recs]
    for j, t in zip(jax_recs, port_recs):
        assert _strip(t) == _strip(j)
        ja, ta = j.get("attrs", {}), t.get("attrs", {})
        if j["name"] == "train.iteration":
            assert set(ta["phases"]) == set(ja["phases"])
            assert ta["seconds"] > 0 and ja["seconds"] > 0
            assert (set(ta["counters"]) - set(ja["counters"])
                    <= set(COUNTER_KEYS_ONLY_IN["port"]))
            assert (set(ja["counters"]) - set(ta["counters"])
                    <= set(COUNTER_KEYS_ONLY_IN["jax"]))
        if j["name"] == "train.eval":
            assert len(ta["results"]) == len(ja["results"])
            for (js, jn, jv), (ts, tn, tv) in zip(ja["results"],
                                                  ta["results"]):
                assert (ts, tn) == (js, jn)
                assert abs(tv - jv) <= 1e-5


def _probe_a(pkg, path):
    """Probe (a): no metric, telemetry_path in params, 3 iterations."""
    X, y, _, _ = _probe()
    p = dict(PROBE_PARAMS, telemetry_path=path)
    if pkg is lt:
        p["device_type"] = "cpu"
    pkg.train(p, pkg.Dataset(X, y), 3, verbose_eval=False)


def test_probe_a_records_match_jax(tmp_path):
    """§C fault 11, probe (a): the port writes the file JAX writes, with
    3 train.iteration records (no metric, so no train.eval)."""
    _probe_a(lj, str(tmp_path / "jax.jsonl"))
    jtel.reset()
    _probe_a(lt, str(tmp_path / "port.jsonl"))
    ttel.reset()
    jr = _records(tmp_path / "jax.jsonl")
    tr = _records(tmp_path / "port.jsonl")
    assert [r["name"] for r in tr] == ["train.iteration"] * 3
    assert [r["attrs"]["iteration"] for r in tr] == [1, 2, 3]
    assert [r["attrs"]["trees"] for r in tr] == [1, 2, 3]
    assert all(r["attrs"]["rows"] == 2000 for r in tr)
    assert_records_match(jr, tr)


_PROBE_B = r"""
import os, sys
sys.path.insert(0, {root!r})
pkg_name = sys.argv[1]
if pkg_name == "lightgbm_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
import importlib
import numpy as np
pkg = importlib.import_module(pkg_name)
rng = np.random.RandomState(0)
X = rng.randn(2000, 5)
y = (X[:, 0] + 0.3 * rng.randn(2000) > 0).astype(np.float64)
Xv = rng.randn(500, 5)
yv = (Xv[:, 0] > 0).astype(np.float64)
p = {{"objective": "binary", "num_leaves": 7, "verbose": -1,
     "tree_growth": "exact", "metric": "auc",
     "checkpoint_path": sys.argv[2], "checkpoint_interval": 1}}
if pkg_name == "lightgbm_tpu_torch":
    p["device_type"] = "cpu"
ds = pkg.Dataset(X, y)
pkg.train(p, ds, 3, valid_sets=[pkg.Dataset(Xv, yv, reference=ds)],
          verbose_eval=False)
"""


def test_probe_b_records_match_jax(tmp_path):
    """§C fault 11, probe (b): the probe valid set, LIGHTGBM_TPU_TELEMETRY
    in the environment, a checkpoint every iteration.  Each package in a
    process of its own (the variable is read at import): 3
    train.iteration, 3 train.eval and 4 train.checkpoint records (3 on
    the interval, 1 final), the same checkpoint path in both."""
    script = tmp_path / "probe_b.py"
    script.write_text(_PROBE_B.format(root=ROOT))
    ck = str(tmp_path / "ck.json")
    recs = {}
    for pkg in ("lightgbm_tpu", "lightgbm_tpu_torch"):
        sink = str(tmp_path / f"{pkg}.jsonl")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   LIGHTGBM_TPU_TELEMETRY=sink)
        r = subprocess.run([sys.executable, str(script), pkg, ck],
                           capture_output=True, text=True, timeout=300,
                           env=env, cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr[-3000:]
        os.remove(ck)
        recs[pkg] = _records(sink)
    tr = recs["lightgbm_tpu_torch"]
    counts = {n: len(_named(tr, n)) for n in {r["name"] for r in tr}}
    assert counts == {"train.iteration": 3, "train.eval": 3,
                      "train.checkpoint": 4}
    assert all(r["attrs"]["path"] == ck
               for r in _named(tr, "train.checkpoint"))
    assert all(r["status"] == "ok" for r in _named(tr, "train.checkpoint"))
    assert_records_match(recs["lightgbm_tpu"], tr)


def test_update_records_match_jax_on_the_telemetry_test_data(tmp_path):
    """tests/test_telemetry.py's RandomState(3) 300 x 8, through
    Booster.update and eval_train: the iteration and eval records of
    both packages agree."""
    rng = np.random.RandomState(3)
    X = rng.rand(300, 8)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(float)
    params = {"objective": "binary", "verbose": -1, "num_leaves": 7,
              "min_data_in_leaf": 5, "metric": "binary_logloss",
              "tree_growth": "exact"}
    recs = {}
    for pkg, tel, extra in ((lj, jtel, {}), (lt, ttel,
                                            {"device_type": "cpu"})):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        tel.configure(path, process="test")
        bst = pkg.Booster(dict(params, **extra), pkg.Dataset(X, y))
        for _ in range(3):
            bst.update()
        assert bst._gbdt.eval_train()
        tel.reset()
        recs[pkg] = _records(path)
    tr = recs[lt]
    iters = _named(tr, "train.iteration")
    assert [r["attrs"]["iteration"] for r in iters] == [1, 2, 3]
    assert iters[0]["attrs"]["rows"] == 300
    assert all("tree" in r["attrs"]["phases"] for r in iters)
    assert all(r["proc"] == "test" for r in tr)
    (ev,) = _named(tr, "train.eval")
    assert ev["attrs"]["results"][0][:2] == ["training", "binary_logloss"]
    assert_records_match(recs[lj], tr)


def test_cli_task_train_writes_train_records(tmp_path):
    """`python -m lightgbm_tpu_torch task=train telemetry_path=<file>`:
    train.iteration records under the process name `train` (the task)."""
    X, y, _, _ = _probe()
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    sink = str(tmp_path / "cli.jsonl")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("LIGHTGBM_TPU_TELEMETRY", None)
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
         f"data={data}", f"output_model={tmp_path / 'm.txt'}",
         "objective=binary", "num_leaves=7", "num_iterations=3",
         "verbose=-1", "device_type=cpu", f"telemetry_path={sink}",
         f"checkpoint_path={tmp_path / 'ck.json'}",
         "checkpoint_interval=2"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    recs = _records(sink)
    iters = _named(recs, "train.iteration")
    assert [x["attrs"]["iteration"] for x in iters] == [1, 2, 3]
    assert len(_named(recs, "train.checkpoint")) == 2
    assert {x["proc"] for x in recs} == {"train"}


def test_train_and_cv_reach_the_sink(tmp_path):
    """lt.train and lt.cv with telemetry_path in params: cv's folds each
    write their iterations."""
    X, y, _, _ = _probe()
    sink = str(tmp_path / "t.jsonl")
    p = dict(PROBE_PARAMS, device_type="cpu", telemetry_path=sink,
             metric="auc")
    lt.cv(p, lt.Dataset(X, y), num_boost_round=2, nfold=2,
          verbose_eval=False)
    recs = _records(sink)
    assert len(_named(recs, "train.iteration")) == 4
    assert len(_named(recs, "train.eval")) == 4


def test_telemetry_path_only_enables(tmp_path):
    """A config that names a sink turns telemetry on; a later config
    without the key leaves it on (a running daemon's sink stays)."""
    sink = str(tmp_path / "s.jsonl")
    assert not ttel.enabled()
    config_from_params({"telemetry_path": sink})
    assert ttel.enabled() and tprof._PHASES_FORCED
    config_from_params({"objective": "binary"})
    assert ttel.enabled()
    ttel.event("probe")
    assert _named(_records(sink), "probe")


@pytest.mark.parametrize("growth", ["exact", "rounds"])
def test_aborted_iteration_emits_no_record(tmp_path, growth):
    """min_sum_hessian_in_leaf above the rows' hessian sum: the first
    iteration finds no split and is taken back, so neither package
    records it (the synchronous path, and the port's device-tree
    path)."""
    X, y, _, _ = _probe()
    recs = {}
    pkgs = [(lt, ttel, {"device_type": "cpu"})]
    if growth == "exact":
        pkgs.append((lj, jtel, {}))
    for pkg, tel, extra in pkgs:
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        p = dict(PROBE_PARAMS, tree_growth=growth, min_sum_hessian_in_leaf=1e9,
                 telemetry_path=path, **extra)
        with pytest.warns(UserWarning, match="no more leaves"):
            bst = pkg.train(p, pkg.Dataset(X, y), 3, verbose_eval=False)
        tel.reset()
        assert bst.current_iteration() == 0
        recs[pkg] = _records(path)
    assert _named(recs[lt], "train.iteration") == []
    if lj in recs:
        assert _named(recs[lj], "train.iteration") == []


def test_telemetry_off_creates_no_file(tmp_path, monkeypatch):
    """Telemetry off: no file appears, and span() hands out one shared
    no-op."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LIGHTGBM_TPU_TELEMETRY", raising=False)
    X, y, Xv, yv = _probe()
    ds = lt.Dataset(X, y)
    lt.train(dict(PROBE_PARAMS, device_type="cpu", metric="auc"), ds, 2,
             valid_sets=[lt.Dataset(Xv, yv, reference=ds)],
             verbose_eval=False)
    assert not ttel.enabled()
    assert ttel.span("x") is ttel.span("y")
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("growth", ["rounds", "exact"])
def test_records_make_no_deferred_counter_drain(tmp_path, monkeypatch,
                                                growth):
    """With telemetry on, a run with a valid set never drains the
    deferred device counters: the records read only host values."""
    def no_drain():
        raise AssertionError("a device read through the counter drain")
    monkeypatch.setattr(tprof, "_drain_deferred_locked", no_drain)
    X, y, Xv, yv = _probe()
    sink = str(tmp_path / "t.jsonl")
    ds = lt.Dataset(X, y)
    lt.train(dict(PROBE_PARAMS, device_type="cpu", metric="auc",
                  tree_growth=growth, telemetry_path=sink), ds, 3,
             valid_sets=[lt.Dataset(Xv, yv, reference=ds)],
             verbose_eval=False)
    recs = _records(sink)
    assert len(_named(recs, "train.iteration")) == 3
    assert len(_named(recs, "train.eval")) == 3


@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_goss_and_dart_record_each_iteration_as_jax(tmp_path, boosting):
    """GOSS and DART: one train.iteration an iteration, and the same
    record sequence as JAX (DART trains through GBDT.train_one_iter
    without evaluating, so its record comes before its eval)."""
    X, y, Xv, yv = _probe()
    extra = ({"top_rate": 0.3, "other_rate": 0.2, "learning_rate": 0.5}
             if boosting == "goss" else {"drop_rate": 0.5})
    recs = {}
    for pkg, tel, dev in ((lj, jtel, {}), (lt, ttel,
                                          {"device_type": "cpu"})):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        p = dict(PROBE_PARAMS, boosting=boosting, metric="auc",
                 telemetry_path=path, **extra, **dev)
        ds = pkg.Dataset(X, y)
        pkg.train(p, ds, 4, valid_sets=[pkg.Dataset(Xv, yv, reference=ds)],
                  verbose_eval=False)
        tel.reset()
        recs[pkg] = _records(path)
    tr = recs[lt]
    assert [r["attrs"]["iteration"]
            for r in _named(tr, "train.iteration")] == [1, 2, 3, 4]
    assert [r["name"] for r in tr] == ["train.iteration", "train.eval"] * 4
    assert [_strip(r) for r in tr] == [_strip(r) for r in recs[lj]]


@pytest.mark.parametrize("path_kind", ["device_tree", "class_trees",
                                       "prepartitioned"])
def test_records_on_every_training_path(tmp_path, path_kind):
    """The port's device-tree path (the rounds learner), the synchronous
    path with K class trees (multiclass), and the synchronous path a
    pre-partitioned world takes (the rounds learner with `_can_pipeline`
    off): each completed iteration one record whose trees count the
    model, with the tree and score phases, and the rounds learner's
    touched-row counter (COUNTER_KEYS_ONLY_IN)."""
    X, y, _, _ = _probe()
    sink = str(tmp_path / "t.jsonl")
    p = dict(PROBE_PARAMS, device_type="cpu", tree_growth="rounds",
             telemetry_path=sink)
    K = 1
    if path_kind == "class_trees":
        K = 3
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
        p.update(objective="multiclass", num_class=3)
    bst = lt.Booster(p, lt.Dataset(X, y))
    if path_kind == "prepartitioned":
        bst._gbdt._can_pipeline = lambda: False
    for _ in range(3):
        bst.update()
    ttel.reset()
    iters = _named(_records(sink), "train.iteration")
    extra = 1 if bst._gbdt.boost_from_average_used else 0
    assert [r["attrs"]["trees"] for r in iters] == [
        K * i + extra for i in (1, 2, 3)]
    for r in iters:
        assert {"tree", "score", "boosting"} <= set(r["attrs"]["phases"])
        assert r["attrs"]["counters"]["hist_rows_touched"] > 0


def test_checkpoint_and_resume_spans_match_jax(tmp_path):
    """train.checkpoint and train.resume carry the same path, iteration
    and trees in both packages: a 3-iteration run checkpointed every
    iteration, then a rerun that resumes from its final checkpoint."""
    X, y, _, _ = _probe()
    ck = str(tmp_path / "ck.json")
    recs = {}
    for pkg, tel, dev in ((lj, jtel, {}), (lt, ttel,
                                          {"device_type": "cpu"})):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        p = dict(PROBE_PARAMS, checkpoint_path=ck, checkpoint_interval=1,
                 telemetry_path=path, **dev)
        pkg.train(p, pkg.Dataset(X, y), 3, verbose_eval=False)
        again = pkg.train(p, pkg.Dataset(X, y), 3, verbose_eval=False)
        assert again.num_trees() == 3
        tel.reset()
        os.remove(ck)
        recs[pkg] = [r for r in _records(path)
                     if r["name"] in ("train.checkpoint", "train.resume")]
    tr = recs[lt]
    assert [r["name"] for r in tr] == ["train.checkpoint"] * 4 + [
        "train.resume", "train.checkpoint"]
    (res,) = _named(tr, "train.resume")
    assert res["attrs"] == {"checkpoint_iteration": 3, "trees": 3}
    assert [_strip(r) for r in tr] == [_strip(r) for r in recs[lj]]
