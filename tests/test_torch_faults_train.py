"""The port's training fault seams on the CPU: the counterparts of the
JAX package's tests/test_faults.py checkpoint scenarios.

- `train.checkpoint` tears the checkpoint at its path (half the payload,
  then a crash): the restarted run warns, ignores it and trains from
  scratch to the uninterrupted model string;
- `train.after_checkpoint` crashes right after a checkpoint landed: the
  restart resumes from it to the uninterrupted model string, bitwise,
  through `lt.train` and through `python -m lightgbm_tpu_torch` with the
  seam armed by LIGHTGBM_TPU_FAULTS (the process dies, no model is
  written; the rerun resumes and writes the uninterrupted model file);
- both seams fire at the same hit as in the JAX package, and the span
  stream holds the same records (the torn write's `train.checkpoint`
  span ends in error, the firing is a `fault.fired` event).

The learning rate is 0.5 (tests/test_torch_checkpoint.py: the device-tree
path shrinks in f32, the model in f64, alike only for a dyadic rate).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu import telemetry as jtel
from lightgbm_tpu.diagnostics import faults as jfaults

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import telemetry as ttel
from lightgbm_tpu_torch.diagnostics import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for m in (faults, jfaults, ttel, jtel):
        m.reset()
    yield
    for m in (faults, jfaults, ttel, jtel):
        m.reset()
    torch.set_num_threads(n)


def _synth(n=400, f=8, seed=9):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    z = X @ rng.randn(f)
    return X, (z > np.median(z)).astype(np.float64)


def _ckpt_params(extra=None):
    return {"objective": "binary", "verbose": -1, "num_leaves": 7,
            "min_data_in_leaf": 5, "learning_rate": 0.5,
            "deterministic": True, "device_type": "cpu", **(extra or {})}


GROWTHS = ["rounds", "exact"]


@pytest.mark.parametrize("growth", GROWTHS)
def test_torn_checkpoint_never_wedges_the_restart(tmp_path, growth):
    """train.checkpoint:2: the first checkpoint lands, the second is torn
    at the path; the restart starts clean and equals the uninterrupted
    model."""
    X, y = _synth()
    ck = str(tmp_path / "ck.json")
    p = _ckpt_params({"checkpoint_path": ck, "checkpoint_interval": 2,
                      "tree_growth": growth})
    faults.arm("train.checkpoint:2")
    with pytest.raises(faults.InjectedFault):
        lt.train(p, lt.Dataset(X, y), 10, verbose_eval=False)
    with pytest.raises(ValueError):
        json.load(open(ck))                 # torn on disk
    faults.reset()
    fresh = lt.train(p, lt.Dataset(X, y), 5, verbose_eval=False)
    assert fresh.current_iteration() == 5
    full = lt.train(_ckpt_params({"tree_growth": growth}), lt.Dataset(X, y),
                    5, verbose_eval=False)
    assert fresh.model_to_string() == full.model_to_string()


@pytest.mark.parametrize("growth", GROWTHS)
def test_crash_after_checkpoint_resumes_to_the_uninterrupted_model(
        tmp_path, growth):
    """train.after_checkpoint:2 kills the run as iteration 4's checkpoint
    lands; the checkpoint on disk is whole and resumes bitwise."""
    X, y = _synth()
    ck = str(tmp_path / "ck.json")
    p = _ckpt_params({"checkpoint_path": ck, "checkpoint_interval": 2,
                      "tree_growth": growth, "bagging_fraction": 0.8,
                      "bagging_freq": 1, "seed": 3})
    faults.arm("train.after_checkpoint:2")
    with pytest.raises(faults.InjectedFault):
        lt.train(p, lt.Dataset(X, y), 10, verbose_eval=False)
    assert json.load(open(ck))["iteration"] == 4
    faults.reset()
    resumed = lt.train(p, lt.Dataset(X, y), 10, verbose_eval=False)
    full = lt.train({k: v for k, v in p.items()
                     if not k.startswith("checkpoint")},
                    lt.Dataset(X, y), 10, verbose_eval=False)
    assert resumed.model_to_string() == full.model_to_string()


@pytest.mark.parametrize("seam", ["train.checkpoint:2",
                                  "train.after_checkpoint:2"])
def test_seams_fire_and_record_as_in_jax(tmp_path, seam):
    """Both packages meet the armed seam at the same checkpoint and write
    the same records up to the crash: the same checkpoint spans (the torn
    one with status error), and the fault.fired event."""
    X, y = _synth()
    recs = {}
    for pkg, flt, tel, dev in ((lj, jfaults, jtel, {}),
                               (lt, faults, ttel, {"device_type": "cpu"})):
        ck = str(tmp_path / f"{pkg.__name__}.ck")
        sink = str(tmp_path / f"{pkg.__name__}.jsonl")
        p = dict(_ckpt_params(), tree_growth="exact", checkpoint_path=ck,
                 checkpoint_interval=2, telemetry_path=sink, **dev)
        if pkg is lj:
            del p["device_type"]
        flt.arm(seam)
        with pytest.raises(flt.InjectedFault) as e:
            pkg.train(p, pkg.Dataset(X, y), 10, verbose_eval=False)
        assert e.value.site == seam.split(":")[0] and e.value.seq == 2
        flt.reset()
        tel.reset()
        with open(sink) as f:
            recs[pkg] = [json.loads(line) for line in f]

    def shape(rs):
        out = []
        for r in rs:
            if r["name"] in ("train.checkpoint", "fault.fired"):
                a = dict(r.get("attrs", {}))
                a.pop("path", None)
                out.append((r["name"], r.get("status"), a))
        return out
    assert shape(recs[lt]) == shape(recs[lj])
    expect = ([("train.checkpoint", "ok"), ("fault.fired", None),
               ("train.checkpoint", "error")]
              if seam.startswith("train.checkpoint") else
              [("train.checkpoint", "ok"), ("train.checkpoint", "ok"),
               ("fault.fired", None)])
    assert [(n, s) for n, s, _ in shape(recs[lt])] == expect


def test_cli_kill_and_resume_is_bitwise(tmp_path):
    """LIGHTGBM_TPU_FAULTS=train.after_checkpoint:2 on `task=train`: the
    process dies with no output model; the rerun without the variable
    resumes and writes the uninterrupted run's model, byte for byte."""
    X, y = _synth(600)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    common = ["task=train", f"data={data}", "objective=binary",
              "num_leaves=7", "min_data_in_leaf=5", "learning_rate=0.5",
              "num_iterations=8", "bagging_fraction=0.8", "bagging_freq=1",
              "seed=3", "verbose=-1", "device_type=cpu"]
    ck = [f"checkpoint_path={tmp_path / 'ck.json'}", "checkpoint_interval=2"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("LIGHTGBM_TPU_FAULTS", None)

    def run(args, extra_env=None):
        return subprocess.run(
            [sys.executable, "-m", "lightgbm_tpu_torch", *args],
            capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
            env=dict(env, **(extra_env or {})))
    out = tmp_path / "m.txt"
    r = run(common + ck + [f"output_model={out}"],
            {"LIGHTGBM_TPU_FAULTS": "train.after_checkpoint:2"})
    assert r.returncode != 0 and "injected fault" in r.stderr
    assert not out.exists()
    r = run(common + ck + [f"output_model={out}"])
    assert r.returncode == 0, r.stderr[-3000:]
    ref = tmp_path / "ref.txt"
    r = run(common + [f"output_model={ref}"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert out.read_bytes() == ref.read_bytes()
