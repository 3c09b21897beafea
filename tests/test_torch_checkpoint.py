"""Checkpoint/resume of the port's training, on the CPU: the
counterparts of the JAX package's tests/test_faults.py checkpoint tests.

- Kill-and-resume: a run checkpointed every 3 iterations and stopped
  at 6, then resumed to 10, writes the model string of the uninterrupted
  10-iteration run, bitwise, with bagging and with GOSS: the sampler's
  RNG state (the bagging RandomState, the GOSS key) is in the checkpoint
  and the resume replays the trees one at a time in training's order.
  The learning rate is 0.5: the device-tree path shrinks leaf values in
  f32 and the model keeps them shrunk in f64, which round alike only for
  a dyadic rate.
- DART resumes with the same tree structure and leaf values within 1e-6:
  its drops add and take off scaled trees from the f32 training scores,
  a history a replay of the final trees cannot repeat bit for bit.
- The early-stopping bests are restored; a finished run's checkpoint
  makes a rerun train nothing and keep its best iteration.
- An unreadable checkpoint is ignored with a warning; a changed recipe
  is refused by the fingerprint, paths and verbosity are not part of it.
"""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.boosting.gbdt import (config_fingerprint,
                                              create_boosting,
                                              load_checkpoint)
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.dataset import Dataset as RawDataset
from lightgbm_tpu_torch.objectives import create_objective


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synth(n=1500, f=10, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    z = X @ rng.randn(f)
    return X, (z > np.median(z)).astype(np.float64)


def _ckpt_params(extra=None):
    return {"objective": "binary", "verbose": -1, "num_leaves": 7,
            "min_data_in_leaf": 5, "learning_rate": 0.5,
            "deterministic": True, "device_type": "cpu", **(extra or {})}


def _kill_and_resume(tmp_path, extra):
    """10 rounds uninterrupted against 6 checkpointed ones and a resume."""
    X, y = _synth(500, 8, seed=7)
    params = _ckpt_params(extra)
    full = lt.train(params, lt.Dataset(X, y), 10, verbose_eval=False)
    ck = str(tmp_path / "ck.json")
    p = dict(params, checkpoint_path=ck, checkpoint_interval=3)
    # the "killed" run: checkpoints at iterations 3 and 6; stopping at 6
    # is a kill right at a checkpoint
    lt.train(p, lt.Dataset(X, y), 6, verbose_eval=False)
    assert json.load(open(ck))["iteration"] == 6
    resumed = lt.train(p, lt.Dataset(X, y), 10, verbose_eval=False)
    return full, resumed, X


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.8, "bagging_freq": 1, "seed": 3},
    {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2, "seed": 3},
    {"bagging_fraction": 0.8, "bagging_freq": 1, "seed": 3,
     "tree_growth": "exact"},
], ids=["bagging", "goss", "bagging_exact"])
def test_kill_and_resume_bitwise(tmp_path, extra):
    full, resumed, _ = _kill_and_resume(tmp_path, extra)
    assert resumed.current_iteration() == 10
    assert resumed.model_to_string() == full.model_to_string()


def _first_difference(a, b):
    """The first node whose feature, threshold or children differ, or
    None when the trees have the same structure."""
    if a.num_leaves != b.num_leaves:
        return 0
    for node in range(a.num_leaves - 1):
        if (a.split_feature[node] != b.split_feature[node]
                or a.threshold[node] != b.threshold[node]
                or a.left_child[node] != b.left_child[node]
                or a.right_child[node] != b.right_child[node]):
            return node
    return None


@pytest.mark.parametrize("growth", ["exact", "rounds"])
def test_kill_and_resume_dart_structure_exact(tmp_path, growth):
    """The exact learner is the JAX test's (its CPU default): every tree
    has the same structure.  On the rounds learner the resumed scores
    differ from the uninterrupted ones by 2.4e-7 at iteration 6 (the JAX
    package's rounds learner: 3.0e-7), and that moves one split of tree 7
    (its sixth node, feature 4: threshold 0.3349128 with gain
    10.67210007 uninterrupted, 0.33987015 with gain 10.6721077 resumed),
    an f32 gain tie (7e-7 relative, a few f32 ulps).  So a tree may
    differ only where its first differing split is such a tie, between
    thresholds of one feature whose gains agree within 1e-5."""
    full, resumed, X = _kill_and_resume(
        tmp_path, {"boosting": "dart", "drop_rate": 0.5, "seed": 3,
                   "tree_growth": growth})
    assert type(resumed._gbdt).__name__ == "DART"
    tied = 0
    for tf, tr in zip(full._gbdt.models, resumed._gbdt.models):
        node = _first_difference(tf, tr)
        if node is None:
            np.testing.assert_allclose(tr.leaf_value[: tr.num_leaves],
                                       tf.leaf_value[: tf.num_leaves],
                                       rtol=0, atol=1e-6)
            continue
        assert growth == "rounds", "the exact learner's trees must match"
        assert tf.split_feature[node] == tr.split_feature[node]
        np.testing.assert_allclose(tr.split_gain[node], tf.split_gain[node],
                                   rtol=1e-5)
        tied += 1
    assert tied <= 1
    if not tied:
        np.testing.assert_allclose(resumed.predict(X), full.predict(X),
                                   rtol=0, atol=1e-5)


def test_resume_restores_early_stopping_state(tmp_path):
    """GBDT._early_stopping_state (fed by eval_and_check_early_stopping)
    is in the checkpoint: the resumed run compares later iterations with
    the first run's best metric, not a reset one."""
    X, y = _synth(600, 8, seed=11)
    cfg = config_from_params(_ckpt_params({"early_stopping_round": 50,
                                           "metric": ("binary_logloss",)}))
    train_ds = RawDataset(X[:400], y[:400].astype(np.float32), cfg)
    ck = str(tmp_path / "ck.json")

    def run(iters, start_state=None, checkpoint_at=None):
        g = create_boosting(cfg)
        obj = create_objective(cfg)
        start = 0
        if start_state is not None:
            start = g.resume_from_checkpoint(start_state, train_ds, obj)
        else:
            g.reset_training_data(train_ds, obj)
        g.add_valid(RawDataset(X[400:], y[400:].astype(np.float32), cfg,
                               reference=train_ds), "v")
        for _ in range(start, iters):
            g.train_one_iter(None, None, is_eval=False)
            g.eval_and_check_early_stopping(g.eval_valid())
            if checkpoint_at is not None and g.iter_ == checkpoint_at:
                g.save_checkpoint(ck)
        return g

    full = run(8)
    run(4, checkpoint_at=4)
    st = json.load(open(ck))
    assert st["iteration"] == 4 and st["early_stopping"]
    resumed = run(8, start_state=load_checkpoint(ck))
    assert resumed._early_stopping_state == full._early_stopping_state
    assert resumed.save_model_to_string() == full.save_model_to_string()


def test_finished_run_is_not_trained_again(tmp_path):
    """The final checkpoint carries a `finished` marker: rerunning a
    finished call trains nothing, and an early-stopped one keeps its best
    iteration."""
    X, y = _synth(600, 8, seed=11)
    ck = str(tmp_path / "ck.json")
    p = _ckpt_params({"checkpoint_path": ck, "checkpoint_interval": 2,
                      "metric": "binary_logloss", "learning_rate": 1.0})
    ds = lt.Dataset(X[:300], y[:300])
    vs = lt.Dataset(X[300:], 1.0 - y[300:], reference=ds)
    first = lt.train(p, ds, 30, valid_sets=[vs], early_stopping_rounds=2,
                     verbose_eval=False)
    st = json.load(open(ck))
    assert st["finished"] == "early_stop"
    assert first.best_iteration == st["best_iteration"] < 30
    ds2 = lt.Dataset(X[:300], y[:300])
    again = lt.train(p, ds2, 30, valid_sets=[lt.Dataset(
        X[300:], 1.0 - y[300:], reference=ds2)], early_stopping_rounds=2,
        verbose_eval=False)
    assert again.best_iteration == first.best_iteration
    assert again.model_to_string() == first.model_to_string()


def test_unreadable_checkpoint_starts_fresh(tmp_path, capfd):
    X, y = _synth(400, 8, seed=9)
    ck = tmp_path / "ck.json"
    ck.write_text('{"version": 1, "model": "tree\\nnum_cl')   # torn
    p = _ckpt_params({"checkpoint_path": str(ck), "checkpoint_interval": 2,
                      "verbose": 0})
    fresh = lt.train(p, lt.Dataset(X, y), 5, verbose_eval=False)
    assert "ignoring unreadable checkpoint" in capfd.readouterr().err
    assert fresh.current_iteration() == 5
    full = lt.train(_ckpt_params(), lt.Dataset(X, y), 5, verbose_eval=False)
    assert fresh.model_to_string() == full.model_to_string()
    ck.write_text(json.dumps({"version": 99, "model": ""}))
    assert load_checkpoint(str(ck)) is None
    assert load_checkpoint(str(tmp_path / "absent.json")) is None


def test_checkpoint_fingerprint_rejects_recipe_change(tmp_path):
    X, y = _synth(400, 8, seed=9)
    ck = str(tmp_path / "ck.json")
    p = _ckpt_params({"checkpoint_path": ck, "checkpoint_interval": 2})
    lt.train(p, lt.Dataset(X, y), 4, verbose_eval=False)
    with pytest.raises(lt.LightGBMError, match="fingerprint"):
        lt.train(dict(p, learning_rate=0.1), lt.Dataset(X, y), 8,
                 verbose_eval=False)
    # paths, verbosity and the iteration count are not part of the recipe
    a = config_fingerprint(config_from_params(p))
    b = config_fingerprint(config_from_params(
        dict(p, verbose=1, num_iterations=99, output_model="elsewhere.txt",
             checkpoint_path="other.json", checkpoint_interval=5)))
    assert a == b


@pytest.mark.parametrize("boosting", ["gbdt", "goss", "dart"])
def test_checkpoint_state_has_the_jax_fields(boosting):
    """The port's checkpoint holds the JAX package's fields, per type."""
    X, y = _synth(300, 6, seed=2)
    p = _ckpt_params({"boosting": boosting})
    bst = lt.train(p, lt.Dataset(X, y), 3, verbose_eval=False)
    jp = {k: v for k, v in p.items() if k != "device_type"}
    jb = lj.train(jp, lj.Dataset(X, y), 3, verbose_eval=False)
    st_t = bst._gbdt.training_state()
    st_j = jb._gbdt.training_state()
    assert set(st_t) == set(st_j)
    assert st_t["boosting"] == st_j["boosting"] == (
        "tree" if boosting == "gbdt" else boosting)
    assert st_t["iteration"] == st_j["iteration"] == 3
    assert st_t["bag_rng"] == st_j["bag_rng"]
    for key in ("goss_key", "drop_rng", "tree_weight"):
        if key in st_j:
            assert st_t[key] == st_j[key], key
