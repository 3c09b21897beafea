"""The port's CLI (lightgbm_tpu_torch/application.py, `python -m
lightgbm_tpu_torch`) on the CPU, against lightgbm_tpu.application.

Every data and config file is written here from a seed (none is read
from a reference checkout).  Both packages run the rounds learner
(`tree_growth=rounds`, `hist_rows=gathered`: JAX's CPU default is the
exact learner).  The CLI-trained model strings agree line by line: every
structural line as a string, the split gains, leaf and internal values
within rtol 1e-4 (the f32 summation orders of ROADMAP.md §C fault 6);
predictions within 1e-5.  Within the port: task=predict against
Booster.predict (1e-6, the runtime's f32 walk against the host f64 walk)
and chunked against one-shot (1e-7); task=refit bitwise against
Booster.refit (within 1e-5 of JAX's task=refit); input_model
continuation; a checkpoint resume whose model string equals the
uninterrupted run's; the error paths; task=serve, task=route and
task=online as subprocesses; and the file surface of basic.py
(Dataset(path), Booster.predict(path), train(init_model=) on a file
dataset, save_binary).
"""
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import lightgbm_tpu.application as japp
from lightgbm_tpu.basic import Booster as JBooster

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import application as tapp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLOAT_LINES = ("split_gain", "leaf_value", "internal_value")
PARAMS = ["objective=binary", "metric=auc", "num_leaves=15", "max_bin=63",
          "min_data_in_leaf=5", "learning_rate=0.2", "tree_growth=rounds",
          "hist_rows=gathered", "verbose=-1"]


def _rows(n, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n)
         > 0).astype(np.float64)
    return X, y


def _write_csv(path, X, y, header=None, sep=","):
    with open(path, "w") as f:
        if header:
            f.write(sep.join(header) + "\n")
        for i in range(len(y)):
            f.write(sep.join(f"{v:.9g}" for v in [y[i], *X[i]]) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    X, y = _rows(2000)
    Xv, yv = _rows(500, seed=7)
    train = _write_csv(d / "train.csv", X, y)
    np.savetxt(train + ".weight",
               np.random.RandomState(3).rand(2000) + 0.5, fmt="%.9g")
    valid = _write_csv(d / "valid.csv", Xv, yv)
    conf = d / "train.conf"
    conf.write_text("# the training config\ntask = train\n"
                    + "".join(p.replace("=", " = ") + "  # a comment\n"
                              for p in PARAMS)
                    + f"data = {train}\nvalid_data = {valid}\n"
                    "num_iterations = 5\n")
    return {"dir": d, "train": train, "valid": valid, "conf": str(conf),
            "X": X, "y": y, "Xv": Xv, "yv": yv}


def _main_port(*argv):
    return tapp.main([*argv, "device_type=cpu"])


@pytest.fixture(scope="module")
def models(files):
    d = files["dir"]
    mt, mj = str(d / "port.txt"), str(d / "jax.txt")
    assert _main_port(f"config={files['conf']}", f"output_model={mt}") == 0
    assert japp.main([f"config={files['conf']}", f"output_model={mj}"]) == 0
    return mt, mj


def _assert_model_lines_close(text_t, text_j):
    a, b = text_j.splitlines(), text_t.splitlines()
    assert len(b) == len(a)
    for i, (la, lb) in enumerate(zip(a, b)):
        key = la.split("=", 1)[0]
        if key in _FLOAT_LINES:
            assert lb.split("=", 1)[0] == key
            va = np.array(la.split("=", 1)[1].split(), np.float64)
            vb = np.array(lb.split("=", 1)[1].split(), np.float64)
            np.testing.assert_allclose(vb, va, rtol=1e-4,
                                       atol=1e-3 * np.abs(va).max(),
                                       err_msg=f"line {i}: {key}")
        else:
            assert lb == la, f"line {i}"


def test_train_from_config_matches_jax(files, models):
    mt, mj = models
    with open(mt) as f, open(mj) as g:
        _assert_model_lines_close(f.read(), g.read())
    bt = lt.Booster(model_file=mt, params={"device_type": "cpu"})
    bj = JBooster(model_file=mj)
    np.testing.assert_allclose(bt.predict(files["Xv"]),
                               bj.predict(files["Xv"]), atol=1e-5)
    assert os.path.exists(mt + ".refbin")


def test_training_log_and_binary_cache(files, tmp_path, capfd):
    """is_save_binary_file writes <data>.bin; a rerun loads it (and says
    so) and trains the same model."""
    data = _write_csv(tmp_path / "t.csv", files["X"], files["y"])
    m1, m2 = str(tmp_path / "m1.txt"), str(tmp_path / "m2.txt")
    base = [f"config={files['conf']}", f"data={data}", "verbose=1",
            "is_save_binary_file=true", "num_iterations=3"]
    assert _main_port(*base, f"output_model={m1}") == 0
    out = capfd.readouterr().out
    assert "saved binary dataset cache" in out
    assert "Iteration:3, valid_1 auc" in out
    assert os.path.exists(data + ".bin")
    assert _main_port(*base, f"output_model={m2}") == 0
    out = capfd.readouterr().out
    assert f"loading binary dataset cache {data}.bin" in out
    assert "saved binary dataset cache" not in out
    with open(m1) as f, open(m2) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("kind", ["value", "raw", "leaf"])
def test_predict_task(files, models, tmp_path, kind):
    mt, _ = models
    out = str(tmp_path / "p.txt")
    extra = {"value": [], "raw": ["is_predict_raw_score=true"],
             "leaf": ["is_predict_leaf_index=true"]}[kind]
    assert _main_port("task=predict", f"data={files['valid']}",
                      f"input_model={mt}", f"output_result={out}",
                      "verbose=-1", *extra) == 0
    got = np.loadtxt(out)
    bst = lt.Booster(model_file=mt, params={"device_type": "cpu"})
    ref = bst.predict(files["Xv"], raw_score=kind == "raw",
                      pred_leaf=kind == "leaf")
    if kind == "leaf":
        assert np.array_equal(got, ref)
        return
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    pred = tapp.Predictor(bst, raw_score=kind == "raw")
    chunked = str(tmp_path / "c.txt")
    pred.predict_file(files["valid"], chunked, chunk_rows=37)
    np.testing.assert_allclose(np.loadtxt(chunked), got, rtol=0, atol=1e-7)


def test_refit_task(files, models, tmp_path):
    mt, mj = models
    Xd, _ = _rows(800, seed=21)
    yd = 1.0 - (Xd[:, 0] > 0)                      # drifted labels
    data = _write_csv(tmp_path / "drift.csv", Xd, yd)
    out_t, out_j = str(tmp_path / "rt.txt"), str(tmp_path / "rj.txt")
    args = ["task=refit", f"data={data}", "verbose=-1",
            "refit_decay_rate=0.3"]
    assert _main_port(*args, f"input_model={mt}",
                      f"output_model={out_t}") == 0
    X9 = np.loadtxt(data, delimiter=",")[:, 1:]    # the file's values
    ref = lt.Booster(model_file=mt, params={"device_type": "cpu"}).refit(
        X9, yd, decay_rate=0.3)
    got = lt.Booster(model_file=out_t, params={"device_type": "cpu"})
    assert got.num_trees() == ref.num_trees()
    for a, b in zip(got._gbdt.models, ref._gbdt.models):
        assert np.array_equal(a.leaf_value[:a.num_leaves],
                              b.leaf_value[:b.num_leaves])
    # JAX's task=refit of the same model text
    assert japp.main([*args, f"input_model={mt}",
                      f"output_model={out_j}"]) == 0
    jb = JBooster(model_file=out_j)
    for a, b in zip(got._gbdt.models, jb._gbdt.models):
        np.testing.assert_allclose(a.leaf_value[:a.num_leaves],
                                   b.leaf_value[:b.num_leaves],
                                   rtol=1e-5, atol=1e-7)


def test_input_model_continuation(files, models, tmp_path):
    """input_model continues a model: 5 loaded trees and 3 new ones, as
    train(init_model=) on Dataset(path) grows them."""
    mt, _ = models
    out = str(tmp_path / "cont.txt")
    assert _main_port(f"config={files['conf']}", f"input_model={mt}",
                      "num_iterations=3", f"output_model={out}") == 0
    cont = lt.Booster(model_file=out, params={"device_type": "cpu"})
    base = lt.Booster(model_file=mt, params={"device_type": "cpu"})
    assert cont.num_trees() == base.num_trees() + 3
    assert cont.current_iteration() == 8
    params = dict(p.split("=") for p in PARAMS)
    params.update(device_type="cpu")
    api = lt.train(params, lt.Dataset(files["train"], params=params), 3,
                   init_model=mt, verbose_eval=False)
    assert api.num_trees() == cont.num_trees()
    np.testing.assert_allclose(api.predict(files["Xv"], raw_score=True),
                               cont.predict(files["Xv"], raw_score=True),
                               rtol=1e-4, atol=1e-4)
    # the continued model improves on its base on the valid rows
    auc = lambda p: _auc(files["yv"], p)
    assert auc(cont.predict(files["Xv"])) >= auc(base.predict(files["Xv"]))


def _auc(y, p):
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    pos = y > 0
    return ((ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2)
            / (pos.sum() * (~pos).sum()))


def test_checkpoint_resume_equals_uninterrupted(files, tmp_path):
    """A run stopped after 3 iterations and resumed to 6 from its
    checkpoint writes the model string of an uninterrupted 6-iteration
    run (a dyadic learning rate and bagging, whose RNG the checkpoint
    carries)."""
    common = [f"config={files['conf']}", "learning_rate=0.5",
              "bagging_fraction=0.7", "bagging_freq=1"]
    full, resumed = str(tmp_path / "full.txt"), str(tmp_path / "res.txt")
    ckpt = str(tmp_path / "ckpt.json")
    assert _main_port(*common, "num_iterations=6",
                      f"output_model={full}") == 0
    assert _main_port(*common, "num_iterations=3", f"checkpoint_path={ckpt}",
                      "checkpoint_interval=1",
                      f"output_model={resumed}") == 0
    assert _main_port(*common, "num_iterations=6", f"checkpoint_path={ckpt}",
                      "checkpoint_interval=1",
                      f"output_model={resumed}") == 0
    with open(full) as f, open(resumed) as g:
        assert g.read() == f.read()


def test_error_paths_return_one(tmp_path):
    assert tapp.main([]) == 1
    assert tapp.main(["task=predict", "data=/nonexistent"]) == 1
    assert tapp.main(["task=banana", "data=x"]) == 1
    assert tapp.main(["task=train"]) == 1
    assert tapp.main(["task=refit", "data=x"]) == 1
    assert tapp.main(["task=online", "verbose=-1", "device_type=cpu"]) == 1
    # pre_partition with num_machines=2 but no machine list and no rank:
    # no world comes up, and the whole file trains, as in the JAX CLI
    rng = np.random.RandomState(0)
    X = rng.randn(300, 3)
    data = str(tmp_path / "d.csv")
    np.savetxt(data, np.column_stack([(X[:, 0] > 0) * 1.0, X]),
               delimiter=",", fmt="%.9g")
    model = str(tmp_path / "m.txt")
    with pytest.warns(UserWarning, match="single-host test mode"):
        assert tapp.main([f"data={data}", "num_machines=2",
                          "is_pre_partition=true", "num_iterations=1",
                          "objective=binary", "verbose=-1",
                          "device_type=cpu", f"output_model={model}"]) == 0
    with open(model) as f:
        assert "internal_count=300 " in f.read()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(*argv):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", *argv,
         "device_type=cpu", "serve_host=127.0.0.1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def _wait_healthy(proc, port, deadline=120.0):
    t0 = time.time()
    while time.time() - t0 < deadline:
        if proc.poll() is not None:
            raise AssertionError(proc.stdout.read())
        try:
            if _request(port, "GET", "/healthz")[0] == 200:
                return
        except OSError:
            time.sleep(0.2)
    raise AssertionError("no answer from /healthz")


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, out


def test_serve_task_subprocess(files, models):
    mt, _ = models
    port = _free_port()
    proc = _spawn("task=serve", f"input_model={mt}", f"serve_port={port}",
                  "serve_quantize=raw", "model_poll_seconds=0")
    try:
        _wait_healthy(proc, port)
        rows = files["Xv"][:8]
        status, text = _request(port, "POST", "/predict",
                                "\n".join(json.dumps(r.tolist())
                                          for r in rows))
        assert status == 200
        got = np.array([json.loads(t) for t in text.splitlines()])
        ref = lt.Booster(model_file=mt, params={"device_type": "cpu"})
        np.testing.assert_allclose(got, ref.predict(rows), atol=1e-6)
    finally:
        _stop(proc)


def test_route_task_subprocess(files, models):
    from lightgbm_tpu_torch.serving import ModelRegistry, PredictionServer
    mt, _ = models
    reg = ModelRegistry(mt, params={"device_type": "cpu", "verbose": -1})
    rows = "\n".join(json.dumps(r.tolist()) for r in files["Xv"][:4])
    with PredictionServer(reg, host="127.0.0.1", port=0,
                          model_poll_seconds=0) as srv:
        direct = _request(srv.port, "POST", "/predict", rows)
        port = _free_port()
        proc = _spawn("task=route", f"route_backends=127.0.0.1:{srv.port}",
                      f"route_port={port}", "route_health_interval_ms=200")
        try:
            _wait_healthy(proc, port)
            routed = _request(port, "POST", "/predict", rows)
        finally:
            _stop(proc)
    assert routed == direct and direct[0] == 200


def test_online_task_publishes_a_generation(files, models, tmp_path):
    from lightgbm_tpu_torch.online import append_traffic
    mt, _ = models
    traffic, pub = str(tmp_path / "traffic.jsonl"), str(tmp_path / "pub.txt")
    append_traffic(traffic, files["X"][:300], 1.0 - files["y"][:300])
    proc = _spawn("task=online", f"input_model={mt}", f"data={traffic}",
                  f"output_model={pub}", "online_trigger_rows=256",
                  "refit_decay_rate=0", "model_poll_seconds=0.2",
                  "verbose=1")
    try:
        t0 = time.time()
        while not os.path.exists(pub + ".meta.json"):
            assert proc.poll() is None, proc.stdout.read()
            assert time.time() - t0 < 120, "no generation published"
            time.sleep(0.2)
    finally:
        _stop(proc)
    with open(pub + ".meta.json") as f:
        assert json.load(f)["generation"] == 1
    assert lt.Booster(model_file=pub, params={"device_type": "cpu"}
                      ).num_trees() == 5


def test_dataset_and_predict_from_path(files, tmp_path):
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "device_type": "cpu", "max_bin": 63}
    ds = lt.Dataset(files["train"], params=params)
    vs = lt.Dataset(files["valid"], reference=ds)
    rec = {}
    bst = lt.train(params, ds, 4, valid_sets=[vs], evals_result=rec,
                   verbose_eval=False)
    assert ds.num_data() == 2000 and vs.num_data() == 500
    assert ds.get_weight() is not None        # the .weight side file
    # the same rows in memory, as the file holds them (%.9g)
    X9 = np.loadtxt(files["train"], delimiter=",")[:, 1:]
    Xv9 = np.loadtxt(files["valid"], delimiter=",")[:, 1:]
    mem = lt.train(params, lt.Dataset(X9, files["y"],
                                      weight=ds.get_weight(),
                                      params=params), 4)
    assert bst.model_to_string() == mem.model_to_string()
    assert np.array_equal(bst.predict(files["valid"]), bst.predict(Xv9))
    hdr = _write_csv(tmp_path / "h.tsv", files["Xv"], files["yv"],
                     header=["y"] + [f"f{j}" for j in range(6)], sep="\t")
    assert np.array_equal(bst.predict(hdr, data_has_header=True),
                          bst.predict(Xv9))
    with pytest.raises(lt.LightGBMError, match="file-backed"):
        ds.subset([0, 1, 2])
    # the public save_binary writes what Dataset(path) loads again
    binf = str(tmp_path / "train.bin")
    ds.save_binary(binf)
    again = lt.Dataset(binf, params=params).construct()
    assert np.array_equal(again._inner.bins, ds._inner.bins)
    assert again._inner.source == binf
    # lazily imported subsystems, and the plot exports
    assert lt.serving.PredictionServer is not None
    assert lt.online.OnlineTrainer is not None
    assert callable(lt.plot_importance) and callable(lt.create_tree_digraph)
