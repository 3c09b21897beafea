"""The port's multi-process bootstrap (lightgbm_tpu_torch/distributed.py)
in worlds of 2 CPU processes (tests/torch_worlds.py), against the
port's one-process run on the same rows.

- init_distributed from a machine-list file (the reference's
  num_machines + machine_list_file, one "ip port" line a machine, the
  rank from LIGHTGBM_TPU_MACHINE_RANK): a gloo world of 2; allgather_f64
  bitwise; the CLI with num_machines=2 in that world, every rank's model
  file the same and the one-process run's.
- init_distributed from a torchrun environment (WORLD_SIZE, RANK,
  MASTER_ADDR, MASTER_PORT), with lt.train feature-parallel in it.

The two TCP rendezvous take a free port of this host, found just before
the world starts."""
import json
import socket

import numpy as np
import pytest

from torch_worlds import run_world


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_rows():
    rng = np.random.RandomState(5)
    X = rng.randn(900, 4)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


_MLIST_BODY = """
import json, os
import numpy as np
os.environ["LIGHTGBM_TPU_MACHINE_RANK"] = str(RANK)
from lightgbm_tpu_torch import distributed as D
import torch.distributed as dist
assert D.init_distributed(2, OUT + "/mlist.txt", device_type="cpu",
                          timeout_s=120)
assert D.init_distributed(2, OUT + "/mlist.txt")       # idempotent
res = {"world": dist.get_world_size(), "rank": dist.get_rank(),
       "backend": dist.get_backend()}
vals = np.array([[1.0 / 3, np.nextafter(1.0, 2.0)], [-0.0, 1e-310]]) + RANK
g = D.allgather_f64(vals)
res["gathered"] = g.view(np.int64).tolist()
from lightgbm_tpu_torch import application
X = np.load(OUT + "/X.npy")
rc = application.main([f"data={OUT}/train.csv", "objective=binary",
                       "num_iterations=3", "num_leaves=7", "verbose=-1",
                       "device_type=cpu", "tree_learner=data",
                       "num_machines=2", f"machine_list_file={OUT}/mlist.txt",
                       f"output_model={OUT}/model_r{RANK}.txt"])
res["cli_rc"] = rc
json.dump(res, open(f"{OUT}/res_r{RANK}.json", "w"))
"""


@pytest.fixture(scope="module")
def mlist_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    out = tmp / "mlist_out"
    out.mkdir()
    port = _free_port()
    (out / "mlist.txt").write_text(
        f"# two processes of this host\n127.0.0.1 {port}\n"
        f"127.0.0.1 {port}\n")
    X, y = _train_rows()
    np.save(out / "X.npy", X)
    np.savetxt(out / "train.csv", np.column_stack([y, X]), delimiter=",",
               fmt="%.9g")
    run_world(tmp, 2, _MLIST_BODY, name="mlist", init=False, timeout=240)
    return out, [json.loads((out / f"res_r{r}.json").read_text())
                 for r in range(2)]


def test_init_distributed_from_a_machine_list(mlist_world):
    _, res = mlist_world
    for r, st in enumerate(res):
        assert (st["world"], st["rank"], st["backend"]) == (2, r, "gloo")


def test_allgather_f64_is_bitwise(mlist_world):
    _, res = mlist_world
    want = np.stack([np.array([[1.0 / 3, np.nextafter(1.0, 2.0)],
                               [-0.0, 1e-310]]) + r for r in range(2)])
    for st in res:
        assert np.array_equal(np.asarray(st["gathered"], np.int64),
                              want.view(np.int64))


def test_cli_with_num_machines_trains_data_parallel(mlist_world, tmp_path):
    """`python -m lightgbm_tpu_torch ... num_machines=2
    machine_list_file=...`: every rank writes the same model file, and
    it is the one-process run's (dyadic-free data: structure equal and
    float lines within rtol 1e-4)."""
    out, res = mlist_world
    assert [st["cli_rc"] for st in res] == [0, 0]
    texts = [(out / f"model_r{r}.txt").read_text() for r in range(2)]
    assert texts[0] == texts[1]
    from lightgbm_tpu_torch import application
    one = tmp_path / "one.txt"
    assert application.main([f"data={out}/train.csv", "objective=binary",
                             "num_iterations=3", "num_leaves=7",
                             "verbose=-1", "device_type=cpu",
                             f"output_model={one}"]) == 0
    a = [ln for ln in texts[0].splitlines() if not ln.startswith("[")]
    b = [ln for ln in one.read_text().splitlines()
         if not ln.startswith("[")]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x == y:
            continue
        k, vx = x.split("=", 1)
        k2, vy = y.split("=", 1)
        assert k == k2 and k in ("split_gain", "leaf_value",
                                 "internal_value"), (x, y)
        np.testing.assert_allclose(np.array(vx.split(), float),
                                   np.array(vy.split(), float),
                                   rtol=1e-4, atol=1e-6)


_ENV_BODY = """
import json, os
import numpy as np
os.environ.update({"WORLD_SIZE": str(WORLD), "RANK": str(RANK),
                   "LOCAL_RANK": str(RANK), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": open(OUT + "/port").read().strip()})
import torch.distributed as dist
from lightgbm_tpu_torch import distributed as D
assert D.init_distributed(0, device_type="cpu", timeout_s=120)
import lightgbm_tpu_torch as lt
X = np.load(OUT + "/X.npy"); y = np.load(OUT + "/y.npy")
p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
     "device_type": "cpu", "tree_learner": "feature"}
bst = lt.train(p, lt.Dataset(X, y, params=p), 3)
json.dump({"world": dist.get_world_size(), "rank": dist.get_rank(),
           "mesh": list(bst._gbdt.learner.mesh.shape),
           "model": bst.model_to_string()},
          open(f"{OUT}/env_r{RANK}.json", "w"))
"""


def test_init_distributed_from_a_torchrun_environment(tmp_path):
    """WORLD_SIZE / RANK / MASTER_ADDR / MASTER_PORT (what
    `python -m torch.distributed.run` sets) bring up the world, and
    lt.train trains feature-parallel in it: the same model on every
    rank."""
    out = tmp_path / "env_out"
    out.mkdir()
    (out / "port").write_text(str(_free_port()))
    X, y = _train_rows()
    np.save(out / "X.npy", X)
    np.save(out / "y.npy", y)
    run_world(tmp_path, 2, _ENV_BODY, name="env", init=False, timeout=180)
    res = [json.loads((out / f"env_r{r}.json").read_text())
           for r in range(2)]
    assert [(st["world"], st["rank"]) for st in res] == [(2, 0), (2, 1)]
    assert res[0]["mesh"] == [1, 2]
    assert res[0]["model"] == res[1]["model"]
    assert res[0]["model"].count("Tree=") == 3
