"""The port stands alone: importing it loads neither JAX nor the JAX
package, and its entry points run on the GPU unless the caller asks for
the CPU — with the default device_type and no visible GPU, training
raises instead of carrying on on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# imports every module of the port (found by walking the package: the
# sklearn wrappers and the callback library too) and chip_smoke.py, then
# names any JAX or JAX-package module loaded; importing builds no native
# library and loads none (the C ABI's library embeds an interpreter)
_PROBE = """
import importlib, pkgutil, sys
import lightgbm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    lightgbm_tpu_torch.__path__, "lightgbm_tpu_torch.")]
for want in ("lightgbm_tpu_torch.application",
             "lightgbm_tpu_torch.__main__",
             "lightgbm_tpu_torch.capi",
             "lightgbm_tpu_torch.native",
             "lightgbm_tpu_torch.pmml",
             "lightgbm_tpu_torch.plotting",
             "lightgbm_tpu_torch.ops.sparse_streams",
             "lightgbm_tpu_torch.serving",
             "lightgbm_tpu_torch.serving.server",
             "lightgbm_tpu_torch.diagnostics.faults",
             "lightgbm_tpu_torch.diagnostics.sanitize",
             "lightgbm_tpu_torch.learner.fused",
             "lightgbm_tpu_torch.online",
             "lightgbm_tpu_torch.online.refit",
             "lightgbm_tpu_torch.online.stream",
             "lightgbm_tpu_torch.online.trainer",
             "lightgbm_tpu_torch.router",
             "lightgbm_tpu_torch.router.server",
             "lightgbm_tpu_torch.sharded.sketch",
             "lightgbm_tpu_torch.sharded.ingest",
             "lightgbm_tpu_torch.sharded.mesh",
             "lightgbm_tpu_torch.distributed"):
    assert want in names, (want, names)
for name in names:
    importlib.import_module(name)
import chip_smoke
# importing the mesh layer and the bootstrap starts no process group
import torch.distributed as dist
assert not dist.is_initialized()
from lightgbm_tpu_torch import native
with open("/proc/self/maps") as f:
    assert "liblgbt_" not in f.read()
assert not native._TRIED and native._LIB is None
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "lightgbm_tpu" or m.startswith("lightgbm_tpu."))
print(",".join(bad))
"""


def _run(code, **env):
    e = dict(os.environ, PYTHONPATH=ROOT, **env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=e,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_no_jax():
    r = _run(_PROBE)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""


def test_import_without_sklearn_loads_no_jax():
    """The GPU host has no scikit-learn (and no pandas): the port, its
    sklearn module included, imports there, and still loads no JAX."""
    r = _run('import sys\nsys.modules["sklearn"] = None\n'
             'sys.modules["pandas"] = None\n' + _PROBE)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""


def test_default_device_raises_without_gpu():
    code = """
import numpy as np
import lightgbm_tpu_torch as lt
X = np.random.RandomState(0).randn(200, 3); y = (X[:, 0] > 0) * 1.0
try:
    lt.train({"objective": "binary", "verbose": -1}, lt.Dataset(X, y), 2)
except RuntimeError as e:
    print("raised:", e)
"""
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr
    assert "raised: device_type=cuda but no CUDA device is visible" in r.stdout


def test_device_type_validated():
    from lightgbm_tpu_torch.config import config_from_params
    assert config_from_params({}).device_type == "cuda"
    assert config_from_params({"device_type": "cpu"}).device_type == "cpu"
    with pytest.raises(ValueError, match="device_type"):
        config_from_params({"device_type": "tpu"})


def test_unported_paths_raise_not_implemented(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0) * 1.0
    import lightgbm_tpu_torch as lt
    # is_pre_partition with no world of ranks loads every row of the
    # file, as the JAX loader does in one process; a distributed
    # tree_learner with no world of ranks warns and trains on one device
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.dataset import Dataset as RawDataset
    csv = str(tmp_path / "rows.csv")
    np.savetxt(csv, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    whole = RawDataset.from_file(csv, config_from_params(
        {"num_machines": 2, "is_pre_partition": True,
         "device_type": "cpu"}))
    assert whole.num_data == 300 and whole.rank_rows is None
    with pytest.warns(UserWarning, match="one rank"):
        one = lt.train({"tree_learner": "data", "device_type": "cpu",
                        "verbose": -1}, lt.Dataset(X, y), 1)
    assert one._gbdt.learner.mesh is None
    sk = lt.train({"bin_find": "sketch", "device_type": "cpu",
                   "verbose": -1}, lt.Dataset(X, X[:, 1]), 1)
    assert sk.num_trees() == 2
    bst = lt.train({"device_type": "cpu", "verbose": -1},
                   lt.Dataset(X, y), 2)
    assert bst.refit(X, 1 - y).num_trees() == bst.num_trees()


def test_online_entry_points_raise_without_gpu():
    """With the default device_type and no visible GPU, Booster.refit
    and OnlineTrainer raise instead of running on the CPU."""
    code = """
import numpy as np
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.online import OnlineTrainer
X = np.random.RandomState(0).randn(200, 3); y = (X[:, 0] > 0) * 1.0
cpu = lt.train({"objective": "binary", "verbose": -1, "device_type": "cpu"},
               lt.Dataset(X, y), 2)
bst = lt.Booster(params={"verbose": -1}, model_str=cpu.model_to_string())
for name, fn in (("refit", lambda: bst.refit(X, y)),
                 ("trainer", lambda: OnlineTrainer(bst, "t.jsonl", "p.txt"))):
    try:
        fn()
        print(name, "ran")
    except RuntimeError as e:
        print(name, "raised:", e)
"""
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr
    for name in ("refit", "trainer"):
        assert (f"{name} raised: device_type=cuda but no CUDA device is "
                "visible") in r.stdout, r.stdout
