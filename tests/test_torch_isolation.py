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
# names any JAX or JAX-package module loaded
_PROBE = """
import importlib, pkgutil, sys
import lightgbm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    lightgbm_tpu_torch.__path__, "lightgbm_tpu_torch.")]
assert "lightgbm_tpu_torch.ops.sparse_streams" in names, names
for name in names:
    importlib.import_module(name)
import chip_smoke
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


def test_unported_paths_raise_not_implemented():
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0) * 1.0
    import lightgbm_tpu_torch as lt
    # multi-device learners and sketch bin finding are still unported
    # (the exact learner, EFB bundles and every objective are ported)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lt.train({"tree_learner": "data", "device_type": "cpu",
                  "verbose": -1}, lt.Dataset(X, y), 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lt.train({"bin_find": "sketch", "device_type": "cpu",
                  "verbose": -1}, lt.Dataset(X, X[:, 1]), 1)
