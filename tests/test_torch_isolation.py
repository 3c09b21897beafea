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

_PROBE = """
import sys
import lightgbm_tpu_torch
import lightgbm_tpu_torch.engine, lightgbm_tpu_torch.convert
import lightgbm_tpu_torch.learner.rounds, lightgbm_tpu_torch.kernels
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
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.dataset import Dataset
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Dataset(X, None, config_from_params({"sparse_store": "csr",
                                              "device_type": "cpu"}))
    # one-hot columns are mutually exclusive: EFB bundles them
    onehot = np.eye(4)[rng.randint(0, 4, size=300)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Dataset(np.hstack([X, onehot]), None,
                config_from_params({"device_type": "cpu"}))
