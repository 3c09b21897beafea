"""Seeded synthetic data and parameters of the north-star workload.

`synth_higgs` is the JAX package's HIGGS-shaped binary task (bench.py
`synth_higgs`): N x 28 dense numerical features, a fixed labeling
function (seed 0) so train and valid sets drawn with different seeds
share it, and seeded features and label noise.  `NORTH_STAR_PARAMS` is
the training configuration bench.py times on it, with the valid set
scored by AUC; chip_smoke.py and trace_main.py both run it.
"""
from __future__ import annotations

import numpy as np

NORTH_STAR_PARAMS = {"objective": "binary", "metric": "auc",
                     "num_leaves": 255, "max_bin": 255,
                     "learning_rate": 0.1, "min_data_in_leaf": 1,
                     "min_sum_hessian_in_leaf": 100.0,
                     "histogram_dtype": "int8", "verbose": -1}


def synth_higgs(n: int, f: int = 28, seed: int = 42):
    w = np.random.RandomState(0).randn(f) / np.sqrt(f)
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    logits = (X @ w + 0.5 * np.sin(X[:, 0] * 2.0) * X[:, 1]
              - 0.3 * X[:, 2] * X[:, 3])
    y = (logits + rng.logistic(size=n) * 0.5 > 0).astype(np.float64)
    return X.astype(np.float64), y
