"""Seeded synthetic data and parameters of the north-star workload.

`synth_higgs` is the JAX package's HIGGS-shaped binary task (bench.py
`synth_higgs`): N x 28 dense numerical features, a fixed labeling
function (seed 0) so train and valid sets drawn with different seeds
share it, and seeded features and label noise.  `NORTH_STAR_PARAMS` is
the training configuration bench.py times on it, with the valid set
scored by AUC; chip_smoke.py and trace_main.py both run it.

`synth_higgs_target` gives the same rows with that labeling function
left unthresholded (a regression target), and `quantile_classes` cuts
such a target into classes (the multiclass workload of chip_smoke.py).

`synth_ctr` is the JAX package's wide-sparse CTR/ranking shape (bench.py
`synth_ctr`): hashed count features with power-law column popularity,
lognormal values and 0/1 relevance in fixed-size queries, returned as a
scipy CSR matrix.  `CTR_PARAMS` is the on-chip CTR configuration of the
JAX package's chip queue (the bench_ctr stage: lambdarank over the
sparse CSR/ELL store, 31 leaves, 63 bins, EFB off); chip_smoke.py and
the sparse tests run it.

`synth_onehot` is the JAX package's one-hot EFB shape (bench.py
`synth_onehot`, BENCH_WORKLOAD=onehot): 40 categorical groups one-hot
encoded into 6 columns each (240 features, exactly one non-zero per
group per row, so bundling packs each group into one store column) with
a fixed (seed 0) logistic labelling.  `ONEHOT_PARAMS` is the training
configuration bench.py runs on it (bench.py:278-293: binary, AUC, 255
leaves, 255 bins, EFB on, the dense store pinned); chip_smoke.py,
trace_main.py and the bundle tests run it.
"""
from __future__ import annotations

import numpy as np

NORTH_STAR_PARAMS = {"objective": "binary", "metric": "auc",
                     "num_leaves": 255, "max_bin": 255,
                     "learning_rate": 0.1, "min_data_in_leaf": 1,
                     "min_sum_hessian_in_leaf": 100.0,
                     "histogram_dtype": "int8", "verbose": -1}

# scripts/run_chip_queue.sh bench_ctr / bench_ctr_int8 read through
# bench.py: float32 histograms there, int8 in the second stage
CTR_PARAMS = {"objective": "lambdarank", "metric": "ndcg",
              "num_leaves": 31, "max_bin": 63, "learning_rate": 0.1,
              "min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 100.0,
              "sparse_store": "csr", "enable_bundle": False,
              "bin_construct_sample_cnt": 20_000,
              "histogram_dtype": "float32", "verbose": -1}


# bench.py with BENCH_WORKLOAD=onehot: the north-star parameters with
# EFB on and the dense store pinned (the exact learner ignores the int8
# histogram dtype and histograms in float32)
ONEHOT_PARAMS = dict(NORTH_STAR_PARAMS, enable_bundle=True,
                     sparse_store="dense")


def synth_higgs_target(n: int, f: int = 28, seed: int = 42):
    """synth_higgs's features and its labeling function left
    unthresholded: (X, logit + 0.5 x logistic noise), the draws of
    synth_higgs(n, f, seed) (its label is this target > 0)."""
    w = np.random.RandomState(0).randn(f) / np.sqrt(f)
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    logits = (X @ w + 0.5 * np.sin(X[:, 0] * 2.0) * X[:, 1]
              - 0.3 * X[:, 2] * X[:, 3])
    return X.astype(np.float64), logits + rng.logistic(size=n) * 0.5


def synth_higgs(n: int, f: int = 28, seed: int = 42):
    X, target = synth_higgs_target(n, f, seed)
    return X, (target > 0).astype(np.float64)


def quantile_classes(target: np.ndarray, cuts: np.ndarray) -> np.ndarray:
    """Class ids 0..len(cuts) of a regression target cut at `cuts`
    (e.g. a training target's 20/40/60/80% quantiles, so a valid set is
    labelled by the same rule)."""
    return np.searchsorted(cuts, target, side="right").astype(np.float64)


def synth_ctr(n: int, features: int = 50_000, density: float = 0.01,
              seed: int = 42, query: int = 20):
    """Hashed count features (power-law column draw, lognormal values),
    0/1 relevance from a fixed (seed 0) labeling function, `query`-row
    queries.  Returns (scipy CSR X [n', features], y [n'], group sizes),
    n' = n rounded down to whole queries."""
    import scipy.sparse as spm
    rng = np.random.RandomState(seed)
    n = max(query, (n // query) * query)
    nnz = max(1, int(round(features * density)))
    cols = (features * rng.rand(n * nnz) ** 3.0).astype(np.int64)
    np.clip(cols, 0, features - 1, out=cols)
    rows = np.repeat(np.arange(n), nnz)
    vals = np.exp(rng.randn(n * nnz))
    X = spm.csr_matrix((vals, (rows, cols)), shape=(n, features))
    X.sum_duplicates()
    w = np.random.RandomState(0).randn(features) / np.sqrt(nnz)
    lin = np.asarray(X @ w).ravel()
    logits = lin + 0.5 * np.sin(3.0 * lin)
    y = (logits + rng.logistic(size=n) * 0.3 > 0).astype(np.float64)
    group = np.full(n // query, query, np.int64)
    return X, y, group


def synth_onehot(n: int, groups: int = 40, card: int = 6, seed: int = 42):
    """`groups` categorical variables of `card` levels each, one-hot
    encoded into groups * card float64 columns (one non-zero per group
    per row: 100% exclusive), and 0/1 labels from a fixed (seed 0)
    linear function plus seeded logistic noise.  Returns (X, y)."""
    w = np.random.RandomState(0).randn(groups * card)
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card), np.float64)
    for g in range(groups):
        X[np.arange(n), g * card + codes[:, g]] = 1.0
    y = (X @ w + rng.logistic(size=n) * 0.5 > 0).astype(np.float64)
    return X, y
