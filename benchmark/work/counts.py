"""The least work of a boosting iteration, counted from its tree (the
rows at each node) and the shape of its data, at float32.

Histogram step: every row is histogrammed at the root, then the smaller
child of each split (the larger comes from the parent by subtraction).
It reads each such row's bins once, each at the least width that
max_bin values need (one byte up to 256), and its float32 gradient and
hessian, adds three values a bin, and writes each histogram once
(features x max_bin cells of two float32 sums).

Whole iteration: the histogram step, plus the gradients (score and
label read, gradient and hessian written, float32, once a row), the
split search (the root's histogram and both children's of every split
read once), the row partition (a leaf id a row written, at the least
width that num_leaves values need), the score update of the train and
valid rows (leaf id read, float32 score read and written) and the valid
metric (score and label read once a row).

The least time of either is the larger of its bytes over the HBM
bandwidth and its adds over the float32 rate (work/peaks.json); both are
bytes-bound at these shapes, so a share of it is a share of bandwidth.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class Shape:
    rows: int
    valid_rows: int
    features: int
    max_bin: int


@dataclass
class Work:
    bytes: float
    adds: float

    def least_s(self, peaks: Dict) -> float:
        return max(self.bytes / float(peaks["hbm_bytes_per_s"]),
                   self.adds / float(peaks["fp32_flops_per_s"]))


def least_bytes(values: int) -> int:
    """Bytes of the narrowest whole-byte integer that holds `values`
    distinct values."""
    return max(1, math.ceil(math.log2(max(values, 2)) / 8))


def child_counts(tree, node_values: np.ndarray, leaf_values: np.ndarray,
                 ) -> np.ndarray:
    """[num_splits, 2] of a per-node quantity at each split's children."""
    out = np.zeros((tree.num_splits, 2), np.float64)
    for j in range(tree.num_splits):
        for s, c in enumerate((tree.left_child[j], tree.right_child[j])):
            out[j, s] = node_values[c] if c >= 0 else leaf_values[~c]
    return out


def histogram(tree, shape: Shape) -> Work:
    """The histogram step of one tree."""
    S = tree.num_splits
    rows = child_counts(tree, tree.internal_count.astype(np.float64),
                        tree.leaf_count.astype(np.float64))
    small = np.argmin(rows, axis=1) if S else np.zeros(0, np.int64)
    n_rows = shape.rows + float(rows[np.arange(S), small].sum())
    n_ent = n_rows * shape.features
    hist_bytes = shape.features * shape.max_bin * 2 * 4.0
    return Work(bytes=n_ent * least_bytes(shape.max_bin) + n_rows * 8.0
                + (1 + S) * hist_bytes, adds=3.0 * n_ent)


def iteration(tree, shape: Shape) -> Work:
    h = histogram(tree, shape)
    S = tree.num_splits
    hist_bytes = shape.features * shape.max_bin * 2 * 4.0
    n, nv = float(shape.rows), float(shape.valid_rows)
    leaf = least_bytes(tree.num_leaves)
    extra = (16.0 * n                       # gradients
             + (1 + 2 * S) * hist_bytes     # split search
             + leaf * n                     # partition
             + (leaf + 8.0) * (n + nv)      # score updates
             + 8.0 * nv)                    # valid metric
    return Work(bytes=h.bytes + extra, adds=h.adds)
