"""A LightGBM tree as its model text states it, and rows sent through it.

A numerical split sends a row left when its value is at or below the
threshold; a missing-type of zero or NaN sends a zero or NaN value the
split's default way (decision_type bit 1 left, bits 2-3 the missing
type).  Rows are walked by their raw float64 values, never by bins.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch


@dataclass
class Tree:
    num_leaves: int
    split_feature: np.ndarray
    threshold: np.ndarray
    decision_type: np.ndarray
    left_child: np.ndarray
    right_child: np.ndarray
    split_gain: np.ndarray
    leaf_value: np.ndarray
    leaf_count: np.ndarray
    internal_count: np.ndarray
    shrinkage: float

    @property
    def num_splits(self) -> int:
        return self.num_leaves - 1


def walk(tree: Tree, cols: torch.Tensor, lut: Dict[int, int],
         values: Optional[torch.Tensor] = None):
    """The leaf of every row ([n] int64).  `cols` holds the raw values of
    the features in `lut`'s order.  With `values` [n, C] float64 it also
    returns their [num_splits, C] sums over the rows reaching each
    internal node."""
    n = cols.shape[0]
    dev = cols.device
    sums = (None if values is None else
            torch.zeros(max(tree.num_splits, 0), values.shape[1],
                        dtype=torch.float64, device=dev))
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    if tree.num_leaves > 1:
        feat = torch.as_tensor([lut[int(f)] for f in tree.split_feature],
                               device=dev)
        thr = torch.as_tensor(tree.threshold, device=dev)
        dt = torch.as_tensor(tree.decision_type, device=dev)
        if bool((dt & 1).any()):
            raise ValueError("categorical splits are not read by this walk")
        default_left = (dt & 2) != 0
        missing = (dt >> 2) & 3
        left = torch.as_tensor(tree.left_child, device=dev)
        right = torch.as_tensor(tree.right_child, device=dev)
        rows = torch.arange(n, device=dev)
        while rows.numel():
            nd = node[rows]
            if sums is not None:
                sums.index_add_(0, nd, values[rows])
            x = cols[rows, feat[nd]]
            go_left = x <= thr[nd]
            m = missing[nd]
            dflt = ((m == 1) & (x == 0)) | ((m == 2) & torch.isnan(x))
            go_left = torch.where(dflt, default_left[nd], go_left)
            nxt = torch.where(go_left, left[nd], right[nd])
            node[rows] = nxt
            rows = rows[nxt >= 0]
        node = ~node
    return node if values is None else (node, sums)


def leaf_sums(tree: Tree, leaf: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(tree.num_leaves, values.shape[1], dtype=torch.float64,
                      device=values.device)
    out.index_add_(0, leaf, values)
    return out
