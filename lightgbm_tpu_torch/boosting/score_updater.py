"""Score updaters: raw model scores kept as [K, N] tensors on the device.

Port of lightgbm_tpu/boosting/score_updater.py for the dense store:
`_add_from_leaf` / `_add_leaf_to_row` (the leaf-partition score add,
fused into kernel K3), `_walk_step` and `traverse_tree_device` (the
valid-set walk: every row advances one tree level per step, per-node
fields fetched by one table lookup), and `ScoreUpdater`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.lookup import select_bin_by_feature, table_lookup


def _walk_step(node: torch.Tensor, bins_fn: torch.Tensor,
               split_feature: torch.Tensor, threshold: torch.Tensor,
               decision: torch.Tensor, left_child: torch.Tensor,
               right_child: torch.Tensor) -> torch.Tensor:
    """One tree level for every row at once (dense branch).  bins_fn is
    the [F, N] store; child ids are exact in f32 (|v| < 2^24)."""
    nd = torch.clamp(node, min=0)
    tbl = torch.stack([split_feature.to(torch.float32),
                       threshold.to(torch.float32),
                       decision.to(torch.float32),
                       left_child.to(torch.float32),
                       right_child.to(torch.float32)])
    r = table_lookup(tbl, nd)
    feat = r[0].to(torch.int32)
    t = r[1].to(torch.int32)
    d = r[2]
    bv = select_bin_by_feature(bins_fn, feat)
    go_left = torch.where(d == 1, bv == t, bv <= t)
    nxt = torch.where(go_left, r[3], r[4]).to(torch.int32)
    return torch.where(node < 0, node, nxt)


def traverse_tree_device(bins_fn: torch.Tensor, split_feature, threshold_bin,
                         is_cat, left_child, right_child, num_leaves: int,
                         depth: int) -> torch.Tensor:
    """Leaf index per row from device tree arrays.  The JAX version walked
    in a while_loop until every row parked at a leaf; here the host knows
    the tree's depth, so it walks exactly `depth` levels (rows parked at
    a leaf stay parked) and reads nothing back."""
    N = bins_fn.shape[1]
    n0 = -1 if num_leaves < 2 else 0       # stump: everything is leaf 0
    node = torch.full((N,), n0, dtype=torch.int32, device=bins_fn.device)
    for _ in range(depth if num_leaves >= 2 else 0):
        node = _walk_step(node, bins_fn, split_feature, threshold_bin,
                          is_cat, left_child, right_child)
    return ~node


def shrink_clip_leaves(leaf_value: torch.Tensor, num_leaves: int,
                       shrink: float) -> torch.Tensor:
    """Shrinkage + kMaxTreeOutput clamp (tree.h: ±100) + stump zeroing,
    in f32 as on the JAX device path."""
    lv = torch.clamp(leaf_value * torch.tensor(np.float32(shrink),
                                               device=leaf_value.device),
                     -100.0, 100.0)
    return lv * float(num_leaves >= 2)


def _add_leaf_to_row(score: torch.Tensor, leaf_id: torch.Tensor,
                     leaf_values: torch.Tensor, tree_id: int) -> torch.Tensor:
    """score[tree_id] += leaf_values[leaf_id] (0.0 for ids outside the
    table, e.g. out-of-bag -1): one fused lookup-add (kernel K3)."""
    row = table_lookup(leaf_values.to(torch.float32)[None], leaf_id,
                       addend=score[tree_id:tree_id + 1])
    if score.shape[0] == 1:
        return row
    out = score.clone()
    out[tree_id] = row[0]
    return out


class ScoreUpdater:
    """Holds [K, N] float32 raw scores for one dataset."""

    def __init__(self, bins_fn: Optional[torch.Tensor], num_data: int,
                 K: int, device: torch.device,
                 init_score: Optional[np.ndarray] = None):
        # bins_fn: [F, N] int32 store on `device` (None for the training
        # set, which adds by leaf id)
        self.bins_fn = bins_fn
        self.num_data = num_data
        self.K = K
        self.device = device
        self.has_init_score = init_score is not None
        score = np.zeros((K, num_data), np.float32)
        if init_score is not None:
            init_score = np.asarray(init_score, np.float64).reshape(-1)
            if init_score.size == num_data * K:
                score = init_score.reshape(K, num_data).astype(np.float32)
            elif init_score.size == num_data:
                score[:] = init_score[None, :].astype(np.float32)
            else:
                raise ValueError("init score size mismatch")
        self.score = torch.as_tensor(score, device=device)

    def add_constant(self, val: float, tree_id: int) -> None:
        self.score[tree_id] += torch.tensor(np.float32(val),
                                            device=self.device)

    def add_tree(self, tree, tree_id: int, scale: float = 1.0) -> None:
        """Whole-data tree predict path (score_updater.hpp AddScore(tree))
        from a host tree."""
        if tree.num_leaves <= 1:
            self.add_constant(float(tree.leaf_value[0]) * scale, tree_id)
            return
        d = tree.as_device_arrays(self.device)
        leaf_idx = traverse_tree_device(
            self.bins_fn, d["split_feature_inner"], d["threshold_in_bin"],
            d["decision_type"], d["left_child"], d["right_child"],
            tree.num_leaves, d["depth"])
        lv = torch.as_tensor(
            tree.leaf_value[: tree.max_leaves].astype(np.float32)
            * np.float32(scale), device=self.device)
        self.score = _add_leaf_to_row(self.score, leaf_idx, lv, tree_id)

    def add_tree_arrays_dev(self, arrs, leaf_values: torch.Tensor,
                            tree_id: int, num_leaves: int,
                            depth: int) -> None:
        """Whole-data score update from device TreeArrays (valid sets);
        `leaf_values` carries shrinkage/clamp already."""
        leaf_idx = traverse_tree_device(
            self.bins_fn, arrs.split_feature, arrs.threshold_bin,
            arrs.is_cat, arrs.left_child, arrs.right_child, num_leaves,
            depth)
        self.score = _add_leaf_to_row(self.score, leaf_idx, leaf_values,
                                      tree_id)

    def add_tree_by_leaf_id_dev(self, leaf_id: torch.Tensor,
                                leaf_values: torch.Tensor,
                                tree_id: int) -> None:
        """Leaf-partition score update (training set) with device leaf
        values, shrinkage applied."""
        self.score = _add_leaf_to_row(self.score, leaf_id, leaf_values,
                                      tree_id)
