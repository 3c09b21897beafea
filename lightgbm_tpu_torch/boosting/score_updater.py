"""Score updaters: raw model scores kept as [K, N] tensors on the device.

Port of lightgbm_tpu/boosting/score_updater.py: `_add_from_leaf` /
`_add_leaf_to_row` (the leaf-partition score add, fused into kernel K3),
`_walk_step` and `traverse_tree_device` (the valid-set walk: every row
advances one tree level per step, per-node fields fetched by one table
lookup), and `ScoreUpdater`.  A valid set's store is the dense [F, N]
tensor or the sparse ELL triple (cols, bins, zero_bin), whose bin reads
probe the row's stored entries (ops/predict.sparse_bin_lookup) so the
store never densifies.  Over an EFB-bundled store the walk maps each
node's original feature to its store column and recovers the original
bin from the packed slot (`feat_tbl`).  The training set adds by leaf
id, and walks its learner's store (resolved on the first walk) where a
tree has no leaf ids for it: bagged iterations of the exact learner,
DART's drops and renormalization, rollback, and the replay of a resumed
or continued model (`add_trees`, one tree at a time in training's
order, so a resumed run's scores are bitwise those of the uninterrupted
one).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.lookup import select_bin_by_feature, table_lookup
from ..ops.predict import sparse_bin_lookup


def _num_rows(bins_fn) -> int:
    """Rows of a dense [F, N] store or a sparse (cols [N, R], ...) triple."""
    if isinstance(bins_fn, (tuple, list)):
        return bins_fn[0].shape[0]
    return bins_fn.shape[1]


def _walk_step(node: torch.Tensor, bins_fn,
               split_feature: torch.Tensor, threshold: torch.Tensor,
               decision: torch.Tensor, left_child: torch.Tensor,
               right_child: torch.Tensor,
               feat_tbl: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One tree level for every row at once.  bins_fn is the [C, N]
    store, or the sparse ELL triple (cols, bins, zero_bin), whose bin
    read is `sparse_bin_lookup`; child ids are exact in f32 (|v| <
    2^24).  feat_tbl ([5, F]: column, offset, default, nslots, packed)
    maps the node's original feature onto a bundled store column and the
    packed slot back to the original bin; None for an unbundled store."""
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
    if isinstance(bins_fn, (tuple, list)):
        def bin_of(c):
            return sparse_bin_lookup(*bins_fn, c)
    else:
        def bin_of(c):
            return select_bin_by_feature(bins_fn, c)
    if feat_tbl is None:
        bv = bin_of(feat)
    else:
        fr = table_lookup(feat_tbl, feat)
        off = fr[1].to(torch.int32)
        dflt = fr[2].to(torch.int32)
        bv_store = bin_of(fr[0].to(torch.int32))
        s = bv_store - off
        in_r = (s >= 0) & (s < fr[3].to(torch.int32))
        orig = torch.where(in_r, s + (s >= dflt).to(torch.int32), dflt)
        bv = torch.where(fr[4] > 0, orig, bv_store)
    go_left = torch.where(d == 1, bv == t, bv <= t)
    nxt = torch.where(go_left, r[3], r[4]).to(torch.int32)
    return torch.where(node < 0, node, nxt)


def traverse_tree_device(bins_fn, split_feature, threshold_bin,
                         is_cat, left_child, right_child, num_leaves: int,
                         depth: int, feat_tbl: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Leaf index per row from device tree arrays.  The JAX version walked
    in a while_loop until every row parked at a leaf; here the host knows
    the tree's depth, so it walks exactly `depth` levels (rows parked at
    a leaf stay parked) and reads nothing back."""
    N = _num_rows(bins_fn)
    n0 = -1 if num_leaves < 2 else 0       # stump: everything is leaf 0
    node = torch.full((N,), n0, dtype=torch.int32,
                      device=split_feature.device)
    for _ in range(depth if num_leaves >= 2 else 0):
        node = _walk_step(node, bins_fn, split_feature, threshold_bin,
                          is_cat, left_child, right_child, feat_tbl)
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
                     leaf_values: torch.Tensor, tree_id: int) -> None:
    """score[tree_id] += leaf_values[leaf_id] (0.0 for ids outside the
    table, e.g. out-of-bag -1), in place: one fused lookup-add (kernel
    K3) that reads and writes row tree_id of the [K, N] score."""
    row = score[tree_id:tree_id + 1]
    table_lookup(leaf_values.to(torch.float32)[None], leaf_id, addend=row,
                 out=row)


class ScoreUpdater:
    """Holds [K, N] float32 raw scores for one dataset."""

    def __init__(self, bins_fn, num_data: int,
                 K: int, device: torch.device,
                 init_score: Optional[np.ndarray] = None,
                 feat_tbl: Optional[np.ndarray] = None):
        # bins_fn: the [C, N] store (int32, or the rounds learner's int8
        # bytes) or the sparse (cols, bins, zero_bin) triple on `device`,
        # or a function returning one, called on the first walk (the
        # training set's learner store); feat_tbl: the [5, F] bundle
        # walk table of an EFB store, None for the per-feature layout
        self._bins_src = bins_fn
        self.feat_tbl = (None if feat_tbl is None else
                         torch.as_tensor(feat_tbl, dtype=torch.float32,
                                         device=device))
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

    @property
    def bins_fn(self):
        """The store the walk reads, resolved on first use."""
        if callable(self._bins_src):
            self._bins_src = self._bins_src()
        return self._bins_src

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
            tree.num_leaves, d["depth"], self.feat_tbl)
        lv = torch.as_tensor(
            tree.leaf_value[: tree.max_leaves].astype(np.float32)
            * np.float32(scale), device=self.device)
        _add_leaf_to_row(self.score, leaf_idx, lv, tree_id)

    def add_trees(self, trees, K: int, kernel: str = "auto") -> None:
        """Replay a whole model onto the scores (a valid set added to a
        trained model, a continued or resumed run): tree i adds to score
        row i % K, one walk a tree in the model's order, as training
        added them.  The JAX package's tensorized replay (one ensemble
        traversal) needs the ensemble predictors; `auto` and `walk` take
        the walk until they are ported."""
        if kernel == "tensorized":
            raise NotImplementedError(
                "predict_kernel=tensorized replay needs the ensemble "
                "predictors, not ported yet (ROADMAP.md §A item 8); use "
                "predict_kernel=walk or auto")
        for i, t in enumerate(trees):
            self.add_tree(t, i % K)

    def get(self) -> np.ndarray:
        """The [K, N] scores on the host, in float64 (what a custom
        objective and a custom metric read)."""
        return self.score.cpu().numpy().astype(np.float64)

    def add_tree_arrays_dev(self, arrs, leaf_values: torch.Tensor,
                            tree_id: int, num_leaves: int,
                            depth: int) -> None:
        """Whole-data score update from device TreeArrays (valid sets);
        `leaf_values` carries shrinkage/clamp already."""
        leaf_idx = traverse_tree_device(
            self.bins_fn, arrs.split_feature, arrs.threshold_bin,
            arrs.is_cat, arrs.left_child, arrs.right_child, num_leaves,
            depth, self.feat_tbl)
        _add_leaf_to_row(self.score, leaf_idx, leaf_values, tree_id)

    def add_tree_by_leaf_id(self, tree, leaf_id: torch.Tensor,
                            tree_id: int) -> None:
        """Leaf-partition score update from a host tree whose leaf values
        carry shrinkage already (the exact learner's training rows):
        leaf id -1 (out-of-bag rows) adds 0.0."""
        lv = torch.as_tensor(
            tree.leaf_value[: tree.max_leaves].astype(np.float32),
            device=self.device)
        _add_leaf_to_row(self.score, leaf_id, lv, tree_id)

    def add_tree_by_leaf_id_dev(self, leaf_id: torch.Tensor,
                                leaf_values: torch.Tensor,
                                tree_id: int) -> None:
        """Leaf-partition score update (training set) with device leaf
        values, shrinkage applied."""
        _add_leaf_to_row(self.score, leaf_id, leaf_values, tree_id)
