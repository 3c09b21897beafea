"""Device tree arrays and the tree-learner factory.

Port of the parts of lightgbm_tpu/learner/fused.py the rounds learner
needs: `TreeArrays`, `pack_tree_arrays`, `unpack_tree_arrays`,
`tree_arrays_to_host` and `create_tree_learner`.  The fused exact and
feature/voting learners are later slices (ROADMAP.md §A items 10, 12).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..tree import CATEGORICAL_DECISION, NUMERICAL_DECISION, Tree


class TreeArrays(NamedTuple):
    """Device tree in the reference's flat-node layout (tree.h:161-196):
    internal nodes 0..n-2, leaves as ~leaf in child arrays."""
    split_feature: torch.Tensor    # [L-1] int32 inner (used-feature) index
    threshold_bin: torch.Tensor    # [L-1] int32
    is_cat: torch.Tensor           # [L-1] bool
    left_child: torch.Tensor       # [L-1] int32
    right_child: torch.Tensor      # [L-1] int32
    split_gain: torch.Tensor       # [L-1] f32
    internal_value: torch.Tensor   # [L-1] f32 (parent output pre-split)
    internal_count: torch.Tensor   # [L-1] f32
    leaf_value: torch.Tensor       # [L] f32
    leaf_count: torch.Tensor       # [L] f32
    leaf_depth: torch.Tensor       # [L] int32
    num_leaves: torch.Tensor       # [] int32


def pack_tree_arrays(arrs: TreeArrays) -> torch.Tensor:
    """Flatten TreeArrays into ONE f32 vector so the host fetches a single
    transfer.  All int fields fit f32 exactly (< 2^24)."""
    return torch.cat([torch.ravel(x).to(torch.float32) for x in arrs]
                     + [torch.zeros(1, dtype=torch.float32,
                                    device=arrs.leaf_value.device)])


def unpack_tree_arrays(vec: np.ndarray, L: int) -> TreeArrays:
    sizes = [L - 1] * 8 + [L] * 3 + [1]
    dts = ([np.int32, np.int32, bool, np.int32, np.int32, np.float32,
            np.float32, np.float32, np.float32, np.float32, np.int32,
            np.int32])
    out, off = [], 0
    for sz, dt in zip(sizes, dts):
        part = vec[off:off + sz]
        out.append(part.astype(dt) if dt != bool else part > 0.5)
        off += sz
    out[-1] = out[-1][0]
    return TreeArrays(*out)


def tree_arrays_to_host(arrs, dataset: Dataset, max_leaves: int) -> Tree:
    """Rehydrate the host Tree (real feature ids + real-valued thresholds
    via the BinMappers) from TreeArrays — device tensors (fetched in one
    transfer) or an already-unpacked numpy TreeArrays."""
    if isinstance(arrs.num_leaves, torch.Tensor):
        a = unpack_tree_arrays(pack_tree_arrays(arrs).cpu().numpy(),
                               max_leaves)
    else:
        a = arrs
    n = int(a.num_leaves)
    t = Tree(max_leaves)
    t.num_leaves = n
    if n < 2:
        t.leaf_value[0] = float(a.leaf_value[0])
        return t
    k = n - 1
    t.split_feature_inner[:k] = a.split_feature[:k]
    t.threshold_in_bin[:k] = a.threshold_bin[:k]
    t.decision_type[:k] = np.where(a.is_cat[:k], CATEGORICAL_DECISION,
                                   NUMERICAL_DECISION)
    t.has_categorical = bool(a.is_cat[:k].any())
    t.left_child[:k] = a.left_child[:k]
    t.right_child[:k] = a.right_child[:k]
    t.split_gain[:k] = a.split_gain[:k]
    t.internal_value[:k] = a.internal_value[:k]
    t.internal_count[:k] = np.round(a.internal_count[:k]).astype(np.int64)
    t.leaf_value[:n] = a.leaf_value[:n]
    t.leaf_count[:n] = np.round(a.leaf_count[:n]).astype(np.int64)
    t.leaf_depth[:n] = a.leaf_depth[:n]
    for node in range(k):
        real = dataset.inner_to_real(int(t.split_feature_inner[node]))
        t.split_feature[node] = real
        t.threshold[node] = dataset.mappers[real].bin_to_value(
            int(t.threshold_in_bin[node]))
    return t


def create_tree_learner(dataset: Dataset, config: Config):
    """Factory (reference tree_learner.cpp:9-33).  This slice has the
    batched-rounds learner on one device: tree_learner=serial with
    tree_growth auto or rounds resolves to it on every device."""
    lt = getattr(config, "tree_learner", "serial")
    growth = getattr(config, "tree_growth", "auto")
    if lt != "serial":
        raise NotImplementedError(
            f"tree_learner={lt} is not ported yet; this slice runs the "
            "single-device rounds learner (ROADMAP.md §A item 12)")
    if growth == "exact":
        raise NotImplementedError(
            "tree_growth=exact is not ported yet; this slice runs the "
            "rounds learner (ROADMAP.md §A item 10)")
    from .rounds import RoundsTreeLearner
    return RoundsTreeLearner(dataset, config)
