"""Flat-array decision tree model.

Mirrors the reference Tree (LightGBM's include/LightGBM/tree.h:18-197,
src/io/tree.cpp): same node-index convention (internal nodes 0..n-2, leaves
referenced as ~leaf_index in child arrays), same Split() bookkeeping
(tree.cpp:52-97), same text serialization keys (tree.cpp:295-330) so model
files interoperate with LightGBM, same ±100 output clamp on Shrinkage
(tree.h:104-112).

The host owns the authoritative numpy arrays (they are mutated during
growth); `as_device_arrays` exports padded torch tensors on the Config's
device for the vectorized binned traversal (the analog of
AddPredictionToScore's BinIterator walk, tree.cpp:99-192).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

K_MAX_TREE_OUTPUT = 100.0  # reference tree.h kMaxTreeOutput

NUMERICAL_DECISION = 0
CATEGORICAL_DECISION = 1


def _arr_to_str(a, fmt="{:g}") -> str:
    return " ".join(fmt.format(x) for x in a)


class Tree:
    def __init__(self, max_leaves: int):
        self.max_leaves = max_leaves
        m = max_leaves
        self.num_leaves = 1
        self.left_child = np.zeros(m - 1, np.int32)
        self.right_child = np.zeros(m - 1, np.int32)
        self.split_feature_inner = np.zeros(m - 1, np.int32)
        self.split_feature = np.zeros(m - 1, np.int32)
        self.threshold_in_bin = np.zeros(m - 1, np.int64)
        self.threshold = np.zeros(m - 1, np.float64)
        self.decision_type = np.zeros(m - 1, np.int8)
        self.split_gain = np.zeros(m - 1, np.float64)
        self.leaf_parent = np.full(m, -1, np.int32)
        self.leaf_value = np.zeros(m, np.float64)
        self.leaf_count = np.zeros(m, np.int64)
        self.internal_value = np.zeros(m - 1, np.float64)
        self.internal_count = np.zeros(m - 1, np.int64)
        self.leaf_depth = np.zeros(m, np.int32)
        self.shrinkage = 1.0
        self.has_categorical = False
        self._device_cache = None

    # -- growth (reference tree.cpp:52-97) ---------------------------------

    def split(self, leaf: int, inner_feature: int, bin_type: int,
              threshold_bin: int, real_feature: int, threshold_double: float,
              left_value: float, right_value: float, left_cnt: int,
              right_cnt: int, gain: float) -> int:
        new_node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = inner_feature
        self.split_feature[new_node] = real_feature
        if bin_type == NUMERICAL_DECISION:
            self.decision_type[new_node] = 0
        else:
            self.decision_type[new_node] = 1
            self.has_categorical = True
        self.threshold_in_bin[new_node] = threshold_bin
        self.threshold[new_node] = threshold_double
        self.split_gain[new_node] = np.finfo(np.float64).max if np.isinf(gain) else gain
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~self.num_leaves
        self.leaf_parent[leaf] = new_node
        self.leaf_parent[self.num_leaves] = new_node
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_count[new_node] = left_cnt + right_cnt
        self.leaf_value[leaf] = 0.0 if np.isnan(left_value) else left_value
        self.leaf_count[leaf] = left_cnt
        self.leaf_value[self.num_leaves] = 0.0 if np.isnan(right_value) else right_value
        self.leaf_count[self.num_leaves] = right_cnt
        self.leaf_depth[self.num_leaves] = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] += 1
        self.num_leaves += 1
        self._device_cache = None
        return self.num_leaves - 1

    def apply_shrinkage(self, rate: float) -> None:
        lv = self.leaf_value[: self.num_leaves] * rate
        np.clip(lv, -K_MAX_TREE_OUTPUT, K_MAX_TREE_OUTPUT, out=lv)
        self.leaf_value[: self.num_leaves] = lv
        self.shrinkage *= rate
        self._device_cache = None

    def set_leaf_values(self, values: np.ndarray) -> None:
        """Replace the leaf values (a refit); the structure stays."""
        self.leaf_value[: self.num_leaves] = values[: self.num_leaves]
        self._device_cache = None

    @property
    def max_depth_grown(self) -> int:
        return int(self.leaf_depth[: self.num_leaves].max()) if self.num_leaves > 1 else 0

    # -- prediction on raw feature values (reference tree.h:217-241) -------

    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        """Vectorized node walk on raw feature values ([N, num_raw_features])."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.full(n, self.leaf_value[0])
        leaf = self.predict_leaf_index(X)
        return self.leaf_value[leaf]

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int32)
        active = node >= 0
        while np.any(active):
            f = self.split_feature[node[active]]
            v = X[active, f]
            thr = self.threshold[node[active]]
            dec = self.decision_type[node[active]]
            # non-finite values on a categorical split always go RIGHT
            # here, while training-time binning maps NaN to value 0
            # (binning.py value_to_bin), which can land in category 0's
            # bin — the reference has the same train/predict asymmetry
            # (its raw predict casts NaN with static_cast<int>, tree.h:
            # 217-241, never matching a category); we emulate it rather
            # than diverge from reference predictions on NaN rows
            finite = np.isfinite(v)
            vi = np.where(finite, v, -1.0).astype(np.int64)
            go_left = np.where(dec == 0, v <= thr,
                               finite & (vi == thr.astype(np.int64)))
            nxt = np.where(go_left, self.left_child[node[active]],
                           self.right_child[node[active]])
            node[active] = nxt
            active = node >= 0
        return (~node).astype(np.int32)

    # -- device export ------------------------------------------------------

    def as_device_arrays(self, device):
        """Padded tree arrays on `device` for the binned traversal
        (boosting/score_updater.py).  Child pointers: internal >= 0,
        leaves encoded as ~leaf (negative).  Cached per device until the
        tree changes."""
        device = torch.device(device)
        cache = self._device_cache
        if cache is None or cache["device"] != device:
            n = max(self.max_leaves - 1, 1)
            binned_dec = getattr(self, "binned_decision_type",
                                 self.decision_type)
            host = dict(
                split_feature_inner=self.split_feature_inner[:n],
                threshold_in_bin=self.threshold_in_bin[:n].astype(np.int32),
                decision_type=binned_dec[:n].astype(np.int32),
                left_child=self.left_child[:n],
                right_child=self.right_child[:n],
                leaf_value=self.leaf_value[: max(self.max_leaves, 1)
                                           ].astype(np.float32),
            )
            cache = {k: torch.as_tensor(np.ascontiguousarray(v),
                                        device=device)
                     for k, v in host.items()}
            cache["device"] = device
            cache["depth"] = max(self.max_depth_grown, 1)
            self._device_cache = cache
        return cache

    # -- serialization (reference tree.cpp:295-330) -------------------------

    def to_string(self) -> str:
        n = self.num_leaves
        lines = [
            f"num_leaves={n}",
            "split_feature=" + _arr_to_str(self.split_feature[: n - 1], "{:d}"),
            "split_gain=" + _arr_to_str(self.split_gain[: n - 1]),
            "threshold=" + _arr_to_str(self.threshold[: n - 1], "{:.17g}"),
            "decision_type=" + _arr_to_str(self.decision_type[: n - 1], "{:d}"),
            "left_child=" + _arr_to_str(self.left_child[: n - 1], "{:d}"),
            "right_child=" + _arr_to_str(self.right_child[: n - 1], "{:d}"),
            "leaf_parent=" + _arr_to_str(self.leaf_parent[:n], "{:d}"),
            "leaf_value=" + _arr_to_str(self.leaf_value[:n], "{:.17g}"),
            "leaf_count=" + _arr_to_str(self.leaf_count[:n], "{:d}"),
            "internal_value=" + _arr_to_str(self.internal_value[: n - 1]),
            "internal_count=" + _arr_to_str(self.internal_count[: n - 1], "{:d}"),
            f"shrinkage={self.shrinkage:g}",
            f"has_categorical={1 if self.has_categorical else 0}",
            "",
        ]
        return "\n".join(lines) + "\n"

    @staticmethod
    def from_string(s: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in s.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                if k.strip() and v.strip():
                    kv[k.strip()] = v.strip()
        if "num_leaves" not in kv:
            raise ValueError("Tree model string must contain num_leaves")
        n = int(kv["num_leaves"])
        t = Tree(max(n, 2))
        t.num_leaves = n
        if n <= 1:
            if "leaf_value" in kv:
                t.leaf_value[0] = float(kv["leaf_value"].split()[0])
            return t

        def ints(key):
            return np.array([int(x) for x in kv[key].split()])

        def floats(key):
            return np.array([float(x) for x in kv[key].split()])

        t.left_child[: n - 1] = ints("left_child")
        t.right_child[: n - 1] = ints("right_child")
        t.split_feature[: n - 1] = ints("split_feature")
        t.split_feature_inner[: n - 1] = t.split_feature[: n - 1]
        t.threshold[: n - 1] = floats("threshold")
        t.split_gain[: n - 1] = floats("split_gain")
        t.leaf_value[:n] = floats("leaf_value")
        if "decision_type" in kv:
            t.decision_type[: n - 1] = ints("decision_type").astype(np.int8)
            t.has_categorical = bool((t.decision_type[: n - 1] == 1).any())
        if "leaf_parent" in kv:
            t.leaf_parent[:n] = ints("leaf_parent")
        if "leaf_count" in kv:
            t.leaf_count[:n] = ints("leaf_count")
        if "internal_value" in kv:
            t.internal_value[: n - 1] = floats("internal_value")
        if "internal_count" in kv:
            t.internal_count[: n - 1] = ints("internal_count")
        if "shrinkage" in kv:
            t.shrinkage = float(kv["shrinkage"])
        # leaf_depth is not part of the model text — reconstruct it (the
        # binned traversal walks `max_depth_grown` levels)
        depth = np.zeros(n - 1, np.int32)
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            depth[node] = d
            for child in (t.left_child[node], t.right_child[node]):
                if child >= 0:
                    stack.append((int(child), d + 1))
                else:
                    t.leaf_depth[~child] = d + 1
        t.needs_rebin = True
        return t

    def rebin_to_dataset(self, dataset) -> None:
        """In-bin thresholds and inner feature indices for a tree loaded
        from model text, which stores only real feature ids and
        real-valued thresholds (tree.cpp:295+), before the binned walk
        replays it onto `dataset`.  Saved thresholds are bin upper bounds,
        so value_to_bin recovers the original bin exactly.

        Only loaded trees rebin (trees grown in this process carry in-bin
        data for the training mappers, which validation sets share); given
        another dataset, a loaded tree rebins again from its real-valued
        thresholds."""
        if not getattr(self, "needs_rebin", False):
            return
        if getattr(self, "_rebin_dataset", None) is dataset:
            return
        # the binned walk may need another decision op than the raw one
        # (the trivial-feature sentinels below); raw predict keeps
        # decision_type, the binned walk reads this override
        self.binned_decision_type = self.decision_type.copy()
        for node in range(self.num_leaves - 1):
            real = int(self.split_feature[node])
            inner = dataset.real_to_inner(real)
            mapper = dataset.mappers[real]
            if inner >= 0:
                self.split_feature_inner[node] = inner
                self.threshold_in_bin[node] = int(mapper.value_to_bin(
                    np.array([self.threshold[node]]))[0])
                self.binned_decision_type[node] = self.decision_type[node]
            else:
                # a feature filtered as trivial in this dataset: every row
                # has the same value, so the comparison has one outcome,
                # encoded as an always-left (huge bin) or always-right (-1)
                # numerical test on feature 0 (bins are never negative)
                c = mapper.bin_to_value(0)
                if self.decision_type[node] == CATEGORICAL_DECISION:
                    left = c == self.threshold[node]
                else:
                    left = c <= self.threshold[node]
                self.split_feature_inner[node] = 0
                self.threshold_in_bin[node] = (1 << 30) if left else -1
                self.binned_decision_type[node] = NUMERICAL_DECISION
        self._rebin_dataset = dataset
        self._device_cache = None

    def to_json(self) -> Dict:
        """Tree::ToJSON (tree.cpp:326-365), for Booster.dump_model."""
        def node_json(index: int) -> Dict:
            if index >= 0:
                return {
                    "split_index": int(index),
                    "split_feature": int(self.split_feature[index]),
                    "split_gain": float(self.split_gain[index]),
                    "threshold": float(self.threshold[index]),
                    # reference names (tree.h GetDecisionTypeName):
                    # numerical "no_greater", categorical "is"
                    "decision_type": ("is" if self.decision_type[index] == 1
                                      else "no_greater"),
                    "internal_value": float(self.internal_value[index]),
                    "internal_count": int(self.internal_count[index]),
                    "left_child": node_json(int(self.left_child[index])),
                    "right_child": node_json(int(self.right_child[index])),
                }
            leaf = ~index
            return {
                "leaf_index": int(leaf),
                "leaf_parent": int(self.leaf_parent[leaf]),
                "leaf_value": float(self.leaf_value[leaf]),
                "leaf_count": int(self.leaf_count[leaf]),
            }

        return {
            "num_leaves": int(self.num_leaves),
            "shrinkage": float(self.shrinkage),
            "has_categorical": 1 if self.has_categorical else 0,
            "tree_structure": node_json(0) if self.num_leaves > 1 else {
                "leaf_index": 0, "leaf_value": float(self.leaf_value[0]),
                "leaf_parent": -1, "leaf_count": int(self.leaf_count[0])},
        }
