"""Carry models trained by the JAX package into the port.

Two routes: the JAX package's per-tree arrays as numpy dicts (the
`Tree` fields, lightgbm_tpu/tree.py) through `trees_from_numpy`, and the
LightGBM text model — the interchange format both packages write —
through `booster_from_model_string`.  Either way the port's host walk
predicts exactly what the JAX package's host walk predicts.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .basic import Booster
from .tree import Tree

# Tree fields carried across, as the JAX package names them
TREE_FIELDS = ("left_child", "right_child", "split_feature_inner",
               "split_feature", "threshold_in_bin", "threshold",
               "decision_type", "split_gain", "leaf_parent", "leaf_value",
               "leaf_count", "internal_value", "internal_count",
               "leaf_depth")


def trees_from_numpy(trees: Sequence[Dict[str, object]]) -> List[Tree]:
    """Port Trees from dicts holding every name of TREE_FIELDS as a numpy
    array plus the scalars max_leaves, num_leaves, shrinkage and
    has_categorical.  Arrays are copied with the port's dtypes."""
    out = []
    for d in trees:
        t = Tree(int(d["max_leaves"]))
        t.num_leaves = int(d["num_leaves"])
        t.shrinkage = float(d["shrinkage"])
        t.has_categorical = bool(d["has_categorical"])
        for name in TREE_FIELDS:
            dst = getattr(t, name)
            src = np.asarray(d[name])
            if src.shape != dst.shape:
                raise ValueError(f"tree field {name}: shape {src.shape}, "
                                 f"expected {dst.shape}")
            setattr(t, name, src.astype(dst.dtype, copy=True))
        out.append(t)
    return out


def booster_from_model_string(s: str, device: str = "cuda") -> Booster:
    """A Booster holding the model of a LightGBM text model string."""
    return Booster(params={"device_type": device}, model_str=s)
