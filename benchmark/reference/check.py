"""The comparison that decides `correct`: the program's outputs against
the plain reference, on the rows the run handed the program.

A boosting job's trees can only be followed from the program's own
state, since a split that ties to rounding may go either way: so the
reference takes each tree's structure and leaf values from the program,
and the scores from the sum of those leaf values as the program adds
them (in float32, a tree at a time).  Everything else it works out
itself, in float64, from the raw rows: the bin boundaries and codes, the
gradients, every node's rows, sums and gain, every leaf's value, the
best split of every node over every feature, the valid rows' scores and
the metric.

Numbers compared (each 0 when the program agrees exactly):
  bin_bounds    features whose boundaries differ (exact)
  bin_codes     train cells whose bin differs (exact)
  node_counts   largest |program - reference| rows at a node (exact)
  leaf_values   largest, over the trees, hessian-weighted norm of the
                leaf values' gap over that of the reference's values
  split_gains   largest gain gap over the tree's largest gain
  node_splits   largest, over every node of the followed trees, of the
                best split's gain less the gain of the program's split,
                over the best split's gain
  valid_scores  largest valid score gap over the median |score|
  valid_metric  largest gap of the reported metric
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import Split, columns
from . import binning, metrics, objectives
from .trees import Tree, leaf_sums, walk


@dataclass
class Outputs:
    """What the program produced, read once the window has closed: the
    trees of one boosting job (as its model text has them, in full
    precision), that job's valid metric at every iteration, its valid
    scores after the last one, its bin boundaries (None for a feature it
    does not use) and its [used features, rows] bin codes."""
    trees: List[Tree]
    evals: Dict[str, List[float]]
    valid_score: np.ndarray
    bounds: Dict[int, Optional[np.ndarray]]
    codes: np.ndarray
    code_features: List[int]


def _leaf_gap(prog: np.ndarray, ref: np.ndarray, hess: np.ndarray) -> float:
    """||prog - ref|| over ||ref||, each leaf weighted by its hessian sum:
    the second-order change of the training loss that the gap makes,
    against the tree's own.  A leaf of few rows, whose sums float32
    rounding moves most, weighs as little as it changes the loss."""
    den = float(np.sqrt(np.sum(hess * ref ** 2)))
    return float(np.sqrt(np.sum(hess * (prog - ref) ** 2))) / (den or 1.0)


def _gain_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    top = float(np.max(np.abs(ref))) if ref.size else 0.0
    return float(np.max(np.abs(prog - ref))) / top if top > 0 else 0.0


def reference_bounds(split: Split, feats: List[int], params: Dict
                     ) -> Dict[int, Optional[np.ndarray]]:
    """The reference's boundaries of `feats`, from the rows bin finding
    samples."""
    n = split.num_rows
    cnt = int(params.get("bin_construct_sample_cnt", 200000))
    rows = binning.sample_rows(n, cnt, int(params.get("data_random_seed",
                                                      1)))
    sample = split.X[rows]
    out = {}
    for f in feats:
        out[f] = binning.find_bounds(
            sample[:, f], len(rows), int(params.get("max_bin", 255)),
            int(params.get("min_data_in_bin", 3)),
            int(params.get("min_data_in_leaf", 20)))
    return out


def _split_gap(best: np.ndarray, prog: np.ndarray) -> float:
    """Largest (best gain - gain of the program's split) / best gain over
    the nodes that have a split with a positive gain."""
    ok = np.isfinite(best) & (best > 0)
    if not ok.any():
        return 0.0
    return float(max(0.0, np.max((best[ok] - prog[ok]) / best[ok])))


def _bounds_differ(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    if a is None or b is None:
        return (a is None) != (b is None)
    return a.shape != b.shape or not np.array_equal(a, b)


def _codes(ub: Optional[np.ndarray], x: torch.Tensor) -> torch.Tensor:
    if ub is None:
        return torch.zeros_like(x, dtype=torch.int64)
    return torch.searchsorted(torch.as_tensor(ub, device=x.device),
                              x.contiguous(), right=False)


def _best_gains(tree: Tree, codes: torch.Tensor, n_bins: List[int],
                leaf: torch.Tensor, vals: torch.Tensor,
                params: Dict) -> np.ndarray:
    """[num_splits] the largest gain of any threshold of any feature at
    each internal node, over the reference's bins (`codes` [n, F], a
    feature with no usable bins holding 0), under min_data_in_leaf and
    min_sum_hessian_in_leaf.  Each node's histogram is the sum of its
    leaves', in float64."""
    l2 = float(params.get("lambda_l2", 0.0))
    min_data = float(params.get("min_data_in_leaf", 20))
    min_hess = float(params.get("min_sum_hessian_in_leaf", 1e-3))
    F, B, L = codes.shape[1], max(max(n_bins), 2), tree.num_leaves
    dev = vals.device
    lh = torch.zeros(F, L * B, vals.shape[1], dtype=torch.float64,
                     device=dev)
    for j in range(F):
        lh[j].index_add_(0, leaf * B + codes[:, j], vals)
    lh = lh.view(F, L, B, -1).transpose(0, 1)
    node = torch.zeros(tree.num_splits, F, B, vals.shape[1],
                       dtype=torch.float64, device=dev)

    def total(c):
        if c < 0:
            return lh[~c]
        node[c] = total(tree.left_child[c]) + total(tree.right_child[c])
        return node[c]
    total(0)
    left = torch.cumsum(node, 2)[:, :, :-1]
    tot = node.sum(dim=2, keepdim=True)
    right = tot - left
    thr = (torch.arange(B - 1, device=dev)[None, :]
           < torch.as_tensor(n_bins, device=dev)[:, None] - 1)
    ok = (thr[None] & (left[..., 2] >= min_data) & (right[..., 2] >= min_data)
          & (left[..., 1] >= min_hess) & (right[..., 1] >= min_hess))
    gain = (left[..., 0] ** 2 / (left[..., 1] + l2)
            + right[..., 0] ** 2 / (right[..., 1] + l2)
            - tot[..., 0] ** 2 / (tot[..., 1] + l2))
    gain = torch.where(ok, gain, -torch.inf)
    return gain.flatten(1).amax(dim=1).cpu().numpy()


def _gains(tree: Tree, node: np.ndarray, lsum: np.ndarray,
           l2: float) -> np.ndarray:
    """Each split's gain from the sums at its node and its children."""
    def side(c):
        return node[c] if c >= 0 else lsum[~c]
    out = np.empty(tree.num_splits)
    for j in range(tree.num_splits):
        a, b = side(tree.left_child[j]), side(tree.right_child[j])
        out[j] = (a[0] ** 2 / (a[1] + l2) + b[0] ** 2 / (b[1] + l2)
                  - node[j, 0] ** 2 / (node[j, 1] + l2))
    return out


def _node_from_leaves(tree: Tree, lsum: np.ndarray) -> np.ndarray:
    """[num_splits, C] sums at each internal node from its leaves' sums."""
    node = np.zeros((tree.num_splits, lsum.shape[1]))

    def total(c):
        if c < 0:
            return lsum[~c]
        node[c] = total(tree.left_child[c]) + total(tree.right_child[c])
        return node[c]
    if tree.num_splits:
        total(0)
    return node


def compare(params: Dict, train: Split, valid: Split, out: Outputs,
            device: torch.device, checked_trees: int) -> Dict[str, float]:
    """The numbers compared, following the job's first `checked_trees`
    trees."""
    objective = params["objective"]
    metric = params["metric"]
    l2 = float(params.get("lambda_l2", 0.0))
    rate = float(params.get("learning_rate", 0.1))
    trees = out.trees
    k = min(checked_trees, len(trees))
    nums: Dict[str, float] = {}

    # the dataset: boundaries of every feature, and the store's codes
    feats = list(range(train.num_features))
    ref_ub = reference_bounds(train, feats, params)
    nums["bin_bounds"] = float(sum(_bounds_differ(out.bounds.get(f), ref_ub[f])
                                   for f in feats))
    cols = columns(train, feats, device)
    codes = torch.stack([_codes(ref_ub[f], cols[:, f]) for f in feats], 1)
    n_bins = [1 if ref_ub[f] is None else len(ref_ub[f]) for f in feats]
    bad = 0
    for i, f in enumerate(out.code_features):
        prog = torch.as_tensor(out.codes[i].astype(np.int64), device=device)
        bad += int((prog != codes[:, f]).sum())
    nums["bin_codes"] = float(bad)
    lut = {f: f for f in feats}

    # the first trees, followed from their structure
    y = torch.as_tensor(train.y, device=device)
    yv = torch.as_tensor(valid.y, device=device)
    vcols = columns(valid, feats, device)
    # the scores each tree's gradients and each reported metric come
    # from are the program's: its leaf values added in float32, one tree
    # at a time, as its score updater adds them
    score = torch.zeros(train.num_rows, dtype=torch.float32, device=device)
    vscore = torch.zeros(valid.num_rows, dtype=torch.float32, device=device)
    vscore64 = torch.zeros(valid.num_rows, dtype=torch.float64,
                           device=device)
    counts = leaves = gains = splits = metric_gap = 0.0
    ones = torch.ones(train.num_rows, dtype=torch.float64, device=device)
    for t, tree in enumerate(trees):
        vleaf = walk(tree, vcols, lut)
        lv = torch.as_tensor(tree.leaf_value[:max(tree.num_leaves, 1)],
                             device=device)
        vscore64 += lv[vleaf]
        vscore += lv.float()[vleaf]
        if t < k or t == len(trees) - 1:
            ref_m = metrics.evaluate(metric, vscore.double(), yv)
            for name, v in ref_m.items():
                metric_gap = max(metric_gap, abs(out.evals[name][t] - v))
        if t >= k:
            continue
        g, h = objectives.gradients(objective, score.double(), y, params)
        vals = torch.stack([g, h, ones], dim=1)
        leaf, node = walk(tree, cols, lut, vals)
        lsum = leaf_sums(tree, leaf, vals).cpu().numpy()
        node = node.cpu().numpy()
        counts = max(counts, float(np.abs(lsum[:, 2] - tree.leaf_count).max()))
        if tree.num_splits:
            counts = max(counts, float(np.abs(
                node[:, 2] - tree.internal_count[:tree.num_splits]).max()))
        ref_leaf = -lsum[:, 0] / (lsum[:, 1] + l2) * rate
        leaves = max(leaves, _leaf_gap(tree.leaf_value[:tree.num_leaves],
                                       ref_leaf, lsum[:, 1]))
        if tree.num_splits:
            ref_gain = _gains(tree, node, lsum, l2)
            gains = max(gains, _gain_gap(tree.split_gain[:tree.num_splits],
                                         ref_gain))
            best = _best_gains(tree, codes, n_bins, leaf, vals, params)
            splits = max(splits, _split_gap(best, ref_gain))
        score += lv.float()[leaf]

    # the valid rows' scores after the job's last tree, against the
    # program's leaf values summed in float64
    ref = vscore64.cpu().numpy()
    med = float(np.median(np.abs(ref))) or 1.0
    nums["node_counts"] = counts
    nums["leaf_values"] = leaves
    nums["split_gains"] = gains
    nums["node_splits"] = splits
    nums["valid_scores"] = float(np.max(np.abs(out.valid_score - ref)) / med)
    nums["valid_metric"] = float(metric_gap)
    return nums
