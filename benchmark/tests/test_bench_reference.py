"""The plain reference at tiny sizes: bin finding, the tree walk, the
best split of every node, the objective and the metric against hand
counts and brute force."""
import math

import numpy as np
import pytest
import torch

from benchmark.reference import binning, check, metrics, objectives
from benchmark.reference.trees import Tree, leaf_sums, walk


def test_bounds_few_distinct_values():
    # fewer distinct values than bins: a boundary between each pair that
    # holds min_data_in_bin samples
    v = np.array([1.0] * 5 + [2.0] * 5 + [4.0] * 5)
    ub = binning.find_bounds(v, 15, 255, 3, 1)
    assert ub.tolist() == [1.5, 3.0, math.inf]


def test_bounds_zero_counted_from_the_sample():
    # 10 sampled rows, 4 non-zero: zero holds the other 6
    v = np.array([-1.0, -1.0, 3.0, 3.0])
    vals, counts = binning.distinct(v, 10)
    assert vals.tolist() == [-1.0, 0.0, 3.0]
    assert counts.tolist() == [2, 6, 2]
    assert binning.find_bounds(v, 10, 255, 1, 1).tolist() == [-0.5, 1.5,
                                                              math.inf]


def test_bounds_greedy_count_balanced():
    v = np.arange(1, 101, dtype=np.float64)
    ub = binning.find_bounds(v, 100, 4, 3, 1)
    # 100 distinct values into 4 bins of 25 samples each
    assert ub.tolist() == [25.5, 50.5, 75.5, math.inf]


def test_bounds_unusable_feature():
    assert binning.find_bounds(np.array([5.0] * 10), 10, 255, 3, 1) is None
    # a split would leave under min_split_data on one side
    v = np.array([1.0] * 9 + [2.0])
    assert binning.find_bounds(v, 10, 255, 1, 2) is None


def test_sample_rows():
    assert binning.sample_rows(5, 10, 1).tolist() == [0, 1, 2, 3, 4]
    r = binning.sample_rows(1000, 100, 1)
    assert len(r) == 100 and np.all(np.diff(r) > 0)
    assert r.tolist() == np.sort(
        np.random.RandomState(1).choice(1000, 100, replace=False)).tolist()


def _tree():
    # root: x0 <= 0.5 ? node 1 : leaf 2;  node 1: x1 <= 0 ? leaf 0 : leaf 1
    return Tree(num_leaves=3, split_feature=np.array([0, 1]),
                threshold=np.array([0.5, 0.0]),
                decision_type=np.array([0, 0]),
                left_child=np.array([1, -1]), right_child=np.array([-3, -2]),
                split_gain=np.array([2.0, 1.0]),
                leaf_value=np.array([1.0, 2.0, 3.0]),
                leaf_count=np.array([1, 1, 2]),
                internal_count=np.array([4, 2]), shrinkage=0.1)


def test_walk_and_sums():
    X = torch.tensor([[0.0, -1.0], [0.5, 1.0], [0.6, 0.0], [9.0, -3.0]],
                     dtype=torch.float64)
    t = _tree()
    vals = torch.tensor([[1.0], [2.0], [3.0], [4.0]], dtype=torch.float64)
    leaf, node = walk(t, X, {0: 0, 1: 1}, vals)
    assert leaf.tolist() == [0, 1, 2, 2]
    assert node[:, 0].tolist() == [10.0, 3.0]
    assert leaf_sums(t, leaf, vals)[:, 0].tolist() == [1.0, 2.0, 7.0]


def test_walk_zero_missing_goes_default_way():
    t = _tree()
    t.decision_type = np.array([(1 << 2) | 2, 0])   # zero missing, left
    X = torch.tensor([[0.0, 1.0], [0.7, 0.0]], dtype=torch.float64)
    # row 0: x0 == 0 goes left by default; then x1 = 1 > 0: leaf 1
    assert walk(t, X, {0: 0, 1: 1}).tolist() == [1, 2]


def test_binary_gradients():
    s = torch.tensor([0.0, 1.0, -2.0], dtype=torch.float64)
    y = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float64)
    g, h = objectives.binary(s, y)
    p = torch.sigmoid(s)
    assert torch.allclose(g, p - y)
    assert torch.allclose(h, p * (1 - p))


def test_auc_with_ties_against_pairs():
    rng = np.random.RandomState(0)
    s = np.round(rng.randn(60), 1)
    y = (rng.rand(60) > 0.5).astype(np.float64)
    pos, neg = s[y > 0], s[y == 0]
    want = np.mean([(a > b) + 0.5 * (a == b) for a in pos for b in neg])
    got = metrics.auc(torch.as_tensor(s), torch.as_tensor(y))
    assert got == pytest.approx(want, abs=1e-12)


def _brute_best(codes, vals, rows, n_bins, min_data, min_hess):
    """The best gain at a node of `rows` by every threshold of every
    feature, one at a time."""
    g, h, c = (vals[rows, i].sum() for i in range(3))
    best = -math.inf
    for f in range(codes.shape[1]):
        for t in range(n_bins[f] - 1):
            lm = rows[codes[rows, f] <= t]
            rm = rows[codes[rows, f] > t]
            gl, hl, cl = (vals[lm, i].sum() for i in range(3))
            gr, hr, cr = g - gl, h - hl, c - cl
            if min(cl, cr) < min_data or min(hl, hr) < min_hess:
                continue
            best = max(best, gl ** 2 / hl + gr ** 2 / hr - g ** 2 / h)
    return best


def test_best_gains_against_brute_force():
    rng = np.random.RandomState(4)
    n = 400
    codes = np.stack([rng.randint(0, 5, n), rng.randint(0, 3, n),
                      np.zeros(n, np.int64)], 1)
    n_bins = [5, 3, 1]
    vals = np.stack([rng.randn(n), rng.rand(n) + 0.1, np.ones(n)], 1)
    t = _tree()
    # rows walked by their codes: the root on feature 0 at bin 1, node 1
    # on feature 1 at bin 0
    leaf = np.where(codes[:, 0] <= 1, np.where(codes[:, 1] <= 0, 0, 1), 2)
    params = {"min_data_in_leaf": 5, "min_sum_hessian_in_leaf": 1.0}
    got = check._best_gains(t, torch.as_tensor(codes), n_bins,
                            torch.as_tensor(leaf), torch.as_tensor(vals),
                            params)
    nodes = [np.arange(n), np.flatnonzero(codes[:, 0] <= 1)]
    want = [_brute_best(codes, vals, r, n_bins, 5, 1.0) for r in nodes]
    assert got == pytest.approx(want, rel=1e-12)


def test_split_gap():
    best = np.array([4.0, 2.0, -np.inf, 0.0])
    prog = np.array([4.0, 1.5, -1.0, 0.0])
    assert check._split_gap(best, prog) == pytest.approx(0.25)
    # rounding may put the program's split a hair above the best
    assert check._split_gap(np.array([1.0]), np.array([1.0 + 1e-15])) == 0.0
