"""Work counts against hand counts on small trees."""
import numpy as np
import pytest

from benchmark.reference.trees import Tree
from benchmark.work import counts

PEAKS = {"hbm_bytes_per_s": 1.0, "fp32_flops_per_s": 1.0}


def _tree():
    # root (10 rows) -> node 1 (6 rows) and leaf 2 (4 rows);
    # node 1 -> leaf 0 (1 row) and leaf 1 (5 rows)
    return Tree(num_leaves=3, split_feature=np.array([0, 1]),
                threshold=np.zeros(2), decision_type=np.zeros(2, np.int64),
                left_child=np.array([1, -1]), right_child=np.array([-3, -2]),
                split_gain=np.ones(2), leaf_value=np.zeros(3),
                leaf_count=np.array([1, 5, 4]),
                internal_count=np.array([10, 6]), shrinkage=0.1)


@pytest.mark.parametrize("values,width", [(2, 1), (63, 1), (255, 1),
                                          (256, 1), (257, 2), (50_000, 2),
                                          (65_536, 2), (65_537, 3)])
def test_least_bytes_by_hand(values, width):
    assert counts.least_bytes(values) == width


@pytest.mark.parametrize("max_bin,bin_bytes", [(4, 1), (255, 1), (1024, 2)])
def test_dense_histogram_by_hand(max_bin, bin_bytes):
    shape = counts.Shape(rows=10, valid_rows=3, features=2, max_bin=max_bin)
    w = counts.histogram(_tree(), shape)
    # rows histogrammed: 10 at the root, 4 (leaf 2 < node 1), 1 (leaf 0)
    rows = 10 + 4 + 1
    hist = 2 * max_bin * 2 * 4    # features x bins x (grad, hess) x f32
    assert w.bytes == rows * 2 * bin_bytes + rows * 8 + 3 * hist
    assert w.adds == 3 * rows * 2
    assert w.least_s(PEAKS) == max(w.bytes, w.adds)


def test_iteration_adds_the_rest():
    shape = counts.Shape(rows=10, valid_rows=3, features=2, max_bin=4)
    t = _tree()
    h = counts.histogram(t, shape)
    it = counts.iteration(t, shape)
    hist = 2 * 4 * 2 * 4
    # gradients, split search, partition (1-byte leaf ids of 3 leaves),
    # score updates of 13 rows (leaf id, score read and written), metric
    extra = 16 * 10 + 5 * hist + 1 * 10 + 9 * 13 + 8 * 3
    assert it.bytes == pytest.approx(h.bytes + extra)
    assert it.adds == h.adds


def test_single_leaf_tree():
    t = Tree(num_leaves=1, split_feature=np.zeros(0, np.int64),
             threshold=np.zeros(0), decision_type=np.zeros(0, np.int64),
             left_child=np.zeros(0, np.int64),
             right_child=np.zeros(0, np.int64), split_gain=np.zeros(0),
             leaf_value=np.zeros(1), leaf_count=np.array([10]),
             internal_count=np.zeros(0, np.int64), shrinkage=1.0)
    shape = counts.Shape(rows=10, valid_rows=0, features=1, max_bin=2)
    w = counts.histogram(t, shape)
    assert w.adds == 30
    assert w.bytes == 10 * 1 + 10 * 8 + 1 * (1 * 2 * 2 * 4)
