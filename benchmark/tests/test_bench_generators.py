"""The device data generators at small sizes on the CPU: shapes, the
same rows from the same seed, other rows from another, and a labelling
that does not depend on the seed."""
import numpy as np

from benchmark.data import columns
from benchmark.generators import higgs

HIGGS = {"rows": 3000, "valid_rows": 500, "features": 28, "rows_seed": 0}
BIG_SEED = 2 ** 31 + 12345


def test_higgs_shapes_and_seeds():
    tr, va = higgs.make(HIGGS, BIG_SEED, "cpu")
    assert tr.X.shape == (3000, 28) and va.X.shape == (500, 28)
    assert tr.X.dtype == np.float64 and set(np.unique(tr.y)) <= {0.0, 1.0}
    tr2, va2 = higgs.make(HIGGS, BIG_SEED, "cpu")
    assert np.array_equal(tr.X, tr2.X) and np.array_equal(va.y, va2.y)
    tr3, _ = higgs.make(HIGGS, BIG_SEED + 1, "cpu")
    assert not np.array_equal(tr.X, tr3.X)
    # another seed: the same rows in another order
    o1, o3 = np.lexsort(tr.X.T), np.lexsort(tr3.X.T)
    assert np.array_equal(tr.X[o1], tr3.X[o3])
    assert np.array_equal(tr.y[o1], tr3.y[o3])
    # the labelling function is fixed: roughly balanced on every seed
    assert 0.4 < tr.y.mean() < 0.6 and 0.4 < tr3.y.mean() < 0.6


def test_views():
    hg, _ = higgs.make(HIGGS, 5, "cpu")
    assert np.array_equal(columns(hg, [3, 1], "cpu").numpy(), hg.X[:, [3, 1]])
