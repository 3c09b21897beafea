"""The port's native bulk binner held against the JAX package's, on the
CPU.

`native.bin_numerical_native` (the port's ctypes binding of
`lgbt_bin_numerical` in src/native/loader.cpp) against
`lightgbm_tpu.native.bin_numerical_native` on NaN, +/-inf, -0.0, values
on the bounds and 16-, 255- and 256-bin mappers; `bin_rows_into` with
and without the library, with and without a bundle plan, against each
other and against the JAX package's store; `FeatureQuantizer.quantize`
through the native binner, through the NumPy grid and against the JAX
package's.  Bins are integers: every comparison is bitwise.  Both
packages' bindings load the library the port builds from
src/native/loader.cpp (the JAX package's own build of the same source
is not assumed to exist).
"""
import numpy as np
import pytest

import lightgbm_tpu.native as jn
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Dataset as JDataset
from lightgbm_tpu.quantize import FeatureQuantizer as JQuantizer

import lightgbm_tpu_torch.native as tn
from lightgbm_tpu_torch import quantize as tq
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import Dataset as TDataset
from lightgbm_tpu_torch.synth import synth_onehot


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's binding, loading the port's build of the same
    C source."""
    path = str(tn.loader_path())
    monkeypatch.setattr(jn, "_find_lib", lambda: path)
    monkeypatch.setattr(jn, "_LIB", None)
    monkeypatch.setattr(jn, "_TRIED", False)
    assert jn.get_lib() is not None
    return jn


def _awkward(n, f, seed):
    """Values with NaN, +/-inf, -0.0 and exact copies of bounds."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f) * 3
    X[rng.rand(n, f) < 0.03] = np.nan
    X[rng.rand(n, f) < 0.02] = np.inf
    X[rng.rand(n, f) < 0.02] = -np.inf
    X[rng.rand(n, f) < 0.03] = -0.0
    X[rng.rand(n, f) < 0.03] = 0.0
    return X


@pytest.mark.parametrize("nbins", [16, 255, 256])
def test_bin_numerical_native_matches_jax(jax_native, nbins):
    rng = np.random.RandomState(nbins)
    X = _awkward(5_000, 4, nbins)
    uppers = []
    for j in range(3):
        ub = np.sort(rng.randn(nbins - 1) * 3)
        ub[np.abs(ub).argmin()] = 0.0                 # a bound at zero
        uppers.append(np.append(ub, np.inf))
        X[:50, j + 1] = ub[rng.randint(0, nbins - 1, 50)]   # on the bounds
    cols = [3, 1, 2]
    got = tn.bin_numerical_native(X, cols, uppers)
    want = jn.bin_numerical_native(X, cols, uppers)
    assert got is not None and got.dtype == np.uint8
    assert got.shape == (3, 5_000)
    np.testing.assert_array_equal(got, want)
    # the NumPy search of value_to_bin: NaN as 0.0, side='left'
    for j, c in enumerate(cols):
        v = np.where(np.isnan(X[:, c]), 0.0, X[:, c])
        np.testing.assert_array_equal(
            got[j], np.searchsorted(uppers[j], v, side="left"))
    # more than 256 bins: no native bins, as in the JAX package
    wide = [np.append(np.sort(rng.randn(300)), np.inf)]
    assert tn.bin_numerical_native(X, [0], wide) is None
    assert jn.bin_numerical_native(X, [0], wide) is None


@pytest.mark.parametrize("case", ["plain", "bundled", "conflicts"])
def test_bin_rows_into_native_matches_numpy_and_jax(jax_native, monkeypatch,
                                                    case):
    """Dataset stores binned through the native binner, through NumPy
    alone, and by the JAX package (native), bitwise, conflicts too."""
    rng = np.random.RandomState(3)
    if case == "plain":
        X = _awkward(3_000, 6, 5)
        extra = {}
    else:
        Xs, _ = synth_onehot(3_000, groups=8, card=5, seed=6)
        if case == "conflicts":
            rows = rng.choice(3_000, 40, replace=False)
            Xs[rows, rng.randint(0, 40, size=40)] = 1.0
        X = np.concatenate([_awkward(3_000, 4, 7), Xs], axis=1)
        extra = {"max_conflict_rate": 0.05} if case == "conflicts" else {}
    y = (rng.rand(3_000) > 0.5).astype(np.float64)
    p = dict(extra, sparse_store="dense", verbose=-1)
    before = dict(tn.BINNED)
    dt = TDataset(X, y, t_config(dict(p, device_type="cpu")))
    n_num = sum(1 for k in range(dt.num_features)
                if dt.bundle_plan is None or not dt.bundle_plan.feat_packed[k])
    assert tn.BINNED["native"] - before["native"] == n_num > 0
    dj = JDataset(X, y, j_config(p))
    assert (dt.bundle_plan is None) == (case == "plain")
    np.testing.assert_array_equal(dt.bins, dj.bins)
    assert dt.bundle_conflict_rows == dj.bundle_conflict_rows
    assert (dt.bundle_conflict_rows > 0) == (case == "conflicts")
    # the same rows binned again into a fresh store, native and NumPy
    stores = []
    for lib in (True, False):
        if not lib:
            monkeypatch.setattr(tn, "get_lib", lambda: None)
        store = np.zeros_like(dt.bins)
        conflicts = tq.bin_rows_into(X, dt.mappers, dt.used_features,
                                     dt.bundle_plan, store, 0)
        stores.append((store, conflicts))
    np.testing.assert_array_equal(stores[0][0], dt.bins)
    np.testing.assert_array_equal(stores[1][0], dt.bins)
    assert stores[0][1] == stores[1][1] == dt.bundle_conflict_rows
    # a valid set through its reference's mappers and plan
    Xv = X[:700] * 1.5
    vt = TDataset(Xv, y[:700], dt.config, reference=dt)
    vj = JDataset(Xv, y[:700], dj.config, reference=dj)
    np.testing.assert_array_equal(vt.bins, vj.bins)


def test_bin_rows_into_takes_numpy_past_uint8(jax_native):
    """A store of more than 256 bins is uint16: no native binning there,
    as in the JAX package, and the same bins."""
    X = _awkward(4_000, 3, 9)
    y = np.zeros(4_000)
    p = {"max_bin": 1000, "sparse_store": "dense", "verbose": -1}
    before = dict(tn.BINNED)
    dt = TDataset(X, y, t_config(dict(p, device_type="cpu")))
    assert dt.bins.dtype == np.uint16
    assert tn.BINNED["native"] == before["native"]
    np.testing.assert_array_equal(dt.bins, JDataset(X, y, j_config(p)).bins)


@pytest.mark.parametrize("max_bin", [15, 255])
def test_feature_quantizer_native_matches_grid_and_jax(jax_native,
                                                       monkeypatch, max_bin):
    X = _awkward(3_000, 5, 11)
    X[:, 4] = np.random.RandomState(2).randint(0, 6, 3_000)
    y = np.zeros(3_000)
    p = {"max_bin": max_bin, "sparse_store": "dense", "verbose": -1}
    dt = TDataset(X, y, t_config(dict(p, device_type="cpu")),
                  categorical_feature=[4])
    dj = JDataset(X, y, j_config(p), categorical_feature=[4])
    assert dt.mappers[4].bin_type == 1
    q = _awkward(2_000, 5, 12)
    q[:, 4] = np.random.RandomState(3).randint(-1, 8, 2_000)
    q[:30, 0] = dt.mappers[dt.used_features[0]].bin_upper_bound[0]
    tq_native = tq.FeatureQuantizer(dt.mappers, dt.used_features)
    assert tq_native._use_native
    before = dict(tn.BINNED)
    got = tq_native.quantize(q)
    assert tn.BINNED["native"] - before["native"] == 4
    want = JQuantizer(dj.mappers, dj.used_features).quantize(q)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(tn, "get_lib", lambda: None)
    tq_grid = tq.FeatureQuantizer(dt.mappers, dt.used_features)
    assert not tq_grid._use_native
    np.testing.assert_array_equal(tq_grid.quantize(q), got)
    # NaN takes the MISSING sentinel, not the bin of 0.0
    assert (got[np.isnan(q[:, 0]), 0] == tq_native.missing_bin).all()
