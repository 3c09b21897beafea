"""The port's training C ABI (csrc/native/c_api_train.cpp →
liblgbt_train_torch, over lightgbm_tpu_torch/capi.py) and its build of the
inference ABI (src/native/c_api.cpp in liblgbt_native_torch), on the CPU.

These mirror tests/test_c_api_train.py with device_type=cpu: each drives
the library through ctypes from this process (whose interpreter it then
shares) and holds it bitwise against the port's own Python path on the
same data and parameters, and at model level (predictions within 1e-5,
both packages on the rounds learner) against the JAX package's Python
path.  LGBM_BoosterRefit on PREDICT_LEAF leaves is bitwise
online.refit.refit_gbdt(leaf_idx=) from Python.  The inference ABI holds
Booster.predict at tests/test_c_api.py's tolerance.  The libraries build
here with g++ (native.py); only where g++ is missing do these skip.
"""
import ctypes
import json
import sys

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import native

c_double_p = ctypes.POINTER(ctypes.c_double)
PARAMS = (b"objective=binary metric=binary_logloss,auc num_leaves=15 "
          b"learning_rate=0.2 min_data_in_leaf=5 verbose=-1 "
          b"min_sum_hessian_in_leaf=1e-3 tree_growth=rounds "
          b"hist_rows=gathered device_type=cpu")
PY_PARAMS = {"objective": "binary", "metric": ["binary_logloss", "auc"],
             "num_leaves": 15, "learning_rate": 0.2, "min_data_in_leaf": 5,
             "verbose": -1, "min_sum_hessian_in_leaf": 1e-3,
             "tree_growth": "rounds", "hist_rows": "gathered"}
PORT_PARAMS = dict(PY_PARAMS, device_type="cpu")


@pytest.fixture(scope="module")
def lib():
    if native.compiler() is None:
        pytest.skip("no C++ compiler (g++) to build liblgbt_train_torch")
    return native.train_lib()


def check(rc, lib):
    assert rc == 0, lib.LGBM_GetLastError().decode()


def synth(n=400, f=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float64)
    return X, y


def _dataset_from_mat(lib, X, y, params=PARAMS, reference=None):
    Xc = np.ascontiguousarray(X, np.float64)
    h = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromMat(
        Xc.ctypes.data_as(ctypes.c_void_p), 1, ctypes.c_int32(X.shape[0]),
        ctypes.c_int32(X.shape[1]), 1, params, reference,
        ctypes.byref(h)), lib)
    if y is not None:
        lab = np.ascontiguousarray(y, np.float32)
        check(lib.LGBM_DatasetSetField(
            h, b"label", lab.ctypes.data_as(ctypes.c_void_p),
            len(lab), 0), lib)
    return h


def _train(lib, ds, iters=10, params=PARAMS):
    bst = ctypes.c_void_p()
    check(lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)), lib)
    fin = ctypes.c_int()
    for _ in range(iters):
        check(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)), lib)
    return bst


def _predict_mat(lib, bst, X, predict_type=0, num_iteration=-1):
    Xc = np.ascontiguousarray(X, np.float64)
    n = ctypes.c_int64()
    check(lib.LGBM_BoosterCalcNumPredict(
        bst, X.shape[0], predict_type, num_iteration, ctypes.byref(n)), lib)
    out = np.empty(n.value, np.float64)
    got = ctypes.c_int64()
    check(lib.LGBM_BoosterPredictForMat(
        bst, Xc.ctypes.data_as(ctypes.c_void_p), 1,
        ctypes.c_int32(X.shape[0]), ctypes.c_int32(X.shape[1]), 1,
        predict_type, num_iteration, ctypes.byref(got),
        out.ctypes.data_as(c_double_p)), lib)
    assert got.value == n.value
    return out


def _model_string(lib, bst):
    ln = ctypes.c_int()
    check(lib.LGBM_BoosterSaveModelToString(
        bst, -1, 0, ctypes.byref(ln), None), lib)
    buf = ctypes.create_string_buffer(ln.value)
    check(lib.LGBM_BoosterSaveModelToString(
        bst, -1, ln.value, ctypes.byref(ln), buf), lib)
    return buf.value.decode()


def _port_booster(X, y, iters, **kw):
    bst = lt.Booster(dict(PORT_PARAMS, **kw), lt.Dataset(X, y, **{
        k: v for k, v in kw.items() if k == "weight"}))
    for _ in range(iters):
        bst.update()
    return bst


def test_train_matches_python_path(lib, tmp_path):
    X, y = synth()
    ds = _dataset_from_mat(lib, X, y)
    n = ctypes.c_int()
    check(lib.LGBM_DatasetGetNumData(ds, ctypes.byref(n)), lib)
    assert n.value == len(X)
    check(lib.LGBM_DatasetGetNumFeature(ds, ctypes.byref(n)), lib)
    assert n.value == X.shape[1]

    bst = _train(lib, ds, iters=10)
    it = ctypes.c_int()
    check(lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)), lib)
    assert it.value == 10
    check(lib.LGBM_BoosterGetNumClasses(bst, ctypes.byref(it)), lib)
    assert it.value == 1
    preds = _predict_mat(lib, bst, X)

    # the port's Python path: the same model, bitwise
    pb = _port_booster(X, y, 10)
    assert _model_string(lib, bst) == pb.model_to_string()
    assert np.array_equal(preds, pb.predict(X))
    # the JAX package's Python path: the same model at model level
    jb = lgb.Booster(PY_PARAMS, lgb.Dataset(X, y))
    for _ in range(10):
        jb.update()
    np.testing.assert_allclose(preds, jb.predict(X), rtol=0, atol=1e-5)

    # leaf-index sizing: CalcNumPredict equals what PredictForMat writes
    leaf = _predict_mat(lib, bst, X[:50], predict_type=2, num_iteration=5)
    assert leaf.size % 50 == 0 and leaf.size >= 50 * 5

    # save to a file and load it again through the C API
    mf = str(tmp_path / "m.txt").encode()
    check(lib.LGBM_BoosterSaveModel(bst, -1, mf), lib)
    out_iters = ctypes.c_int()
    bst2 = ctypes.c_void_p()
    check(lib.LGBM_BoosterCreateFromModelfile(
        mf, ctypes.byref(out_iters), ctypes.byref(bst2)), lib)
    assert out_iters.value == 10
    assert np.array_equal(_predict_mat(lib, bst2, X), preds)
    # PredictForFile writes Booster.predict(path)'s values
    data = tmp_path / "d.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    res = tmp_path / "r.txt"
    check(lib.LGBM_BoosterPredictForFile(
        bst, str(data).encode(), 0, 0, -1, str(res).encode()), lib)
    np.testing.assert_allclose(np.loadtxt(res), pb.predict(str(data)),
                               rtol=1e-5)

    check(lib.LGBM_BoosterFree(bst), lib)
    check(lib.LGBM_BoosterFree(bst2), lib)
    check(lib.LGBM_DatasetFree(ds), lib)


def test_eval_and_valid_data(lib):
    X, y = synth(seed=5)
    Xv, yv = synth(n=200, seed=8)
    ds = _dataset_from_mat(lib, X, y)
    dv = _dataset_from_mat(lib, Xv, yv, reference=ds)
    bst = ctypes.c_void_p()
    check(lib.LGBM_BoosterCreate(ds, PARAMS, ctypes.byref(bst)), lib)
    check(lib.LGBM_BoosterAddValidData(bst, dv), lib)
    fin = ctypes.c_int()
    for _ in range(5):
        check(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)), lib)

    cnt = ctypes.c_int()
    check(lib.LGBM_BoosterGetEvalCounts(bst, ctypes.byref(cnt)), lib)
    assert cnt.value == 2
    bufs = [ctypes.create_string_buffer(256) for _ in range(cnt.value)]
    arr = (ctypes.c_char_p * cnt.value)(
        *[ctypes.cast(b, ctypes.c_char_p) for b in bufs])
    check(lib.LGBM_BoosterGetEvalNames(bst, ctypes.byref(cnt), arr), lib)
    assert [arr[i].decode() for i in range(cnt.value)] == \
        ["binary_logloss", "auc"]

    pb = lt.Booster(PORT_PARAMS, lt.Dataset(X, y))
    pv = lt.Dataset(Xv, yv, reference=pb.train_set)
    pb.add_valid(pv, "valid_0")
    for _ in range(5):
        pb.update()
    ref = {0: [v for _, _, v, _ in pb.eval_train()],
           1: [v for _, _, v, _ in pb.eval_valid()]}
    for idx in (0, 1):
        vals = np.empty(cnt.value, np.float64)
        check(lib.LGBM_BoosterGetEval(
            bst, idx, ctypes.byref(cnt), vals.ctypes.data_as(c_double_p)),
            lib)
        assert vals.tolist() == ref[idx]
    assert ref[0][1] > 0.7

    n = ctypes.c_int64()
    check(lib.LGBM_BoosterGetNumPredict(bst, 1, ctypes.byref(n)), lib)
    assert n.value == len(Xv)
    inner = np.empty(n.value, np.float64)
    check(lib.LGBM_BoosterGetPredict(
        bst, 1, ctypes.byref(n), inner.ctypes.data_as(c_double_p)), lib)
    assert np.array_equal(
        inner, pb._gbdt.valid_sets[0][2].get().reshape(-1))
    # device-f32 inner scores against the f64 walk
    np.testing.assert_allclose(inner, _predict_mat(lib, bst, Xv, 1),
                               rtol=1e-5, atol=1e-5)
    check(lib.LGBM_BoosterFree(bst), lib)
    check(lib.LGBM_DatasetFree(dv), lib)
    check(lib.LGBM_DatasetFree(ds), lib)


def test_push_rows_matches_from_mat(lib):
    """CreateFromSampledColumn + chunked PushRows grows the model of the
    one-shot dataset when the sample covers every row."""
    X, y = synth(n=300)
    cols = [np.ascontiguousarray(X[:, j]) for j in range(X.shape[1])]
    col_ptrs = (ctypes.POINTER(ctypes.c_double) * len(cols))(
        *[c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for c in cols])
    idx = np.arange(len(X), dtype=np.int32)
    idx_ptrs = (ctypes.POINTER(ctypes.c_int32) * len(cols))(
        *[idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))] * len(cols))
    per_col = (ctypes.c_int * len(cols))(*[len(X)] * len(cols))
    h = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromSampledColumn(
        col_ptrs, idx_ptrs, ctypes.c_int32(len(cols)), per_col,
        ctypes.c_int32(len(X)), ctypes.c_int32(len(X)), PARAMS,
        ctypes.byref(h)), lib)
    for start in range(0, len(X), 100):
        chunk = np.ascontiguousarray(X[start:start + 100], np.float64)
        check(lib.LGBM_DatasetPushRows(
            h, chunk.ctypes.data_as(ctypes.c_void_p), 1,
            ctypes.c_int32(len(chunk)), ctypes.c_int32(X.shape[1]),
            ctypes.c_int32(start)), lib)
    lab = np.ascontiguousarray(y, np.float32)
    check(lib.LGBM_DatasetSetField(
        h, b"label", lab.ctypes.data_as(ctypes.c_void_p), len(lab), 0), lib)
    ds = _dataset_from_mat(lib, X, y)
    b1 = _train(lib, h, iters=5)
    b2 = _train(lib, ds, iters=5)
    assert np.array_equal(_predict_mat(lib, b1, X), _predict_mat(lib, b2, X))
    for handle in (b1, b2):
        check(lib.LGBM_BoosterFree(handle), lib)
    check(lib.LGBM_DatasetFree(h), lib)
    check(lib.LGBM_DatasetFree(ds), lib)


def test_csr_matches_dense(lib):
    sparse = pytest.importorskip("scipy.sparse")
    X, y = synth(n=250)
    X[np.abs(X) < 0.4] = 0.0
    sp = sparse.csr_matrix(X)
    indptr = sp.indptr.astype(np.int32)
    indices = sp.indices.astype(np.int32)
    data = sp.data.astype(np.float64)
    h = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromCSR(
        indptr.ctypes.data_as(ctypes.c_void_p), 2,
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p), 1,
        ctypes.c_int64(len(indptr)), ctypes.c_int64(len(data)),
        ctypes.c_int64(X.shape[1]), PARAMS, None, ctypes.byref(h)), lib)
    lab = np.ascontiguousarray(y, np.float32)
    check(lib.LGBM_DatasetSetField(
        h, b"label", lab.ctypes.data_as(ctypes.c_void_p), len(lab), 0), lib)
    ds = _dataset_from_mat(lib, X, y)
    b1 = _train(lib, h, iters=5)
    b2 = _train(lib, ds, iters=5)
    p1 = _predict_mat(lib, b1, X)
    assert np.array_equal(p1, _predict_mat(lib, b2, X))
    # CSR prediction walks densified row slabs: the dense answers
    out = np.empty(len(X), np.float64)
    n = ctypes.c_int64()
    check(lib.LGBM_BoosterPredictForCSR(
        b1, indptr.ctypes.data_as(ctypes.c_void_p), 2,
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p), 1,
        ctypes.c_int64(len(indptr)), ctypes.c_int64(len(data)),
        ctypes.c_int64(X.shape[1]), 0, -1, ctypes.byref(n),
        out.ctypes.data_as(c_double_p)), lib)
    assert n.value == len(X) and np.array_equal(out, p1)
    for handle in (b1, b2):
        check(lib.LGBM_BoosterFree(handle), lib)
    check(lib.LGBM_DatasetFree(h), lib)
    check(lib.LGBM_DatasetFree(ds), lib)


def test_custom_objective_and_field_roundtrip(lib):
    X, y = synth(n=200)
    ds = _dataset_from_mat(lib, X, y)
    w = np.linspace(0.5, 1.5, len(X)).astype(np.float32)
    check(lib.LGBM_DatasetSetField(
        ds, b"weight", w.ctypes.data_as(ctypes.c_void_p), len(w), 0), lib)
    out_ptr, out_len, out_type = (ctypes.c_void_p(), ctypes.c_int(),
                                  ctypes.c_int())
    check(lib.LGBM_DatasetGetField(
        ds, b"weight", ctypes.byref(out_len), ctypes.byref(out_ptr),
        ctypes.byref(out_type)), lib)
    assert out_len.value == len(w) and out_type.value == 0
    got = np.ctypeslib.as_array(
        ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_float)),
        shape=(out_len.value,))
    assert np.array_equal(got, w)

    # logistic gradients fed through UpdateOneIterCustom, and the same
    # gradients through the port's Booster.update(fobj=): bitwise
    params = PARAMS + b" boost_from_average=false"
    bst = ctypes.c_void_p()
    check(lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)), lib)
    fin = ctypes.c_int()
    yv = y.astype(np.float64)
    n64 = ctypes.c_int64()

    def grads(raw):
        p = 1.0 / (1.0 + np.exp(-raw))
        return ((p - yv) * w).astype(np.float32), \
            (p * (1 - p) * w).astype(np.float32)

    for _ in range(5):
        raw = np.empty(len(X), np.float64)
        check(lib.LGBM_BoosterGetPredict(
            bst, 0, ctypes.byref(n64), raw.ctypes.data_as(c_double_p)), lib)
        g, h = grads(raw)
        check(lib.LGBM_BoosterUpdateOneIterCustom(
            bst, g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(fin)), lib)
    pb = lt.Booster(dict(PORT_PARAMS, boost_from_average=False),
                    lt.Dataset(X, y, weight=w))
    for _ in range(5):
        pb.update(fobj=lambda raw, _ds: grads(np.asarray(raw, np.float64)))
    assert _model_string(lib, bst) == pb.model_to_string()
    # the built-in objective of the JAX package: the same trees, leaf
    # values to f32 round-off (f64-derived gradients rounded to f32)
    jb = lgb.Booster(dict(PY_PARAMS, boost_from_average=False),
                     lgb.Dataset(X, y, weight=w))
    for _ in range(5):
        jb.update()
    np.testing.assert_allclose(_predict_mat(lib, bst, X, predict_type=1),
                               jb.predict(X, raw_score=True),
                               rtol=1e-3, atol=1e-4)
    check(lib.LGBM_BoosterFree(bst), lib)
    check(lib.LGBM_DatasetFree(ds), lib)


def test_leaf_value_rollback_and_subset(lib):
    X, y = synth(n=200)
    ds = _dataset_from_mat(lib, X, y)
    bst = _train(lib, ds, iters=3)
    v = ctypes.c_double()
    check(lib.LGBM_BoosterGetLeafValue(bst, 0, 0, ctypes.byref(v)), lib)
    before = _predict_mat(lib, bst, X, predict_type=1)
    check(lib.LGBM_BoosterSetLeafValue(
        bst, 0, 0, ctypes.c_double(v.value + 0.25)), lib)
    v2 = ctypes.c_double()
    check(lib.LGBM_BoosterGetLeafValue(bst, 0, 0, ctypes.byref(v2)), lib)
    assert abs(v2.value - v.value - 0.25) < 1e-12
    # the edited leaf moves the raw predictions by exactly 0.25
    after = _predict_mat(lib, bst, X, predict_type=1)
    moved = np.abs(after - before) > 0
    assert moved.any()
    np.testing.assert_allclose((after - before)[moved], 0.25, atol=1e-12)

    it = ctypes.c_int()
    check(lib.LGBM_BoosterRollbackOneIter(bst), lib)
    check(lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)), lib)
    assert it.value == 2

    idx = np.arange(0, 100, dtype=np.int32)
    sub = ctypes.c_void_p()
    check(lib.LGBM_DatasetGetSubset(
        ds, idx.ctypes.data_as(ctypes.c_void_p), len(idx), b"",
        ctypes.byref(sub)), lib)
    n = ctypes.c_int()
    check(lib.LGBM_DatasetGetNumData(sub, ctypes.byref(n)), lib)
    assert n.value == 100
    # the subset trains as the port's dataset of those rows
    b_sub = _train(lib, sub, iters=2)
    pb = lt.Booster(PORT_PARAMS, lt.Dataset(X[:100], y[:100],
                                            reference=lt.Dataset(X, y)))
    for _ in range(2):
        pb.update()
    assert _model_string(lib, b_sub) == pb.model_to_string()
    check(lib.LGBM_BoosterFree(b_sub), lib)
    check(lib.LGBM_BoosterFree(bst), lib)
    check(lib.LGBM_DatasetFree(sub), lib)
    check(lib.LGBM_DatasetFree(ds), lib)


def test_feature_names_and_error_path(lib):
    X, y = synth(n=120)
    ds = _dataset_from_mat(lib, X, y)
    names = [f"feat_{i}".encode() for i in range(X.shape[1])]
    arr = (ctypes.c_char_p * len(names))(*names)
    check(lib.LGBM_DatasetSetFeatureNames(ds, arr, len(names)), lib)
    bufs = [ctypes.create_string_buffer(256) for _ in range(len(names))]
    out = (ctypes.c_char_p * len(names))(
        *[ctypes.cast(b, ctypes.c_char_p) for b in bufs])
    n = ctypes.c_int()
    check(lib.LGBM_DatasetGetFeatureNames(ds, out, ctypes.byref(n)), lib)
    assert [out[i].decode() for i in range(n.value)] == \
        [nm.decode() for nm in names]
    assert lib.LGBM_DatasetSetField(ds, b"nonsense", None, 0, 0) == -1
    assert b"nonsense" in lib.LGBM_GetLastError()
    check(lib.LGBM_DatasetFree(ds), lib)


def test_refit_on_predicted_leaves(lib):
    """LGBM_BoosterRefit on the PREDICT_LEAF leaves of new rows: bitwise
    refit_gbdt(leaf_idx=) from Python on the same model and rows."""
    from lightgbm_tpu_torch.online.refit import refit_gbdt
    X, y = synth(n=400)
    bst = _train(lib, _dataset_from_mat(lib, X, y), iters=6)
    text = _model_string(lib, bst)
    Xn, _ = synth(n=300, seed=11)
    yn = 1.0 - (Xn[:, 0] > 0)
    params = PARAMS + b" refit_decay_rate=0.5"
    dn = _dataset_from_mat(lib, Xn, yn, params=params)
    rb = ctypes.c_void_p()
    check(lib.LGBM_BoosterCreate(dn, params, ctypes.byref(rb)), lib)
    check(lib.LGBM_BoosterMerge(rb, bst), lib)
    leaf = _predict_mat(lib, rb, Xn, predict_type=2).astype(np.int32)
    ncol = leaf.size // len(Xn)
    check(lib.LGBM_BoosterRefit(
        rb, leaf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(len(Xn)), ctypes.c_int32(ncol)), lib)
    refit = lt.Booster(model_str=_model_string(lib, rb),
                       params={"device_type": "cpu"})

    ref = lt.Booster(dict(PORT_PARAMS, refit_decay_rate=0.5),
                     model_str=text)
    inner = lt.Dataset(Xn, yn, params=PORT_PARAMS).construct()._inner
    refit_gbdt(ref._gbdt, inner,
               leaf_idx=ref._gbdt.predict_leaf_index(Xn))
    assert refit.num_trees() == ref.num_trees() == 6
    for a, b in zip(refit._gbdt.models, ref._gbdt.models):
        assert np.array_equal(a.leaf_value[:a.num_leaves],
                              b.leaf_value[:b.num_leaves])
    check(lib.LGBM_BoosterFree(rb), lib)
    check(lib.LGBM_BoosterFree(bst), lib)


def test_dump_model_and_no_jax_package_in_a_fresh_process(lib, tmp_path):
    X, y = synth(n=200)
    bst = _train(lib, _dataset_from_mat(lib, X, y), iters=2)
    ln = ctypes.c_int()
    buf = ctypes.create_string_buffer(1 << 20)
    check(lib.LGBM_BoosterDumpModel(bst, -1, 1 << 20, ctypes.byref(ln),
                                    buf), lib)
    dumped = json.loads(buf.value.decode())
    assert len(dumped["tree_info"]) == 2
    assert dumped["tree_info"][1]["num_leaves"] > 1
    check(lib.LGBM_BoosterFree(bst), lib)
    # loaded into a process that never imported the JAX package, the
    # library trains through lightgbm_tpu_torch.capi alone
    import subprocess
    code = f"""
import ctypes, sys
import numpy as np
lib = ctypes.CDLL({str(native.train_lib_path())!r})
X = np.random.RandomState(0).randn(200, 4); X = np.ascontiguousarray(X)
h = ctypes.c_void_p()
assert lib.LGBM_DatasetCreateFromMat(X.ctypes.data_as(ctypes.c_void_p), 1,
    200, 4, 1, b"verbose=-1 device_type=cpu", None, ctypes.byref(h)) == 0
lab = np.ascontiguousarray((X[:, 0] > 0).astype(np.float32))
assert lib.LGBM_DatasetSetField(h, b"label",
    lab.ctypes.data_as(ctypes.c_void_p), 200, 0) == 0
b = ctypes.c_void_p(); fin = ctypes.c_int()
assert lib.LGBM_BoosterCreate(h, b"verbose=-1 device_type=cpu",
                              ctypes.byref(b)) == 0
assert lib.LGBM_BoosterUpdateOneIter(b, ctypes.byref(fin)) == 0
print(sorted(m for m in sys.modules if m == "jax" or m == "lightgbm_tpu"
             or m.startswith(("jax.", "lightgbm_tpu."))))
"""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _inference_lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler (g++) to build liblgbt_native_torch")
    lib.LGBM_BoosterCreateFromModelfile.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.LGBM_BoosterFree.argtypes = [ctypes.c_void_p]
    lib.LGBM_BoosterPredictForMat.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    return lib


@pytest.mark.parametrize("objective,classes", [("binary", 2),
                                               ("regression", 0),
                                               ("multiclass", 3)])
def test_inference_abi_matches_booster_predict(tmp_path, objective,
                                               classes):
    """The port-built inference ABI (no Python) scores a model saved by
    the port as Booster.predict does, at rtol 1e-12."""
    lib = _inference_lib()
    rng = np.random.RandomState(11)
    X = rng.randn(400, 6)
    y = ((X[:, 0] > 0) * 1.0 if classes == 2 else
         np.digitize(X[:, 0], [-0.5, 0.5]) * 1.0 if classes == 3 else
         X[:, 0] + 0.1 * rng.randn(400))
    params = {"objective": objective, "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5, "device_type": "cpu"}
    if classes == 3:
        params["num_class"] = 3
    bst = lt.train(params, lt.Dataset(X, y), 5)
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    h, iters = ctypes.c_void_p(), ctypes.c_int()
    assert lib.LGBM_BoosterCreateFromModelfile(
        path.encode(), ctypes.byref(iters), ctypes.byref(h)) == 0
    k = max(classes, 1) if classes != 2 else 1
    for ptype, ref in ((0, bst.predict(X)),
                       (1, bst.predict(X, raw_score=True))):
        out = np.empty(len(X) * k, np.float64)
        n = ctypes.c_int64()
        assert lib.LGBM_BoosterPredictForMat(
            h, np.ascontiguousarray(X).ctypes.data_as(ctypes.c_void_p), 1,
            len(X), X.shape[1], 1, ptype, -1, ctypes.byref(n), out) == 0
        np.testing.assert_allclose(out.reshape(np.shape(ref)), ref,
                                   rtol=1e-12, atol=0)
    lib.LGBM_BoosterFree(h)


def test_kernel_build_leaves_the_abi_source_alone():
    """The nvcc build of kernels.py compiles csrc/*.cu and hashes them
    with csrc/*.cuh; the C ABI's source under csrc/native/ is g++'s and
    enters neither."""
    from lightgbm_tpu_torch import kernels
    assert native.TRAIN_SOURCE.parent.parent == kernels.CSRC
    assert native.TRAIN_SOURCE.name not in {
        p.name for p in kernels.CSRC.glob("*")}
    assert all((kernels.CSRC / f"{s}.cu").exists() for s in kernels.SOURCES)
    assert not any(s.startswith("c_api") for s in kernels.SOURCES)
