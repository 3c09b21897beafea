"""Python side of the training C ABI (csrc/native/c_api_train.cpp).

Port of lightgbm_tpu/capi.py.  The reference exposes its training
workflow through ~50 ``LGBM_*`` C functions (include/LightGBM/c_api.h);
here the compute path is PyTorch on the GPU, so the native training ABI
hosts the Python runtime (CPython embedding) and this module is the
marshaling boundary: every function takes raw pointer ADDRESSES plus
shape/dtype metadata, wraps them as numpy arrays via ctypes (zero-copy
views; copies only where the data must outlive the call), and delegates
to the package's own Dataset/Booster objects.  The C++ layer stays a
thin shell that never touches array memory itself.

Handles held by C callers are ordinary Python objects (`CApiDataset`,
`CApiBooster`) kept alive by the C layer's reference counts.  The
library is built by native.train_lib (``liblgbt_train_torch``); the
inference-only ABI (src/native/c_api.cpp) stays dependency-free.
"""
from __future__ import annotations

import ctypes
import json
from typing import List, Optional

import numpy as np
import torch

from .basic import Booster as _PyBooster, Dataset as _PyDataset
from .binning import CATEGORICAL, NUMERICAL, find_bin
from .config import apply_aliases, config_from_params
from .dataset import Dataset as _InnerDataset, Metadata

# reference c_api.h:20-28 dtype / predict-type codes
_DTYPE = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}
PREDICT_NORMAL, PREDICT_RAW, PREDICT_LEAF = 0, 1, 2


def _view(addr: int, count: int, type_code: int) -> np.ndarray:
    """Zero-copy numpy view of `count` elements at raw address `addr`."""
    dt = _DTYPE[int(type_code)]
    if count == 0:
        return np.empty(0, dt)
    ct = {np.float32: ctypes.c_float, np.float64: ctypes.c_double,
          np.int32: ctypes.c_int32, np.int64: ctypes.c_int64}[dt]
    buf = (ct * int(count)).from_address(int(addr))
    return np.ctypeslib.as_array(buf)


def _params_from_string(parameters: str) -> dict:
    """Parse the reference's 'key1=value1 key2=value2' parameter format
    (c_api.h LGBM_BoosterCreate doc; application.cpp:46-70 tokens)."""
    out: dict = {}
    for tok in (parameters or "").replace("\n", " ").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _categorical_from_params(params: dict) -> List[int]:
    res = apply_aliases(dict(params))
    spec = str(res.get("categorical_feature", "") or "")
    cols: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if part.isdigit() or (part.startswith("-") and part[1:].isdigit()):
            cols.append(int(part))
    return cols


class CApiDataset:
    """Dataset handle: either fully constructed, or an empty push-mode
    shell (CreateByReference / CreateFromSampledColumn) that finalizes
    once rows [0, num_total_row) have all been pushed — the reference's
    FinishLoad contract (c_api.h LGBM_DatasetPushRows doc)."""

    def __init__(self, inner: Optional[_InnerDataset], params: dict,
                 reference: Optional["CApiDataset"] = None):
        self.inner = inner
        self.params = dict(params)
        self.reference = reference
        self._pushed = 0
        self._finished = inner is not None
        self._field_cache: dict = {}    # keeps GetField views alive

    # -- push-mode construction ---------------------------------------------

    @classmethod
    def empty_like(cls, reference: "CApiDataset", num_total_row: int
                   ) -> "CApiDataset":
        ref = reference.require_finished()
        cfg = config_from_params(reference.params)
        inner = _InnerDataset._empty_from_mappers(
            cfg, ref.mappers, list(ref.used_features), int(num_total_row),
            ref.num_total_features, list(ref.feature_names),
            plan=ref.bundle_plan)
        ds = cls(None, reference.params, reference)
        ds.inner = inner
        return ds

    @classmethod
    def from_sampled_column(cls, col_addrs, idx_addrs, num_per_col,
                            num_sample_row: int, num_total_row: int,
                            params: dict) -> "CApiDataset":
        """LGBM_DatasetCreateFromSampledColumn: per-column sampled
        non-zero values build the bin mappers (the exact FindBin input,
        bin.cpp:67-240); the store is then filled by PushRows."""
        cfg = config_from_params(params)
        cats = set(_categorical_from_params(params))
        mappers = []
        for j, (addr, cnt) in enumerate(zip(col_addrs, num_per_col)):
            vals = _view(addr, cnt, 1).astype(np.float64, copy=True)
            vals = vals[(vals != 0.0) & ~np.isnan(vals)]
            bt = CATEGORICAL if j in cats else NUMERICAL
            mappers.append(find_bin(vals, int(num_sample_row), cfg.max_bin,
                                    cfg.min_data_in_bin,
                                    cfg.min_data_in_leaf, bt))
        used = [i for i, m in enumerate(mappers) if not m.is_trivial]
        inner = _InnerDataset._empty_from_mappers(
            cfg, mappers, used, int(num_total_row), len(mappers), None)
        ds = cls(None, params)
        ds.inner = inner
        return ds

    def push_rows(self, X: np.ndarray, start_row: int) -> None:
        if self._finished:
            raise RuntimeError("cannot push rows into a finished Dataset")
        self.inner._bin_rows_into(np.ascontiguousarray(X, np.float64),
                                  int(start_row))
        self._pushed += len(X)
        if int(start_row) + len(X) >= self.inner.num_data:
            self._finish_load()

    def _finish_load(self) -> None:
        md = self.inner.metadata
        if md.label.size == 0:
            md.label = np.zeros(self.inner.num_data, np.float32)
        self._finished = True

    def require_finished(self) -> _InnerDataset:
        if not self._finished:
            raise RuntimeError(
                f"Dataset is still loading: {self._pushed} of "
                f"{self.inner.num_data} rows pushed")
        return self.inner

    # -- fields (c_api.h LGBM_DatasetSetField/GetField) ----------------------

    def set_field(self, name: str, addr: int, count: int,
                  type_code: int) -> None:
        data = _view(addr, count, type_code)
        md = self.inner.metadata
        name = name.lower()
        if name == "label":
            md.label = np.asarray(data, np.float32).copy()
        elif name == "weight":
            md.weights = (np.asarray(data, np.float32).copy()
                          if count else None)
        elif name == "init_score":
            md.init_score = (np.asarray(data, np.float64).copy()
                             if count else None)
        elif name in ("group", "query", "group_id", "query_id"):
            sizes = np.asarray(data, np.int64)
            md.set_query_from_sizes(sizes.copy())
        else:
            raise ValueError(f"unknown field name: {name}")
        self._field_cache.pop(name, None)

    def get_field(self, name: str):
        """Returns (addr, len, type_code) of the field's storage; the
        array is cached on the handle so the pointer stays valid until
        the next SetField/Free (the reference hands out internal
        metadata pointers with the same lifetime)."""
        md = self.require_finished().metadata
        name = name.lower()
        if name == "label":
            arr, code = np.asarray(md.label, np.float32), 0
        elif name == "weight":
            if md.weights is None:
                return 0, 0, 0
            arr, code = np.asarray(md.weights, np.float32), 0
        elif name == "init_score":
            if md.init_score is None:
                return 0, 0, 1
            arr, code = np.asarray(md.init_score, np.float64), 1
        elif name in ("group", "query", "group_id", "query_id"):
            qb = md.query_boundaries
            if qb is None:
                return 0, 0, 2
            arr, code = np.asarray(qb, np.int32), 2
        else:
            raise ValueError(f"unknown field name: {name}")
        arr = np.ascontiguousarray(arr)
        self._field_cache[name] = arr
        return arr.ctypes.data, arr.size, code


# -- dataset creation entry points -------------------------------------------

def dataset_from_file(filename: str, parameters: str,
                      reference: Optional[CApiDataset]) -> CApiDataset:
    params = _params_from_string(parameters)
    cfg = config_from_params(params)
    ref_inner = reference.require_finished() if reference else None
    inner = _InnerDataset.from_file(filename, cfg, reference=ref_inner)
    return CApiDataset(inner, params)


def _mat_view(addr: int, type_code: int, nrow: int, ncol: int,
              is_row_major: int) -> np.ndarray:
    flat = _view(addr, int(nrow) * int(ncol), type_code)
    if is_row_major:
        return flat.reshape(int(nrow), int(ncol))
    return flat.reshape(int(ncol), int(nrow)).T


def dataset_from_mat(addr: int, type_code: int, nrow: int, ncol: int,
                     is_row_major: int, parameters: str,
                     reference: Optional[CApiDataset]) -> CApiDataset:
    params = _params_from_string(parameters)
    cfg = config_from_params(params)
    X = _mat_view(addr, type_code, nrow, ncol, is_row_major)
    ref_inner = reference.require_finished() if reference else None
    inner = _InnerDataset(
        np.asarray(X, np.float64), None, cfg, reference=ref_inner,
        categorical_feature=_categorical_from_params(params))
    return CApiDataset(inner, params)


def _dense_from_csr(indptr, indices, data, num_col: int) -> np.ndarray:
    """Densify a whole CSR matrix (dataset-construction entries, whose
    downstream binner wants the full matrix anyway).  The PREDICT paths
    never call this — they densify bounded row chunks via
    `_csr_row_chunks` so a 10^6-row sparse predict peaks at one
    chunk's dense bytes, not the whole matrix."""
    nrow = indptr.size - 1
    X = np.zeros((nrow, int(num_col)), np.float64)
    row = np.repeat(np.arange(nrow), np.diff(indptr).astype(np.int64))
    X[row, indices[: data.size]] = data
    return X


def _predict_densify_chunk(num_col: int = 1) -> int:
    """Row-slab size of the predict-path densify: the device predict
    chunk cap, additionally BYTE-capped by the column count (a
    262144-row float64 slab at 50k features would be ~105 GB — the
    wide-sparse shape this path exists for).  ~256 MB per slab; the
    device loop re-chunks rows internally, so a smaller slab costs
    nothing."""
    from .boosting.gbdt import GBDT
    byte_cap = int(256e6) // max(int(num_col) * 8, 1)
    return max(1024, min(int(GBDT._PREDICT_CHUNK), byte_cap))


def _csr_row_chunks(indptr, indices, data, num_col: int, chunk: int):
    """Yield dense [<=chunk, num_col] float64 row slabs of a CSR
    matrix; peak memory is one slab + the sparse arrays."""
    nrow = indptr.size - 1
    for r0 in range(0, nrow, chunk):
        r1 = min(nrow, r0 + chunk)
        s, e = int(indptr[r0]), int(indptr[r1])
        Xc = np.zeros((r1 - r0, int(num_col)), np.float64)
        rows = np.repeat(np.arange(r0, r1),
                         np.diff(indptr[r0:r1 + 1]).astype(np.int64)) - r0
        Xc[rows, indices[s:e]] = data[s:e]
        yield Xc


def _csc_to_csr_arrays(col_ptr, indices, data, num_row: int):
    """CSC → CSR index arrays (one nnz-sized stable sort, no dense
    matrix) so the CSC predict path can reuse `_csr_row_chunks`."""
    ncol = col_ptr.size - 1
    cols = np.repeat(np.arange(ncol), np.diff(col_ptr).astype(np.int64))
    rows = np.asarray(indices[: data.size])
    order = np.argsort(rows, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(
        np.bincount(rows, minlength=int(num_row)))]).astype(np.int64)
    return indptr, cols[order], np.asarray(data)[order]


def _dense_from_csc(col_ptr, indices, data, num_row: int) -> np.ndarray:
    ncol = col_ptr.size - 1
    X = np.zeros((int(num_row), ncol), np.float64)
    col = np.repeat(np.arange(ncol), np.diff(col_ptr).astype(np.int64))
    X[indices[: data.size], col] = data
    return X


def dataset_from_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                     data_type, nindptr, nelem, num_col, parameters,
                     reference: Optional[CApiDataset]) -> CApiDataset:
    indptr = _view(indptr_addr, nindptr, indptr_type).astype(np.int64)
    indices = _view(indices_addr, nelem, 2)
    data = _view(data_addr, nelem, data_type).astype(np.float64)
    X = _dense_from_csr(indptr, indices, data, num_col)
    params = _params_from_string(parameters)
    ref_inner = reference.require_finished() if reference else None
    inner = _InnerDataset(X, None, config_from_params(params),
                          reference=ref_inner,
                          categorical_feature=_categorical_from_params(params))
    return CApiDataset(inner, params)


def dataset_from_csc(col_ptr_addr, col_ptr_type, indices_addr, data_addr,
                     data_type, ncol_ptr, nelem, num_row, parameters,
                     reference: Optional[CApiDataset]) -> CApiDataset:
    col_ptr = _view(col_ptr_addr, ncol_ptr, col_ptr_type).astype(np.int64)
    indices = _view(indices_addr, nelem, 2)
    data = _view(data_addr, nelem, data_type).astype(np.float64)
    X = _dense_from_csc(col_ptr, indices, data, num_row)
    params = _params_from_string(parameters)
    ref_inner = reference.require_finished() if reference else None
    inner = _InnerDataset(X, None, config_from_params(params),
                          reference=ref_inner,
                          categorical_feature=_categorical_from_params(params))
    return CApiDataset(inner, params)


def dataset_push_rows(ds: CApiDataset, addr: int, type_code: int,
                      nrow: int, ncol: int, start_row: int) -> None:
    X = _mat_view(addr, type_code, nrow, ncol, 1)
    ds.push_rows(X, start_row)


def dataset_push_rows_csr(ds: CApiDataset, indptr_addr, indptr_type,
                          indices_addr, data_addr, data_type, nindptr,
                          nelem, num_col, start_row) -> None:
    indptr = _view(indptr_addr, nindptr, indptr_type).astype(np.int64)
    indices = _view(indices_addr, nelem, 2)
    data = _view(data_addr, nelem, data_type).astype(np.float64)
    ds.push_rows(_dense_from_csr(indptr, indices, data, num_col), start_row)


def dataset_get_subset(ds: CApiDataset, idx_addr: int, num_idx: int,
                       parameters: str) -> CApiDataset:
    inner = ds.require_finished()
    idx = _view(idx_addr, num_idx, 2).astype(np.int64)
    params = dict(ds.params)
    params.update(_params_from_string(parameters))
    cfg = config_from_params(params)
    sub = _InnerDataset._empty_from_mappers(
        cfg, inner.mappers, list(inner.used_features), int(num_idx),
        inner.num_total_features, list(inner.feature_names),
        plan=inner.bundle_plan)
    sub._bins = np.ascontiguousarray(
        inner.dense_bins(site="capi_subset")[:, idx])
    # conflicts of the selected rows are not recoverable from the bundled
    # store; carry a proportional ESTIMATE so realized_conflict_rate()
    # stays in [0, 1] instead of inheriting the full dataset's count
    sub.bundle_conflict_rows = int(round(
        inner.bundle_conflict_rows * num_idx / max(inner.num_data, 1)))
    md = Metadata()
    md.label = np.asarray(inner.metadata.label, np.float32)[idx].copy()
    if inner.metadata.weights is not None:
        md.weights = np.asarray(inner.metadata.weights,
                                np.float32)[idx].copy()
    if inner.metadata.init_score is not None:
        md.init_score = np.asarray(inner.metadata.init_score,
                                   np.float64)[idx].copy()
    if inner.metadata.query_boundaries is not None:
        # carry ranking groups: map rows to query ids, then rebuild
        # boundaries from the subset's id runs.  Like the reference,
        # this assumes the indices keep each query's rows together
        # (CV folds subset whole queries).
        qb = inner.metadata.query_boundaries.astype(np.int64)
        qid = np.repeat(np.arange(len(qb) - 1), np.diff(qb))[idx]
        change = np.flatnonzero(np.diff(qid)) + 1
        sizes = np.diff(np.concatenate([[0], change, [qid.size]]))
        md.set_query_from_sizes(sizes)
    sub.metadata = md
    out = CApiDataset(sub, params)
    return out


# -- booster -----------------------------------------------------------------

class CApiBooster:
    """Booster handle: a thin shell over the package Booster plus the
    eval-result bookkeeping the C contract needs (GetEvalNames order is
    the order GetEval fills results in, c_api.h:465-480)."""

    def __init__(self, booster: _PyBooster,
                 train_ds: Optional[CApiDataset] = None):
        self.booster = booster
        self.train_ds = train_ds
        self.valid: List[CApiDataset] = []
        self._cache: dict = {}          # keeps returned buffers alive

    @classmethod
    def create(cls, train: CApiDataset, parameters: str) -> "CApiBooster":
        params = _params_from_string(parameters)
        shell = _wrap_inner(train.require_finished(), params)
        return cls(_PyBooster(params, shell), train)

    @classmethod
    def from_model_file(cls, filename: str) -> "CApiBooster":
        return cls(_PyBooster(model_file=filename))

    @classmethod
    def from_model_string(cls, model_str: str) -> "CApiBooster":
        return cls(_PyBooster(model_str=model_str))

    # -- training ------------------------------------------------------------

    def add_valid(self, ds: CApiDataset) -> None:
        shell = _wrap_inner(ds.require_finished(), self.booster.params)
        self.booster.add_valid(shell, f"valid_{len(self.valid)}")
        self.valid.append(ds)

    def update(self) -> bool:
        return bool(self.booster.update())

    def update_custom(self, grad_addr: int, hess_addr: int) -> bool:
        """Boost directly from caller gradients.  Booster.update(fobj=..)
        would first materialize the full score array for fobj — a
        device sync + K*N host copy the C caller (who already read
        scores via GetPredict) never looks at."""
        g = self.booster._gbdt
        n, k = int(g.num_data), int(g.K)
        grad = _view(grad_addr, n * k, 0).reshape(k, n)
        hess = _view(hess_addr, n * k, 0).reshape(k, n)
        return bool(g.train_one_iter(
            torch.as_tensor(np.array(grad), device=g.device),
            torch.as_tensor(np.array(hess), device=g.device), False))

    def reset_training_data(self, ds: CApiDataset) -> None:
        shell = _wrap_inner(ds.require_finished(), self.booster.params)
        self.booster._gbdt.reset_training_data(shell._inner)
        self.booster.train_set = shell
        self.train_ds = ds

    def merge(self, other: "CApiBooster") -> None:
        """Append the other booster's trees (reference GBDT::MergeFrom,
        gbdt.h: models are concatenated)."""
        g, og = self.booster._gbdt, other.booster._gbdt
        if not g.models:
            # the merged model leads: its average stump stays one
            g.boost_from_average_used = og.boost_from_average_used
        g.models.extend(og.models)
        g._models_changed()

    def refit(self, leaf_pred_addr: int, nrow: int, ncol: int) -> None:
        """LGBM_BoosterRefit: refit the handle's model IN PLACE on its
        training dataset's labels using caller-provided leaf
        predictions ([nrow, ncol] int32 — one column per model, the
        PredictForMat(PREDICT_LEAF) layout).  Delegates to the online
        refit kernel with the routing step skipped (c_api.h
        LGBM_BoosterRefit semantics; decay/min-rows come from the
        booster's ``refit_decay_rate`` / ``refit_min_rows`` params)."""
        if self.train_ds is None:
            raise RuntimeError("refit needs the training dataset on the "
                               "booster handle")
        from .online.refit import refit_gbdt
        leaf = _view(leaf_pred_addr, int(nrow) * int(ncol), 2).reshape(
            int(nrow), int(ncol)).copy()
        refit_gbdt(self.booster._gbdt, self.train_ds.require_finished(),
                   leaf_idx=leaf)

    # -- eval ----------------------------------------------------------------

    def eval_names(self) -> List[str]:
        """One metric object can yield several results (ndcg@1,3,5);
        Metric.result_names enumerates them without an eval pass —
        GetEvalCounts/GetEvalNames must stay cheap (the reference
        returns stored names, c_api.cpp GetEvalNames)."""
        g = self.booster._gbdt
        metrics = g.train_metrics or (
            g.valid_sets[0][3] if g.valid_sets else [])
        return [n for m in metrics for n in m.result_names()]

    def get_eval(self, data_idx: int) -> List[float]:
        g = self.booster._gbdt
        if data_idx == 0:
            return [v for _, _, v, _ in g.eval_train()]
        # evaluate ONLY the requested set — eval_valid() would run every
        # registered set per call (V sets polled per iteration -> V^2)
        name, _, su, ms = g.valid_sets[data_idx - 1]
        out: List = []
        g._eval_one_set(name, su, ms, out)
        return [v for _, _, v, _ in g._materialize(out)]

    def inner_predict_len(self, data_idx: int) -> int:
        """Length of GetPredict's result WITHOUT materializing it
        (GetNumPredict is a pure size query, c_api.h:487-494)."""
        g = self.booster._gbdt
        n = (int(g.num_data) if data_idx == 0
             else int(g.valid_sets[data_idx - 1][1].num_data))
        return n * int(g.K)

    def inner_predict(self, data_idx: int) -> np.ndarray:
        g = self.booster._gbdt
        if data_idx == 0:
            sc = g.train_score.get()
        else:
            sc = np.asarray(g.valid_sets[data_idx - 1][2].get())
        arr = np.ascontiguousarray(np.asarray(sc, np.float64).reshape(-1))
        self._cache[("inner", data_idx)] = arr
        return arr

    # -- prediction -----------------------------------------------------------

    def _predict(self, X: np.ndarray, predict_type: int,
                 num_iteration: int) -> np.ndarray:
        ni = int(num_iteration) if int(num_iteration) > 0 else -1
        out = self.booster.predict(
            X, num_iteration=ni,
            raw_score=(predict_type == PREDICT_RAW),
            pred_leaf=(predict_type == PREDICT_LEAF), is_reshape=False)
        return np.ascontiguousarray(np.asarray(out, np.float64).reshape(-1))

    def predict_for_mat(self, addr, type_code, nrow, ncol, is_row_major,
                        predict_type, num_iteration, out_addr) -> int:
        X = _mat_view(addr, type_code, nrow, ncol, is_row_major)
        res = self._predict(np.asarray(X, np.float64), predict_type,
                            num_iteration)
        _view(out_addr, res.size, 1)[:] = res
        return int(res.size)

    def _predict_sparse_chunks(self, indptr, indices, data, num_col,
                               predict_type, num_iteration,
                               out_addr) -> int:
        """Chunked dense predict over CSR arrays: each row slab is
        densified, scored, and written at its output offset — the full
        dense matrix never exists."""
        chunk = _predict_densify_chunk(num_col)
        total = 0
        for Xc in _csr_row_chunks(indptr, indices, data, num_col, chunk):
            res = self._predict(Xc, predict_type, num_iteration)
            _view(out_addr, total + res.size, 1)[total:] = res
            total += int(res.size)
        return total

    def predict_for_csr(self, indptr_addr, indptr_type, indices_addr,
                        data_addr, data_type, nindptr, nelem, num_col,
                        predict_type, num_iteration, out_addr) -> int:
        indptr = _view(indptr_addr, nindptr, indptr_type).astype(np.int64)
        indices = _view(indices_addr, nelem, 2)
        data = _view(data_addr, nelem, data_type).astype(np.float64)
        return self._predict_sparse_chunks(indptr, indices, data, num_col,
                                           predict_type, num_iteration,
                                           out_addr)

    def predict_for_csc(self, col_ptr_addr, col_ptr_type, indices_addr,
                        data_addr, data_type, ncol_ptr, nelem, num_row,
                        predict_type, num_iteration, out_addr) -> int:
        col_ptr = _view(col_ptr_addr, ncol_ptr, col_ptr_type).astype(np.int64)
        indices = _view(indices_addr, nelem, 2)
        data = _view(data_addr, nelem, data_type).astype(np.float64)
        num_col = col_ptr.size - 1
        indptr, cols, vals = _csc_to_csr_arrays(col_ptr, indices, data,
                                                num_row)
        return self._predict_sparse_chunks(indptr, cols, vals, num_col,
                                           predict_type, num_iteration,
                                           out_addr)

    def predict_for_file(self, data_filename: str, data_has_header: int,
                         predict_type: int, num_iteration: int,
                         result_filename: str) -> None:
        ni = int(num_iteration) if int(num_iteration) > 0 else -1
        preds = self.booster.predict(
            data_filename, num_iteration=ni,
            raw_score=(predict_type == PREDICT_RAW),
            pred_leaf=(predict_type == PREDICT_LEAF),
            data_has_header=bool(data_has_header), is_reshape=True)
        preds = np.asarray(preds)
        if preds.ndim == 1:
            preds = preds[:, None]
        with open(result_filename, "w") as fh:
            for row in preds:
                fh.write("\t".join(f"{v:g}" for v in row) + "\n")

    def calc_num_predict(self, num_row: int, predict_type: int,
                         num_iteration: int) -> int:
        g = self.booster._gbdt
        if predict_type == PREDICT_LEAF:
            # must agree with predict_leaf_index's model count (which
            # includes the boost_from_average init model) or the caller
            # under-allocates and PredictForMat writes past the buffer
            ni = int(num_iteration) if int(num_iteration) > 0 else -1
            return int(num_row) * int(g._num_used_models(ni))
        return int(num_row) * int(g.num_class)

    # -- model IO --------------------------------------------------------------

    def save_model(self, num_iteration: int, filename: str) -> None:
        ni = int(num_iteration) if int(num_iteration) > 0 else -1
        self.booster.save_model(filename, num_iteration=ni)

    def model_to_string(self, num_iteration: int) -> str:
        ni = int(num_iteration) if int(num_iteration) > 0 else -1
        return self.booster.model_to_string(num_iteration=ni)

    def dump_model(self, num_iteration: int) -> str:
        ni = int(num_iteration) if int(num_iteration) > 0 else -1
        return json.dumps(self.booster.dump_model(num_iteration=ni))

    def get_leaf_value(self, tree_idx: int, leaf_idx: int) -> float:
        t = self.booster._gbdt.models[int(tree_idx)]
        return float(t.leaf_value[int(leaf_idx)])

    def set_leaf_value(self, tree_idx: int, leaf_idx: int,
                       val: float) -> None:
        g = self.booster._gbdt
        t = g.models[int(tree_idx)]
        t.leaf_value[int(leaf_idx)] = float(val)
        t._device_cache = None
        g._models_changed()


def _wrap_inner(inner: _InnerDataset, params: dict) -> _PyDataset:
    """Wrap an already-constructed inner dataset in the package-level
    Dataset shell (skips re-binning: _inner is pre-set)."""
    shell = _PyDataset.__new__(_PyDataset)
    shell.params = dict(params)
    shell.data = None
    shell.label = None
    shell.reference = None
    shell.weight = shell.group = shell.init_score = None
    shell.feature_name = "auto"
    shell.categorical_feature = "auto"
    shell.free_raw_data = False
    shell.pandas_categorical = None
    shell._inner = inner
    shell._raw_X = None
    return shell
