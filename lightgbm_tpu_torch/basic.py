"""User-facing Dataset / Booster API.

Port of lightgbm_tpu/basic.py (LightGBM's python-package basic.py): a
`Dataset` with lazy construction, reference alignment for validation
data, query groups, the label/weight/group/init-score setters, row
subsets (for `cv`) and pandas categoricals; a scipy sparse matrix goes to
`Dataset.from_csc`, so the dense [N, F] matrix never materializes.  A
`Booster` built through `create_boosting` (gbdt, goss or dart, from the
parameters or from a model's first line) with update (custom objectives
too), rollback, parameter resets, eval with custom metrics, prediction
(values, raw scores, leaf indices), the text model with its
pandas-categorical trailer, the JSON dump, feature importances and
pickling.  pandas is never imported here: a DataFrame is read through
its own methods.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .boosting.gbdt import create_boosting
from .config import config_from_params
from .dataset import Dataset as _InnerDataset, Metadata
from .log import LightGBMError  # noqa: F401  (canonical error type)


def _is_scipy_sparse(data) -> bool:
    try:
        import scipy.sparse as spm
    except ImportError:
        return False
    return spm.issparse(data)


def _to_numpy(data) -> np.ndarray:
    if hasattr(data, "values"):  # pandas DataFrame/Series
        return np.asarray(data.values, dtype=np.float64)
    return np.asarray(data, dtype=np.float64)


def _read_last_line(path: str) -> str:
    """The final line of a file, read backwards in 1 MB chunks (the
    pandas_categorical trailer is one line of any length)."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        pos = f.tell()
        buf = b""
        while pos > 0:
            step = min(1 << 20, pos)
            pos -= step
            f.seek(pos)
            buf = f.read(step) + buf
            stripped = buf.rstrip(b"\n")
            nl = stripped.rfind(b"\n")
            if nl >= 0:
                return stripped[nl + 1:].decode(errors="replace")
        return buf.rstrip(b"\n").decode(errors="replace")


def _load_pandas_categorical(model_tail: str):
    """The category lists of the `pandas_categorical:<json>` trailer that
    a save appends (as LightGBM's save_model does); `model_tail` may be
    just the end of the model text."""
    marker = "pandas_categorical:"
    pos = model_tail.rfind("\n" + marker)
    if pos < 0:
        if not model_tail.startswith(marker):
            return None
        pos = -1
    line = model_tail[pos + 1:].splitlines()[0]
    try:
        return json.loads(line[len(marker):])
    except json.JSONDecodeError:
        from . import log
        log.warning("model file has a corrupt pandas_categorical trailer; "
                    "categorical DataFrame prediction will be unavailable")
        return None


def _apply_pandas_categorical(data, pandas_categorical):
    """Map a prediction DataFrame's category columns onto the training
    category codes: category order may differ between frames, so codes
    are derived again from the training category lists; unseen
    categories map to -1, pandas' missing code."""
    if not (hasattr(data, "dtypes") and hasattr(data, "columns")):
        return data
    cat_cols = [c for c in data.columns
                if str(data[c].dtype) == "category"]
    if not cat_cols:
        return data
    if not pandas_categorical or len(cat_cols) != len(pandas_categorical):
        raise ValueError(
            "prediction data has pandas categorical columns but the "
            "model carries no matching training category lists")
    df = data.copy()
    for col, cats in zip(cat_cols, pandas_categorical):
        df[col] = df[col].cat.set_categories(cats).cat.codes.astype(
            np.float64)
    return df


def _resolve_categorical(data, categorical_feature, feature_name):
    """pandas categorical columns -> their codes, the categorical column
    indices and the training category lists (None for non-pandas data)."""
    cat_cols: List[int] = []
    pandas_categorical = None
    if hasattr(data, "dtypes") and hasattr(data, "columns"):
        df = data.copy()
        pandas_categorical = []
        for i, col in enumerate(df.columns):
            if str(df[col].dtype) == "category":
                pandas_categorical.append(list(df[col].cat.categories))
                df[col] = df[col].cat.codes.astype(np.float64)
                cat_cols.append(i)
        data = df
    if categorical_feature not in (None, "auto"):
        names = feature_name if feature_name not in (None, "auto") else None
        for c in categorical_feature:
            if isinstance(c, str) and names:
                cat_cols.append(names.index(c))
            elif isinstance(c, (int, np.integer)):
                cat_cols.append(int(c))
    return data, sorted(set(cat_cols)), pandas_categorical


class Dataset:
    """Training/validation dataset with lazy construction."""

    def __init__(self, data, label=None, max_bin=None, reference=None,
                 weight=None, group=None, init_score=None, silent=False,
                 feature_name="auto", categorical_feature="auto",
                 params=None, free_raw_data=False):
        self.params: Dict[str, Any] = dict(params or {})
        if max_bin is not None:
            self.params.setdefault("max_bin", max_bin)
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.free_raw_data = free_raw_data
        self.pandas_categorical = None
        self._inner: Optional[_InnerDataset] = None
        self._raw_X = None

    def construct(self, extra_params: Optional[Dict[str, Any]] = None
                  ) -> "Dataset":
        if self._inner is not None:
            return self
        if isinstance(self.data, str):
            raise NotImplementedError(
                "a Dataset from a file is not ported yet: the text and "
                "binary dataset readers come with the CLI (ROADMAP.md §A "
                "item 13)")
        merged = dict(self.params)
        for k, v in (extra_params or {}).items():
            merged.setdefault(k, v)
        cfg = config_from_params(merged)
        data, cats, self.pandas_categorical = _resolve_categorical(
            self.data, self.categorical_feature, self.feature_name)
        y = None if self.label is None else _to_numpy(self.label).reshape(-1)
        md = Metadata()
        if self.weight is not None:
            md.weights = _to_numpy(self.weight).reshape(-1).astype(np.float32)
        if self.group is not None:
            md.set_query_from_sizes(
                _to_numpy(self.group).reshape(-1).astype(np.int64))
        if self.init_score is not None:
            md.init_score = _to_numpy(self.init_score).reshape(-1)
        names = None
        if self.feature_name not in (None, "auto"):
            names = list(self.feature_name)
        elif hasattr(self.data, "columns"):
            names = [str(c) for c in self.data.columns]
        ref_inner = (self.reference.construct(extra_params)._inner
                     if self.reference is not None else None)
        if _is_scipy_sparse(data):
            self._inner = _InnerDataset.from_csc(
                data, y, cfg, metadata=md, feature_names=names,
                categorical_feature=cats, reference=ref_inner)
            self._raw_X = None if self.free_raw_data else data
            return self
        X = _to_numpy(data)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        self._inner = _InnerDataset(X, y, cfg, reference=ref_inner,
                                    metadata=md, feature_names=names,
                                    categorical_feature=cats)
        self._raw_X = None if self.free_raw_data else X
        return self

    # -- LightGBM-style helpers ----------------------------------------------

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, silent=False, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, silent=silent,
                       params=params or self.params)

    def set_label(self, label) -> None:
        self.label = label
        if self._inner is not None:
            self._inner.metadata.label = _to_numpy(label).reshape(
                -1).astype(np.float32)

    def set_weight(self, weight) -> None:
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.weights = (
                None if weight is None
                else _to_numpy(weight).reshape(-1).astype(np.float32))

    def set_group(self, group) -> None:
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_query_from_sizes(
                _to_numpy(group).reshape(-1).astype(np.int64))

    def set_init_score(self, init_score) -> None:
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.init_score = (
                None if init_score is None
                else _to_numpy(init_score).reshape(-1))

    def get_label(self):
        self.construct()
        return np.asarray(self._inner.metadata.label)

    def get_weight(self):
        self.construct()
        return self._inner.metadata.weights

    def get_group(self):
        self.construct()
        qb = self._inner.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    def get_init_score(self):
        self.construct()
        return self._inner.metadata.init_score

    def num_data(self) -> int:
        self.construct()
        return self._inner.num_data

    def num_feature(self) -> int:
        self.construct()
        return self._inner.num_total_features

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._inner.feature_names)

    def subset(self, used_indices: Sequence[int], params=None) -> "Dataset":
        """A dataset of the given rows, binned with this one's mappers
        (LightGBM's Dataset.subset), for cv()."""
        self.construct()
        if self._raw_X is None:
            raise LightGBMError("cannot subset when raw data was freed")
        idx = np.asarray(used_indices, np.int64)
        sub = Dataset(self._raw_X[idx],
                      label=np.asarray(self.get_label())[idx],
                      reference=self, params=params or self.params)
        w = self.get_weight()
        if w is not None:
            sub.weight = np.asarray(w)[idx]
        return sub


class Booster:
    """The boosting model (LightGBM's basic.py:1160+)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, silent: bool = False):
        params = dict(params or {})
        self.params = params
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._valid_names: List[str] = []
        self._valid_data: List[Dataset] = []
        self.pandas_categorical = None
        cfg = config_from_params(params)
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("train_set should be Dataset instance")
            train_set.construct(params)
            self._gbdt = create_boosting(cfg)
            self._gbdt.reset_training_data(train_set._inner)
            self.train_set = train_set
            self.pandas_categorical = train_set.pandas_categorical
        elif model_file is not None:
            self._gbdt = create_boosting(cfg, model_file)
            self.train_set = None
            self.pandas_categorical = _load_pandas_categorical(
                _read_last_line(model_file))
        elif model_str is not None:
            self._gbdt = create_boosting(cfg, model_str=model_str)
            self.train_set = None
            self.pandas_categorical = _load_pandas_categorical(model_str)
        else:
            raise TypeError("need one of train_set, model_file, model_str")

    # -- training --------------------------------------------------------------

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct(self.params)
        self._gbdt.add_valid(data._inner, name)
        self._valid_names.append(name)
        self._valid_data.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj: Optional[Callable] = None) -> bool:
        """One boosting iteration, on the objective's gradients or on
        those of `fobj(raw scores, train_set)`; returns True when no
        leaf could split."""
        if train_set is not None and train_set is not self.train_set:
            train_set.construct(self.params)
            self._gbdt.reset_training_data(train_set._inner)
            self.train_set = train_set
        if fobj is None:
            return self._gbdt.train_one_iter(None, None, False)
        grad, hess = fobj(self._inner_raw_score(), self.train_set)
        return self._boost(grad, hess)

    def _inner_raw_score(self) -> np.ndarray:
        # class-major flat, as LightGBM hands it to fobj
        return self._gbdt.train_score.get().reshape(-1)

    def _boost(self, grad, hess) -> bool:
        g = self._gbdt
        shape = (g.K, g.num_data)
        gt = torch.as_tensor(np.asarray(grad, np.float32).reshape(shape),
                             device=g.device)
        ht = torch.as_tensor(np.asarray(hess, np.float32).reshape(shape),
                             device=g.device)
        return g.train_one_iter(gt, ht, False)

    def rollback_one_iter(self) -> "Booster":
        self._gbdt.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration()

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        self.params.update(params)
        new_cfg = config_from_params(self.params)
        self._gbdt.config = new_cfg
        self._gbdt.shrinkage_rate = new_cfg.learning_rate
        if self._gbdt.train_set is not None:
            self._gbdt.learner.config = new_cfg
        return self

    # -- evaluation ------------------------------------------------------------

    def eval_train(self, feval=None):
        return self._eval(self._gbdt.eval_train(), feval, is_train=True)

    def eval_valid(self, feval=None):
        return self._eval(self._gbdt.eval_valid(), feval, is_train=False)

    def eval(self, data: Dataset, name: str, feval=None):
        if data is self.train_set:
            return self.eval_train(feval)
        return [r for r in self.eval_valid(feval) if r[0] == name]

    def _eval(self, results, feval, is_train):
        out = list(results)
        if feval is None:
            return out

        def apply(ds_name, raw, dataset):
            ret = feval(raw, dataset)
            if ret is None:
                return
            if isinstance(ret, tuple):
                ret = [ret]
            for fname, val, hib in ret:
                out.append((ds_name, fname, val, hib))

        if is_train and self.train_set is not None:
            apply("training", self._inner_raw_score(), self.train_set)
        elif not is_train:
            for vname, vdata, (_, _, su, _) in zip(
                    self._valid_names, self._valid_data,
                    self._gbdt.valid_sets):
                apply(vname, su.get().reshape(-1), vdata)
        return out

    def refit(self, data, label, decay_rate: float = 0.9, weight=None,
              **kwargs) -> "Booster":
        raise NotImplementedError(
            "Booster.refit needs the online leaf refitter "
            "(online/refit.py), not ported yet (ROADMAP.md §A item 14)")

    # -- prediction ------------------------------------------------------------

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, data_has_header: bool = False,
                is_reshape: bool = True) -> np.ndarray:
        if isinstance(data, str):
            raise NotImplementedError(
                "predicting a file is not ported yet: the text readers "
                "come with the CLI (ROADMAP.md §A item 13)")
        data = _apply_pandas_categorical(data, self.pandas_categorical)
        X = (data.toarray() if _is_scipy_sparse(data)
             else _to_numpy(data))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if pred_leaf:
            return self._gbdt.predict_leaf_index(X, num_iteration)
        if raw_score:
            return self._gbdt.predict_raw(X, num_iteration)
        return self._gbdt.predict(X, num_iteration)

    # -- model io --------------------------------------------------------------

    def _pandas_categorical_trailer(self) -> str:
        if not self.pandas_categorical:
            return ""

        def _reject(o):
            # a stringified category (a Timestamp, say) would no longer
            # match the frame's values after a reload
            raise LightGBMError(
                "categorical column categories must be JSON-native "
                f"(str/int/float/bool) to save the model; got {type(o)}")
        return ("pandas_categorical:"
                + json.dumps(self.pandas_categorical, default=_reject)
                + "\n")

    def save_model(self, filename: str, num_iteration: int = -1
                   ) -> "Booster":
        self._gbdt.save_model_to_file(filename, num_iteration)
        trailer = self._pandas_categorical_trailer()
        if trailer:
            with open(filename, "a") as f:
                f.write(trailer)
        return self

    def model_to_string(self, num_iteration: int = -1) -> str:
        return (self._gbdt.save_model_to_string(num_iteration)
                + self._pandas_categorical_trailer())

    def dump_model(self, num_iteration: int = -1) -> Dict:
        return self._gbdt.to_json()

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        if importance_type not in ("split", "gain"):
            raise ValueError(
                f"unknown importance_type {importance_type!r}; "
                "use 'split' or 'gain'")
        imp = self._gbdt.feature_importance(importance_type)
        # split counts are int32, as in LightGBM's C API
        dt = np.float64 if importance_type == "gain" else np.int32
        return np.array([imp.get(n, 0) for n in self.feature_name()], dt)

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def free_dataset(self) -> "Booster":
        self.train_set = None
        return self

    def __getstate__(self):
        return {"params": self.params,
                "model_str": self.model_to_string(),
                "best_iteration": self.best_iteration,
                "best_score": self.best_score}

    def __setstate__(self, state):
        self.params = state["params"]
        self._gbdt = create_boosting(config_from_params(self.params),
                                     model_str=state["model_str"])
        self.best_iteration = state.get("best_iteration", -1)
        self.best_score = state.get("best_score", {})
        self.train_set = None
        self._valid_names = []
        self._valid_data = []
        # the category lists travel in the model text's trailer
        self.pandas_categorical = _load_pandas_categorical(
            state["model_str"])
