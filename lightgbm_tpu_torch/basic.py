"""User-facing Dataset / Booster API.

Port of lightgbm_tpu/basic.py for this slice: a `Dataset` over a dense
numpy matrix or a scipy sparse matrix (routed to `Dataset.from_csc`, so
the dense [N, F] matrix never materializes), with query groups, lazy
construction and reference alignment for validation data, and a
`Booster` with update, eval, host predict and the text model.  Pandas
categoricals, refit and custom objectives are later slices (ROADMAP.md
§A item 9).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .boosting.gbdt import GBDT
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


class Dataset:
    """Training/validation dataset with lazy construction."""

    def __init__(self, data, label=None, max_bin=None, reference=None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto",
                 categorical_feature="auto", params=None):
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
        self._inner: Optional[_InnerDataset] = None

    def construct(self, extra_params: Optional[Dict[str, Any]] = None
                  ) -> "Dataset":
        if self._inner is not None:
            return self
        merged = dict(self.params)
        for k, v in (extra_params or {}).items():
            merged.setdefault(k, v)
        cfg = config_from_params(merged)
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
        cats = ([] if self.categorical_feature in (None, "auto")
                else [int(c) for c in self.categorical_feature])
        ref_inner = (self.reference.construct(extra_params)._inner
                     if self.reference is not None else None)
        if _is_scipy_sparse(self.data):
            self._inner = _InnerDataset.from_csc(
                self.data, y, cfg, metadata=md, feature_names=names,
                categorical_feature=cats, reference=ref_inner)
            return self
        X = _to_numpy(self.data)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        self._inner = _InnerDataset(X, y, cfg, reference=ref_inner,
                                    metadata=md, feature_names=names,
                                    categorical_feature=cats)
        return self


class Booster:
    """The boosting model (reference basic.py:1160+)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_str: Optional[str] = None,
                 model_file: Optional[str] = None):
        params = dict(params or {})
        self.params = params
        self.best_iteration = -1
        self._valid_names: List[str] = []
        cfg = config_from_params(params)
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("train_set should be Dataset instance")
            train_set.construct(params)
            self._gbdt = GBDT(cfg)
            self._gbdt.reset_training_data(train_set._inner)
            self.train_set = train_set
        elif model_str is not None or model_file is not None:
            if model_str is None:
                with open(model_file) as f:
                    model_str = f.read()
            self._gbdt = GBDT(cfg)
            self._gbdt.load_model_from_string(model_str)
            self.train_set = None
        else:
            raise TypeError("need one of train_set, model_str, model_file")

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct(self.params)
        self._gbdt.add_valid(data._inner, name)
        self._valid_names.append(name)
        return self

    def update(self) -> bool:
        """One boosting iteration; returns True if no further splits."""
        return self._gbdt.train_one_iter()

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration()

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    def eval_train(self):
        return self._gbdt.eval_train()

    def eval_valid(self):
        return self._gbdt.eval_valid()

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        X = (data.toarray() if _is_scipy_sparse(data)
             else _to_numpy(data))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if raw_score:
            return self._gbdt.predict_raw(X, num_iteration)
        return self._gbdt.predict(X, num_iteration)

    def save_model(self, filename: str, num_iteration: int = -1
                   ) -> "Booster":
        self._gbdt.save_model_to_file(filename, num_iteration)
        return self

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._gbdt.save_model_to_string(num_iteration)
