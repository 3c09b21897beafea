"""scikit-learn wrapper interface.

A copy of lightgbm_tpu/sklearn.py over this package's engine, after
LightGBM's python-package/lightgbm/sklearn.py: LGBMModel
(sklearn.py:123+), LGBMRegressor (:488), LGBMClassifier (:536),
LGBMRanker (:645), plus the custom objective adapter (:15-121) translating
sklearn-style `fobj(y_true, y_pred)` into the engine's
`fobj(preds, dataset)` form.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset, LightGBMError
from .engine import train


def _objective_function_wrapper(func: Callable) -> Callable:
    """sklearn fobj(y_true, y_pred[, group]) -> engine fobj(preds, dataset)
    (LightGBM's sklearn.py:15-88)."""
    def inner(preds, dataset):
        labels = dataset.get_label()
        argc = func.__code__.co_argcount
        if argc == 2:
            grad, hess = func(labels, preds)
        elif argc == 3:
            grad, hess = func(labels, preds, dataset.get_group())
        else:
            raise TypeError(f"Self-defined objective should have 2 or 3 "
                            f"arguments, got {argc}")
        return grad, hess
    return inner


def _eval_function_wrapper(func: Callable) -> Callable:
    """sklearn feval(y_true, y_pred[, weight[, group]]) adapter
    (LightGBM's sklearn.py:88-121)."""
    def inner(preds, dataset):
        labels = dataset.get_label()
        argc = func.__code__.co_argcount
        if argc == 2:
            return func(labels, preds)
        if argc == 3:
            return func(labels, preds, dataset.get_weight())
        if argc == 4:
            return func(labels, preds, dataset.get_weight(),
                        dataset.get_group())
        raise TypeError(f"Self-defined eval function should have 2, 3, or 4 "
                        f"arguments, got {argc}")
    return inner


try:  # sklearn interop (clone / GridSearchCV need BaseEstimator tags)
    from sklearn.base import (BaseEstimator as _SkBase,
                              ClassifierMixin as _SkClassifierMixin,
                              RegressorMixin as _SkRegressorMixin)
except ImportError:  # sklearn not installed: plain-Python wrappers
    _SkBase = object

    class _SkClassifierMixin:
        pass

    class _SkRegressorMixin:
        pass


class LGBMModel(_SkBase):
    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 10, max_bin: int = 255,
                 subsample_for_bin: int = 50000, objective: str = "regression",
                 min_split_gain: float = 0.0, min_child_weight: float = 5,
                 min_child_samples: int = 10, subsample: float = 1.0,
                 subsample_freq: int = 1, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 scale_pos_weight: float = 1.0, is_unbalance: bool = False,
                 seed: int = 0, nthread: int = -1, silent: bool = True,
                 sigmoid: float = 1.0, huber_delta: float = 1.0,
                 gaussian_eta: float = 1.0, fair_c: float = 1.0,
                 poisson_max_delta_step: float = 0.7,
                 max_position: int = 20, label_gain=None,
                 drop_rate: float = 0.1, skip_drop: float = 0.5,
                 max_drop: int = 50, uniform_drop: bool = False,
                 xgboost_dart_mode: bool = False, **kwargs):
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.max_bin = max_bin
        self.subsample_for_bin = subsample_for_bin
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.scale_pos_weight = scale_pos_weight
        self.is_unbalance = is_unbalance
        self.seed = seed
        self.nthread = nthread
        self.silent = silent
        self.sigmoid = sigmoid
        self.huber_delta = huber_delta
        self.gaussian_eta = gaussian_eta
        self.fair_c = fair_c
        self.poisson_max_delta_step = poisson_max_delta_step
        self.max_position = max_position
        self.label_gain = label_gain
        self.drop_rate = drop_rate
        self.skip_drop = skip_drop
        self.max_drop = max_drop
        self.uniform_drop = uniform_drop
        self.xgboost_dart_mode = xgboost_dart_mode
        # arbitrary LightGBM params pass through (silent in the v2.0-era
        # fixed signature, a **kwargs superset like later LightGBM): they
        # participate in get_params/set_params so sklearn clone and
        # GridSearchCV see them
        self._other_param_names = sorted(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._Booster: Optional[Booster] = None
        self.evals_result: Dict = {}
        self.best_iteration: int = -1

    # sklearn plumbing ------------------------------------------------------

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        import inspect
        sig = inspect.signature(LGBMModel.__init__)
        out = {k: getattr(self, k) for k in sig.parameters
               if k not in ("self", "kwargs")}
        for k in getattr(self, "_other_param_names", ()):
            out[k] = getattr(self, k)
        return out

    def set_params(self, **params) -> "LGBMModel":
        import inspect
        known = set(inspect.signature(LGBMModel.__init__).parameters)
        for k, v in params.items():
            setattr(self, k, v)
            if k not in known and k not in self._other_param_names:
                self._other_param_names.append(k)
        return self

    def _lgbm_params(self) -> Dict[str, Any]:
        p = {
            "boosting_type": self.boosting_type,
            "objective": self.objective if isinstance(self.objective, str)
                         else "regression",
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "max_bin": self.max_bin,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "scale_pos_weight": self.scale_pos_weight,
            "is_unbalance": self.is_unbalance,
            "seed": self.seed,
            "sigmoid": self.sigmoid,
            "huber_delta": self.huber_delta,
            "gaussian_eta": self.gaussian_eta,
            "fair_c": self.fair_c,
            "poisson_max_delta_step": self.poisson_max_delta_step,
            "max_position": self.max_position,
            "verbose": 0,
        }
        for k in getattr(self, "_other_param_names", ()):
            p[k] = getattr(self, k)
        if self.label_gain is not None:
            p["label_gain"] = self.label_gain
        if self.boosting_type == "dart":
            p.update(drop_rate=self.drop_rate, skip_drop=self.skip_drop,
                     max_drop=self.max_drop, uniform_drop=self.uniform_drop,
                     xgboost_dart_mode=self.xgboost_dart_mode)
        return p

    # fitting ---------------------------------------------------------------

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_sample_weight=None, eval_init_score=None,
            eval_group=None, eval_metric=None, early_stopping_rounds=None,
            verbose: bool = False, feature_name="auto",
            categorical_feature="auto", callbacks=None) -> "LGBMModel":
        params = self._lgbm_params()
        fobj = None
        if callable(self.objective):
            fobj = _objective_function_wrapper(self.objective)
            params["objective"] = "regression"
        feval = None
        if callable(eval_metric):
            feval = _eval_function_wrapper(eval_metric)
        elif isinstance(eval_metric, str):
            params["metric"] = eval_metric
        elif isinstance(eval_metric, (list, tuple)):
            params["metric"] = ",".join(eval_metric)
        if getattr(self, "_n_classes", None) and self._n_classes > 2:
            params["num_class"] = self._n_classes
        train_set = Dataset(X, label=y, weight=sample_weight,
                            group=group, init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                valid_sets.append(Dataset(vx, label=vy, weight=vw, group=vg,
                                          init_score=vi, reference=train_set))
        self.evals_result = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self.evals_result, verbose_eval=verbose,
            callbacks=callbacks)
        self.best_iteration = self._Booster.best_iteration
        return self

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1):
        if self._Booster is None:
            raise LightGBMError("Need to call fit beforehand")
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration)

    def apply(self, X, num_iteration: int = -1):
        if self._Booster is None:
            raise LightGBMError("Need to call fit beforehand")
        return self._Booster.predict(X, pred_leaf=True,
                                     num_iteration=num_iteration)

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit beforehand.")
        return self._Booster

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance()

    @property
    def evals_result_(self) -> Dict:
        return self.evals_result

    # deprecated accessors kept for drop-in compatibility
    # (LightGBM's sklearn.py:480-487 keeps both spellings)
    def booster(self) -> Booster:
        import warnings
        warnings.warn("Use attribute booster_ instead.",
                      DeprecationWarning)
        return self.booster_

    def feature_importance(self) -> np.ndarray:
        import warnings
        warnings.warn("Use attribute feature_importances_ instead.",
                      DeprecationWarning)
        return self.feature_importances_


class LGBMRegressor(_SkRegressorMixin, LGBMModel):
    def __init__(self, objective: str = "regression", **kwargs):
        super().__init__(objective=objective, **kwargs)


class LGBMClassifier(_SkClassifierMixin, LGBMModel):
    def __init__(self, objective: str = "binary", **kwargs):
        super().__init__(objective=objective, **kwargs)

    def fit(self, X, y, **kwargs):  # noqa: D102
        y = np.asarray(y)
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        self._n_classes = len(self.classes_)
        if self._n_classes > 2 and not callable(self.objective):
            self.objective = "multiclass"
        return super().fit(X, y_enc, **kwargs)

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1):
        prob = self.predict_proba(X, raw_score, num_iteration)
        if raw_score:
            return prob
        if prob.ndim > 1:
            return self.classes_[np.argmax(prob, axis=1)]
        return self.classes_[(prob > 0.5).astype(np.int64)]

    def predict_proba(self, X, raw_score: bool = False,
                      num_iteration: int = -1):
        out = self.booster_.predict(X, raw_score=raw_score,
                                    num_iteration=num_iteration)
        if raw_score or out.ndim > 1:
            return out
        return np.vstack([1.0 - out, out]).T

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    def __init__(self, objective: str = "lambdarank", **kwargs):
        super().__init__(objective=objective, **kwargs)

    def fit(self, X, y, group=None, **kwargs):  # noqa: D102
        if group is None:
            raise ValueError("Should set group for ranking task")
        if "eval_set" in kwargs and kwargs["eval_set"] is not None:
            if kwargs.get("eval_group") is None:
                raise ValueError("Eval_group cannot be None when eval_set is "
                                 "not None")
        return super().fit(X, y, group=group, **kwargs)
