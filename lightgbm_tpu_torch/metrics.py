"""Evaluation metrics: the regression losses, binary logloss and error,
AUC, multiclass logloss and error, NDCG@k and MAP@k.

Port of lightgbm_tpu/metrics.py, device path only (its `eval_device`):
`eval` works on the resident [K, N] score tensor and returns
[(name, 0-d tensor)]; GBDT fetches every metric of an iteration in one
transfer.  Metrics report `factor_to_bigger_better` (+1/-1) so early
stopping can maximize uniformly.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .ops import eval as deval


class Metric:
    name = "metric"
    factor_to_bigger_better = -1.0  # losses by default
    device_kind: Optional[str] = None  # ops/eval.pointwise_loss kind

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device) -> None:
        self.num_data = num_data
        self.label = torch.as_tensor(np.asarray(metadata.label, np.float32),
                                     device=device)
        self.weights = (None if metadata.weights is None
                        else torch.as_tensor(np.asarray(metadata.weights,
                                                        np.float32),
                                             device=device))
        self.sum_weights = (float(num_data) if metadata.weights is None
                            else float(np.asarray(metadata.weights,
                                                  np.float64).sum()))
        # device f32 scalars, as JAX's `_dev_scalars`
        self._sw = torch.tensor(np.float32(self.sum_weights), device=device)
        self._p1 = torch.tensor(np.float32(self._device_param()),
                                device=device)

    def _device_param(self) -> float:
        return 0.0

    def result_names(self) -> List[str]:
        """The names `eval` returns, without evaluating (the C ABI's
        GetEvalCounts/GetEvalNames read them)."""
        return [self.name]

    def eval(self, score: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
        """The weighted mean of the metric's pointwise loss."""
        return [(self.name, deval.pointwise_loss(
            score.reshape(-1), self.label, self.weights, self._sw,
            kind=self.device_kind, p1=self._p1))]


class L2Metric(Metric):
    name = "l2"
    device_kind = "l2"


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval(self, score):
        return [(self.name, torch.sqrt(super().eval(score)[0][1]))]


class L1Metric(Metric):
    name = "l1"
    device_kind = "l1"


class HuberMetric(Metric):
    name = "huber"
    device_kind = "huber"

    def _device_param(self):
        return float(self.config.huber_delta)


class FairMetric(Metric):
    name = "fair"
    device_kind = "fair"

    def _device_param(self):
        return float(self.config.fair_c)


class PoissonMetric(Metric):
    name = "poisson"
    device_kind = "poisson"


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"
    device_kind = "binary_logloss"

    def _device_param(self):
        return float(self.config.sigmoid)


class BinaryErrorMetric(Metric):
    name = "binary_error"
    device_kind = "binary_error"


class AUCMetric(Metric):
    name = "auc"
    factor_to_bigger_better = 1.0

    def eval(self, score):
        return [(self.name, deval.auc(score.reshape(-1), self.label,
                                      self.weights))]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self._label_int = torch.as_tensor(
            np.asarray(metadata.label).astype(np.int64), device=device)

    def eval(self, score):
        K = self.config.num_class
        return [(self.name, deval.multi_logloss(
            score.reshape(K, -1), self._label_int, self.weights, self._sw))]


class MultiErrorMetric(MultiLoglossMetric):
    name = "multi_error"

    def eval(self, score):
        K = self.config.num_class
        return [(self.name, deval.multi_error(
            score.reshape(K, -1), self._label_int, self.weights, self._sw))]


def _dcg_tables(config: Config, max_len: int):
    gains = config.label_gain
    if not gains:
        gains = tuple(float(2 ** i - 1) for i in range(31))
    label_gain = np.asarray(gains, np.float64)
    discount = 1.0 / np.log2(2.0 + np.arange(max(max_len, 1)))
    return label_gain, discount


class NDCGMetric(Metric):
    """NDCG@k for every k of `ndcg_eval_at`, over query groups, averaged
    by the per-query weights when row weights exist."""
    name = "ndcg"
    factor_to_bigger_better = 1.0

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            raise ValueError(f"{self.name.upper()} metric requires query "
                             "information")
        qb = np.asarray(metadata.query_boundaries, np.int64)
        sizes = np.diff(qb)
        label_gain, discount = _dcg_tables(self.config, num_data)
        qw = metadata.query_weights
        self._qid = torch.as_tensor(
            np.repeat(np.arange(len(sizes), dtype=np.int32), sizes),
            device=device)
        self._qstart = torch.as_tensor(
            np.repeat(qb[:-1].astype(np.int32), sizes), device=device)
        self._gain = torch.as_tensor(label_gain.astype(np.float32),
                                     device=device)
        self._disc = torch.as_tensor(discount.astype(np.float32),
                                     device=device)
        self._num_queries = len(sizes)
        self._max_len = int(sizes.max(initial=1))
        self._qw = None if qw is None else torch.as_tensor(qw, device=device)
        self._label_int = torch.as_tensor(
            np.asarray(metadata.label).astype(np.int32), device=device)

    def result_names(self) -> List[str]:
        return [f"{self.name}@{int(k)}" for k in self.config.ndcg_eval_at]

    def eval(self, score):
        ks = tuple(int(k) for k in self.config.ndcg_eval_at)
        vals = deval.ndcg_at_k(score.reshape(-1), self._label_int,
                               self._qid, self._qstart, self._gain,
                               self._disc, self._qw, ks, self._num_queries,
                               self._max_len)
        return [(f"{self.name}@{k}", vals[i]) for i, k in enumerate(ks)]


class MAPMetric(NDCGMetric):
    """MAP@k for every k of `ndcg_eval_at` (the JAX package's choice),
    over query groups."""
    name = "map"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self._label_pos = torch.as_tensor(np.asarray(metadata.label) > 0,
                                          device=device)

    def eval(self, score):
        ks = tuple(int(k) for k in self.config.ndcg_eval_at)
        vals = deval.map_at_k(score.reshape(-1), self._label_pos, self._qid,
                              self._qstart, self._qw, ks, self._num_queries,
                              self._max_len)
        return [(f"{self.name}@{k}", vals[i]) for i, k in enumerate(ks)]


_METRICS = {
    "l2": L2Metric, "mse": L2Metric, "mean_squared_error": L2Metric,
    "regression": L2Metric,
    "rmse": RMSEMetric,
    "l1": L1Metric, "mae": L1Metric, "mean_absolute_error": L1Metric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "map": MAPMetric, "mean_average_precision": MAPMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    name = name.strip().lower()
    if name in ("", "none", "null", "na"):
        return None
    if name not in _METRICS:
        raise ValueError(f"unknown metric: {name}")
    return _METRICS[name](config)
