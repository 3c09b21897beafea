"""Evaluation metrics: binary_logloss, auc and ndcg@k.

Port of the binary metrics and NDCG of lightgbm_tpu/metrics.py, device
path only:
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

    def eval(self, score: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
        raise NotImplementedError


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score):
        return [(self.name, deval.binary_logloss(
            score.reshape(-1), self.label, self.weights,
            self.sum_weights, float(self.config.sigmoid)))]


class AUCMetric(Metric):
    name = "auc"
    factor_to_bigger_better = 1.0

    def eval(self, score):
        return [(self.name, deval.auc(score.reshape(-1), self.label,
                                      self.weights))]


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
            raise ValueError("NDCG metric requires query information")
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
        self._qw = None if qw is None else torch.as_tensor(qw, device=device)
        self._label_int = torch.as_tensor(
            np.asarray(metadata.label).astype(np.int32), device=device)

    def eval(self, score):
        ks = tuple(int(k) for k in self.config.ndcg_eval_at)
        vals = deval.ndcg_at_k(score.reshape(-1), self._label_int,
                               self._qid, self._qstart, self._gain,
                               self._disc, self._qw, ks, self._num_queries)
        return [(f"ndcg@{k}", vals[i]) for i, k in enumerate(ks)]


_METRICS = {"binary_logloss": BinaryLoglossMetric,
            "binary": BinaryLoglossMetric, "auc": AUCMetric,
            "ndcg": NDCGMetric, "lambdarank": NDCGMetric}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    name = name.strip().lower()
    if name in ("", "none", "null", "na"):
        return None
    if name not in _METRICS:
        raise NotImplementedError(
            f"metric {name!r} is not ported yet; this slice has "
            "binary_logloss, auc and ndcg (ROADMAP.md §A item 8)")
    return _METRICS[name](config)
