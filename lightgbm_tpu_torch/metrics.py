"""Evaluation metrics: binary_logloss and auc.

Port of the binary metrics of lightgbm_tpu/metrics.py, device path only:
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


_METRICS = {"binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
            "auc": AUCMetric}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    name = name.strip().lower()
    if name in ("", "none", "null", "na"):
        return None
    if name not in _METRICS:
        raise NotImplementedError(
            f"metric {name!r} is not ported yet; this slice has "
            "binary_logloss and auc (ROADMAP.md §A item 8)")
    return _METRICS[name](config)
