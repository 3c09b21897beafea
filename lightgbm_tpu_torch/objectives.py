"""Objective functions: elementwise gradient/hessian on [K, N] tensors.

Port of lightgbm_tpu/objectives.py restricted to the binary objective
(`Objective`, `BinaryLogloss`, `create_objective`,
`objective_from_model_string`).  The f32 operation order follows JAX.
The other objectives are later slices (ROADMAP.md §A item 10).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata


class Objective:
    """Base objective.  get_gradients: [K, N] score -> ([K, N], [K, N])."""

    name = "regression"
    num_tree_per_iteration = 1
    boost_from_average = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        self.num_data = num_data
        self.label = torch.as_tensor(np.asarray(metadata.label, np.float32),
                                     device=device)
        self.weights = (None if metadata.weights is None
                        else torch.as_tensor(
                            np.asarray(metadata.weights, np.float32),
                            device=device))

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        """Raw score -> prediction output (reference ConvertOutput)."""
        return score

    def to_string(self) -> str:
        return self.name


class BinaryLogloss(Objective):
    name = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = config.sigmoid

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label)
        is_pos = lab > 0
        cnt_pos, cnt_neg = int(is_pos.sum()), int((~is_pos).sum())
        self.need_train = cnt_pos > 0 and cnt_neg > 0
        w_pos, w_neg = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.config.scale_pos_weight
        # per-row (label sign, label weight) as f32 rows, computed once
        is_p = self.label > 0
        one = torch.ones((), dtype=torch.float32, device=device)
        self._lbl = torch.where(is_p, one, -one)
        self._lw = torch.where(is_p, torch.tensor(w_pos, dtype=torch.float32,
                                                  device=device),
                               torch.tensor(w_neg, dtype=torch.float32,
                                            device=device))

    def get_gradients(self, score):
        if not self.need_train:
            z = torch.zeros_like(score)
            return z, z
        sigmoid = self.sigmoid
        lbl = self._lbl[None, :]
        response = -lbl * sigmoid / (1.0 + torch.exp(lbl * sigmoid * score))
        absr = torch.abs(response)
        lw = self._lw[None, :]
        g = response * lw
        h = absr * (sigmoid - absr) * lw
        if self.weights is not None:
            g = g * self.weights[None, :]
            h = h * self.weights[None, :]
        return g, h

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * score))

    def to_string(self):
        return f"binary sigmoid:{self.sigmoid:g}"


def create_objective(config: Config) -> Objective:
    if config.objective != "binary":
        raise NotImplementedError(
            f"objective {config.objective!r} is not ported yet; this slice "
            "trains the binary objective (ROADMAP.md §A item 10)")
    return BinaryLogloss(config)


def objective_from_model_string(s: str, config: Config) -> Objective:
    """Recreate an objective from its model-file ToString() form
    (objective_function.cpp:33-57)."""
    toks = s.split()
    name = toks[0]
    kw = {}
    for t in toks[1:]:
        if ":" in t:
            k, v = t.split(":", 1)
            kw[k] = v
    cfg = config
    if "num_class" in kw:
        cfg = cfg.with_updates(num_class=int(kw["num_class"]))
    if "sigmoid" in kw:
        cfg = cfg.with_updates(sigmoid=float(kw["sigmoid"]))
    cfg = cfg.with_updates(objective=name)
    return create_objective(cfg)
