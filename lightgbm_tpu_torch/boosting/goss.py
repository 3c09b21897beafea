"""GOSS: Gradient-based One-Side Sampling.

Port of lightgbm_tpu/boosting/goss.py (goss.hpp): in place of bagging,
keep the top `top_rate` share of rows by |g*h|, draw `other_rate` of the
rest uniformly and amplify their gradients and hessians by (1-a)/b
(goss.hpp:79-124); no sampling during the first 1/learning_rate
iterations (goss.hpp:129).

The JAX package selects with `jax.lax.top_k`, which puts the lower index
first among equal values, and draws with `jax.random` (threefry2x32).
Here a stable descending sort keeps the same tie rule (CUDA's
`torch.topk` gives none), and `prng` draws the same bits, so the bag and
the amplified gradients are bitwise those of the JAX package.  The bag
goes to the learner as a bagging draw does: the int8 histograms quantize
over the rows a pass reads, amplified rows included.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import prng
from ..config import Config
from .gbdt import GBDT


def _top_k_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, the lower index first among
    equal values (`jax.lax.top_k`'s order)."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


def _goss_select(gradients: torch.Tensor, hessians: torch.Tensor,
                 rand_key: torch.Tensor, *, top_k: int, other_k: int,
                 cap: int):
    """Returns (bag [cap] int32 padded with N, amplified g, h [K, N])."""
    K, N = gradients.shape
    dev = gradients.device
    score = torch.sum(torch.abs(gradients * hessians), dim=0)
    top_idx = _top_k_indices(score, top_k)
    # draw other_k of the rest uniformly: the top rows score -1
    mask_top = torch.zeros(N, dtype=torch.bool, device=dev)
    mask_top[top_idx] = True
    u = prng.uniform(rand_key, (N,), device=dev).masked_fill(mask_top, -1.0)
    other_idx = _top_k_indices(u, other_k)
    # the factor in Python float64, stored as f32 (as JAX's .at[].set)
    amp = (1.0 - top_k / N) / max(other_k / N, 1e-30) if N else 1.0
    multiply = torch.ones(N, dtype=torch.float32, device=dev)
    multiply[other_idx] = float(np.float32(amp))
    sel = torch.sort(torch.cat([top_idx, other_idx]).to(torch.int32)).values
    pad = torch.full((cap - sel.shape[0],), N, dtype=torch.int32, device=dev)
    bag = torch.cat([sel, pad])
    return bag, gradients * multiply[None, :], hessians * multiply[None, :]


class GOSS(GBDT):
    def __init__(self, config: Config, train_set=None, objective=None):
        if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
            raise ValueError("cannot use bagging in GOSS")
        super().__init__(config, train_set, objective)
        self._goss_key = prng.PRNGKey(config.bagging_seed)

    def sub_model_name(self) -> str:
        return "goss"

    def _extra_training_state(self):
        return {"goss_key": [int(w) for w in self._goss_key.tolist()]}

    def _restore_extra_training_state(self, state):
        if "goss_key" in state:
            self._goss_key = torch.tensor(
                [int(w) & 0xFFFFFFFF for w in state["goss_key"]],
                dtype=torch.int64)

    def train_one_iter(self, gradient=None, hessian=None,
                       is_eval: bool = False) -> bool:
        self._boost_from_average()
        if gradient is None or hessian is None:
            gradient, hessian = self.boosting_gradients()
        cfg = self.config
        n = self.num_data
        top_k = max(int(n * cfg.top_rate), 1)
        other_k = max(int(n * cfg.other_rate), 1)
        # no sampling during the warm-up (goss.hpp:129)
        warmup = int(1.0 / max(cfg.learning_rate, 1e-12))
        if self.iter_ >= warmup and top_k + other_k < n:
            keys = prng.split(self._goss_key)
            self._goss_key, sub = keys[0], keys[1]
            cnt = top_k + other_k
            cap = min(1 << max(cnt - 1, 1).bit_length(), n)
            cap = max(cap, cnt)
            bag, gradient, hessian = _goss_select(
                gradient, hessian, sub, top_k=top_k, other_k=other_k,
                cap=cap)
            self.bag_idx = bag
            self.bag_cnt = cnt
            self.need_bagging = True
        else:
            self.bag_idx = None
            self.bag_cnt = n
            self.need_bagging = False
        return GBDT.train_one_iter(self, gradient, hessian, is_eval)

    def _bagging(self, iter_):
        return  # GOSS's selection above takes bagging's place
