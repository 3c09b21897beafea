"""Device-side evaluation metrics: the binary log loss and AUC.

Port of lightgbm_tpu/ops/eval.py `pointwise_loss` (binary_logloss kind)
and `auc`.  The score stays on the device; each metric returns a 0-d
tensor, and the boosting loop fetches all of an iteration's metrics in
one transfer.
"""
from __future__ import annotations

from typing import Optional

import torch


def binary_logloss(score: torch.Tensor, label: torch.Tensor,
                   w: Optional[torch.Tensor], sum_w: float,
                   sigmoid: float) -> torch.Tensor:
    """Weighted mean binary log loss of raw scores [N] against labels."""
    prob = torch.sigmoid(sigmoid * score.to(torch.float32))
    prob = torch.clamp(prob, 1e-15, 1 - 1e-15)
    loss = -torch.where(label > 0, torch.log(prob), torch.log1p(-prob))
    if w is None:
        return torch.sum(loss) / sum_w
    return torch.sum(loss * w) / sum_w


def auc(score: torch.Tensor, label: torch.Tensor,
        w: Optional[torch.Tensor]) -> torch.Tensor:
    """Weighted tie-aware rank-sum AUC: sort once, fold tied blocks with a
    segment sum keyed by a block id derived from score changes."""
    s = score.to(torch.float32)
    n = s.shape[0]
    order = torch.argsort(s, stable=True)
    s_s = s[order]
    y_s = label[order] > 0
    w_s = torch.ones_like(s) if w is None else w[order]
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    wpos = torch.where(y_s, w_s, zero)
    wneg = torch.where(y_s, zero, w_s)
    new_block = torch.cat([torch.ones(1, dtype=torch.int64, device=s.device),
                           (s_s[1:] != s_s[:-1]).to(torch.int64)])
    block_id = torch.cumsum(new_block, 0) - 1
    bpos = torch.zeros(n, dtype=torch.float32,
                       device=s.device).index_add_(0, block_id, wpos)
    bneg = torch.zeros(n, dtype=torch.float32,
                       device=s.device).index_add_(0, block_id, wneg)
    below = torch.cumsum(bneg, 0) - bneg
    acc = torch.sum(bpos * (below + 0.5 * bneg))
    tot_pos = torch.sum(wpos)
    tot_neg = torch.sum(wneg)
    return torch.where((tot_pos > 0) & (tot_neg > 0),
                       acc / (tot_pos * tot_neg),
                       torch.ones((), dtype=torch.float32, device=s.device))
