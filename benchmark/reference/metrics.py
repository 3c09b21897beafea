"""Validation metrics, plainly and in float64.

auc: the chance that a positive outscores a negative, ties counting
one half (ranks averaged over tied scores).
"""
from __future__ import annotations

from typing import Dict

import torch


def auc(score: torch.Tensor, label: torch.Tensor) -> float:
    pos = label > 0
    n_pos = int(pos.sum())
    n_neg = score.numel() - n_pos
    if n_pos == 0 or n_neg == 0:
        return 1.0
    s, order = torch.sort(score)
    _, inv, counts = torch.unique_consecutive(s, return_inverse=True,
                                              return_counts=True)
    last = torch.cumsum(counts, 0).to(torch.float64)
    avg_rank = last - (counts.to(torch.float64) - 1.0) / 2.0
    ranks = avg_rank[inv]
    rank_pos = ranks[pos[order]].sum()
    return float((rank_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def evaluate(metric: str, score: torch.Tensor,
             label: torch.Tensor) -> Dict[str, float]:
    """{name as the program's evals_result keys it: value}."""
    if metric == "auc":
        return {"auc": auc(score, label)}
    raise ValueError(f"no reference for metric {metric!r}")
