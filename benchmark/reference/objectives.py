"""Gradients and hessians of the objectives, plainly and in float64.

binary (LightGBM's BinaryLogloss, sigmoid s, labels 0/1 as -1/+1):
    r = -y s / (1 + exp(y s f)),  g = r,  h = |r| (s - |r|)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def binary(score: torch.Tensor, label: torch.Tensor,
           sigmoid: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    y = torch.where(label > 0, 1.0, -1.0).to(torch.float64)
    r = -y * sigmoid / (1.0 + torch.exp(y * sigmoid * score))
    return r, r.abs() * (sigmoid - r.abs())


def gradients(objective: str, score: torch.Tensor, label: torch.Tensor,
              params: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    if objective == "binary":
        return binary(score, label, float(params.get("sigmoid", 1.0)))
    raise ValueError(f"no reference for objective {objective!r}")
