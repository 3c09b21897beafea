"""The rows a run hands to the program, and the plain view of them that
the reference reads."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass
class Split:
    """One set of rows as the program gets it: X a float64 [n, F] array,
    y float64 labels."""
    X: np.ndarray
    y: np.ndarray

    @property
    def num_rows(self) -> int:
        return int(self.X.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.X.shape[1])


def columns(split: Split, feats: Sequence[int],
            device: torch.device) -> torch.Tensor:
    """[n, len(feats)] float64 raw values of the given features, on the
    device."""
    feats = [int(f) for f in feats]
    return torch.as_tensor(np.ascontiguousarray(split.X[:, feats]),
                           device=device)
