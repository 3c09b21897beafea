"""HIGGS-shaped binary rows: `features` standard-normal float64 columns
(drawn in float32), labelled by a fixed function of them — a linear
part with weights from seed 0, plus 0.5 sin(2 x0) x1 - 0.3 x2 x3 — with
0.5 x logistic noise.  The distribution of the repository's
synth_higgs, drawn on the device.

The rows are drawn once, from the configuration's `rows_seed`; the
run's seed draws their order.  Fresh rows for every seed would change
the trees, and with them the work of an iteration, by more than a run
spreads: every seed gets the same set of rows, in another order."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..data import Split


def label_weights(f: int, scale: float) -> torch.Tensor:
    """The fixed labelling weights: RandomState(0) normals / scale, as
    synth_higgs draws them."""
    return torch.as_tensor(np.random.RandomState(0).randn(f) / scale)


def _logistic(n: int, g: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
    u = u.clamp_(1e-12, 1.0 - 1e-12)
    return torch.log(u) - torch.log1p(-u)


def draw(n: int, f: int, g: torch.Generator, device):
    """([n, f] float64 rows, [n] 0/1 labels) on the device."""
    X = torch.randn(n, f, generator=g, dtype=torch.float32,
                    device=device).double()
    w = label_weights(f, math.sqrt(f)).to(device)
    logit = (X @ w + 0.5 * torch.sin(2.0 * X[:, 0]) * X[:, 1]
             - 0.3 * X[:, 2] * X[:, 3])
    y = (logit + 0.5 * _logistic(n, g, device) > 0).double()
    return X, y


def make(cfg: Dict, seed: int, device) -> Tuple[Split, Split]:
    rows = torch.Generator(device=device).manual_seed(int(cfg["rows_seed"]))
    order = torch.Generator(device=device).manual_seed(int(seed))
    f = int(cfg["features"])
    out = []
    for n in (int(cfg["rows"]), int(cfg["valid_rows"])):
        X, y = draw(n, f, rows, device)
        p = torch.randperm(n, generator=order, device=device)
        out.append(Split(X[p].cpu().numpy(), y[p].cpu().numpy()))
    return out[0], out[1]
