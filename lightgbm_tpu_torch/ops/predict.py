"""Device-side binned prediction helpers.

Port of lightgbm_tpu/ops/predict.py `sparse_bin_lookup`: the bin of a
requested store column per row, read straight off the CSR/ELL row
entries — the probe the valid-set walk (boosting/score_updater.py) and
the sparse row partition (ops/partition.py) share, so a sparse store is
never densified to be scored.  The ensemble predictors of the JAX module
are later slices (ROADMAP.md §A item 8).
"""
from __future__ import annotations

import torch


def sparse_bin_lookup(cols: torch.Tensor, binsv: torch.Tensor,
                      zero_bin: torch.Tensor,
                      col: torch.Tensor) -> torch.Tensor:
    """Store bin id per requested column.

    cols/binsv [N, R] int ELL entries (a column >= C marks an empty slot
    and never matches a request); zero_bin [C] int32 (-1 only on padded
    columns no tree names); col [N] int32 requested store columns.  A
    stored entry answers directly; otherwise the column's zero bin
    (clamped at 0).  Returns [N] int32."""
    hit = cols == col[:, None]                                  # [N, R]
    bv = torch.where(hit, binsv.to(torch.int32),
                     torch.zeros((), dtype=torch.int32,
                                 device=cols.device)).sum(
                                     dim=1, dtype=torch.int32)
    C = zero_bin.shape[0]
    zb = torch.clamp(zero_bin[torch.clamp(col, 0, C - 1).long()], min=0)
    return torch.where(hit.any(dim=1), bv, zb).to(torch.int32)
