"""Small-table row lookups (kernel K3).

Port of lightgbm_tpu/ops/lookup.py.  The TPU ran `table[ids]` as a
one-hot matmul because its vector gather is slow; the GPU gathers
directly, in csrc/lookup.cu, which can also fuse the score add of
boosting/score_updater.py.  The plain PyTorch version beside it is what
a CPU tensor takes and what the kernel is held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels


def _lookup_plain(tables: torch.Tensor, ids: torch.Tensor,
                  addend: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[t, n] = tables[t, ids[n]] (0.0 for ids outside [0, S)), plus
    addend[t, n] when given."""
    S = tables.shape[1]
    ok = (ids >= 0) & (ids < S)
    val = tables[:, ids.clamp(0, max(S - 1, 0)).long()]
    val = torch.where(ok[None, :], val, torch.zeros((), dtype=tables.dtype,
                                                    device=tables.device))
    res = val if addend is None else addend + val
    if out is None:
        return res
    return out.copy_(res)


def _lookup_cuda(tables: torch.Tensor, ids: torch.Tensor,
                 addend: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    T, S = tables.shape
    N = ids.shape[0]
    if tables.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("table_lookup kernel takes float32 tables and "
                        "int32 ids")
    tables = tables.contiguous()
    ids = ids.contiguous()
    if addend is not None:
        if addend.shape != (T, N) or addend.dtype != torch.float32:
            raise ValueError("addend must be float32 [T, N]")
        addend = addend.contiguous()
    if out is None:
        out = torch.empty((T, N), dtype=torch.float32, device=tables.device)
    elif (out.shape != (T, N) or out.dtype != torch.float32
          or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 [T, N]")
    if N == 0:
        return out
    kernels.call("lookup", tables.data_ptr(), T, S, ids.data_ptr(), N,
                 kernels.ptr(addend), out.data_ptr())
    kernels.LAUNCHES["table_lookup"] += 1
    return out


def table_lookup(tables: torch.Tensor, ids: torch.Tensor, *,
                 addend: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tables [T, S] f32, ids [N] int32 -> [T, N] f32 with
    out[t, n] = tables[t, ids[n]] and 0.0 for ids outside [0, S).  Exact
    for any f32 table values.  With `addend` [T, N] the result is
    addend + lookup (the fused score add).  With `out` [T, N] (which may
    be the addend itself: each element is read before it is written) the
    result is written there and `out` returned.  The table's width bounds
    the ids (the JAX function's num_slots).

    A CUDA tensor launches kernel K3 (csrc/lookup.cu); a CPU tensor takes
    the plain version."""
    if tables.is_cuda:
        return _lookup_cuda(tables, ids, addend, out)
    return _lookup_plain(tables, ids, addend, out)


def select_bin_by_feature(bins_fn: torch.Tensor,
                          fi: torch.Tensor) -> torch.Tensor:
    """Per-row bin of that row's feature: bins_fn [F, N] int, fi [N] int
    -> [N] int32 (rows whose fi names no feature yield 0).  An int8 store
    holds value - 128 (the rounds learner's byte store)."""
    F = bins_fn.shape[0]
    ok = (fi >= 0) & (fi < F)
    v = bins_fn.gather(0, fi.clamp(0, F - 1).long()[None, :])[0].to(
        torch.int32)
    if bins_fn.dtype == torch.int8:
        v = v + 128
    return torch.where(ok, v,
                       torch.zeros((), dtype=torch.int32,
                                   device=bins_fn.device))
