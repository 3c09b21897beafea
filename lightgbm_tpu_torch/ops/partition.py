"""Row partition of one boosting round (kernel K4, and the sparse store).

Port of lightgbm_tpu/ops/partition.py `partition_rows` for the 7-row
table the learner builds, with the contract of the JAX function's XLA
branch, and `partition_rows_sparse` over the CSR/ELL store.
On the GPU the whole step — per-leaf table lookup, the row's bin of its
split column, the left/right decision and the new leaf id — is one
kernel, csrc/partition.cu, with the table decoded into shared memory
(no int8 base-128 encoding: that existed only for the TPU's one-hot
matmul).  It reads the bins from the int32 or int8 [F, N] store, 4 rows
a thread, and no bin of a row whose leaf does not split.  The plain
PyTorch version beside it is what a CPU tensor takes.
"""
from __future__ import annotations

import torch

from .. import kernels
from .lookup import _lookup_plain, table_lookup
from .predict import sparse_bin_lookup


def _partition_plain(bins_fn: torch.Tensor, leaf_id: torch.Tensor,
                     tbl: torch.Tensor) -> torch.Tensor:
    r = _lookup_plain(tbl, leaf_id)
    fi = r[0].to(torch.int32)
    ti = r[1].to(torch.int32)
    ci = r[2] > 0
    nli = r[3].to(torch.int32)
    lo = r[4].to(torch.int32)
    hi1 = r[5].to(torch.int32)
    dl = r[6] > 0
    F = bins_fn.shape[0]
    off = 128 if bins_fn.dtype == torch.int8 else 0
    ok = (fi >= 0) & (fi < F)
    v = bins_fn.gather(0, fi.clamp(0, F - 1).long()[None, :])[0]
    vi = torch.where(ok, v.to(torch.int32), 0) + off
    gl = torch.where(ci, vi == ti, vi <= ti)
    gl = torch.where((vi >= lo) & (vi <= hi1), gl, dl)
    return torch.where((nli > 0) & ~gl, nli, leaf_id)


def _partition_cuda(bins_fn: torch.Tensor, leaf_id: torch.Tensor,
                    tbl: torch.Tensor) -> torch.Tensor:
    F, N = bins_fn.shape
    S = tbl.shape[1]
    if bins_fn.dtype not in (torch.int32, torch.int8):
        raise TypeError("partition kernel takes int32 or int8 bins")
    if leaf_id.dtype != torch.int32 or leaf_id.shape != (N,):
        raise TypeError("partition kernel takes int32 leaf ids [N]")
    if tbl.dtype != torch.float32 or tbl.shape[0] != 7:
        raise TypeError("partition kernel takes a float32 [7, S] table")
    bins_fn = bins_fn.contiguous()
    leaf_id = leaf_id.contiguous()
    tbl = tbl.contiguous()
    out = torch.empty_like(leaf_id)
    if N == 0:
        return out
    kernels.call("partition", tbl.data_ptr(), S, bins_fn.data_ptr(),
                 int(bins_fn.dtype == torch.int8), F, N, leaf_id.data_ptr(),
                 out.data_ptr())
    kernels.LAUNCHES["partition_rows"] += 1
    return out


def partition_rows(bins_fn: torch.Tensor, leaf_id: torch.Tensor,
                   tbl: torch.Tensor) -> torch.Tensor:
    """New leaf id per row after this round's splits.

    bins_fn [F, N] int STORE bins (int8 = value-128 storage); leaf_id [N]
    int32; tbl [7, S] f32 rows (store column, threshold T, is-categorical,
    new leaf id, window lo, window hi inclusive, default-left) indexed by
    leaf.  Row values of non-splitting leaves must be 0 (new leaf 0
    means "stay").  The table's width bounds the leaf ids (the JAX
    function's num_slots).

    A CUDA tensor launches kernel K4 (csrc/partition.cu); a CPU tensor
    takes the plain version."""
    if bins_fn.is_cuda:
        return _partition_cuda(bins_fn, leaf_id, tbl)
    return _partition_plain(bins_fn, leaf_id, tbl)


def partition_rows_sparse(cols: torch.Tensor, binsv: torch.Tensor,
                          zero_bin: torch.Tensor, leaf_id: torch.Tensor,
                          tbl: torch.Tensor) -> torch.Tensor:
    """partition_rows over the CSR/ELL sparse store.

    cols/binsv [N, R] int32 per-row (store column, bin) entries (a column
    >= C marks an empty slot); zero_bin [C] int32.  The row's bin of its
    leaf's split column is an ELL probe — R compares per row — falling
    back to the column's zero bin when the row stores no entry there.
    Table semantics match partition_rows exactly (new leaf 0 = stay).
    In JAX this is XLA ops around a table lookup, not a TPU kernel; here
    it is torch ops around kernel K3 (table_lookup)."""
    r = table_lookup(tbl, leaf_id)
    fi = r[0].to(torch.int32)
    ti = r[1].to(torch.int32)
    ci = r[2] > 0
    nli = r[3].to(torch.int32)
    lo = r[4].to(torch.int32)
    hi1 = r[5].to(torch.int32)
    dl = r[6] > 0
    vi = sparse_bin_lookup(cols, binsv, zero_bin, fi)
    gl = torch.where(ci, vi == ti, vi <= ti)
    gl = torch.where((vi >= lo) & (vi <= hi1), gl, dl)
    return torch.where((nli > 0) & ~gl, nli, leaf_id)
