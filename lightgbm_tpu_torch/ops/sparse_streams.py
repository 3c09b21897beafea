"""Column-sorted entry streams of the sparse CSR/ELL store, and the K-leaf
histogram over them (kernels K7 and K8 of csrc/hist_sparse.cu).

Port of the stream half of lightgbm_tpu/ops/histogram.py:
`sparse_window_streams` sorted the store's entries by column once per
dataset, so that each TPU grid cell owned a window of columns; here the
same stable sort gives each CUDA block one column (`build_sparse_streams`,
run on the device when the rounds learner is built).  The streams are
`col_off [C+1]` int64, `e_row [nnz]` int32 (ascending within a column)
and `e_bin [nnz]` uint8 (uint16 when a stored bin reaches 256): 5 bytes
an entry beside the ELL arrays, which the partition and the valid-set
walk still read by row.

`hist_streams` is the whole sparse pass after the per-pass set-up (slot
of every row, quantized or float values, slot totals, dequantize
scales): the stored-entry sums, each column's zero bin rebuilt as slot
totals minus the column's stored sums, and, for int8, one dequantize.
A CUDA tensor launches K7 (int32 values) or K8 (float32) and raises if
the launch is refused; a CPU tensor takes the plain version,
`hist_streams_plain`, which computes the same function with index_add_.
The per-pass set-up's slot totals have a kernel pair of the same source
(`_slot_totals_cuda`, sums in an order fixed by the inputs) and a plain
version (`slot_totals_plain`, index_add_); ops/histogram.py
`_slot_totals` dispatches between them.  K7, K8 and the slot totals give
the same bits on every run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from .. import kernels

# entries one block adds before a column splits into chunks (one block
# each, summed by the last to finish): the longest ctr column (~500k
# entries) stays whole
SPARSE_BLOCK_ENTRIES = 1 << 20
# shared memory a block's histogram of k_tile slots may take; K is cut
# into slot tiles above it (two blocks of this size fit on an SM)
SPARSE_SMEM_BUDGET = 96 * 1024
# the same for K8, whose block also stages a step's entries in shared
# memory (csrc/hist_sparse.cu kStageBytes): a K=31 ctr pass in one tile
SPARSE_SMEM_BUDGET_F32 = 24 * 1024
# the most dynamic shared memory an H100 block may opt in to
_SMEM_MAX = 227 * 1024
# rows one block of the slot-totals kernel sums: at least this many, and
# few enough for at most _TOTALS_BLOCKS blocks
_TOTALS_MIN_ROWS = 2048
_TOTALS_BLOCKS = 1024


@dataclass
class WorkPlan:
    """The kernel's work items for one chunk length: (column, chunk)
    pairs, heaviest column first, every column at least once (an empty
    column still writes its zero bin)."""
    w_col: torch.Tensor       # [W] int32 column of each work item
    w_chunk: torch.Tensor     # [W] int32 chunk index within the column
    c_long: torch.Tensor      # [C] int32 index among multi-chunk columns
    long_base: torch.Tensor   # [n_long] int32 first scratch part of each
    n_long: int               # columns of more than one chunk
    n_parts: int              # chunks of those columns


@dataclass
class SparseStreams:
    """The store's entries sorted by column (stable: ascending rows within
    a column), with the column order the kernel walks."""
    col_off: torch.Tensor     # [C+1] int64 first entry of each column
    e_row: torch.Tensor       # [nnz] int32
    e_bin: torch.Tensor       # [nnz] uint8 / uint16
    order: torch.Tensor       # [C] int64 columns by descending entry count
    num_bins: int             # 1 + the largest stored bin (at least 1)
    _plans: Dict[int, WorkPlan] = field(default_factory=dict, repr=False)

    @property
    def num_columns(self) -> int:
        return int(self.col_off.shape[0]) - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.col_off, self.e_row, self.e_bin,
                             self.order))

    def plan(self, chunk: int) -> WorkPlan:
        """The work items at `chunk` entries a block, built once per
        chunk length (it reads three sizes back to the host)."""
        p = self._plans.get(chunk)
        if p is None:
            p = self._plans[chunk] = _work_plan(self.col_off, self.order,
                                                chunk)
        return p


def build_sparse_streams(cols: torch.Tensor, binsv: torch.Tensor,
                         num_columns: int) -> SparseStreams:
    """Sort the ELL entries (cols/binsv [N, R], col >= num_columns or < 0
    an empty slot) by column, stably, on the tensors' device: per column,
    its (row, bin) entries in ascending row order — the order of
    `np.argsort(c_e, kind="stable")` in the JAX package's
    `sparse_window_streams`."""
    N, R = cols.shape
    C = int(num_columns)
    dev = cols.device
    flat = cols.reshape(-1)
    pos = torch.nonzero((flat >= 0) & (flat < C)).squeeze(1)   # row-major
    col = flat[pos]
    col, perm = torch.sort(col, stable=True)
    pos = pos[perm]
    del perm
    e_row = torch.div(pos, R, rounding_mode="floor").to(torch.int32)
    e_bin = binsv.reshape(-1)[pos]
    del pos
    top = int(e_bin.max()) if e_bin.numel() else 0
    e_bin = e_bin.to(torch.uint8 if top < 256 else torch.uint16)
    cnt = torch.bincount(col, minlength=C)[:C]
    del col
    col_off = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    col_off[1:] = torch.cumsum(cnt, 0)
    order = torch.sort(cnt, descending=True, stable=True).indices
    st = SparseStreams(col_off=col_off, e_row=e_row, e_bin=e_bin,
                       order=order, num_bins=max(1, top + 1))
    st.plan(SPARSE_BLOCK_ENTRIES)
    return st


def _work_plan(col_off: torch.Tensor, order: torch.Tensor,
               chunk: int) -> WorkPlan:
    dev = col_off.device
    cnt = col_off[1:] - col_off[:-1]
    nch = torch.clamp(torch.div(cnt + chunk - 1, chunk,
                                rounding_mode="floor"), min=1)
    nch_o = nch[order]
    w_col = torch.repeat_interleave(order, nch_o)
    first = torch.cumsum(nch_o, 0) - nch_o
    w_chunk = (torch.arange(w_col.shape[0], device=dev)
               - torch.repeat_interleave(first, nch_o))
    is_long = nch > 1
    n_long = int(is_long.sum())
    c_long = torch.full_like(cnt, -1)
    c_long[is_long] = torch.arange(n_long, device=dev)
    nl = nch[is_long]
    long_base = torch.cumsum(nl, 0) - nl
    return WorkPlan(w_col=w_col.to(torch.int32),
                    w_chunk=w_chunk.to(torch.int32),
                    c_long=c_long.to(torch.int32),
                    long_base=long_base.to(torch.int32), n_long=n_long,
                    n_parts=int(nl.sum()))


def slot_budget(quantized: bool) -> int:
    """The shared-memory budget of a block's slot tile: K7's, or K8's."""
    return SPARSE_SMEM_BUDGET if quantized else SPARSE_SMEM_BUDGET_F32


def slot_tile(K: int, nb: int, budget: int, rows: int = 3) -> int:
    """Slots one block histograms: as many slots of `rows` words a bin
    (grad, hess and count: csrc/hist_sparse.cu; an odd bin stride) as
    fit the shared-memory budget, at least one, with K cut into tiles of
    equal size (the last one at most as large)."""
    per_slot = rows * (nb | 1) * 4
    if per_slot > _SMEM_MAX:
        raise ValueError(f"sparse histogram kernel supports up to "
                         f"{_SMEM_MAX // (4 * rows) - 1} bins, got {nb}")
    most = max(1, min(K, budget // per_slot))
    return -(-K // -(-K // most))


def apply_zero_bin(hist: torch.Tensor, tot: torch.Tensor,
                   zero_bin: torch.Tensor) -> torch.Tensor:
    """Add each store column's implicit-zero bin in place: slot totals
    minus the stored-entry sums, at the column's zero bin.  hist
    [K, C, 3, B] (stored entries only), tot [K, 3], zero_bin [C] (-1 on
    padded columns, which keep their stored sums).  Exact in the int32
    lanes."""
    K, C, _, B = hist.shape
    colsum = hist.sum(dim=3, dtype=hist.dtype)             # [K, C, 3]
    resid = torch.where((zero_bin >= 0)[None, :, None],
                        tot[:, None, :] - colsum,
                        torch.zeros((), dtype=hist.dtype,
                                    device=hist.device))
    zb = torch.clamp(zero_bin, 0, B - 1).long()
    ar = torch.arange(C, device=hist.device)
    # the advanced axes (column, zero bin) move first: [C, K, 3]
    hist[:, ar, :, zb] += resid.permute(1, 0, 2)
    return hist


def finish_sparse_hist(hist: torch.Tensor, tot: torch.Tensor,
                       zero_bin: torch.Tensor,
                       scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero bins, then (int32 sums, `scale` = (sg, sh, 1)) the one
    dequantize of the JAX function: float32 [K, C, 3, B]."""
    hist = apply_zero_bin(hist, tot, zero_bin)
    if scale is None:
        return hist
    return hist.to(torch.float32).mul_(scale[None, None, :, None])


def hist_streams_plain(st: SparseStreams, zero_bin: torch.Tensor,
                       srow: torch.Tensor, vals: torch.Tensor,
                       tot: torch.Tensor, scale: Optional[torch.Tensor],
                       K: int, Cp: int, B: int) -> torch.Tensor:
    """Plain version of K7/K8: one index_add_ per channel of the stream
    entries' values vals [3, N] (int32 exactly, or float32) at
    [srow[row], column, channel, min(bin, B-1)] over the entries of rows
    with srow < K, then `finish_sparse_hist`.  Returns float32
    [K, Cp, 3, B]."""
    dev = st.e_row.device
    out = torch.zeros(K * Cp * 3 * B, dtype=vals.dtype, device=dev)
    col = torch.repeat_interleave(torch.arange(Cp, device=dev),
                                  st.col_off[1:] - st.col_off[:-1])
    r = st.e_row.long()
    s = srow.long()[r]
    keep = s < K
    r, col = r[keep], col[keep]
    b = torch.clamp(st.e_bin[keep].long(), max=B - 1)
    base = (s[keep] * Cp + col) * (3 * B) + b
    del s, keep, col, b
    for ch in range(3):
        out.index_add_(0, base + ch * B, vals[ch, r])
    return finish_sparse_hist(out.view(K, Cp, 3, B), tot, zero_bin, scale)


def _hist_streams_cuda(st: SparseStreams, zero_bin: torch.Tensor,
                       srow: torch.Tensor, vals: torch.Tensor,
                       tot: torch.Tensor, scale: Optional[torch.Tensor],
                       K: int, Cp: int, B: int) -> torch.Tensor:
    """Kernels K7 (int32 vals) and K8 (float32 vals), csrc/hist_sparse.cu,
    with the plain version's contract."""
    N = srow.shape[0]
    quant = not vals.is_floating_point()
    dev = st.e_row.device
    if st.num_columns != Cp or zero_bin.shape != (Cp,) \
            or zero_bin.dtype != torch.int32:
        raise ValueError(f"streams over {st.num_columns} columns and "
                         f"zero_bin {tuple(zero_bin.shape)} for Cp={Cp}")
    if srow.dtype != torch.int32 or srow.shape != (N,):
        raise TypeError("sparse histogram kernel takes int32 srow [N]")
    if vals.dtype not in (torch.int32, torch.float32) \
            or vals.shape != (3, N):
        raise TypeError("sparse histogram kernel takes [3, N] int32 or "
                        "float32 vals")
    if tot.dtype != vals.dtype or tot.shape != (K, 3):
        raise TypeError("slot totals must be [K, 3] of the values' type")
    if quant != (scale is not None):
        raise ValueError("int32 values take a dequantize scale, float32 "
                         "values none")
    if st.e_bin.dtype not in (torch.uint8, torch.uint16):
        raise TypeError("entry bins must be uint8 or uint16")
    out = torch.empty((K, Cp, 3, B), dtype=torch.float32, device=dev)
    if K == 0 or Cp == 0 or B == 0:
        return out
    nb = min(st.num_bins, B)
    k_tile = slot_tile(K, nb, slot_budget(quant))
    n_tiles = -(-K // k_tile)
    chunk = SPARSE_BLOCK_ENTRIES
    plan = st.plan(chunk)
    # the kernel's per-pass row table (a 16-byte record a row: slot and
    # the bits of the 3 values) and live-row bitmask of each slot tile,
    # filled by the kernel
    rec = torch.empty((N, 4), dtype=torch.int32, device=dev)
    live = torch.empty(n_tiles * -(-N // 32), dtype=torch.int32,
                       device=dev)
    srow = srow.contiguous()
    vals = vals.contiguous()
    tot = tot.contiguous()
    scratch = tickets = None
    if plan.n_long:
        scratch = torch.empty(plan.n_parts * n_tiles * k_tile * 3 * nb,
                              dtype=vals.dtype, device=dev)
        tickets = torch.zeros(plan.n_long * n_tiles, dtype=torch.int32,
                              device=dev)
    scale = None if scale is None else scale.to(torch.float32).contiguous()
    kernels.call("hist_sparse", st.col_off.data_ptr(), st.e_row.data_ptr(),
                 st.e_bin.data_ptr(), st.e_bin.element_size(),
                 plan.w_col.data_ptr(), plan.w_chunk.data_ptr(),
                 plan.w_col.shape[0], chunk, plan.c_long.data_ptr(),
                 plan.long_base.data_ptr(), srow.data_ptr(), vals.data_ptr(),
                 N, live.data_ptr(), rec.data_ptr(), tot.data_ptr(),
                 kernels.ptr(scale), int(quant), zero_bin.data_ptr(), K,
                 k_tile, Cp, B, nb, kernels.ptr(scratch),
                 kernels.ptr(tickets), out.data_ptr())
    kernels.LAUNCHES["hist_sparse_int8" if quant else "hist_sparse_f32"] += 1
    return out


def hist_streams(st: SparseStreams, zero_bin: torch.Tensor,
                 srow: torch.Tensor, vals: torch.Tensor, tot: torch.Tensor,
                 scale: Optional[torch.Tensor], K: int, Cp: int,
                 B: int) -> torch.Tensor:
    """Dispatch: K7/K8 for CUDA tensors, the plain version for CPU
    tensors."""
    fn = _hist_streams_cuda if st.e_row.is_cuda else hist_streams_plain
    return fn(st, zero_bin, srow, vals, tot, scale, K, Cp, B)


def slot_totals_plain(srow: torch.Tensor, vals: torch.Tensor,
                      K: int) -> torch.Tensor:
    """Plain version of the slot-totals kernels: [K, 3] sums of vals
    [3, N] over the rows of each slot (srow [N], K or more = none) by
    index_add_, which adds in row order on the CPU."""
    tot = torch.zeros((K + 1, 3), dtype=vals.dtype, device=vals.device)
    idx = torch.clamp(srow.long(), max=K)
    return tot.index_add_(0, idx, vals[:3].t())[:K]


def _slot_totals_cuda(srow: torch.Tensor, vals: torch.Tensor,
                      K: int) -> torch.Tensor:
    """The slot-totals kernels of csrc/hist_sparse.cu: each block of
    `rows` rows sums its rows' values per slot, then one warp per (slot,
    channel) sums the blocks in order, with the plain version's
    contract."""
    N = srow.shape[0]
    if srow.dtype != torch.int32 or srow.shape != (N,):
        raise TypeError("slot totals take int32 srow [N]")
    vals = vals[:3]
    if vals.dtype not in (torch.int32, torch.float32) \
            or vals.shape != (3, N):
        raise TypeError("slot totals take [3, N] int32 or float32 vals")
    dev = srow.device
    tot = torch.empty((K, 3), dtype=vals.dtype, device=dev)
    if K == 0:
        return tot
    rows = max(_TOTALS_MIN_ROWS, -(-N // (_TOTALS_BLOCKS * 256)) * 256)
    partial = torch.empty(-(-N // rows) * K * 3, dtype=vals.dtype,
                          device=dev)
    srow = srow.contiguous()
    vals = vals.contiguous()
    kernels.call("slot_totals", srow.data_ptr(), vals.data_ptr(), N, K,
                 int(not vals.is_floating_point()), rows, partial.data_ptr(),
                 tot.data_ptr())
    kernels.LAUNCHES["slot_totals"] += 1
    return tot
