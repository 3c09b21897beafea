"""Histograms: the gather-fed dense half (kernels K5, K6) and the K-leaf
histograms of the batched-rounds learner (kernels K1, K2, K7, K8).

Port of lightgbm_tpu/ops/histogram.py.  The gather-fed half:
`hist_xla` (the plain version of K5), `hist_pallas` (K5's wrapper),
`histogram_from_indices` (one leaf's histogram over an index vector, the
exact leaf-wise learner's feed), `hist_multileaf_xla` (the plain version
of K6), `hist_pallas_multileaf` / `hist_multileaf` (K6's wrappers) and
`_coerce_dtype`.  Their output is [F, 3, B] (or [F, M, B]) float32.  The
JAX functions took `backend=` and `interpret=`; here, as in every
wrapper of the port, the tensor's device decides: a CUDA tensor launches
the kernel of csrc/hist_gathered.cu, a CPU tensor takes the plain
version.

The rounds learner's part: `_quantize_gh`, `hist_multileaf_masked`,
`gather_segments` and `hist_multileaf_gathered` over the dense store,
and the sparse half (`hist_sparse_xla`, `hist_sparse_multileaf`,
`hist_sparse_gathered` and their helpers) over the CSR/ELL store.
Output layout is the JAX one: [K, F, 3, B] float32, channels (sum_grad,
sum_hess, count) per slot, feature (store column) and bin.

The TPU kernels built one-hot matrices and contracted them on the MXU;
the CUDA kernels (csrc/histogram.cu) scatter each row into a per-block
shared-memory histogram with atomics instead.  K1 (int8 gradients)
accumulates exactly in int32, so it is bitwise equal to its plain
version and to the JAX kernel; K2 (float32 / bfloat16 operands)
accumulates with float atomics, whose order varies run to run.

int8 quantization (`_quantize_gh`) and the dequantize stay outside the
kernel, as plain torch ops, exactly as in JAX.  In the gathered row feed
the kernel reads each scratch position's bins through the row index
(`row_idx`) instead of materializing the gathered [F, capacity] copy.

Over the sparse store `hist_sparse_multileaf` runs the CUDA kernels K7
(int8) and K8 (float32) of csrc/hist_sparse.cu over the store's
column-sorted entry streams (ops/sparse_streams.py, the GPU form of the
JAX package's `sparse_window_streams`): each block owns one column's
histogram in shared memory and writes it once, with the column's zero
bin and the int8 dequantize applied.  On the CPU it takes
`hist_sparse_xla`, the JAX function's formulation over the ELL arrays
(stored-entry sums, then the zero bins from each slot's totals).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels, log
from .sparse_streams import (build_sparse_streams, finish_sparse_hist,
                             hist_streams)

# int32-accumulator bound: with constant hessians every row quantizes to
# 127, so one bin can reach 127 * C; above 16M rows per pass the int8
# path switches to bfloat16 operands (lightgbm_tpu/ops/histogram.py)
INT8_MAX_ROWS = 16_000_000

# f32 reciprocal of the int8 range (see _quantize_gh)
_INV127 = float(np.float32(1.0 / 127.0))

# whether _coerce_dtype has warned (it warns once per process)
_INT8_COERCED = False


# ----------------------------------------------------------------------------
# Gather-fed dense histograms (kernels K5 and K6)
# ----------------------------------------------------------------------------

def _coerce_dtype(input_dtype: str) -> str:
    """int8 means caller-side gradient quantization, which only the
    rounds learner's histograms implement; a bare int8 cast would
    truncate real-valued gradients, so the gather-fed histograms run
    float32 instead and say so, once."""
    global _INT8_COERCED
    if input_dtype == "int8":
        if not _INT8_COERCED:
            log.warning("histogram_dtype=int8 is only supported by the "
                        "batched-rounds learner; using float32 here")
            _INT8_COERCED = True
        return "float32"
    return input_dtype


def _operands(vals: torch.Tensor, input_dtype: str) -> torch.Tensor:
    """float32 operands, rounded to bfloat16 first in bfloat16 mode (the
    JAX functions' `vals.astype(input_dtype)`)."""
    vals = vals.to(torch.float32)
    if input_dtype == "bfloat16":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    return vals


def _rows_hist_plain(gb_t: torch.Tensor, vals: torch.Tensor,
                     B: int) -> torch.Tensor:
    """[F, M, B] float32 sums of vals [M, C] over the positions whose bin
    gb_t [F, C] falls in each bin; bins outside [0, B) add nothing."""
    F, C = gb_t.shape
    M = vals.shape[0]
    dev = gb_t.device
    # out-of-range bins add into one extra cell that is sliced off
    out = torch.zeros(F * M * B + 1, dtype=torch.float32, device=dev)
    b = gb_t.long()
    ok = ((b >= 0) & (b < B)).reshape(-1)
    base = (torch.arange(F, device=dev)[:, None] * (M * B) + b).reshape(-1)
    dump = torch.full((), F * M * B, device=dev)
    for m in range(M):
        out.index_add_(0, torch.where(ok, base + m * B, dump),
                       vals[m][None, :].expand(F, C).reshape(-1))
    return out[:F * M * B].view(F, M, B)


def _gathered_cuda(bins: torch.Tensor, row_stride: int, feat_stride: int,
                   F: int, idx: Optional[torch.Tensor], C: int,
                   g: torch.Tensor, h: torch.Tensor,
                   m: Optional[torch.Tensor], n_live: int, B: int,
                   input_dtype: str) -> torch.Tensor:
    """Kernel K5 (csrc/hist_gathered.cu): [F, 3, B] float32 sums of
    (g[r], h[r], m[r] or r < n_live) over the rows r of the C positions
    (r = idx[p], or p without an index), bin of (r, f) at
    bins[r * row_stride + f * feat_stride]."""
    if bins.dtype != torch.int32:
        raise TypeError("gathered histogram kernel takes int32 bins")
    if idx is not None and (idx.dtype != torch.int32 or idx.shape != (C,)):
        raise TypeError("gathered histogram kernel takes int32 idx [C]")
    for t in (g, h) + ((m,) if m is not None else ()):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("gathered histogram kernel takes contiguous "
                            "float32 value rows")
    out = torch.zeros((F, 3, B), dtype=torch.float32, device=bins.device)
    if C == 0 or F == 0:
        return out
    kernels.call("hist_gathered", bins.data_ptr(), row_stride, feat_stride,
                 F, kernels.ptr(idx), C, g.data_ptr(), h.data_ptr(),
                 kernels.ptr(m), n_live, B, int(input_dtype == "bfloat16"),
                 out.data_ptr())
    kernels.LAUNCHES["hist_gathered"] += 1
    return out


def hist_xla(gb: torch.Tensor, vals: torch.Tensor, *, num_bins_padded: int,
             input_dtype: str = "float32") -> torch.Tensor:
    """The plain version of kernel K5, on any device: gb [C, F] integer
    bins of the gathered rows (sentinel rows carry zero vals), vals
    [3, C] (grad, hess, count mask) -> [F, 3, B] float32."""
    input_dtype = _coerce_dtype(input_dtype)
    return _rows_hist_plain(gb.t(), _operands(vals[:3], input_dtype),
                            num_bins_padded)


def hist_pallas(gb_t: torch.Tensor, vals8: torch.Tensor, *,
                num_bins_padded: int,
                input_dtype: str = "bfloat16") -> torch.Tensor:
    """One-leaf histogram of gathered rows: gb_t [F, C] int32, vals8
    [>=3, C] float32 (grad, hess, mask, padding rows) -> [F, 3, B]
    float32.  A CUDA tensor launches kernel K5, reading gb_t in place; a
    CPU tensor takes the plain version (`hist_xla`)."""
    input_dtype = _coerce_dtype(input_dtype)
    if not gb_t.is_cuda:
        return hist_xla(gb_t.t(), vals8[:3], num_bins_padded=num_bins_padded,
                        input_dtype=input_dtype)
    F, C = gb_t.shape
    gb_t = gb_t.contiguous()
    v = vals8[:3].to(torch.float32).contiguous()
    return _gathered_cuda(gb_t, 1, C, F, None, C, v[0], v[1], v[2], C,
                          num_bins_padded, input_dtype)


def _from_indices_plain(bins_t: torch.Tensor, grad_pad: torch.Tensor,
                        hess_pad: torch.Tensor, idx: torch.Tensor, B: int,
                        input_dtype: str = "float32") -> torch.Tensor:
    """The plain version of histogram_from_indices on any device: gather
    the rows, then `hist_xla`'s sums."""
    N = grad_pad.shape[0] - 1
    il = idx.long()
    vals = torch.stack([grad_pad[il], hess_pad[il],
                        (idx < N).to(torch.float32)])
    return _rows_hist_plain(bins_t[il].t(), _operands(vals, input_dtype), B)


def _from_indices_cuda(bins_t: torch.Tensor, grad_pad: torch.Tensor,
                       hess_pad: torch.Tensor, idx: torch.Tensor, B: int,
                       input_dtype: str = "float32") -> torch.Tensor:
    """Kernel K5 with histogram_from_indices' contract: each position's
    row bins are read through idx in the [N+1, F] store."""
    N = grad_pad.shape[0] - 1
    F = bins_t.shape[1]
    return _gathered_cuda(bins_t.contiguous(), F, 1, F,
                          idx.to(torch.int32).contiguous(), idx.shape[0],
                          grad_pad.contiguous(), hess_pad.contiguous(), None,
                          N, B, input_dtype)


def histogram_from_indices(bins_t: torch.Tensor, grad_pad: torch.Tensor,
                           hess_pad: torch.Tensor, idx: torch.Tensor, *,
                           num_bins_padded: int,
                           input_dtype: str = "float32") -> torch.Tensor:
    """hist [F, 3, B] float32 over the rows named by `idx`.

    bins_t [N+1, F] int32 bins, row N the sentinel (any value);
    grad_pad, hess_pad [N+1] float32 with [N] == 0; idx [C] int32 row ids
    padded with N.  Padded positions add nothing (zero gradient, mask
    idx < N).  A CUDA tensor launches kernel K5, which reads each row's
    bins through idx (the gathered [C, F] copy is never built); a CPU
    tensor gathers and takes the plain version (`hist_xla`'s sums)."""
    input_dtype = _coerce_dtype(input_dtype)
    fn = _from_indices_cuda if bins_t.is_cuda else _from_indices_plain
    return fn(bins_t, grad_pad, hess_pad, idx, num_bins_padded, input_dtype)


def hist_multileaf_xla(gb_t: torch.Tensor, vals: torch.Tensor, *,
                       num_bins_padded: int,
                       input_dtype: str = "float32") -> torch.Tensor:
    """The plain version of kernel K6, on any device: gb_t [F, C] int
    bins, vals [M, C] float32 -> [F, M, B] float32."""
    input_dtype = _coerce_dtype(input_dtype)
    return _rows_hist_plain(gb_t, _operands(vals, input_dtype),
                            num_bins_padded)


def _multirow_cuda(gb_t: torch.Tensor, vals: torch.Tensor, B: int,
                   input_dtype: str) -> torch.Tensor:
    """Kernel K6 (csrc/hist_gathered.cu) with hist_multileaf_xla's
    contract."""
    F, C = gb_t.shape
    M = vals.shape[0]
    if vals.shape[1] != C:
        raise ValueError("vals must be [M, C] over gb_t's C positions")
    gb_t = gb_t.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    out = torch.zeros((F, M, B), dtype=torch.float32, device=gb_t.device)
    if C == 0 or F == 0 or M == 0:
        return out
    kernels.call("hist_multirow", gb_t.data_ptr(), F, C, vals.data_ptr(), M,
                 B, int(input_dtype == "bfloat16"), out.data_ptr())
    kernels.LAUNCHES["hist_multirow"] += 1
    return out


def hist_pallas_multileaf(gb_t: torch.Tensor, vals: torch.Tensor, *,
                          num_bins_padded: int,
                          input_dtype: str = "bfloat16") -> torch.Tensor:
    """Histogram of M value rows at once: gb_t [F, C] int, vals [M, C]
    float32 (3 rows per leaf for K leaves) -> [F, M, B] float32.  A CUDA
    tensor launches kernel K6; a CPU tensor takes the plain version."""
    input_dtype = _coerce_dtype(input_dtype)
    if not gb_t.is_cuda:
        return hist_multileaf_xla(gb_t, vals,
                                  num_bins_padded=num_bins_padded,
                                  input_dtype=input_dtype)
    return _multirow_cuda(gb_t, vals, num_bins_padded, input_dtype)


def hist_multileaf(gb_t: torch.Tensor, vals: torch.Tensor, *,
                   num_bins_padded: int,
                   input_dtype: str = "float32") -> torch.Tensor:
    """hist_pallas_multileaf with the float32 default of the JAX entry."""
    return hist_pallas_multileaf(gb_t, vals, num_bins_padded=num_bins_padded,
                                 input_dtype=input_dtype)


def _quantize_gh(gh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Per-pass symmetric int8 quantization of the (grad, hess) rows of
    gh [>=3, C] f32.  Returns (ghq [3, C] int32 holding int8-ranged
    values, scale_g, scale_h); the mask row is carried through exactly.
    The f32 operations are the ones JAX runs: max|x| floored at 1e-30,
    then "/ 127", which XLA compiles to a multiply by the f32 reciprocal
    of the constant 127 (so the port multiplies too, and its scales are
    bitwise JAX's), then round half to even of x / scale."""
    sg = torch.clamp(gh[0].abs().max(), min=1e-30) * _INV127
    sh = torch.clamp(gh[1].abs().max(), min=1e-30) * _INV127
    ghq = torch.stack([torch.round(gh[0] / sg), torch.round(gh[1] / sh),
                       gh[2]]).to(torch.int32)
    return ghq, sg, sh


def _hist_plain(bins: torch.Tensor, row_idx: Optional[torch.Tensor],
                lid: torch.Tensor, vals: torch.Tensor, sl: torch.Tensor,
                B: int, round_bf16: bool = False) -> torch.Tensor:
    """Plain version of both kernels: [K, F, 3, B] sums of vals [3, C]
    (int32 -> int32 exactly, float32 -> float32) over the positions whose
    lid equals each slot's sl, binned by bins[f, row_idx[p] or p]."""
    F = bins.shape[0]
    K = sl.shape[0]
    dev = bins.device
    acc = torch.int64 if not vals.is_floating_point() else torch.float32
    out = torch.zeros(K * F * 3 * B, dtype=acc, device=dev)
    kk, pp = torch.nonzero(lid[None, :] == sl[:, None], as_tuple=True)
    if pp.numel():
        rows = pp if row_idx is None else row_idx[pp].long()
        off = 128 if bins.dtype == torch.int8 else 0
        b = bins[:, rows].long() + off                        # [F, E]
        ok = (b >= 0) & (b < B)
        f = torch.arange(F, device=dev)[:, None]
        v = vals[:, pp]
        if round_bf16:
            v = v.to(torch.bfloat16).to(torch.float32)
        for ch in range(3):
            idx = ((kk[None, :] * F + f) * 3 + ch) * B + b
            out.index_add_(0, idx[ok],
                           v[ch][None, :].expand(F, -1)[ok].to(acc))
    out = out.view(K, F, 3, B)
    return out.to(torch.int32) if acc == torch.int64 else out


def _hist_cuda(bins: torch.Tensor, row_idx: Optional[torch.Tensor],
               lid: torch.Tensor, vals: torch.Tensor, sl: torch.Tensor,
               B: int, round_bf16: bool = False) -> torch.Tensor:
    F, n_stride = bins.shape
    K = sl.shape[0]
    C = lid.shape[0]
    quant = not vals.is_floating_point()
    if bins.dtype not in (torch.int32, torch.int8):
        raise TypeError("histogram kernel takes int32 or int8 bins")
    if (vals.dtype not in (torch.int32, torch.float32)
            or vals.shape != (3, C) or lid.dtype != torch.int32
            or sl.dtype != torch.int32):
        raise TypeError("histogram kernel takes int32 lid/sl and [3, C] "
                        "int32 or float32 vals")
    if row_idx is not None and (row_idx.dtype != torch.int32
                                or row_idx.shape != (C,)):
        raise TypeError("row_idx must be int32 [C]")
    if 3 * B * 4 > 96 * 1024:
        raise ValueError(f"histogram kernel supports B <= 8192, got {B}")
    out = torch.zeros((K, F, 3, B), dtype=vals.dtype, device=bins.device)
    if C == 0 or K == 0 or F == 0:
        return out
    bins = bins.contiguous()
    vals = vals.contiguous()
    lid = lid.contiguous()
    sl = sl.contiguous()
    row_idx = None if row_idx is None else row_idx.contiguous()
    kernels.call("histogram", bins.data_ptr(), int(bins.dtype == torch.int8),
                 n_stride, F, kernels.ptr(row_idx), lid.data_ptr(),
                 vals.data_ptr(), int(quant), C, sl.data_ptr(), K, B,
                 int(round_bf16), out.data_ptr())
    kernels.LAUNCHES["hist_masked_int8" if quant else "hist_masked_f32"] += 1
    return out


def hist_counts(bins, row_idx, lid, vals, sl, B: int,
                round_bf16: bool = False) -> torch.Tensor:
    """Dispatch: kernel K1 (int32 vals) / K2 (float32 vals) for CUDA
    tensors, the plain version for CPU tensors."""
    fn = _hist_cuda if bins.is_cuda else _hist_plain
    return fn(bins, row_idx, lid, vals, sl, B, round_bf16)


def hist_multileaf_masked(gb_t: torch.Tensor, lid: torch.Tensor,
                          gh8: torch.Tensor, sl: torch.Tensor, *,
                          num_bins_padded: int,
                          input_dtype: str = "float32",
                          row_idx: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Histogram K leaves in one pass, masks built on the fly.

    gb_t [F, N] int bins (int8 = value-128 storage); lid [C] int32 leaf
    id per position; gh8 [>=3, C] f32 (grad·rm, hess·rm, rm); sl [K]
    int32 leaf ids to histogram (-1 = empty slot).  Position p reads
    bins column row_idx[p] when row_idx is given, else column p.
    Returns [K, F, 3, B] f32.

    input_dtype "int8" quantizes grad/hess per pass (`_quantize_gh`),
    accumulates exactly in int32 (K1) and dequantizes once; "float32" /
    "bfloat16" accumulate in float32 (K2), bfloat16 rounding the
    operands first."""
    C = lid.shape[0]
    B = num_bins_padded
    quant = input_dtype == "int8"
    if quant and C > INT8_MAX_ROWS:
        log.warning("histogram_dtype=int8 disabled for this pass: "
                    f"{C} rows exceeds the int32-exactness bound "
                    "(16M rows per device); using bfloat16")
        quant = False
        input_dtype = "bfloat16"
    if quant:
        ghq, sg, sh = _quantize_gh(gh8)
        h = hist_counts(gb_t, row_idx, lid, ghq, sl, B).to(torch.float32)
        return torch.stack([h[:, :, 0] * sg, h[:, :, 1] * sh, h[:, :, 2]],
                           dim=2)
    vals = gh8[:3].to(torch.float32)
    return hist_counts(gb_t, row_idx, lid, vals, sl, B,
                       round_bf16=input_dtype == "bfloat16")


def gather_segments(perm: torch.Tensor, seg_off: torch.Tensor,
                    seg_cnt: torch.Tensor, *, capacity: int):
    """Concatenate K contiguous segments of the row permutation `perm`
    into one [capacity] scratch layout.  Returns (idx [capacity] int32
    row ids — clamped but arbitrary past the live rows, slot [capacity]
    int32 slot id per position with -2 marking unused positions, total
    rows).  sum(seg_cnt) must not exceed capacity."""
    K = seg_off.shape[0]
    dev = perm.device
    base = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(seg_cnt.long(), 0)])
    total = base[K]
    j = torch.arange(capacity, dtype=torch.int64, device=dev)
    slot = torch.searchsorted(base[1:].contiguous(), j, right=True)
    valid = j < total
    sc = torch.clamp(slot, max=K - 1)
    pos = seg_off.long()[sc] + (j - base[sc])
    pos = torch.clamp(pos, 0, perm.shape[0] - 1)
    idx = perm[pos].to(torch.int32)
    slot = torch.where(valid, sc, torch.full_like(sc, -2)).to(torch.int32)
    return idx, slot, total


def hist_multileaf_gathered(bins_fn: torch.Tensor, gh8: torch.Tensor,
                            perm: torch.Tensor, seg_off: torch.Tensor,
                            seg_cnt: torch.Tensor, *, capacity: int,
                            num_bins_padded: int,
                            input_dtype: str = "float32") -> torch.Tensor:
    """Histogram K leaf-contiguous row segments in one pass over a
    [capacity] scratch: slot k holds segment k's histogram, exactly
    hist_multileaf_masked's output for that leaf.  On the int8 path the
    quantization scales derive from the gathered rows only, as in JAX.
    The kernel reads bins through the gathered row ids; only the
    [3, capacity] gradient rows are gathered here."""
    K = seg_off.shape[0]
    idx, slot, _ = gather_segments(perm, seg_off, seg_cnt,
                                   capacity=capacity)
    live = (slot >= 0).to(torch.float32)
    ghg = gh8[:3][:, idx.long()] * live[None, :]
    sl = torch.arange(K, dtype=torch.int32, device=bins_fn.device)
    return hist_multileaf_masked(bins_fn, slot, ghg, sl,
                                 num_bins_padded=num_bins_padded,
                                 input_dtype=input_dtype, row_idx=idx)


# ----------------------------------------------------------------------------
# Sparse (CSR/ELL) store: nonzero-iterating multi-leaf histograms
# ----------------------------------------------------------------------------

def _slot_of_rows(lid: torch.Tensor, sl: torch.Tensor) -> torch.Tensor:
    """[N] int32 slot index per row (first position of the row's leaf id
    in `sl`), or K for rows whose leaf is not histogrammed this pass."""
    K = sl.shape[0]
    ar = torch.arange(K, dtype=torch.int32, device=lid.device)
    eq = lid[:, None] == sl[None, :]                       # [N, K]
    return torch.where(eq, ar[None, :], K).min(dim=1).values.to(torch.int32)


def _slot_totals(srow: torch.Tensor, vals: torch.Tensor,
                 K: int) -> torch.Tensor:
    """[K, 3] per-slot (sum_grad, sum_hess, count) over all rows of each
    slot — the zero-bin anchor; dtype follows vals [3, N] (int32 for the
    quantized lanes, where the residual must stay an exact integer)."""
    tot = torch.zeros((K + 1, 3), dtype=vals.dtype, device=vals.device)
    return tot.index_add_(0, srow.long(), vals[:3].t())[:K]


def _sparse_quant_ok(input_dtype: str, num_rows: int) -> bool:
    """int8 eligibility of a sparse pass: the int32-exactness bound of
    the dense path, keyed on the row count (a (column, bin) cell takes at
    most one entry per row)."""
    if input_dtype != "int8":
        return False
    if num_rows > INT8_MAX_ROWS:
        log.warning("histogram_dtype=int8 disabled for this sparse pass: "
                    f"{num_rows} rows exceeds the int32-exactness bound "
                    "(16M rows per device); using float32")
        return False
    return True


def _sparse_hist_plain(cols: torch.Tensor, binsv: torch.Tensor,
                       srow: torch.Tensor, vals: torch.Tensor, K: int,
                       Cp: int, B: int) -> torch.Tensor:
    """Stored-entry sums over the ELL arrays: [K, Cp, 3, B] sums of
    vals [3, N] (int32 exactly, or float32) over the stored ELL entries
    (0 <= col < Cp) of rows with srow < K, at [srow, col, ch,
    min(bin, B-1)].  Zero bins are not included."""
    dev = cols.device
    out = torch.zeros(K * Cp * 3 * B, dtype=vals.dtype, device=dev)
    ok = (cols >= 0) & (cols < Cp) & (srow < K)[:, None]
    rr, jj = torch.nonzero(ok, as_tuple=True)
    if rr.numel():
        b = torch.clamp(binsv[rr, jj].long(), max=B - 1)
        keep = b >= 0
        rr, b = rr[keep], b[keep]
        c = cols[rr, jj[keep]].long()
        base = (srow[rr].long() * Cp + c) * (3 * B) + b
        for ch in range(3):
            out.index_add_(0, base + ch * B, vals[ch, rr])
    return out.view(K, Cp, 3, B)


def _sparse_pass(lid: torch.Tensor, gh8: torch.Tensor, sl: torch.Tensor,
                 input_dtype: str):
    """The per-pass set-up of a sparse histogram, in the order of the JAX
    function: quantize (int8), slot of every row, slot totals.  Returns
    (srow [N] int32, vals [3, N] int32 or float32, tot [K, 3] of vals'
    type, scale [3] f32 (sg, sh, 1) for int8 or None)."""
    K = sl.shape[0]
    if _sparse_quant_ok(input_dtype, lid.shape[0]):
        vals, sg, sh = _quantize_gh(gh8)                   # [3, N] int32
        scale = torch.stack([sg, sh, torch.ones_like(sg)])
    else:
        vals, scale = gh8[:3].to(torch.float32), None
    srow = _slot_of_rows(lid, sl)
    return srow, vals, _slot_totals(srow, vals, K), scale


def hist_sparse_xla(cols: torch.Tensor, binsv: torch.Tensor,
                    zero_bin: torch.Tensor, lid: torch.Tensor,
                    gh8: torch.Tensor, sl: torch.Tensor, *,
                    num_columns_padded: int, num_bins_padded: int,
                    input_dtype: str = "float32") -> torch.Tensor:
    """Nonzero-iterating multi-leaf histogram in plain torch ops over the
    ELL arrays, on any device — the JAX function's formulation.

    cols/binsv [N, R] int32 ELL entries (col >= num_columns_padded marks
    an empty slot); zero_bin [Cp] int32 (-1 = padded column); lid [N]
    int32 leaf ids; gh8 [>=3, N] f32 (grad·rm, hess·rm, rm); sl [K]
    int32 leaf ids to histogram (-1 = empty slot).  Returns
    [K, Cp, 3, B] f32 — hist_multileaf_masked's contract over the sparse
    store.  input_dtype "int8" quantizes per pass (`_quantize_gh`) and
    keeps the stored sums, slot totals and zero-bin residual in int32,
    with one dequantizing scale at the end."""
    srow, vals, tot, scale = _sparse_pass(lid, gh8, sl, input_dtype)
    hist = _sparse_hist_plain(cols, binsv, srow, vals, sl.shape[0],
                              num_columns_padded, num_bins_padded)
    return finish_sparse_hist(hist, tot, zero_bin, scale)


def hist_sparse_multileaf(sp, lid: torch.Tensor, gh8: torch.Tensor,
                          sl: torch.Tensor, *, num_columns_padded: int,
                          num_bins_padded: int,
                          input_dtype: str = "float32") -> torch.Tensor:
    """hist_sparse_xla's contract over the sparse store
    sp = (cols, binsv, zero_bin[, streams]).  A CUDA tensor launches
    kernel K7 (int8) or K8 (float32) over the column-sorted entry
    streams (`sparse_streams`; built here when sp carries none), a CPU
    tensor takes hist_sparse_xla."""
    cols, binsv, zero_bin = sp[0], sp[1], sp[2]
    Cp = num_columns_padded
    if not cols.is_cuda:
        return hist_sparse_xla(cols, binsv, zero_bin, lid, gh8, sl,
                               num_columns_padded=Cp,
                               num_bins_padded=num_bins_padded,
                               input_dtype=input_dtype)
    st = sp[3] if len(sp) > 3 else build_sparse_streams(cols, binsv, Cp)
    srow, vals, tot, scale = _sparse_pass(lid, gh8, sl, input_dtype)
    return hist_streams(st, zero_bin, srow, vals, tot, scale, sl.shape[0],
                        Cp, num_bins_padded)


def hist_sparse_gathered(sp, gh8: torch.Tensor, perm: torch.Tensor,
                         seg_off: torch.Tensor, seg_cnt: torch.Tensor, *,
                         capacity: int, num_columns_padded: int,
                         num_bins_padded: int,
                         input_dtype: str = "float32") -> torch.Tensor:
    """Gathered sparse histogram, plain torch ops: compact the K
    leaf-contiguous row segments of the row partition into a
    [capacity] scratch, gather their ELL rows and histogram only those
    (dead scratch positions get sentinel columns and zero values).  The
    JAX package runs it off the TPU only when hist_rows=gathered is
    pinned; the port's learner does the same on the CPU, and runs the
    masked feed on CUDA.  Like the JAX function, it histograms in
    float32 whatever `input_dtype` says."""
    cols, binsv, zero_bin = sp[0], sp[1], sp[2]
    K = seg_off.shape[0]
    Cp = num_columns_padded
    idx, slot, _ = gather_segments(perm, seg_off, seg_cnt,
                                   capacity=capacity)
    il = idx.long()
    live = slot >= 0
    cg = torch.where(live[:, None], cols[il],
                     torch.full((), Cp, dtype=cols.dtype, device=cols.device))
    bg = binsv[il]
    ghg = gh8[:3][:, il] * live[None, :].to(torch.float32)
    sl = torch.arange(K, dtype=torch.int32, device=cols.device)
    return hist_sparse_xla(cg, bg, zero_bin, slot, ghg, sl,
                           num_columns_padded=Cp,
                           num_bins_padded=num_bins_padded)
