"""K-leaf histograms of the batched-rounds learner (kernels K1 and K2).

Port of the main-path part of lightgbm_tpu/ops/histogram.py:
`_quantize_gh`, `hist_multileaf_masked`, `gather_segments` and
`hist_multileaf_gathered`.  Output layout is the JAX one: [K, F, 3, B]
float32, channels (sum_grad, sum_hess, count) per slot, feature and bin.

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
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels, log

# int32-accumulator bound: with constant hessians every row quantizes to
# 127, so one bin can reach 127 * C; above 16M rows per pass the int8
# path switches to bfloat16 operands (lightgbm_tpu/ops/histogram.py)
INT8_MAX_ROWS = 16_000_000

# f32 reciprocal of the int8 range (see _quantize_gh)
_INV127 = float(np.float32(1.0 / 127.0))


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
