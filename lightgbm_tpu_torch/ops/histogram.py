"""Histograms: the gather-fed dense half (kernels K5, K6) and the K-leaf
histograms of the batched-rounds learner (kernels K1, K2, K7, K8).

Port of lightgbm_tpu/ops/histogram.py.  The gather-fed half:
`hist_xla` (the plain version of K5), `hist_pallas` (K5's wrapper),
`histogram_from_indices` (one leaf's histogram over an index vector, the
exact leaf-wise learner's feed, in bytes, with the leaf's row count),
`hist_multileaf_xla` (the plain version of K6), `hist_pallas_multileaf`
/ `hist_multileaf` (K6's wrappers) and `_coerce_dtype`.  Their output
is [F, 3, B] (or [F, M, B]) float32.  The JAX functions took `backend=`
and `interpret=`; here, as in every wrapper of the port, the tensor's
device decides: a CUDA tensor launches the kernel of
csrc/hist_gathered.cu, a CPU tensor takes the plain version.

The rounds learner's part: `_quantize_gh`, `hist_multileaf_masked`,
`gather_segments` and `hist_multileaf_gathered` over the dense store,
and the sparse half (`hist_sparse_xla`, `hist_sparse_multileaf`,
`hist_sparse_gathered` and their helpers) over the CSR/ELL store.
Output layout is the JAX one: [K, F, 3, B] float32, channels (sum_grad,
sum_hess, count) per slot, feature (store column) and bin.

The TPU kernels built one-hot matrices and contracted them on the MXU;
the CUDA kernels (csrc/histogram.cu) add each row into a per-block
shared-memory histogram instead.  Both walk each slot's run of the
gathered feed's scratch in tiles (`segment_plan`; the plain version
`_segments_plain` sums each run straight from its bounds) and read a
row's bins from the learner's row-major byte copy of the store
(`RowBins`, `row_major_bins`) when there is one.  K1 (int8 gradients)
accumulates exactly in int32, so it is bitwise equal to its plain
version and to the JAX kernel.  K2 (float32 / bfloat16 operands) gives
every float cell one owner thread and adds in a fixed order, so its
sums are the same from run to run; they differ from the plain version's
index_add_ order by float rounding only.

int8 quantization (`_quantize_gh`) and the dequantize stay outside the
kernel, as plain torch ops, exactly as in JAX.  In the gathered row feed
the kernels read each scratch position's bins through the row index
(`row_idx`) instead of materializing the gathered [F, capacity] copy.

Over the sparse store `hist_sparse_multileaf` runs the CUDA kernels K7
(int8) and K8 (float32) of csrc/hist_sparse.cu over the store's
column-sorted entry streams (ops/sparse_streams.py, the GPU form of the
JAX package's `sparse_window_streams`): each block owns one column's
histogram in shared memory and writes it once, with the column's zero
bin and the int8 dequantize applied.  On the CPU it takes
`hist_sparse_xla`, the JAX function's formulation over the ELL arrays
(stored-entry sums, then the zero bins from each slot's totals).

The fused single-split builder's feeds, `histogram_full_masked` (dense)
and `histogram_full_sparse`, are one-leaf passes over every row with a
row mask: no TPU kernel of their own (in JAX they are `hist_xla` and
`hist_sparse_xla`); on CUDA they launch K2 with one slot and K8 with
K=1, on the CPU they take those plain versions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def _rows_hist_plain(gb_t: torch.Tensor, vals: torch.Tensor, B: int,
                     nb: Optional[int] = None) -> torch.Tensor:
    """[F, M, B] float32 sums of vals [M, C] over the positions whose bin
    gb_t [F, C] falls in each bin; bins outside [0, nb) add nothing (nb
    defaults to B)."""
    F, C = gb_t.shape
    M = vals.shape[0]
    dev = gb_t.device
    # out-of-range bins add into one extra cell that is sliced off
    out = torch.zeros(F * M * B + 1, dtype=torch.float32, device=dev)
    b = gb_t.long()
    ok = ((b >= 0) & (b < min(B, nb or B))).reshape(-1)
    base = (torch.arange(F, device=dev)[:, None] * (M * B) + b).reshape(-1)
    dump = torch.full((), F * M * B, device=dev)
    for m in range(M):
        out.index_add_(0, torch.where(ok, base + m * B, dump),
                       vals[m][None, :].expand(F, C).reshape(-1))
    return out[:F * M * B].view(F, M, B)


# K5's work (csrc/hist_gathered.cu), sized by the positions it reads:
# at least K5_MIN_ROWS positions a block, up to K5_BLOCKS_PER_SM blocks an
# SM over the feature tiles; a feature tile of up to 64 features, with a
# copy of it for each of the 16 warps when they fit K5_WARP_COPIES_SMEM,
# else one copy within K5_SMEM
K5_MIN_ROWS = 512
K5_BLOCKS_PER_SM = 2
K5_WARP_COPIES_SMEM = 110 * 1024
K5_SMEM = 100 * 1024
_K5_WARPS = 16

# bytes of a bin in the feeds K5 reads
_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}


def _k5_tile_words(f_tile: int, nb: int, warp_copies: bool) -> int:
    """32-bit words of one K5 tile: [3, nb, f_tile rounded up to 32] with
    a copy a warp, [f_tile, (3 nb) | 1] with one a block."""
    if warp_copies:
        return 3 * nb * (-(-f_tile // 32) * 32)
    return f_tile * ((3 * nb) | 1)


def _k5_layout(F: int, nb: int) -> Tuple[int, bool]:
    """(features a tile, whether each warp keeps a copy of the tile)."""
    ft = min(F, 64)
    # the copies and 32 staged 16-byte rows a warp
    if (_K5_WARPS * (_k5_tile_words(ft, nb, True) * 4 + 512)
            <= K5_WARP_COPIES_SMEM):
        return ft, True
    return max(1, min(ft, K5_SMEM // (((3 * nb) | 1) * 4))), False


def _k5_blocks(n_pos: int, ftiles: int, n_sm: int) -> Tuple[int, int]:
    """(blocks a feature tile, positions a block) for n_pos positions."""
    P = max(1, min(-(-n_pos // K5_MIN_ROWS),
                   K5_BLOCKS_PER_SM * n_sm // ftiles))
    per_block = -(-n_pos // P)
    rows = -(-per_block // 32) * 32
    return -(-n_pos // rows), rows


def _gathered_cuda(bins: torch.Tensor, row_stride: int, feat_stride: int,
                   F: int, idx: Optional[torch.Tensor], n_pos: int,
                   g: torch.Tensor, h: torch.Tensor,
                   m: Optional[torch.Tensor], n_live: int, B: int, nb: int,
                   input_dtype: str) -> torch.Tensor:
    """Kernel K5 (csrc/hist_gathered.cu): [F, 3, B] float32 sums of
    (g[r], h[r], m[r] or r < n_live) over the rows r of the first n_pos
    positions (r = idx[p], or p without an index), bin of (r, f) at
    bins[r * row_stride + f * feat_stride] (uint8, uint16 or int32, every
    bin below nb <= B); bins nb..B-1 of the output are zero.  Calls on
    one stream share its partial-tile scratch (kernels.combine_buffers)."""
    if bins.dtype not in _BIN_BYTES:
        raise TypeError("gathered histogram kernel takes uint8, uint16 or "
                        "int32 bins")
    if idx is not None and (idx.dtype != torch.int32
                            or idx.shape[0] < n_pos):
        raise TypeError("gathered histogram kernel takes int32 idx of at "
                        "least n_pos positions")
    for t in (g, h) + ((m,) if m is not None else ()):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("gathered histogram kernel takes contiguous "
                            "float32 value rows")
    if not 1 <= nb <= B:
        raise ValueError(f"store bins {nb} outside [1, {B}]")
    dev = bins.device
    if n_pos == 0 or F == 0:
        return torch.zeros((F, 3, B), dtype=torch.float32, device=dev)
    f_tile, warp_copies = _k5_layout(F, nb)
    ftiles = -(-F // f_tile)
    P, rows = _k5_blocks(n_pos, ftiles, kernels.sm_count(dev))
    ng = -(-P // 16)
    item = _k5_tile_words(f_tile, nb, warp_copies)
    # the partial tiles' slab, group slab and tickets only when blocks
    # combine
    slab = gslab = tickets = None
    if P > 1:
        n_slab = ftiles * P * item
        sc, tk = kernels.combine_buffers(
            dev, n_slab + (ftiles * ng * item if ng > 1 else 0),
            ftiles * (ng + 1))
        slab, tickets = sc.data_ptr(), tk.data_ptr()
        gslab = slab + 4 * n_slab if ng > 1 else None
    out = torch.empty((F, 3, B), dtype=torch.float32, device=dev)
    kernels.call("hist_gathered", bins.data_ptr(), _BIN_BYTES[bins.dtype],
                 row_stride, feat_stride, F, f_tile, int(warp_copies),
                 kernels.ptr(idx), n_pos, rows, P, g.data_ptr(),
                 h.data_ptr(), kernels.ptr(m), n_live, nb, B,
                 int(input_dtype == "bfloat16"), slab, gslab, tickets,
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
    gb_t = gb_t.to(torch.int32).contiguous()
    v = vals8[:3].to(torch.float32).contiguous()
    return _gathered_cuda(gb_t, 1, C, F, None, C, v[0], v[1], v[2], C,
                          num_bins_padded, num_bins_padded, input_dtype)


def _from_indices_plain(bins_t: torch.Tensor, grad_pad: torch.Tensor,
                        hess_pad: torch.Tensor, idx: torch.Tensor, B: int,
                        input_dtype: str = "float32",
                        count: Optional[int] = None,
                        nb: Optional[int] = None) -> torch.Tensor:
    """The plain version of histogram_from_indices on any device: gather
    the rows of the first `count` positions (all without a count), then
    `hist_xla`'s sums over bins below nb."""
    N = grad_pad.shape[0] - 1
    if count is not None:
        idx = idx[:count]
    il = idx.long()
    vals = torch.stack([grad_pad[il], hess_pad[il],
                        (idx < N).to(torch.float32)])
    return _rows_hist_plain(bins_t[il].t(), _operands(vals, input_dtype), B,
                            nb)


def _from_indices_cuda(bins_t: torch.Tensor, grad_pad: torch.Tensor,
                       hess_pad: torch.Tensor, idx: torch.Tensor, B: int,
                       input_dtype: str = "float32",
                       count: Optional[int] = None,
                       nb: Optional[int] = None) -> torch.Tensor:
    """Kernel K5 with histogram_from_indices' contract: each position's
    row bins are read through idx in the [N+1, F] feed; positions from
    `count` on are not read."""
    N = grad_pad.shape[0] - 1
    F = bins_t.shape[1]
    n_pos = idx.shape[0] if count is None else min(int(count), idx.shape[0])
    if idx.dtype != torch.int32:
        idx = idx.to(torch.int32)
    return _gathered_cuda(bins_t.contiguous(), F, 1, F, idx.contiguous(),
                          n_pos, grad_pad.contiguous(),
                          hess_pad.contiguous(), None, N, B, nb or B,
                          input_dtype)


def histogram_from_indices(bins_t: torch.Tensor, grad_pad: torch.Tensor,
                           hess_pad: torch.Tensor, idx: torch.Tensor, *,
                           num_bins_padded: int,
                           input_dtype: str = "float32",
                           count: Optional[int] = None,
                           num_store_bins: Optional[int] = None
                           ) -> torch.Tensor:
    """hist [F, 3, B] float32 over the rows named by `idx`.

    bins_t [N+1, F] integer bins (the exact learner's uint8 or uint16
    feed, or int32), row N the sentinel (any value); grad_pad, hess_pad
    [N+1] float32 with [N] == 0; idx [C] int32 row ids padded with N.
    Padded positions add nothing (zero gradient, mask idx < N).  `count`
    (optional) is the number of leading positions that hold rows — the
    leaf's row count when its rows come first, as `compact_rows` puts
    them; positions from it on are not read.  `num_store_bins`
    (optional, default B) bounds every bin of the feed; output bins from
    it on are zero.  A CUDA tensor launches kernel K5, which reads each
    row's bins through idx (the gathered [C, F] copy is never built); a
    CPU tensor gathers and takes the plain version (`hist_xla`'s
    sums)."""
    input_dtype = _coerce_dtype(input_dtype)
    fn = _from_indices_cuda if bins_t.is_cuda else _from_indices_plain
    return fn(bins_t, grad_pad, hess_pad, idx, num_bins_padded, input_dtype,
              count, num_store_bins)


def hist_multileaf_xla(gb_t: torch.Tensor, vals: torch.Tensor, *,
                       num_bins_padded: int,
                       input_dtype: str = "float32") -> torch.Tensor:
    """The plain version of kernel K6, on any device: gb_t [F, C] int
    bins, vals [M, C] float32 -> [F, M, B] float32."""
    input_dtype = _coerce_dtype(input_dtype)
    return _rows_hist_plain(gb_t, _operands(vals, input_dtype),
                            num_bins_padded)


# K6's work (csrc/hist_gathered.cu `hist_multirow_kernel`): up to 8 owner
# warps a block, each lane owning all B bins of one (feature, value row),
# and 4 warps that stage the positions into a two-slot ring, 12 16-byte
# loads a producer thread a tile.  Those three are the kernel's
# compile-time constants (kMultiThreads, kProducerWarps, kMultiLoads);
# the values here mirror them for the layout and are not to be set apart
# from them.  The layout keeps a block within K6_SMEM of shared memory
# and gives it chunks of at least K6_MIN_CHUNK positions, as many blocks
# as the SMs hold at once
_K6_MAX_WARPS = 8
_K6_PRODUCER_WARPS = 4
_K6_LOADS = 12
K6_SMEM = 226 * 1024
K6_MIN_CHUNK = 1024


class K6Layout(NamedTuple):
    lg: int          # lanes a feature group: 1 << lg
    warps: int       # owner warps a block
    pt: int          # positions a staged tile
    chunk: int       # positions a block
    P: int           # blocks an item (feature tile, value-row tile)
    rtiles: int      # value-row tiles
    items: int
    words: int       # 32-bit words of a block's cells
    smem: int        # bytes of shared memory a block


def _k6_layout(F: int, M: int, B: int, C: int, n_sm: int) -> K6Layout:
    """K6's tiling: a feature tile of up to 32 features, rounded up to a
    power of two (nfp), owned by the lanes of a warp, each warp owning
    32 / nfp value rows; as many owner warps as the cells of B + 1 bins a
    lane fit beside the ring (at most 8, no more than the rows need);
    the staged tile as long as the producers' 12 loads a thread hold (a multiple of 16 positions, at most 256); chunks so that
    the blocks fill the SMs."""
    nfp = 1
    while nfp < min(F, 32):
        nfp *= 2
    rpw = 32 // nfp
    cell_bytes = (B + 1) * 32 * 4

    def r16(n):
        return -(-n // 16) * 16

    def smem(W, pt):
        return W * cell_bytes + 2 * (r16((nfp + 1) * (pt + 4) * 2)
                                     + r16(W * rpw * (pt + 4) * 4))

    def tile(W):
        loads = _K6_LOADS * _K6_PRODUCER_WARPS * 32 * 4
        pt = min(256, loads // (nfp + W * rpw) // 16 * 16)
        while pt > 16 and smem(W, pt) > K6_SMEM:
            pt -= 16
        return pt
    W = min(_K6_MAX_WARPS, -(-M // rpw))
    while W > 0 and (tile(W) < 16 or smem(W, tile(W)) > K6_SMEM):
        W -= 1
    if W < 1:
        raise ValueError(f"multi-row histogram kernel: {B} bins do not "
                         f"fit one owner warp's shared memory")
    pt = tile(W)
    rtiles = -(-M // (W * rpw))
    items = -(-F // nfp) * rtiles
    resident = max(1, (228 * 1024) // (smem(W, pt) + 1024))
    P = max(1, min(-(-C // K6_MIN_CHUNK),
                   round(n_sm * resident / items)))
    chunk = -(-C // P)
    chunk = -(-chunk // 16) * 16             # a multiple of 16 positions
    P = max(1, -(-C // chunk))
    return K6Layout(nfp.bit_length() - 1, W, pt, chunk, P, rtiles, items,
                    W * (B + 1) * 32, smem(W, pt))


def _multirow_cuda(gb_t: torch.Tensor, vals: torch.Tensor, B: int,
                   input_dtype: str) -> torch.Tensor:
    """Kernel K6 (csrc/hist_gathered.cu) with hist_multileaf_xla's
    contract.  Calls on one stream share its partial-tile scratch
    (kernels.combine_buffers)."""
    F, C = gb_t.shape
    M = vals.shape[0]
    if vals.shape[1] != C:
        raise ValueError("vals must be [M, C] over gb_t's C positions")
    gb_t = gb_t.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    dev = gb_t.device
    if C == 0 or F == 0 or M == 0:
        return torch.zeros((F, M, B), dtype=torch.float32, device=dev)
    lay = _k6_layout(F, M, B, C, kernels.sm_count(dev))
    ng = -(-lay.P // 16)
    slab = gslab = tickets = None
    if lay.P > 1:
        n_slab = lay.items * lay.P * lay.words
        sc, tk = kernels.combine_buffers(
            dev, n_slab + (lay.items * ng * lay.words if ng > 1 else 0),
            lay.items * (ng + 1))
        slab, tickets = sc.data_ptr(), tk.data_ptr()
        gslab = slab + 4 * n_slab if ng > 1 else None
    out = torch.empty((F, M, B), dtype=torch.float32, device=dev)
    kernels.call("hist_multirow", gb_t.data_ptr(), F, C, vals.data_ptr(), M,
                 B, int(input_dtype == "bfloat16"), lay.lg, lay.warps,
                 lay.pt, lay.chunk, lay.P, lay.rtiles, slab, gslab, tickets,
                 out.data_ptr())
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


def _quantize_gh(gh: torch.Tensor, exchange=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pass symmetric int8 quantization of the (grad, hess) rows of
    gh [>=3, C] f32.  Returns (ghq [3, C] int32 holding int8-ranged
    values, scale_g, scale_h); the mask row is carried through exactly.
    The f32 operations are the ones JAX runs: max|x| floored at 1e-30,
    then "/ 127", which XLA compiles to a multiply by the f32 reciprocal
    of the constant 127 (so the port multiplies too, and its scales are
    bitwise JAX's), then round half to even of x / scale.

    With a mesh `exchange` (sharded/mesh.py HistExchange) the two
    max|x| are the maxima over every rank's rows, so every rank
    quantizes with the scales one device would use over all the rows.
    (The JAX mesh learners quantize each shard with its own local
    scales; a shared scale keeps the exchanged int32 sums exact, so a
    W-rank int8 histogram is bitwise the one-device one.)"""
    amax = torch.stack([gh[0].abs().max(), gh[1].abs().max()])
    if exchange is not None:
        amax = exchange.amax(amax)
    sg = torch.clamp(amax[0], min=1e-30) * _INV127
    sh = torch.clamp(amax[1], min=1e-30) * _INV127
    ghq = torch.stack([torch.round(gh[0] / sg), torch.round(gh[1] / sh),
                       gh[2]]).to(torch.int32)
    return ghq, sg, sh


class RowBins(NamedTuple):
    """The rounds learner's row-major byte copy of its [F, N] store:
    rows [N, F4] uint8 (F4 = F rounded up to 4, the pad columns zero),
    and num_bins, a bound on every bin of the store (its largest bin
    count).  Kernel K1 reads a row's bins from it with 32-bit loads."""
    rows: torch.Tensor
    num_bins: int


def row_major_bins(bins: torch.Tensor, num_bins: int) -> RowBins:
    """The row-major byte copy of an [F, N] store of at most 256 bins, on
    the store's device: from the int32 store, or the int8 one holding
    value - 128."""
    if num_bins > 256:
        raise ValueError(f"a byte copy holds at most 256 bins, not "
                         f"{num_bins}")
    F, N = bins.shape
    rows = torch.zeros((N, -(-F // 4) * 4), dtype=torch.uint8,
                       device=bins.device)
    off = 128 if bins.dtype == torch.int8 else 0
    for f in range(F):
        rows[:, f] = (bins[f].to(torch.int32) + off).to(torch.uint8)
    return RowBins(rows, int(num_bins))


def _hist_pairs(bins: torch.Tensor, rows: Optional[RowBins],
                row_idx: Optional[torch.Tensor], kk: torch.Tensor,
                pp: torch.Tensor, vals: torch.Tensor, K: int, B: int,
                round_bf16: bool = False) -> torch.Tensor:
    """[K, F, 3, B] sums of vals [3, C] (int32 -> int32 exactly, float32
    -> float32) over the (slot kk[e], position pp[e]) pairs, each pair
    once, binned by the bins of row row_idx[p] (or p): from the byte copy
    when given (bins below its num_bins), else from bins[f, row]."""
    F = bins.shape[0]
    dev = bins.device
    acc = torch.int64 if not vals.is_floating_point() else torch.float32
    out = torch.zeros(K * F * 3 * B, dtype=acc, device=dev)
    if pp.numel():
        r = pp if row_idx is None else row_idx[pp].long()
        if rows is not None:
            b = rows.rows[r, :F].t().long()                    # [F, E]
            hi = min(B, rows.num_bins)
        else:
            off = 128 if bins.dtype == torch.int8 else 0
            b = bins[:, r].long() + off                        # [F, E]
            hi = B
        ok = (b >= 0) & (b < hi)
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


def _hist_plain(bins: torch.Tensor, row_idx: Optional[torch.Tensor],
                lid: torch.Tensor, vals: torch.Tensor, sl: torch.Tensor,
                B: int, round_bf16: bool = False,
                rows: Optional[RowBins] = None) -> torch.Tensor:
    """Plain version of both kernels over the masked feed: [K, F, 3, B]
    sums of vals [3, C] (int32 -> int32 exactly, float32 -> float32) over
    the positions whose lid equals each slot's sl, binned by
    bins[f, row_idx[p] or p] (or the byte copy `rows`)."""
    kk, pp = torch.nonzero(lid[None, :] == sl[:, None], as_tuple=True)
    return _hist_pairs(bins, rows, row_idx, kk, pp, vals, sl.shape[0], B,
                       round_bf16)


# K1's work (csrc/histogram.cu `hist_q_kernel`): positions a block of at
# least K1_TILE_ROWS, up to K1_BLOCKS_PER_SM blocks an SM over the
# feature tiles; a feature tile as wide as K1_SMEM holds over the gathered
# feed, half that over the masked one
K1_TILE_ROWS = 2048
K1_BLOCKS_PER_SM = 2
K1_SMEM = 96 * 1024


def _k1_feature_tile(F: int, nb: int, row_feed: bool, gathered: bool) -> int:
    """Features a K1 tile: a multiple of 4 (at most 128) over the byte
    copy, at most 32 over the [F, N] store.  The gathered feed reads each
    row through its index, and a second feature tile reads it again, so
    its tile takes the whole budget; the masked feed reads rows in order
    and takes half (twice the resident blocks an SM), which timed faster
    on the root pass (PERF.md, section 6)."""
    S = (3 * nb) | 1
    ft = max(1, (K1_SMEM if gathered else K1_SMEM // 2) // (S * 4))
    if row_feed:
        return max(4, min(-(-F // 4) * 4, 128, ft // 4 * 4))
    return max(1, min(F, 32, ft))


def _k1_tile_rows(C: int, blocks: int) -> int:
    """Positions a tile so that C positions take about `blocks` blocks,
    at least K1_TILE_ROWS, a multiple of 32."""
    return -(-max(K1_TILE_ROWS, -(-C // max(1, blocks))) // 32) * 32


def segment_plan(base: torch.Tensor, tile_rows: int, n_blocks: int):
    """The gathered feed's work plan, as kernel K1 computes it: slot k's
    run [base[k], base[k+1]) of the scratch is cut into
    max(1, ceil(cnt / tile_rows)) tiles, numbered slot by slot; block b
    takes tile b.  Returns (slot, lo, hi) [n_blocks] int64: block b adds
    positions [lo[b], hi[b]) to slot[b], and slot -1 marks a block past
    the work.  n_blocks = ceil(capacity / tile_rows) + K bounds the
    tiles."""
    base = base.long()
    K = base.numel() - 1
    cnt = base[1:] - base[:-1]
    P = torch.clamp((cnt + tile_rows - 1) // tile_rows, min=1)
    end = torch.cumsum(P, 0)
    b = torch.arange(n_blocks, dtype=torch.int64, device=base.device)
    k = torch.clamp(torch.searchsorted(end, b, right=True), max=K - 1)
    lo = base[k] + (b - (end[k] - P[k])) * tile_rows
    hi = torch.minimum(base[k + 1], lo + tile_rows)
    valid = b < end[K - 1]
    zero = torch.zeros_like(lo)
    return (torch.where(valid, k, torch.full_like(k, -1)),
            torch.where(valid, lo, zero), torch.where(valid, hi, zero))


def _k1_plan(C: int, K: int, F: int, nb: int, row_feed: bool, n_sm: int,
             gathered: bool):
    """(f_tile, tile_rows, n_blocks, P_masked) of one K1 launch: the
    gathered feed's grid bounds its tiles, ceil(C / tile_rows) + K; the
    masked feed cuts each slot's C positions into P_masked tiles."""
    f_tile = _k1_feature_tile(F, nb, row_feed, gathered)
    ftiles = -(-F // f_tile)
    target = max(1, K1_BLOCKS_PER_SM * n_sm // ftiles)
    if gathered:
        T = _k1_tile_rows(C, target)
        return f_tile, T, -(-C // T) + K, 0
    T = _k1_tile_rows(C, max(1, target // K))
    P = max(1, -(-C // T))
    return f_tile, T, K * P, P


def _segments_plain(bins: torch.Tensor, rows: Optional[RowBins],
                    row_idx: Optional[torch.Tensor], vals: torch.Tensor,
                    base: torch.Tensor, B: int,
                    round_bf16: bool = False) -> torch.Tensor:
    """Plain version of kernels K1 (int32 vals) and K2 (float32 vals,
    rounded to bfloat16 first when round_bf16) over the gathered feed:
    every position of slot k's run [base[k], base[k+1]) adds once to
    slot k."""
    K = base.numel() - 1
    base = base.long()
    kk = torch.repeat_interleave(torch.arange(K, device=base.device),
                                 base[1:] - base[:-1])
    pp = base[0] + torch.arange(kk.numel(), dtype=torch.int64,
                                device=base.device)
    return _hist_pairs(bins, rows, row_idx, kk, pp, vals, K, B, round_bf16)


def _row_feed(bins: torch.Tensor, rows: Optional[RowBins], B: int):
    """(feed, source, stride, nb) of a K1/K2 launch: the byte copy when
    given (feed 0, bins below its num_bins), else the [F, N] store in
    int32 (1) or int8 (2)."""
    if rows is not None:
        if rows.rows.dtype != torch.uint8 or rows.rows.shape[1] < bins.shape[0]:
            raise TypeError("the byte copy must be [N, F4] uint8")
        return 0, rows.rows, rows.rows.shape[1], min(B, rows.num_bins)
    if bins.dtype == torch.int32:
        return 1, bins, bins.shape[1], B
    if bins.dtype == torch.int8:
        return 2, bins, bins.shape[1], B
    raise TypeError("histogram kernel takes int32 or int8 bins")


def _check_feed(vals: torch.Tensor, row_idx: Optional[torch.Tensor],
                lid: Optional[torch.Tensor], sl: Optional[torch.Tensor],
                base: Optional[torch.Tensor]) -> None:
    C = vals.shape[1]
    if row_idx is not None and (row_idx.dtype != torch.int32
                                or row_idx.shape != (C,)):
        raise TypeError("row_idx must be int32 [C]")
    if base is None and (lid is None or sl is None or lid.shape != (C,)
                         or lid.dtype != torch.int32
                         or sl.dtype != torch.int32):
        raise TypeError("the masked feed takes int32 lid [C] and sl [K]")


def _combine_scratch(dev: torch.device, gathered: bool, K: int,
                     n_blocks: int, P_m: int, ftiles: int, item: int):
    """The partial-tile slab, group slab and tickets of a K1/K2 launch
    (kernels.combine_buffers): (slab pointer, group slab pointer, tickets
    pointer, slab items, group items, ticket items) per feature tile."""
    if gathered:
        slab_items, gslab_items = n_blocks, -(-n_blocks // 16) + K
        ticket_items = n_blocks + K
    else:
        ng = -(-P_m // 16)
        slab_items, gslab_items, ticket_items = K * P_m, K * ng, K * (ng + 1)
    n_slab = ftiles * slab_items * item
    slab, tickets = kernels.combine_buffers(
        dev, n_slab + ftiles * gslab_items * item, ftiles * ticket_items)
    return (slab.data_ptr(), slab.data_ptr() + 4 * n_slab, tickets.data_ptr(),
            slab_items, gslab_items, ticket_items)


def _hist_q_cuda(bins: torch.Tensor, rows: Optional[RowBins],
                 row_idx: Optional[torch.Tensor], vals: torch.Tensor, B: int,
                 *, lid: Optional[torch.Tensor] = None,
                 sl: Optional[torch.Tensor] = None,
                 base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K1 (csrc/histogram.cu `hist_q_kernel`): [K, F, 3, B] int32
    sums of vals [3, C] int32.  Gathered feed: base [K+1] bounds slot k's
    run of positions; masked feed: lid [C] and sl [K], a position adding
    to the slots whose leaf id it holds.  Bins from the byte copy `rows`
    when given, else from the [F, N] store `bins` (int32 or int8).  Calls
    on one stream share its partial-tile scratch
    (kernels.combine_buffers)."""
    F = bins.shape[0]
    C = vals.shape[1]
    if vals.dtype != torch.int32 or vals.shape != (3, C):
        raise TypeError("histogram kernel K1 takes [3, C] int32 vals")
    _check_feed(vals, row_idx, lid, sl, base)
    feed, src, stride, nb = _row_feed(bins, rows, B)
    K = base.numel() - 1 if base is not None else sl.shape[0]
    dev = bins.device
    if K == 0 or F == 0 or (C == 0 and base is None):
        return torch.zeros((K, F, 3, B), dtype=torch.int32, device=dev)
    gathered = base is not None
    f_tile, T, n_blocks, P_m = _k1_plan(C, K, F, nb, rows is not None,
                                        kernels.sm_count(dev), gathered)
    scratch = _combine_scratch(dev, gathered, K, n_blocks, P_m,
                               -(-F // f_tile), f_tile * ((3 * nb) | 1))
    src = src.contiguous()
    vals = vals.contiguous()
    row_idx = None if row_idx is None else row_idx.contiguous()
    base = None if base is None else base.to(torch.int64).contiguous()
    lid = None if lid is None else lid.contiguous()
    sl = None if sl is None else sl.contiguous()
    out = torch.empty((K, F, 3, B), dtype=torch.int32, device=dev)
    kernels.call("hist_q", src.data_ptr(), feed, stride, F, f_tile, nb, B,
                 kernels.ptr(row_idx), vals.data_ptr(), C, kernels.ptr(base),
                 T, kernels.ptr(lid), kernels.ptr(sl), P_m, K, n_blocks,
                 *scratch, out.data_ptr())
    kernels.LAUNCHES["hist_masked_int8"] += 1
    return out


# K2's work (csrc/histogram.cu `hist_owned_kernel`): blocks of 128
# threads, each with one copy of its feature tile, 3 (nb + 1) ls words,
# within K2_SMEM with the staged batches; positions a block of at least
# K2_TILE_ROWS, the grid about one wave of the blocks resident at once
K2_TILE_ROWS = 2048
K2_SMEM = 227 * 1024
_K2_BATCH = 128
# blocks an SM at most (the kernel's launch bounds)
_K2_PER_SM = 4


def _k2_layout(F: int, nb: int, row_feed: bool, K: int):
    """(f_tile, ls, smem bytes) of a K2 launch: the features of a block's
    tile (a multiple of 4 over the byte copy, at most 32), the lane
    stride of its copy (the power of two at or above it) and the shared
    memory: the copy (3 planes of nb + 1 bins, the last a trash bin),
    two batches of values and rows (16 bytes a position), a batch of
    16-bit bins (a padded row a feature, and a sentinel row) and the
    K + 1 segment bounds of the gathered feed.  The tile narrows until
    the copy fits."""
    step = 4 if row_feed else 1
    ft = min(32, -(-F // step) * step)
    while True:
        ls = 1 << (ft - 1).bit_length()
        smem = (-(-3 * (nb + 1) * ls // 4) * 16 + 2 * _K2_BATCH * 16
                + (ft + 1) * (_K2_BATCH + 4) * 2 + (K + 1) * 8)
        if smem <= K2_SMEM:
            return ft, ls, smem
        if ft == step:
            raise ValueError(f"histogram kernel K2 holds no copy of {nb} "
                             "bins in shared memory")
        ft = max(step, ft // 2 // step * step)


def _k2_plan(C: int, K: int, F: int, nb: int, row_feed: bool, n_sm: int,
             gathered: bool):
    """(f_tile, ls, tile_rows, n_blocks, P_masked) of one K2 launch, cut
    as K1's (`_k1_plan`) for one wave of resident blocks."""
    f_tile, ls, smem = _k2_layout(F, nb, row_feed, K if gathered else 0)
    ftiles = -(-F // f_tile)
    resident = max(1, min(_K2_PER_SM, (228 * 1024) // (smem + 1024)))
    target = max(1, resident * n_sm // ftiles)
    rows_min = max(_K2_BATCH, K2_TILE_ROWS)
    if gathered:
        T = -(-max(rows_min, -(-C // target)) // _K2_BATCH) * _K2_BATCH
        return f_tile, ls, T, -(-C // T) + K, 0
    T = -(-max(rows_min, -(-C // max(1, target // K))) // _K2_BATCH) \
        * _K2_BATCH
    P = max(1, -(-C // T))
    return f_tile, ls, T, K * P, P


def _hist_f_cuda(bins: torch.Tensor, rows: Optional[RowBins],
                 row_idx: Optional[torch.Tensor], vals: torch.Tensor, B: int,
                 *, lid: Optional[torch.Tensor] = None,
                 sl: Optional[torch.Tensor] = None,
                 base: Optional[torch.Tensor] = None,
                 round_bf16: bool = False) -> torch.Tensor:
    """Kernel K2 (csrc/histogram.cu `hist_owned_kernel`): [K, F, 3, B]
    float32 sums of vals [3, C] float32 (rounded to bfloat16 first when
    round_bf16), over the gathered feed (base) or the masked one (lid,
    sl), bins from the byte copy `rows` when given, as `_hist_q_cuda`.
    Each cell is summed in a fixed order: two calls give the same bits."""
    F = bins.shape[0]
    C = vals.shape[1]
    if vals.dtype != torch.float32 or vals.shape != (3, C):
        raise TypeError("histogram kernel K2 takes [3, C] float32 vals")
    _check_feed(vals, row_idx, lid, sl, base)
    feed, src, stride, nb = _row_feed(bins, rows, B)
    K = base.numel() - 1 if base is not None else sl.shape[0]
    dev = bins.device
    if K == 0 or F == 0 or (C == 0 and base is None):
        return torch.zeros((K, F, 3, B), dtype=torch.float32, device=dev)
    gathered = base is not None
    f_tile, ls, T, n_blocks, P_m = _k2_plan(
        C, K, F, nb, rows is not None, kernels.sm_count(dev), gathered)
    scratch = _combine_scratch(dev, gathered, K, n_blocks, P_m,
                               -(-F // f_tile), 3 * (nb + 1) * ls)
    src = src.contiguous()
    vals = vals.contiguous()
    row_idx = None if row_idx is None else row_idx.contiguous()
    base = None if base is None else base.to(torch.int64).contiguous()
    lid = None if lid is None else lid.contiguous()
    sl = None if sl is None else sl.contiguous()
    out = torch.empty((K, F, 3, B), dtype=torch.float32, device=dev)
    kernels.call("hist_f", src.data_ptr(), feed, stride, F, f_tile, ls, nb,
                 B, kernels.ptr(row_idx), vals.data_ptr(),
                 int(round_bf16), C, kernels.ptr(base), T, kernels.ptr(lid),
                 kernels.ptr(sl), P_m, K, n_blocks, *scratch, out.data_ptr())
    kernels.LAUNCHES["hist_masked_f32"] += 1
    return out


def hist_counts(bins, row_idx, lid, vals, sl, B: int,
                round_bf16: bool = False,
                rows: Optional[RowBins] = None) -> torch.Tensor:
    """Dispatch of the masked feed: kernel K1 (int32 vals) / K2 (float32
    vals) for CUDA tensors, the plain version for CPU tensors; bins from
    the byte copy `rows` when given."""
    if not bins.is_cuda:
        return _hist_plain(bins, row_idx, lid, vals, sl, B, round_bf16, rows)
    if vals.is_floating_point():
        return _hist_f_cuda(bins, rows, row_idx, vals, B, lid=lid, sl=sl,
                            round_bf16=round_bf16)
    return _hist_q_cuda(bins, rows, row_idx, vals, B, lid=lid, sl=sl)


def segment_counts(bins, rows: Optional[RowBins], row_idx, vals,
                   base: torch.Tensor, B: int,
                   round_bf16: bool = False) -> torch.Tensor:
    """Dispatch of the gathered feed (slot k's positions [base[k],
    base[k+1])): kernel K1 (int32 vals) / K2 (float32 vals) for CUDA
    tensors, their plain version for CPU tensors."""
    if not bins.is_cuda:
        return _segments_plain(bins, rows, row_idx, vals, base, B,
                               round_bf16)
    if vals.is_floating_point():
        return _hist_f_cuda(bins, rows, row_idx, vals, B, base=base,
                            round_bf16=round_bf16)
    return _hist_q_cuda(bins, rows, row_idx, vals, B, base=base)


def _int8_ok(C: int) -> bool:
    """int8 eligibility of a dense pass over C positions (the
    int32-exactness bound), warning when it is refused."""
    if C > INT8_MAX_ROWS:
        log.warning("histogram_dtype=int8 disabled for this pass: "
                    f"{C} rows exceeds the int32-exactness bound "
                    "(16M rows per device); using bfloat16")
        return False
    return True


def _dequantize(h: torch.Tensor, sg: torch.Tensor,
                sh: torch.Tensor) -> torch.Tensor:
    """[K, F, 3, B] int32 sums -> float32, (grad, hess) scaled once."""
    h = h.to(torch.float32)
    return torch.stack([h[:, :, 0] * sg, h[:, :, 1] * sh, h[:, :, 2]], dim=2)


def hist_multileaf_masked(gb_t: torch.Tensor, lid: torch.Tensor,
                          gh8: torch.Tensor, sl: torch.Tensor, *,
                          num_bins_padded: int,
                          input_dtype: str = "float32",
                          row_idx: Optional[torch.Tensor] = None,
                          rows: Optional[RowBins] = None,
                          exchange=None) -> torch.Tensor:
    """Histogram K leaves in one pass, masks built on the fly.

    gb_t [F, N] int bins (int8 = value-128 storage); lid [C] int32 leaf
    id per position; gh8 [>=3, C] f32 (grad·rm, hess·rm, rm); sl [K]
    int32 leaf ids to histogram (-1 = empty slot).  Position p reads
    bins column row_idx[p] when row_idx is given, else column p.
    Returns [K, F, 3, B] f32.  `rows` (optional) is the store's
    row-major byte copy, which the kernels read instead.

    input_dtype "int8" quantizes grad/hess per pass (`_quantize_gh`),
    accumulates exactly in int32 (K1) and dequantizes once; "float32" /
    "bfloat16" accumulate in float32 (K2), bfloat16 rounding the
    operands first.

    `exchange` (a mesh learner's sharded/mesh.py HistExchange) reduces
    this rank's pass across the ranks of the row axes: the int32 sums
    before the dequantize (with scales shared by every rank), the float
    ones as they are; the result is the exchange's (a column slice
    under psum_scatter)."""
    B = num_bins_padded
    rows_total = lid.shape[0] * (exchange.shards if exchange else 1)
    if input_dtype == "int8":
        if _int8_ok(rows_total):
            ghq, sg, sh = _quantize_gh(gh8, exchange)
            h = hist_counts(gb_t, row_idx, lid, ghq, sl, B, rows=rows)
            return _dequantize(_exchanged(h, exchange), sg, sh)
        input_dtype = "bfloat16"
    vals = gh8[:3].to(torch.float32)
    return _exchanged(hist_counts(gb_t, row_idx, lid, vals, sl, B,
                                  round_bf16=input_dtype == "bfloat16",
                                  rows=rows), exchange)


def _exchanged(h: torch.Tensor, exchange) -> torch.Tensor:
    return h if exchange is None else exchange(h)


def _gather_rows(perm: torch.Tensor, seg_off: torch.Tensor,
                 seg_cnt: torch.Tensor, capacity: int):
    """The rows of gather_segments' scratch: (idx [capacity] int32, sc
    [capacity] int64 each position's slot, clamped to K-1 past the live
    positions, valid [capacity] bool (position < total), total, base
    [K+1] int64: slot k's positions are [base[k], base[k+1]))."""
    K = seg_off.shape[0]
    dev = perm.device
    base = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(seg_cnt.long(), 0)])
    total = base[K]
    j = torch.arange(capacity, dtype=torch.int64, device=dev)
    sc = torch.clamp(torch.searchsorted(base[1:].contiguous(), j,
                                        right=True), max=K - 1)
    pos = seg_off.long()[sc] + (j - base[sc])
    pos = torch.clamp(pos, 0, perm.shape[0] - 1)
    idx = perm[pos].to(torch.int32)
    return idx, sc, j < total, total, base


def _gather_segments(perm: torch.Tensor, seg_off: torch.Tensor,
                     seg_cnt: torch.Tensor, capacity: int):
    """gather_segments, plus base [K+1] int64: slot k's positions are
    [base[k], base[k+1]) of the scratch."""
    idx, sc, valid, total, base = _gather_rows(perm, seg_off, seg_cnt,
                                               capacity)
    slot = torch.where(valid, sc, torch.full_like(sc, -2)).to(torch.int32)
    return idx, slot, total, base


def gather_segments(perm: torch.Tensor, seg_off: torch.Tensor,
                    seg_cnt: torch.Tensor, *, capacity: int):
    """Concatenate K contiguous segments of the row permutation `perm`
    into one [capacity] scratch layout.  Returns (idx [capacity] int32
    row ids — clamped but arbitrary past the live rows, slot [capacity]
    int32 slot id per position with -2 marking unused positions, total
    rows).  sum(seg_cnt) must not exceed capacity."""
    return _gather_segments(perm, seg_off, seg_cnt, capacity)[:3]


def hist_multileaf_gathered(bins_fn: torch.Tensor, gh8: torch.Tensor,
                            perm: torch.Tensor, seg_off: torch.Tensor,
                            seg_cnt: torch.Tensor, *, capacity: int,
                            num_bins_padded: int,
                            input_dtype: str = "float32",
                            rows: Optional[RowBins] = None,
                            exchange=None) -> torch.Tensor:
    """Histogram K leaf-contiguous row segments in one pass over a
    [capacity] scratch: slot k holds segment k's histogram, exactly
    hist_multileaf_masked's output for that leaf.  The kernel (K1 on the
    int8 path, K2 in float32 / bfloat16) walks each slot's run of the
    scratch, [base[k], base[k+1]), reading bins through the gathered row
    ids (from the byte copy `rows` when given); only the [3, capacity]
    gradient rows are gathered here.  The kernels read the slot bounds,
    not per-position slot ids (the gather still finds each position's
    slot to find its row).  On the int8 path the quantization scales derive from the
    gathered rows only, as in JAX.  `exchange` as in
    `hist_multileaf_masked`; under it the int8 bound is judged on the
    whole padded row axis, a count every rank shares (each rank picks
    its own capacity tier)."""
    B = num_bins_padded
    idx, _, valid, _, base = _gather_rows(perm, seg_off, seg_cnt, capacity)
    ghg = gh8[:3][:, idx.long()] * valid.to(torch.float32)[None, :]
    if input_dtype == "int8":
        if _int8_ok(capacity if exchange is None
                    else perm.shape[0] * exchange.shards):
            ghq, sg, sh = _quantize_gh(ghg, exchange)
            h = segment_counts(bins_fn, rows, idx, ghq, base, B)
            return _dequantize(_exchanged(h, exchange), sg, sh)
        input_dtype = "bfloat16"
    return _exchanged(segment_counts(bins_fn, rows, idx,
                                     ghg.to(torch.float32), base, B,
                                     round_bf16=input_dtype == "bfloat16"),
                      exchange)


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
                 input_dtype: str, exchange=None):
    """The per-pass set-up of a sparse histogram, in the order of the JAX
    function: quantize (int8; with the scales shared by a mesh
    `exchange`'s ranks), slot of every row, slot totals.  Returns
    (srow [N] int32, vals [3, N] int32 or float32, tot [K, 3] of vals'
    type, scale [3] f32 (sg, sh, 1) for int8 or None)."""
    K = sl.shape[0]
    rows = lid.shape[0] * (exchange.shards if exchange is not None else 1)
    if _sparse_quant_ok(input_dtype, rows):
        vals, sg, sh = _quantize_gh(gh8, exchange)         # [3, N] int32
        scale = torch.stack([sg, sh, torch.ones_like(sg)])
    else:
        vals, scale = gh8[:3].to(torch.float32), None
    srow = _slot_of_rows(lid, sl)
    return srow, vals, _slot_totals(srow, vals, K), scale


def hist_sparse_xla(cols: torch.Tensor, binsv: torch.Tensor,
                    zero_bin: torch.Tensor, lid: torch.Tensor,
                    gh8: torch.Tensor, sl: torch.Tensor, *,
                    num_columns_padded: int, num_bins_padded: int,
                    input_dtype: str = "float32",
                    exchange=None) -> torch.Tensor:
    """Nonzero-iterating multi-leaf histogram in plain torch ops over the
    ELL arrays, on any device — the JAX function's formulation.

    cols/binsv [N, R] int32 ELL entries (col >= num_columns_padded marks
    an empty slot); zero_bin [Cp] int32 (-1 = padded column); lid [N]
    int32 leaf ids; gh8 [>=3, N] f32 (grad·rm, hess·rm, rm); sl [K]
    int32 leaf ids to histogram (-1 = empty slot).  Returns
    [K, Cp, 3, B] f32 — hist_multileaf_masked's contract over the sparse
    store.  input_dtype "int8" quantizes per pass (`_quantize_gh`) and
    keeps the stored sums, slot totals and zero-bin residual in int32,
    with one dequantizing scale at the end.  A mesh `exchange` reduces
    the finished float32 histogram across its ranks (as on CUDA, where
    the kernel finishes it), the int8 scales shared by the ranks."""
    srow, vals, tot, scale = _sparse_pass(lid, gh8, sl, input_dtype,
                                          exchange)
    hist = _sparse_hist_plain(cols, binsv, srow, vals, sl.shape[0],
                              num_columns_padded, num_bins_padded)
    return _exchanged(finish_sparse_hist(hist, tot, zero_bin, scale),
                      exchange)


def hist_sparse_multileaf(sp, lid: torch.Tensor, gh8: torch.Tensor,
                          sl: torch.Tensor, *, num_columns_padded: int,
                          num_bins_padded: int,
                          input_dtype: str = "float32",
                          exchange=None) -> torch.Tensor:
    """hist_sparse_xla's contract over the sparse store
    sp = (cols, binsv, zero_bin[, streams]).  A CUDA tensor launches
    kernel K7 (int8) or K8 (float32) over the column-sorted entry
    streams (`sparse_streams`; built here when sp carries none), a CPU
    tensor takes hist_sparse_xla.  `exchange` as in hist_sparse_xla."""
    cols, binsv, zero_bin = sp[0], sp[1], sp[2]
    Cp = num_columns_padded
    if not cols.is_cuda:
        return hist_sparse_xla(cols, binsv, zero_bin, lid, gh8, sl,
                               num_columns_padded=Cp,
                               num_bins_padded=num_bins_padded,
                               input_dtype=input_dtype, exchange=exchange)
    st = sp[3] if len(sp) > 3 else build_sparse_streams(cols, binsv, Cp)
    srow, vals, tot, scale = _sparse_pass(lid, gh8, sl, input_dtype,
                                          exchange)
    return _exchanged(hist_streams(st, zero_bin, srow, vals, tot, scale,
                                   sl.shape[0], Cp, num_bins_padded),
                      exchange)


def hist_sparse_gathered(sp, gh8: torch.Tensor, perm: torch.Tensor,
                         seg_off: torch.Tensor, seg_cnt: torch.Tensor, *,
                         capacity: int, num_columns_padded: int,
                         num_bins_padded: int,
                         input_dtype: str = "float32",
                         exchange=None) -> torch.Tensor:
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
                           num_bins_padded=num_bins_padded,
                           exchange=exchange)


# ----------------------------------------------------------------------------
# One-leaf full-scan histograms (the fused single-split builder's feeds)
# ----------------------------------------------------------------------------

def _mask_feed(grad: torch.Tensor, hess: torch.Tensor, mask: torch.Tensor):
    """gh8 [3, N] (grad·mask, hess·mask, mask) and the one-slot masked
    feed: leaf id 0 on rows inside the mask, -1 outside, slot list [0] —
    device tensors, so the slot is chosen without a host read."""
    gh8 = torch.stack([grad * mask, hess * mask, mask])
    lid = (mask != 0).to(torch.int32) - 1
    sl = torch.zeros(1, dtype=torch.int32, device=mask.device)
    return gh8, lid, sl


def histogram_full_masked(bins: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, mask: torch.Tensor, *,
                          num_bins_padded: int,
                          input_dtype: str = "float32",
                          rows: Optional[RowBins] = None) -> torch.Tensor:
    """Full-scan masked histogram of one leaf over all rows (no gather):
    the fused leaf-wise builder's dense feed.

    bins [F, N] int (int8 = value-128 storage), grad/hess [N] f32, mask
    [N] f32 0/1 row weights.  Returns [F, 3, B] f32.  int8 coerces to
    float32 (`_coerce_dtype`), as the JAX function's `hist_xla` does.  A
    CUDA tensor launches kernel K2 through the masked feed of
    `hist_multileaf_masked` with one slot (rows outside the mask carry
    leaf id -1), reading the byte copy `rows` when given; a CPU tensor
    takes `hist_xla`."""
    input_dtype = _coerce_dtype(input_dtype)
    if not bins.is_cuda:
        gb = bins.t().to(torch.int32)
        if bins.dtype == torch.int8:
            gb = gb + 128
        vals = torch.stack([grad * mask, hess * mask, mask])
        return hist_xla(gb, vals, num_bins_padded=num_bins_padded,
                        input_dtype=input_dtype)
    gh8, lid, sl = _mask_feed(grad, hess, mask)
    return hist_multileaf_masked(bins, lid, gh8, sl,
                                 num_bins_padded=num_bins_padded,
                                 input_dtype=input_dtype, rows=rows)[0]


def histogram_full_sparse(cols: torch.Tensor, binsv: torch.Tensor,
                          zero_bin: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, mask: torch.Tensor, *,
                          num_columns_padded: int, num_bins_padded: int,
                          input_dtype: str = "float32",
                          streams=None) -> torch.Tensor:
    """histogram_full_masked's contract over the sparse store: cols/binsv
    [N, R] ELL entries (a column >= num_columns_padded an empty slot),
    zero_bin [Cp] int32 (-1 = padded column), and on CUDA optionally the
    store's column-sorted `streams` (built here when not given, as
    `hist_sparse_multileaf` does).  The K=1 specialisation of
    `hist_sparse_multileaf`, every row in slot 0 and the mask in the
    value rows, so masked rows add to neither the stored entries nor
    the totals and the zero-bin residual is exact for any mask.  Returns
    [Cp, 3, B] f32.  int8 coerces to float32, as in the JAX function.
    A CUDA tensor launches kernel K8 over the column-sorted streams; a
    CPU tensor takes `hist_sparse_xla`."""
    gh8 = torch.stack([grad * mask, hess * mask, mask])
    N = grad.shape[0]
    lid = torch.zeros(N, dtype=torch.int32, device=grad.device)
    sl = torch.zeros(1, dtype=torch.int32, device=grad.device)
    sp = (cols, binsv, zero_bin) + (() if streams is None else (streams,))
    return hist_sparse_multileaf(sp, lid, gh8, sl,
                                 num_columns_padded=num_columns_padded,
                                 num_bins_padded=num_bins_padded,
                                 input_dtype=_coerce_dtype(input_dtype))[0]
