// K-leaf histogram kernels of the batched-rounds learner (K1 and K2).
//
// Replace the Pallas TPU kernels `_hist_kernel_masked_q` (K1, int8
// gradients, exact int32 accumulation) and `_hist_kernel_masked` (K2,
// float32 / bfloat16 operands, float32 accumulation) reached through
// lightgbm_tpu/ops/histogram.py `hist_multileaf_masked` (and, for the
// gathered row feed, `hist_multileaf_gathered`).
//
// Contract (the JAX function's output): out[k, f, c, b] sums vals[c, p]
// over the positions p of slot k and bins[f, row(p)] == b, where row(p)
// = row_idx[p] when a row index is given (the gathered row feed) and p
// otherwise.  Bins outside [0, B) add nothing, as in the one-hot
// formulation.  int8-stored bins hold value - 128.
//
// K1 (hist_q_kernel) is designed for this card rather than carried over
// from the TPU's one-hot matmuls.  What bounds it: the bins of each row
// it reads and 3 shared-memory integer adds per (row, feature).
//   - Work sized by the rows: in the gathered feed each slot's positions
//     are one contiguous run of the scratch, [base[k], base[k+1]), so
//     each block takes one tile of tile_rows positions of one slot's run
//     (a slot with no rows gets one block, which writes its zeros).  The
//     grid, ceil(capacity / tile_rows) + K blocks, bounds the tiles
//     without a device read; blocks past the work exit after reading
//     base.  No block scans leaf ids it does not own.  In the masked feed
//     (the root pass: one slot, every row) each slot's positions are cut
//     into P tiles and a position adds when lid[p] == sl[k].
//   - Bins read a row at a time: the rounds learner keeps a row-major
//     byte copy of the store ([N, F4] uint8, F4 = F rounded up to 4),
//     28 B a north-star row.  A lane loads one 32-bit word, the bins of
//     4 features, so 7 lanes cover a row and a warp adds 4 rows a step;
//     a feature's cells sit at an odd stride of (3 nb) | 1 words, so the
//     lanes fall in different banks.  Above 256 bins the kernel reads
//     the [F, N] store, one feature a lane.
//   - Only the store's nb real bins are zeroed, added and combined.
//   - No contended flush: a slot that one block covers writes its cells
//     with plain stores; the tiles of a slot split across blocks combine
//     through a slab and tickets (tile_combine.cuh) and the last block
//     writes each cell once.  Integer sums are exact in any order, so K1
//     is bitwise equal to its plain version and to the JAX kernel.
//
// K2 (hist_kernel<BinT, float>) keeps the earlier design: grid x
// walks chunks of positions, y the K slots, z feature tiles; a block
// scans its chunk's leaf ids for its slot, leaves if none is there, adds
// into a [F_tile, 3, B] shared histogram and flushes the non-zero cells
// with global float atomics (exact up to the order of the additions).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_combine.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// warp steps whose bins a lane loads before it adds them
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_acc(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <typename BinT, typename T>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const BinT* __restrict__ bins, long long n_stride, int F,
            int f_tile, const int* __restrict__ row_idx,
            const int* __restrict__ lid, const T* __restrict__ vals,
            long long C, long long chunk, const int* __restrict__ sl,
            int B, int bin_offset, int round_bf16, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const int k = blockIdx.y;
  const int f0 = blockIdx.z * f_tile;
  const int nf = min(f_tile, F - f0);
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = min(C, c0 + chunk);
  const int target = sl[k];

  // leave early when no position of this chunk belongs to slot k
  int any = 0;
  for (long long base = c0; base < c1; base += blockDim.x) {
    const long long p = base + threadIdx.x;
    const int hit = (p < c1) && (lid[p] == target);
    if (__syncthreads_or(hit)) {
      any = 1;
      break;
    }
  }
  if (!any) return;

  const int cells = nf * 3 * B;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = T(0);
  __syncthreads();

  for (long long p = c0 + threadIdx.x; p < c1; p += blockDim.x) {
    if (lid[p] != target) continue;
    const T g = to_acc(vals[p], round_bf16);
    const T h = to_acc(vals[C + p], round_bf16);
    const T m = to_acc(vals[2 * C + p], round_bf16);
    if (g == T(0) && h == T(0) && m == T(0)) continue;
    const long long row = row_idx ? (long long)row_idx[p] : p;
    const BinT* col = bins + (long long)f0 * n_stride + row;
    for (int f = 0; f < nf; ++f) {
      const int b = (int)col[(long long)f * n_stride] + bin_offset;
      if ((unsigned)b >= (unsigned)B) continue;
      T* cell = sh + f * 3 * B + b;
      if (g != T(0)) atomicAdd(cell, g);
      if (h != T(0)) atomicAdd(cell + B, h);
      if (m != T(0)) atomicAdd(cell + 2 * B, m);
    }
  }
  __syncthreads();

  T* dst = out + ((long long)k * F + f0) * 3 * B;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const T v = sh[i];
    if (v != T(0)) atomicAdd(dst + i, v);
  }
}

template <typename BinT, typename T>
cudaError_t launch(const void* bins, long long n_stride, int F,
                   const int* row_idx, const int* lid, const void* vals,
                   long long C, const int* sl, int K, int B, int round_bf16,
                   void* out, cudaStream_t stream) {
  // shared-memory budget per block: ~96 KB keeps two blocks on an SM
  const int per_feature = 3 * B * (int)sizeof(T);
  const int f_tile = min(F, (96 * 1024) / per_feature);
  if (f_tile < 1) return cudaErrorInvalidValue;
  const int smem = f_tile * per_feature;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_kernel<BinT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        96 * 1024);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int ftiles = (F + f_tile - 1) / f_tile;
  // about two resident blocks per SM for one slot and feature tile
  const long long target_chunks = 264 / ftiles + 1;
  long long chunk = (C + target_chunks - 1) / target_chunks;
  if (chunk < 1024) chunk = 1024;
  const long long nchunks = (C + chunk - 1) / chunk;
  if (nchunks > 0x7fffffffLL || K > 65535 || ftiles > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)nchunks, (unsigned)K, (unsigned)ftiles);
  const int bin_offset = sizeof(BinT) == 1 ? 128 : 0;
  hist_kernel<BinT, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), n_stride, F, f_tile, row_idx, lid,
      static_cast<const T*>(vals), C, chunk, sl, B, bin_offset, round_bf16,
      static_cast<T*>(out));
  return cudaGetLastError();
}

// The row-major byte copy: [N, stride] uint8, stride a multiple of 4; a
// lane group is the 4 features of one 32-bit word.
struct RowsU8 {
  static constexpr int kG = 4;
  const unsigned char* p;
  long long stride;
  __device__ __forceinline__ void load(long long r, int f, int* b) const {
    const unsigned w =
        __ldg(reinterpret_cast<const unsigned*>(p + r * stride + f));
    b[0] = w & 0xff;
    b[1] = (w >> 8) & 0xff;
    b[2] = (w >> 16) & 0xff;
    b[3] = w >> 24;
  }
};

// The [F, stride] store, int32 or int8 (value - 128); one feature a lane.
template <typename BinT>
struct Cols {
  static constexpr int kG = 1;
  const BinT* p;
  long long stride;
  __device__ __forceinline__ void load(long long r, int f, int* b) const {
    b[0] = (int)__ldg(p + f * stride + r) + (sizeof(BinT) == 1 ? 128 : 0);
  }
};

template <typename Feed>
__global__ void __launch_bounds__(kThreads)
hist_q_kernel(Feed feed, int F, int f_tile, int nb, int B,
              const int* __restrict__ row_idx, const int* __restrict__ vals,
              long long C, const long long* __restrict__ base,
              long long tile_rows, const int* __restrict__ lid,
              const int* __restrict__ sl, int P_masked, int K,
              unsigned* __restrict__ slab, unsigned* __restrict__ gslab,
              int* __restrict__ tickets, long long slab_items,
              long long gslab_items, long long ticket_items,
              int* __restrict__ out) {
  constexpr int kG = Feed::kG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* sh = reinterpret_cast<unsigned*>(smem_raw);
  const int S = (3 * nb) | 1;
  const int z = blockIdx.y;
  const int f0 = z * f_tile;
  const int nf = min(f_tile, F - f0);
  const int words = nf * S;
  __shared__ long long s_lo, s_hi;
  __shared__ int s_k, s_t, s_P, s_item, s_gitem, s_tick;

  // ---- this block's work: slot k, tile t of its P, positions [lo, hi)
  if (base) {
    // the segment bounds sit past the tile, at an even word
    long long* sbase =
        reinterpret_cast<long long*>(sh + ((f_tile * S + 1) & ~1));
    for (int j = threadIdx.x; j <= K; j += kThreads) sbase[j] = base[j];
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long b = blockIdx.x;
      long long acc = 0, gacc = 0;
      s_k = -1;
      for (int j = 0; j < K; ++j) {
        const long long cnt = sbase[j + 1] - sbase[j];
        const long long Pj =
            cnt > tile_rows ? (cnt + tile_rows - 1) / tile_rows : 1;
        if (b < acc + Pj) {
          s_k = j;
          s_t = (int)(b - acc);
          s_P = (int)Pj;
          s_lo = sbase[j] + (b - acc) * tile_rows;
          s_hi = min(sbase[j + 1], s_lo + tile_rows);
          s_item = (int)acc;
          s_gitem = (int)gacc;
          s_tick = (int)gacc + j;
          break;
        }
        acc += Pj;
        gacc += tile_combine::groups((int)Pj);
      }
    }
  } else if (threadIdx.x == 0) {
    const int k = blockIdx.x / P_masked;
    const int t = blockIdx.x - k * P_masked;
    const int ng = tile_combine::groups(P_masked);
    s_k = k;
    s_t = t;
    s_P = P_masked;
    s_lo = (long long)t * tile_rows;
    s_hi = min(C, s_lo + tile_rows);
    s_item = k * P_masked;
    s_gitem = k * ng;
    s_tick = k * (ng + 1);
  }
  __syncthreads();
  const int k = s_k;
  if (k < 0) return;                    // past the work
  const long long lo = s_lo, hi = s_hi;
  const int target = base ? 0 : sl[k];

  for (int i = threadIdx.x; i < words; i += kThreads) sh[i] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpr = (nf + kG - 1) / kG;     // lanes a row
  const int rps = 32 / lpr;               // rows a warp step
  const int steps = (32 + rps - 1) / rps;
  const int jl = lane / lpr;
  const int fq = (lane - jl * lpr) * kG;  // this lane's first feature
  const bool lane_on = jl < rps;

  for (long long p0 = lo + warp * 32; p0 < hi; p0 += kWarps * 32) {
    // one position a lane: its row and (grad, hess, count)
    const long long p = p0 + lane;
    int r = 0, gv = 0, hv = 0, mv = 0;
    if (p < hi && (base || __ldg(lid + p) == target)) {
      r = row_idx ? __ldg(row_idx + p) : (int)p;
      gv = __ldg(vals + p);
      hv = __ldg(vals + C + p);
      mv = __ldg(vals + 2 * C + p);
    }
    const bool keep = (gv | hv | mv) != 0;
    // then `rps` rows a step, kUnroll steps' bins loaded before the adds
#pragma unroll 1
    for (int s0 = 0; s0 < steps; s0 += kUnroll) {
      int b[kUnroll][kG];
      bool on[kUnroll];
      int src[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = (s0 + u) * rps + jl;
        src[u] = j & 31;
        const int rj = __shfl_sync(0xffffffffu, r, src[u]);
        const bool kj = __shfl_sync(0xffffffffu, keep, src[u]);
        on[u] = lane_on && j < 32 && kj;
        if (on[u]) feed.load(rj, f0 + fq, b[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int gj = __shfl_sync(0xffffffffu, gv, src[u]);
        const int hj = __shfl_sync(0xffffffffu, hv, src[u]);
        const int mj = __shfl_sync(0xffffffffu, mv, src[u]);
        if (!on[u]) continue;
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          const int f = fq + i;
          const int bin = b[u][i];
          if (f >= nf || (unsigned)bin >= (unsigned)nb) continue;
          int* cell = reinterpret_cast<int*>(sh + f * S + bin);
          if (gj) atomicAdd(cell, gj);
          if (hj) atomicAdd(cell + nb, hj);
          if (mj) atomicAdd(cell + 2 * nb, mj);
        }
      }
    }
  }
  __syncthreads();

  const long long item_words = (long long)f_tile * S;
  if (!tile_combine::combine(
          sh, words, s_t, s_P,
          slab + ((long long)z * slab_items + s_item) * item_words,
          gslab + ((long long)z * gslab_items + s_gitem) * item_words,
          tickets + (long long)z * ticket_items + s_tick,
          tile_combine::AddInt{}))
    return;
  __syncthreads();

  // one write of every output cell of the slot's feature tile
  int* dst = out + ((long long)k * F + f0) * 3 * B;
  for (int i = threadIdx.x; i < nf * 3 * B; i += kThreads) {
    const int f = i / (3 * B);
    const int cb = i - f * 3 * B;
    const int c = cb / B;
    const int bin = cb - c * B;
    dst[i] = bin < nb ? (int)sh[f * S + c * nb + bin] : 0;
  }
}

template <typename Feed>
cudaError_t launch_q(Feed feed, int F, int f_tile, int nb, int B,
                     const int* row_idx, const int* vals, long long C,
                     const long long* base, long long tile_rows,
                     const int* lid, const int* sl, int P_masked, int K,
                     int n_blocks, void* slab, void* gslab, int* tickets,
                     long long slab_items, long long gslab_items,
                     long long ticket_items, int* out, cudaStream_t stream) {
  static int smem_set = 48 * 1024;
  const int S = (3 * nb) | 1;
  // the tile, then (gathered feed) the K + 1 segment bounds, 8-aligned
  const long long smem = (long long)((f_tile * S + 1) & ~1) * 4 +
                         (base ? (long long)(K + 1) * 8 : 0);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_q_kernel<Feed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = (int)smem;
  }
  const int ftiles = (F + f_tile - 1) / f_tile;
  dim3 grid((unsigned)n_blocks, (unsigned)ftiles);
  hist_q_kernel<Feed><<<grid, kThreads, (int)smem, stream>>>(
      feed, F, f_tile, nb, B, row_idx, vals, C, base, tile_rows, lid, sl,
      P_masked, K, static_cast<unsigned*>(slab),
      static_cast<unsigned*>(gslab), tickets, slab_items, gslab_items,
      ticket_items, out);
  return cudaGetLastError();
}

}  // namespace

// K1.  feed 0: bins is the row-major byte copy [N, stride] uint8 (stride
// a multiple of 4, f_tile a multiple of 4); feed 1 / 2: the [F, stride]
// store in int32 / int8 (value - 128).  Every bin is below nb <= B.
// row_idx: [C] int32 or null; vals: [3, C] int32.  Gathered feed: base
// [K + 1] int64 segment bounds in the scratch, n_blocks = ceil(capacity
// / tile_rows) + K; masked feed (base null): lid [C] and sl [K] int32,
// P_masked tiles of tile_rows positions a slot, n_blocks = K * P_masked.
// The caller sizes the work (ops/histogram.py `_k1_plan`); slab: [tiles,
// slab_items, f_tile * S] words, gslab: [tiles, gslab_items, f_tile * S]
// words, tickets: [tiles, ticket_items] int32, zero, left zero; out:
// [K, F, 3, B] int32, every cell written.
extern "C" int lgbt_hist_q(const void* bins, int feed, long long stride,
                           int F, int f_tile, int nb, int B,
                           const int* row_idx, const int* vals, long long C,
                           const long long* base, long long tile_rows,
                           const int* lid, const int* sl, int P_masked,
                           int K, int n_blocks, void* slab, void* gslab,
                           int* tickets, long long slab_items,
                           long long gslab_items, long long ticket_items,
                           int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_tile < 1 || nb < 1 || nb > B || tile_rows < 1 || n_blocks < 1 ||
      (F + f_tile - 1) / f_tile > 65535 || (!base && (!lid || !sl)))
    return cudaErrorInvalidValue;
  if (feed == 0) {
    if (f_tile % 4 || stride % 4 || f_tile > 128)
      return cudaErrorInvalidValue;
    return launch_q(RowsU8{static_cast<const unsigned char*>(bins), stride},
                    F, f_tile, nb, B, row_idx, vals, C, base, tile_rows, lid,
                    sl, P_masked, K, n_blocks, slab, gslab, tickets,
                    slab_items, gslab_items, ticket_items,
                    static_cast<int*>(out), s);
  }
  if (f_tile > 32) return cudaErrorInvalidValue;
  if (feed == 1)
    return launch_q(Cols<int32_t>{static_cast<const int32_t*>(bins), stride},
                    F, f_tile, nb, B, row_idx, vals, C, base, tile_rows, lid,
                    sl, P_masked, K, n_blocks, slab, gslab, tickets,
                    slab_items, gslab_items, ticket_items,
                    static_cast<int*>(out), s);
  if (feed == 2)
    return launch_q(Cols<int8_t>{static_cast<const int8_t*>(bins), stride},
                    F, f_tile, nb, B, row_idx, vals, C, base, tile_rows, lid,
                    sl, P_masked, K, n_blocks, slab, gslab, tickets,
                    slab_items, gslab_items, ticket_items,
                    static_cast<int*>(out), s);
  return cudaErrorInvalidValue;
}

// K2.  bins: [F, n_stride] int32 or int8 (value - 128); row_idx: [C] or
// null; lid: [C] int32; vals: [3, C] float32; sl: [K] int32; out: zeroed
// [K, F, 3, B] float32.
extern "C" int lgbt_hist_multileaf(const void* bins, int bins_int8,
                                   long long n_stride, int F,
                                   const int* row_idx, const int* lid,
                                   const void* vals, long long C,
                                   const int* sl, int K, int B,
                                   int round_bf16, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bins_int8
      ? launch<int8_t, float>(bins, n_stride, F, row_idx, lid, vals, C, sl,
                              K, B, round_bf16, out, s)
      : launch<int32_t, float>(bins, n_stride, F, row_idx, lid, vals, C, sl,
                               K, B, round_bf16, out, s);
}
