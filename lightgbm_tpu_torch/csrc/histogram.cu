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
// formulation.  int8-stored bins hold value - 128.  K2 rounds each value
// to bfloat16 first in bfloat16 mode.
//
// Both kernels share their work plan and their bin feeds:
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
//     28 B a north-star row, read as 32-bit words of 4 bins.  Above 256
//     bins the kernels read the [F, N] store, one bin a load.
//   - Only the store's nb real bins are zeroed, added and combined.
//   - No contended flush: a slot that one block covers writes its cells
//     with plain stores; the tiles of a slot split across blocks combine
//     through a slab and tickets in a fixed order (tile_combine.cuh) and
//     the last block writes each cell once.
//
// K1 (hist_q_kernel): what bounds it is the bins of each row
// and 3 shared-memory integer atomics per (row, feature).  7 lanes cover
// a north-star row and a warp adds 4 rows a step; a feature's cells sit
// at an odd stride of (3 nb) | 1 words, so the lanes fall in different
// banks.  Integer sums are exact in any order, so K1 is bitwise equal to
// its plain version and to the JAX kernel.
//
// K2 (hist_owned_kernel): float shared atomics compile to compare-and-swap
// loops on this card and add in a run-dependent order, so K2 gives every
// float cell one owner thread and adds in a fixed order instead: the sums
// are the same bits from run to run.  A block keeps one copy of its
// feature tile, three planes (grad, hess, count) of [nb + 1][ls] floats
// (ls: the lane stride, 32 for up to 32 features; bin nb a trash cell a
// lane), 98 KB at 255 bins, so two blocks fit an SM.  Owner warp c of a
// block owns plane c and its lane f feature f: lane f's cells sit in bank
// f whatever their bins, and the three warps walk the same rows, each
// adding one channel.  What bounds K2 is the owners' instructions and add
// chains (a cell is loaded, added to and stored, and the next row may hit
// the same cell), not bytes: a lane takes 4 rows at a time, their bins in
// one 8-byte load and their values in one 16-byte broadcast, loads the 4
// cells before any store, forwards a sum in registers to a later row of
// the same bin, and reads the next 4 rows before it stores; a bin that
// adds nothing (a row of no slot, a lane of no feature) adds into the
// lane's trash cell, so no load or store needs a predicate.  The block's
// 4 warps stage batches of 128 positions in shared memory (values and
// row ids two batches ahead of the owners, the rows' bins one ahead,
// feature-major), so the dependent loads (row id, then the row's bins)
// are in flight while the owners add; no instruction reads a loaded word
// before the owners are done, or the warp would wait out the load.  The
// copy is the tile that the blocks of a slot combine; the output is
// written 32 bins of one channel at a time through a small transposing
// stage, so that reads and writes are conflict-free and each warp writes
// 128 B at once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_combine.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// warp steps whose bins a lane loads before it adds them
constexpr int kUnroll = 4;

// K2: threads a block (3 owner warps and a fourth that only stages),
// positions a staged batch (one a thread)
constexpr int kOThreads = 128;
constexpr int kBatch = kOThreads;
// 16-bit bins a feature's row of K2's bin stage: kBatch and a pad, so
// that lane f's 8-byte loads fall in banks 2f, 2f + 1
constexpr int kSP = kBatch + 4;

__device__ __forceinline__ float to_acc(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The row-major byte copy: [N, stride] uint8, stride a multiple of 4; a
// lane group (an item) is the 4 features of one 32-bit word.
struct RowsU8 {
  static constexpr int kG = 4;
  const unsigned char* p;
  long long stride;
  __device__ __forceinline__ unsigned item(long long r, int f) const {
    return __ldg(reinterpret_cast<const unsigned*>(p + r * stride + f));
  }
  __device__ __forceinline__ static int bin(unsigned w, int i) {
    return (w >> (8 * i)) & 0xff;
  }
};

// The [F, stride] store, int32 or int8 (value - 128); an item is one bin.
template <typename BinT>
struct Cols {
  static constexpr int kG = 1;
  const BinT* p;
  long long stride;
  __device__ __forceinline__ unsigned item(long long r, int f) const {
    return (unsigned)((int)__ldg(p + f * stride + r) +
                      (sizeof(BinT) == 1 ? 128 : 0));
  }
  __device__ __forceinline__ static int bin(unsigned w, int) {
    return (int)w;
  }
};

// One block's work: slot k, tile t of its P, positions [lo, hi), and the
// offsets of its partial tile, its group sum and its tickets in the
// combine scratch.
struct Work {
  long long lo, hi;
  int k, t, P, item, gitem, tick;
};

// Work of this block (block-uniform, after the call's last barrier); k <
// 0 marks a block past the work.  Gathered feed: base [K + 1] segment
// bounds (copied to sbase, K + 1 words of shared memory), slot k's run
// cut into tiles of tile_rows, numbered slot by slot; masked feed: slot
// blockIdx.x / P_masked, its tile of the C positions.
__device__ void find_work(const long long* __restrict__ base,
                          long long* sbase, long long tile_rows, int K,
                          long long C, int P_masked, Work* w) {
  if (base) {
    for (int j = threadIdx.x; j <= K; j += blockDim.x) sbase[j] = base[j];
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long b = blockIdx.x;
      long long acc = 0, gacc = 0;
      w->k = -1;
      for (int j = 0; j < K; ++j) {
        const long long cnt = sbase[j + 1] - sbase[j];
        const long long Pj =
            cnt > tile_rows ? (cnt + tile_rows - 1) / tile_rows : 1;
        if (b < acc + Pj) {
          w->k = j;
          w->t = (int)(b - acc);
          w->P = (int)Pj;
          w->lo = sbase[j] + (b - acc) * tile_rows;
          w->hi = min(sbase[j + 1], w->lo + tile_rows);
          w->item = (int)acc;
          w->gitem = (int)gacc;
          w->tick = (int)gacc + j;
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
    w->k = k;
    w->t = t;
    w->P = P_masked;
    w->lo = (long long)t * tile_rows;
    w->hi = min(C, w->lo + tile_rows);
    w->item = k * P_masked;
    w->gitem = k * ng;
    w->tick = k * (ng + 1);
  }
  __syncthreads();
}

// The combined [f_tile][(3 nb) | 1] tile in shared memory to the slot's
// [nf, 3, B] rows of the output, every cell written once (bins from nb
// on are zero); words are written as they are (int32 or float32).
__device__ __forceinline__ void write_tile(const unsigned* sh, int nf,
                                           int nb, int B,
                                           unsigned* __restrict__ dst) {
  const int S = (3 * nb) | 1;
  for (int i = threadIdx.x; i < nf * 3 * B; i += blockDim.x) {
    const int f = i / (3 * B);
    const int cb = i - f * 3 * B;
    const int c = cb / B;
    const int bin = cb - c * B;
    dst[i] = bin < nb ? sh[f * S + c * nb + bin] : 0u;
  }
}

// K1: int32 values, integer atomics.
template <typename Feed>
__global__ void __launch_bounds__(kThreads)
hist_q_kernel(Feed feed, int F, int f_tile, int nb, int B,
              const int* __restrict__ row_idx, const int* __restrict__ vals,
              long long C, const long long* __restrict__ base,
              long long tile_rows, const int* __restrict__ lid,
              const int* __restrict__ sl, int P_masked, int K,
              unsigned* __restrict__ slab,
              unsigned* __restrict__ gslab, int* __restrict__ tickets,
              long long slab_items, long long gslab_items,
              long long ticket_items, unsigned* __restrict__ out) {
  constexpr int kG = Feed::kG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* sh = reinterpret_cast<unsigned*>(smem_raw);
  const int S = (3 * nb) | 1;
  const int z = blockIdx.y;
  const int f0 = z * f_tile;
  const int nf = min(f_tile, F - f0);
  const int words = nf * S;
  __shared__ Work s_w;

  // the segment bounds sit past the tile, at an even word
  find_work(base, reinterpret_cast<long long*>(sh + ((f_tile * S + 1) & ~1)),
            tile_rows, K, C, P_masked, &s_w);
  const int k = s_w.k;
  if (k < 0) return;                    // past the work
  const long long lo = s_w.lo, hi = s_w.hi;
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
      int bb[kUnroll][kG];
      bool on[kUnroll];
      int src[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = (s0 + u) * rps + jl;
        src[u] = j & 31;
        const int rj = __shfl_sync(0xffffffffu, r, src[u]);
        const bool kj = __shfl_sync(0xffffffffu, keep, src[u]);
        on[u] = lane_on && j < 32 && kj;
        if (on[u]) {
          // the bins taken apart here, at the load: taken apart in the
          // adds below, they made the kernel ~5% slower on an H100
          const unsigned wv = feed.item(rj, f0 + fq);
#pragma unroll
          for (int i = 0; i < kG; ++i) bb[u][i] = Feed::bin(wv, i);
        }
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
          const int bin = bb[u][i];
          if (f >= nf || (unsigned)bin >= (unsigned)nb) continue;
          int* ic = reinterpret_cast<int*>(sh + f * S + bin);
          if (gj) atomicAdd(ic, gj);
          if (hj) atomicAdd(ic + nb, hj);
          if (mj) atomicAdd(ic + 2 * nb, mj);
        }
      }
    }
  }
  __syncthreads();

  const long long item_words = (long long)f_tile * S;
  unsigned* my_slab =
      slab + ((long long)z * slab_items + s_w.item) * item_words;
  unsigned* my_gslab =
      gslab + ((long long)z * gslab_items + s_w.gitem) * item_words;
  int* my_tick = tickets + (long long)z * ticket_items + s_w.tick;
  if (!tile_combine::combine<kThreads>(sh, words, s_w.t, s_w.P, my_slab,
                                       my_gslab, my_tick,
                                       tile_combine::AddInt{}))
    return;
  __syncthreads();
  write_tile(sh, nf, nb, B, out + ((long long)k * F + f0) * 3 * B);
}

// K2.  Shared memory: the copy, 3 (nb + 1) ls words ([3][nb + 1][ls]
// floats, lanes past nf and bin nb, the trash, left out of the output),
// the staged batches (two slots of kBatch values a channel and kBatch
// row ids; bins feature-major, [f_tile + 1][kSP] 16-bit, the last row
// and bin nb the sentinel that adds into the trash), then the gathered
// feed's K + 1 segment bounds.  kLS: the lane stride ls when it is 32
// (a shift), else 0 (ls at run time).  After the adds the staged
// batches' space holds the [ls][33] transposing stage of the output.
template <typename Feed, int kLS>
__global__ void __launch_bounds__(kOThreads, 4)
hist_owned_kernel(Feed feed, int F, int f_tile, int ls_arg, int nb, int B,
                  const int* __restrict__ row_idx,
                  const float* __restrict__ vals, long long C,
                  const long long* __restrict__ base, long long tile_rows,
                  const int* __restrict__ lid, const int* __restrict__ sl,
                  int P_masked, int K, int round_bf16,
                  unsigned* __restrict__ slab, unsigned* __restrict__ gslab,
                  int* __restrict__ tickets, long long slab_items,
                  long long gslab_items, long long ticket_items,
                  float* __restrict__ out) {
  constexpr int kG = Feed::kG;
  // items (words or bins) of one row a thread stages: f_tile <= 32
  constexpr int kItems = 32 / kG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* sh = reinterpret_cast<unsigned*>(smem_raw);
  const int ls = kLS ? kLS : ls_arg;
  // a plane holds nb bins and, at bin nb, each lane's trash cell: the
  // sentinel bin adds there, so no load or store needs a predicate
  const int pw = (nb + 1) * ls;
  const int cw = 3 * pw;
  // [2][3][kBatch] values, [2][kBatch] rows, [f_tile + 1][kSP] bins
  float* svals = reinterpret_cast<float*>(sh + ((cw + 3) & ~3));
  int* srow = reinterpret_cast<int*>(svals + 2 * 3 * kBatch);
  unsigned short* sbin = reinterpret_cast<unsigned short*>(srow + 2 * kBatch);
  const int z = blockIdx.y;
  const int f0 = z * f_tile;
  const int nf = min(f_tile, F - f0);
  __shared__ Work s_w;
  find_work(base, reinterpret_cast<long long*>(sbin + (f_tile + 1) * kSP),
            tile_rows, K, C, P_masked, &s_w);
  const int k = s_w.k;
  if (k < 0) return;                    // past the work
  const long long lo = s_w.lo, hi = s_w.hi;
  const int target = base ? 0 : sl[k];

  for (int i = threadIdx.x; i < (cw >> 2); i += kOThreads)
    reinterpret_cast<uint4*>(sh)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = (cw & ~3) + threadIdx.x; i < cw; i += kOThreads) sh[i] = 0u;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_batches = (int)((hi - lo + kBatch - 1) / kBatch);
  const int wpr = (nf + kG - 1) / kG;   // items of a row

  // stage A: the values and row of this thread's position of batch q
  // (row -1: the position adds nothing), into slot q & 1.  The loads
  // land in registers that nothing reads until store_rec, after the
  // owners' adds: an instruction that read one would wait out the load.
  float g_raw, h_raw, m_raw;
  int r_raw, l_raw;
  auto load_rec = [&](int q) {
    const long long p = lo + (long long)q * kBatch + tid;
    const bool in = q < n_batches && p < hi;
    l_raw = in && !base ? __ldg(lid + p) : target;
    r_raw = in && row_idx ? __ldg(row_idx + p) : 0;
    g_raw = in ? __ldg(vals + p) : 0.f;
    h_raw = in ? __ldg(vals + C + p) : 0.f;
    m_raw = in ? __ldg(vals + 2 * C + p) : 0.f;
  };
  auto store_rec = [&](int q) {
    const long long p = lo + (long long)q * kBatch + tid;
    const bool on = q < n_batches && p < hi && l_raw == target;
    float* v = svals + (q & 1) * 3 * kBatch;
    v[tid] = on ? to_acc(g_raw, round_bf16) : 0.f;
    v[kBatch + tid] = on ? to_acc(h_raw, round_bf16) : 0.f;
    v[2 * kBatch + tid] = on ? to_acc(m_raw, round_bf16) : 0.f;
    srow[(q & 1) * kBatch + tid] = on ? (row_idx ? r_raw : (int)p) : -1;
  };
  // stage B: the items of batch q's rows (row ids staged in slot q & 1),
  // then their bins into the stage.  Over the byte copy the lanes of a
  // warp take consecutive words of consecutive rows (item e: word e %
  // wpr of row e / wpr), so a load touches the few lines of ~4 rows;
  // over the [F, N] store they take consecutive rows of one feature.
  unsigned items[kItems];
  auto item_row = [&](int s) {
    return kG > 1 ? (s * kBatch + tid) / wpr : tid;
  };
  auto item_feature = [&](int s) {
    return kG > 1 ? (s * kBatch + tid) % wpr * kG : s;
  };
  auto load_items = [&](int q) {
    const int* rows = srow + (q & 1) * kBatch;
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      if (s >= wpr || q >= n_batches) break;
      const int r = rows[item_row(s)];
      if (r >= 0) items[s] = feed.item(r, f0 + item_feature(s));
    }
  };
  auto store_items = [&](int q) {
    const int* rows = srow + (q & 1) * kBatch;
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      if (s >= wpr) break;
      const int j = item_row(s);
      const int r = q < n_batches ? rows[j] : -1;
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const int f = item_feature(s) + i;
        int b = r >= 0 ? Feed::bin(items[s], i) : nb;
        if ((unsigned)b >= (unsigned)nb) b = nb;
        if (f < nf) sbin[f * kSP + j] = (unsigned short)b;
      }
    }
  };

  // prologue: the sentinel row of the bin stage (read by the lanes with
  // no feature), records of batches 0 and 1, then the bins of batch 0
  for (int j = tid; j < kSP; j += kOThreads)
    sbin[f_tile * kSP + j] = (unsigned short)nb;
  load_rec(0);
  store_rec(0);
  load_rec(1);
  store_rec(1);
  __syncthreads();
  load_items(0);
  store_items(0);
  __syncthreads();

  // owner warp c < 3: plane c, lane f < ls its feature f; a lane with no
  // feature (f >= nf) reads the sentinel row and adds into its trash
  const int c = warp < 3 ? warp : 0;
  float* pl = reinterpret_cast<float*>(sh) + c * pw + lane;
  const unsigned short* my_bins = sbin + (lane < nf ? lane : f_tile) * kSP;
  // the cells of 4 rows (bins in w, values in v), all loaded before any
  // store; a row whose bin an earlier row of the 4 hit adds to that row's
  // sum, and the stores go in row order, so the last store of a cell
  // holds its sum
  auto add4 = [&](uint2 w, float4 v) {
    const int b0 = w.x & 0xffffu, b1 = w.x >> 16;
    const int b2 = w.y & 0xffffu, b3 = w.y >> 16;
    float* a0 = pl + b0 * ls;
    float* a1 = pl + b1 * ls;
    float* a2 = pl + b2 * ls;
    float* a3 = pl + b3 * ls;
    float c0 = *a0, c1 = *a1, c2 = *a2, c3 = *a3;
    c0 += v.x;
    c1 = (b1 == b0 ? c0 : c1) + v.y;
    c2 = (b2 == b1 ? c1 : b2 == b0 ? c0 : c2) + v.z;
    c3 = (b3 == b2 ? c2 : b3 == b1 ? c1 : b3 == b0 ? c0 : c3) + v.w;
    *a0 = c0;
    *a1 = c1;
    *a2 = c2;
    *a3 = c3;
  };
  for (int q = 0; q < n_batches; ++q) {
    // in flight while the owners add batch q: the records of batch q + 2
    // and the bins of batch q + 1
    load_rec(q + 2);
    load_items(q + 1);
    if (warp < 3 && lane < ls) {
      const float* rv = svals + (q & 1) * 3 * kBatch + c * kBatch;
      // rows past the batch's end hold the sentinel bin and zero values,
      // so the owners walk whole groups of 8
      const int n8 =
          ((int)min((long long)kBatch, hi - lo - (long long)q * kBatch) + 7) &
          ~7;
      uint2 w = *reinterpret_cast<const uint2*>(my_bins);
      float4 v = *reinterpret_cast<const float4*>(rv);
#pragma unroll 1
      for (int j0 = 0; j0 < n8; j0 += 8) {
        // each group's bins and values (the stage is not the copy) are
        // read before the group ahead of it stores
        const uint2 w2 = *reinterpret_cast<const uint2*>(my_bins + j0 + 4);
        const float4 v2 = *reinterpret_cast<const float4*>(rv + j0 + 4);
        add4(w, v);
        if (j0 + 8 < n8) {
          w = *reinterpret_cast<const uint2*>(my_bins + j0 + 8);
          v = *reinterpret_cast<const float4*>(rv + j0 + 8);
        }
        add4(w2, v2);
      }
    }
    __syncthreads();
    store_items(q + 1);
    store_rec(q + 2);
    __syncthreads();
  }

  if (!tile_combine::combine<kOThreads>(
          sh, cw, s_w.t, s_w.P,
          slab + ((long long)z * slab_items + s_w.item) * cw,
          gslab + ((long long)z * gslab_items + s_w.gitem) * cw,
          tickets + (long long)z * ticket_items + s_w.tick,
          tile_combine::AddFloat{}))
    return;
  __syncthreads();

  // one write of every output cell of the slot's feature tile, 32 bins of
  // one channel at a time through the [ls][33] stage
  float* tr = svals;
  const float* tile = reinterpret_cast<const float*>(sh);
  float* dst = out + ((long long)k * F + f0) * 3 * B;
  const int lsl = __ffs(ls) - 1;         // ls is a power of two
  for (int ch = 0; ch < 3; ++ch)
    for (int b0 = 0; b0 < B; b0 += 32) {
      for (int i = tid; i < 32 * ls; i += kOThreads) {
        const int r = i >> lsl;
        const int f = i & (ls - 1);
        const int bin = b0 + r;
        tr[f * 33 + r] = bin < nb ? tile[ch * pw + bin * ls + f] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < nf * 32; i += kOThreads) {
        const int f = i >> 5;
        const int r = i & 31;
        if (b0 + r < B)
          dst[((long long)f * 3 + ch) * B + b0 + r] = tr[f * 33 + r];
      }
      __syncthreads();
    }
}

// raise a kernel's dynamic shared-memory limit to `bytes` once it is
// needed (above 48 KB a launch is refused without it)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes, int* current) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes <= *current) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *current = (int)bytes;
  return e;
}

template <typename Feed>
cudaError_t launch_q(Feed feed, int F, int f_tile, int nb, int B,
                     const int* row_idx, const int* vals, long long C,
                     const long long* base, long long tile_rows,
                     const int* lid, const int* sl, int P_masked, int K,
                     int n_blocks, void* slab, void* gslab,
                     int* tickets, long long slab_items,
                     long long gslab_items, long long ticket_items,
                     void* out, cudaStream_t stream) {
  static int smem_set = 48 * 1024;
  const int S = (3 * nb) | 1;
  // the tile, then (gathered feed) the K + 1 segment bounds, 8-aligned
  const long long smem = (long long)((f_tile * S + 1) & ~1) * 4 +
                         (base ? (long long)(K + 1) * 8 : 0);
  cudaError_t e = allow_smem(hist_q_kernel<Feed>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const int ftiles = (F + f_tile - 1) / f_tile;
  dim3 grid((unsigned)n_blocks, (unsigned)ftiles);
  hist_q_kernel<Feed><<<grid, kThreads, (int)smem, stream>>>(
      feed, F, f_tile, nb, B, row_idx, vals, C, base, tile_rows, lid, sl,
      P_masked, K, static_cast<unsigned*>(slab),
      static_cast<unsigned*>(gslab), tickets, slab_items, gslab_items,
      ticket_items, static_cast<unsigned*>(out));
  return cudaGetLastError();
}

template <typename Feed>
cudaError_t launch_owned(Feed feed, int F, int f_tile, int ls, int nb, int B,
                         const int* row_idx, const float* vals, long long C,
                         const long long* base, long long tile_rows,
                         const int* lid, const int* sl, int P_masked, int K,
                         int n_blocks, int round_bf16, void* slab,
                         void* gslab, int* tickets, long long slab_items,
                         long long gslab_items, long long ticket_items,
                         float* out, cudaStream_t stream) {
  static int smem_set32 = 48 * 1024, smem_set = 48 * 1024;
  const long long cw = 3LL * (nb + 1) * ls;
  // the copy, the staged values and rows, the bins and their sentinel
  // row, the segment bounds
  const long long smem = ((cw + 3) & ~3LL) * 4 + 2LL * kBatch * 16 +
                         (long long)(f_tile + 1) * kSP * 2 +
                         (base ? (long long)(K + 1) * 8 : 0);
  if (ls < f_tile || (ls & (ls - 1))) return cudaErrorInvalidValue;
  const int ftiles = (F + f_tile - 1) / f_tile;
  dim3 grid((unsigned)n_blocks, (unsigned)ftiles);
  cudaError_t e;
  if (ls == 32) {
    e = allow_smem(hist_owned_kernel<Feed, 32>, smem, &smem_set32);
    if (e != cudaSuccess) return e;
    hist_owned_kernel<Feed, 32><<<grid, kOThreads, (int)smem, stream>>>(
        feed, F, f_tile, ls, nb, B, row_idx, vals, C, base, tile_rows, lid,
        sl, P_masked, K, round_bf16, static_cast<unsigned*>(slab),
        static_cast<unsigned*>(gslab), tickets, slab_items, gslab_items,
        ticket_items, out);
  } else {
    e = allow_smem(hist_owned_kernel<Feed, 0>, smem, &smem_set);
    if (e != cudaSuccess) return e;
    hist_owned_kernel<Feed, 0><<<grid, kOThreads, (int)smem, stream>>>(
        feed, F, f_tile, ls, nb, B, row_idx, vals, C, base, tile_rows, lid,
        sl, P_masked, K, round_bf16, static_cast<unsigned*>(slab),
        static_cast<unsigned*>(gslab), tickets, slab_items, gslab_items,
        ticket_items, out);
  }
  return cudaGetLastError();
}

}  // namespace

// K1.  feed 0: bins is the row-major byte copy [N, stride]
// uint8 (stride a multiple of 4, f_tile a multiple of 4); feed 1 / 2: the
// [F, stride] store in int32 / int8 (value - 128).  Every bin is below nb
// <= B.  row_idx: [C] int32 or null; vals: [3, C].  Gathered feed: base
// [K + 1] int64 segment bounds in the scratch, n_blocks = ceil(capacity
// / tile_rows) + K; masked feed (base null): lid [C] and sl [K] int32,
// P_masked tiles of tile_rows positions a slot, n_blocks = K * P_masked.
// The caller sizes the work (ops/histogram.py `_k1_plan`); slab: [tiles,
// slab_items, f_tile * S] words, gslab: [tiles, gslab_items, f_tile * S]
// words, tickets: [tiles, ticket_items] int32, zero, left zero; out:
// [K, F, 3, B], every cell written.
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
#define LGBT_Q(FEED)                                                      \
  launch_q(FEED, F, f_tile, nb, B, row_idx, vals, C, base, tile_rows, lid, \
           sl, P_masked, K, n_blocks, slab, gslab, tickets, slab_items,    \
           gslab_items, ticket_items, out, s)
  if (feed == 0) {
    if (f_tile % 4 || stride % 4 || f_tile > 128)
      return cudaErrorInvalidValue;
    return LGBT_Q((RowsU8{static_cast<const unsigned char*>(bins), stride}));
  }
  if (f_tile > 32) return cudaErrorInvalidValue;
  if (feed == 1)
    return LGBT_Q((Cols<int32_t>{static_cast<const int32_t*>(bins), stride}));
  if (feed == 2)
    return LGBT_Q((Cols<int8_t>{static_cast<const int8_t*>(bins), stride}));
#undef LGBT_Q
  return cudaErrorInvalidValue;
}

// K2.  feed, bins, stride, row_idx, base, lid, sl, the plan and the
// combine scratch as for lgbt_hist_q (ops/histogram.py `_k2_plan` sizes
// the work; a partial tile is the block's copy, 3 (nb + 1) ls words);
// f_tile <= ls <= 32 features a tile (a multiple of 4 over the byte
// copy), ls a power of two; vals: [3, C] float32, rounded to bfloat16
// first when round_bf16; out: [K, F, 3, B] float32, every cell written.
extern "C" int lgbt_hist_f(const void* bins, int feed, long long stride,
                           int F, int f_tile, int ls, int nb, int B,
                           const int* row_idx, const float* vals,
                           int round_bf16, long long C, const long long* base,
                           long long tile_rows, const int* lid, const int* sl,
                           int P_masked, int K, int n_blocks, void* slab,
                           void* gslab, int* tickets, long long slab_items,
                           long long gslab_items, long long ticket_items,
                           float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_tile < 1 || f_tile > 32 || ls > 32 || nb < 1 || nb > B ||
      nb > 65535 || tile_rows < 1 || n_blocks < 1 ||
      (F + f_tile - 1) / f_tile > 65535 || (!base && (!lid || !sl)))
    return cudaErrorInvalidValue;
#define LGBT_F(FEED)                                                        \
  launch_owned(FEED, F, f_tile, ls, nb, B, row_idx, vals, C, base,         \
               tile_rows, lid, sl, P_masked, K, n_blocks, round_bf16, slab, \
               gslab, tickets, slab_items, gslab_items, ticket_items, out, s)
  if (feed == 0) {
    if (f_tile % 4 || stride % 4) return cudaErrorInvalidValue;
    return LGBT_F((RowsU8{static_cast<const unsigned char*>(bins), stride}));
  }
  if (feed == 1)
    return LGBT_F((Cols<int32_t>{static_cast<const int32_t*>(bins), stride}));
  if (feed == 2)
    return LGBT_F((Cols<int8_t>{static_cast<const int8_t*>(bins), stride}));
#undef LGBT_F
  return cudaErrorInvalidValue;
}
