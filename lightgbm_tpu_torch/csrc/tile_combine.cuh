// Deterministic combine of the partial tiles of one work item.
//
// Used by the dense histogram kernels K1 and K2 (histogram.cu) and K5
// (hist_gathered.cu).  A work item (one slot's histogram, or one feature
// tile of one leaf's) is split over P blocks.  Each block accumulates a
// partial tile of `words` 32-bit words in shared memory; the blocks then
// combine their tiles in two levels instead of flushing each cell with a
// contended global atomic:
//
//   1. every block writes its tile to slot t of the item's slab and takes
//      the ticket of its group (kGroup consecutive blocks); the last block
//      of a group to arrive sums the group's tiles in block order;
//   2. when the item has more than one group, that block writes the group
//      sum to the group slab and takes the item's ticket; the last group
//      to arrive sums the group sums in group order.
//
// The block that ends with the item's total (combine() returns true)
// writes the output once.  The order of every sum is fixed, so float
// tiles give the same bits from run to run.  Each level's reader uses
// __ldcg (L2, never a stale L1 line) after a __threadfence() that pairs
// with the writer's.  A ticket is reset to 0 by the block that took it
// last, so the counters stay zero between launches and are allocated
// once.
#pragma once

#include <cuda_runtime.h>

namespace tile_combine {

constexpr int kGroup = 16;

__device__ __forceinline__ int groups(int P) {
  return (P + kGroup - 1) / kGroup;
}

// Whether a tile may move 16 bytes a thread at a time (see sum_tiles).
__device__ __forceinline__ bool by16(int words, const void* a,
                                     const void* b) {
  return (words & 3) == 0 &&
         ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b)) &
          15) == 0;
}

// Publish `words` of shared memory to global memory, then take the
// ticket: true in the last of `n` blocks to arrive (block-uniform).
__device__ __forceinline__ bool publish_and_wait(const unsigned* sh,
                                                 int words,
                                                 unsigned* __restrict__ dst,
                                                 int* ticket, int n) {
  __shared__ int s_last;
  if (by16(words, sh, dst)) {
    for (int i = threadIdx.x; i < (words >> 2); i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(sh)[i];
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = sh[i];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ticket, 1) == n - 1;
    if (s_last) atomicExch(ticket, 0);
  }
  __syncthreads();
  const bool last = s_last;
  if (last) __threadfence();
  return last;
}

// The 16-byte form of sum_tiles: a thread takes kW of its 4-word groups
// at once and kP tiles of each, kW * kP loads in flight.
template <int kW, int kP, typename Add>
__device__ __forceinline__ void sum_vec(unsigned* sh, int words,
                                        const unsigned* src, int n,
                                        Add add) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const int w4 = words >> 2;
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < w4; i0 += step * kW) {
    uint4 acc[kW];
#pragma unroll
    for (int u = 0; u < kW; ++u)
      acc[u] = i0 + u * step < w4 ? __ldcg(s4 + i0 + u * step)
                                  : make_uint4(0u, 0u, 0u, 0u);
    for (int p0 = 1; p0 < n; p0 += kP) {
      uint4 v[kW][kP];
#pragma unroll
      for (int u = 0; u < kW; ++u)
#pragma unroll
        for (int q = 0; q < kP; ++q)
          v[u][q] = p0 + q < n && i0 + u * step < w4
                        ? __ldcg(s4 + (long long)(p0 + q) * w4 + i0 +
                                 u * step)
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        const int i = i0 + u * step;
#pragma unroll
        for (int q = 0; q < kP; ++q)
          if (p0 + q < n) {
            acc[u].x = add(4 * i, acc[u].x, v[u][q].x);
            acc[u].y = add(4 * i + 1, acc[u].y, v[u][q].y);
            acc[u].z = add(4 * i + 2, acc[u].z, v[u][q].z);
            acc[u].w = add(4 * i + 3, acc[u].w, v[u][q].w);
          }
      }
    }
#pragma unroll
    for (int u = 0; u < kW; ++u)
      if (i0 + u * step < w4)
        reinterpret_cast<uint4*>(sh)[i0 + u * step] = acc[u];
  }
}

// sh[i] = the sum over p < n of src[p * words + i], in order of p, with
// `add(i, a, b)` adding two words of cell i (an integer or a float).  A
// thread of a block of kThreads reads 4 words a load when the tiles allow
// it, with 2048 / kThreads loads in flight, so that a block keeps ~2048
// in flight whatever its size: at 512 threads 4 tiles of one group of 4
// words; at 128, 8 tiles of 2 groups or, with few tiles, 2 tiles of 8
// groups.  The load count is fixed at compile time: 16 loads a thread
// in a 512-thread block took K1 from 40 to 92 registers a thread, one
// block an SM, even where the branch was not taken.  Else one word a
// load, up to kGroup in flight.  The sums are the same either way.
template <int kThreads, typename Add>
__device__ __forceinline__ void sum_tiles(unsigned* sh, int words,
                                          const unsigned* src, int n,
                                          Add add) {
  constexpr int kFlight = 2048 / kThreads;
  constexpr int kP = kFlight < 8 ? kFlight : 8;
  static_assert(kFlight >= 1 && kFlight % kP == 0, "block size");
  if (by16(words, sh, src)) {
    if (n > 4 || kFlight < 8)
      sum_vec<kFlight / kP, kP>(sh, words, src, n, add);
    else
      sum_vec<kFlight / 2, 2>(sh, words, src, n, add);
    return;
  }
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    unsigned acc = __ldcg(src + i);
    for (int p0 = 1; p0 < n; p0 += kGroup) {
      // up to kGroup loads in flight before the ordered adds
      unsigned v[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        v[u] = p0 + u < n ? __ldcg(src + (long long)(p0 + u) * words + i)
                          : 0u;
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (p0 + u < n) acc = add(i, acc, v[u]);
    }
    sh[i] = acc;
  }
}

// Combine block t's tile (sh, complete: the caller synchronised) with
// the other P - 1 tiles of its item.  slab: the item's [P, words] tiles;
// gslab: its [groups(P), words] group sums; tickets: its groups(P) + 1
// counters, zero on entry.  Returns true in the one block that then
// holds the item's total in sh (synchronise before reading it).
// kThreads: the block's size (see sum_tiles).
template <int kThreads, typename Add>
__device__ bool combine(unsigned* sh, int words, int t, int P,
                        unsigned* __restrict__ slab,
                        unsigned* __restrict__ gslab, int* tickets,
                        Add add) {
  if (P == 1) return true;
  const int grp = t / kGroup;
  const int ng = groups(P);
  const int in_grp = min(kGroup, P - grp * kGroup);
  if (!publish_and_wait(sh, words, slab + (long long)t * words,
                               tickets + grp, in_grp))
    return false;
  sum_tiles<kThreads>(sh, words, slab + (long long)grp * kGroup * words,
                   in_grp, add);
  if (ng == 1) return true;
  __syncthreads();
  if (!publish_and_wait(sh, words, gslab + (long long)grp * words,
                               tickets + ng, ng))
    return false;
  sum_tiles<kThreads>(sh, words, gslab, ng, add);
  return true;
}

struct AddInt {
  __device__ __forceinline__ unsigned operator()(int, unsigned a,
                                                 unsigned b) const {
    return a + b;
  }
};

struct AddFloat {
  __device__ __forceinline__ unsigned operator()(int, unsigned a,
                                                 unsigned b) const {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
};

}  // namespace tile_combine
