// Deterministic combine of the partial tiles of one work item.
//
// Used by the dense histogram kernels K1 (histogram.cu) and K5
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

// Publish `words` of shared memory to global memory, then take the
// ticket: true in the last of `n` blocks to arrive (block-uniform).
__device__ __forceinline__ bool publish_and_wait(const unsigned* sh,
                                                 int words,
                                                 unsigned* __restrict__ dst,
                                                 int* ticket, int n) {
  __shared__ int s_last;
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = sh[i];
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

// sh[i] = the sum over p < n of src[p * words + i], in order of p, with
// `add(i, a, b)` adding two words of cell i (an integer or a float).
template <typename Add>
__device__ __forceinline__ void sum_tiles(unsigned* sh, int words,
                                          const unsigned* src, int n,
                                          Add add) {
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
template <typename Add>
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
  sum_tiles(sh, words, slab + (long long)grp * kGroup * words, in_grp, add);
  if (ng == 1) return true;
  __syncthreads();
  if (!publish_and_wait(sh, words, gslab + (long long)grp * words,
                        tickets + ng, ng))
    return false;
  sum_tiles(sh, words, gslab, ng, add);
  return true;
}

struct AddInt {
  __device__ __forceinline__ unsigned operator()(int, unsigned a,
                                                 unsigned b) const {
    return a + b;
  }
};

}  // namespace tile_combine
