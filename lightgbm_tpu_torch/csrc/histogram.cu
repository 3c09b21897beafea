// K-leaf histogram kernels of the batched-rounds learner (K1 and K2).
//
// Replaces the Pallas TPU kernels `_hist_kernel_masked_q` (K1, int8
// gradients, exact int32 accumulation) and `_hist_kernel_masked` (K2,
// float32 / bfloat16 operands, float32 accumulation) reached through
// lightgbm_tpu/ops/histogram.py `hist_multileaf_masked`.
//
// Contract (the JAX function's output): out[k, f, c, b] sums vals[c, p]
// over the positions p with lid[p] == sl[k] and bins[f, row(p)] == b,
// where row(p) = row_idx[p] when a row index is given (the gathered row
// feed) and p otherwise.  Bins outside [0, B) add nothing, as in the
// one-hot formulation.  int8-stored bins hold value - 128.
//
// What bounds it on an H100: the bin reads (F bytes or 4F bytes per
// matching row) and the shared-memory atomics (3F per matching row).
// The TPU kernel turned the scatter into one-hot matmuls because the TPU
// has no fast atomics; Hopper has fast shared-memory atomics, so each
// block keeps a [F_tile, 3, B] partial histogram in shared memory (86 KB
// at F=28, B=256 in int32), adds each matching row's bins into it, and
// flushes the non-zero cells to device memory with global atomics.
// Integer atomics make K1 exact in any order; K2's float atomics make it
// exact up to the order of the additions.
//
// Grid: x walks chunks of positions, y the K slots, z feature tiles.  A
// block first scans its chunk's leaf ids for one of its slot and leaves
// before touching shared memory if none is there.  In the gathered feed
// each slot's positions are one contiguous run, so only the blocks that
// overlap that run accumulate, but every other block still reads its
// whole chunk of leaf ids: K x C int32 reads per pass.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float to_acc(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
__device__ __forceinline__ int to_acc(int v, int) { return v; }

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

}  // namespace

// bins: [F, n_stride] int32 or int8 (value - 128); row_idx: [C] or null;
// lid: [C] int32; vals: [3, C] int32 (quantized=1, K1) or float32 (K2);
// sl: [K] int32; out: zeroed [K, F, 3, B] int32 (K1) or float32 (K2).
extern "C" int lgbt_hist_multileaf(const void* bins, int bins_int8,
                                   long long n_stride, int F,
                                   const int* row_idx, const int* lid,
                                   const void* vals, int quantized,
                                   long long C, const int* sl, int K, int B,
                                   int round_bf16, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return bins_int8
        ? launch<int8_t, int>(bins, n_stride, F, row_idx, lid, vals, C, sl,
                              K, B, 0, out, s)
        : launch<int32_t, int>(bins, n_stride, F, row_idx, lid, vals, C,
                               sl, K, B, 0, out, s);
  }
  return bins_int8
      ? launch<int8_t, float>(bins, n_stride, F, row_idx, lid, vals, C, sl,
                              K, B, round_bf16, out, s)
      : launch<int32_t, float>(bins, n_stride, F, row_idx, lid, vals, C, sl,
                               K, B, round_bf16, out, s);
}
