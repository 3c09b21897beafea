// Histograms of gathered rows (K5) and of many value rows (K6).
//
// K5 replaces the Pallas TPU kernel `_hist_kernel`, reached through
// lightgbm_tpu/ops/histogram.py `hist_pallas` and, on the exact leaf-wise
// learner's path, `histogram_from_indices`: one leaf's [F, 3, B] float32
// histogram over the rows named by an index vector.
// Contract: out[f, c, b] sums val_c(r) over the positions p with
// r = idx[p] (or p without an index) and bins(r, f) == b, where val_0 =
// g[r], val_1 = h[r] and val_2 = m[r], or without a mask row 1 for
// r < n_live and 0 otherwise (the sentinel row N of the padded index).
// Bins outside [0, B) add nothing, as in the one-hot formulation.
//
// K6 replaces the Pallas TPU kernel `_hist_kernel_ml`, reached through
// `hist_pallas_multileaf` (`hist_multileaf`): out[f, m, b] sums
// vals[m, p] over the positions p with gb[f, p] == b, for M value rows
// at once.  No production path of the JAX package calls it.
//
// What bounds them on an H100: K5 reads one int32 bin per (row,
// feature) and three values per row, and makes 3 shared-memory atomics
// per (row, feature); K6 reads M values per position and makes M
// shared-memory atomics per (position, feature).  The TPU kernels built
// one-hot blocks and contracted them on the MXU because the TPU has no
// fast atomics; Hopper has fast shared-memory atomics, so each block
// privatises a partial histogram in shared memory — a feature tile's
// [F_tile, 3, B] for K5 (61 KB at F=40, B=128; 86 KB at F=28, B=256),
// one feature's [M_tile, B] for K6 (128 KB at M=128, B=256) — adds its
// chunk of positions into it, and flushes the non-zero cells to device
// memory with global float atomics.  Float atomics add in a run-dependent
// order, so the sums are exact only up to that order (bitwise on dyadic
// values).
//
// K5 never materialises the gathered [cap, F] copy that the JAX wrapper
// builds: one warp takes one position, reads the row's value lanes once
// (a broadcast load) and leaves the row before any atomic when all three
// are zero (the sentinel positions of a padded index), then its lanes
// read the row's F bins — contiguous in the [N+1, F] row-major store, so
// the load is coalesced — and add into the shared histogram.  A
// feature's 3 * B cells sit at a stride of 3 * B + 1 words, so the 32
// lanes of a warp (32 features of one row) fall in 32 different banks
// even when their bins agree, as they mostly do in a store of few bins.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMultiThreads = 256;
// shared memory a block may privatise; above it the features (K5) or
// value rows (K6) are tiled across blocks
constexpr int kMaxSmem = 200 * 1024;

__device__ __forceinline__ float to_acc(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__global__ void __launch_bounds__(kThreads)
hist_gathered_kernel(const int* __restrict__ bins, long long row_stride,
                     long long feat_stride, int F, int f_tile,
                     const int* __restrict__ idx, long long C,
                     long long chunk, const float* __restrict__ g,
                     const float* __restrict__ h,
                     const float* __restrict__ m, long long n_live, int B,
                     int round_bf16, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sh = reinterpret_cast<float*>(smem_raw);
  const int f0 = blockIdx.y * f_tile;
  const int nf = min(f_tile, F - f0);
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = min(C, c0 + chunk);
  const int stride = 3 * B + 1;                  // one pad word per feature
  const int cells = nf * stride;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (long long p = c0 + (threadIdx.x >> 5); p < c1; p += kWarps) {
    const long long r = idx ? (long long)idx[p] : p;
    const float gv = to_acc(g[r], round_bf16);
    const float hv = to_acc(h[r], round_bf16);
    const float mv = to_acc(m ? m[r] : (r < n_live ? 1.f : 0.f),
                            round_bf16);
    if (gv == 0.f && hv == 0.f && mv == 0.f) continue;   // warp-uniform
    const int* row = bins + r * row_stride + (long long)f0 * feat_stride;
    for (int f = lane; f < nf; f += 32) {
      const int b = row[(long long)f * feat_stride];
      if ((unsigned)b >= (unsigned)B) continue;
      float* cell = sh + f * stride + b;
      if (gv != 0.f) atomicAdd(cell, gv);
      if (hv != 0.f) atomicAdd(cell + B, hv);
      if (mv != 0.f) atomicAdd(cell + 2 * B, mv);
    }
  }
  __syncthreads();

  float* dst = out + (long long)f0 * 3 * B;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int f = i / stride, c = i - f * stride;
    const float v = sh[i];
    if (c < 3 * B && v != 0.f) atomicAdd(dst + f * 3 * B + c, v);
  }
}

__global__ void __launch_bounds__(kMultiThreads)
hist_multirow_kernel(const int* __restrict__ gb, long long C,
                     long long chunk, const float* __restrict__ vals, int M,
                     int m_tile, int B, int round_bf16,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sh = reinterpret_cast<float*>(smem_raw);
  const int f = blockIdx.y;
  const int m0 = blockIdx.z * m_tile;
  const int nm = min(m_tile, M - m0);
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = min(C, c0 + chunk);
  const int cells = nm * B;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const int* col = gb + (long long)f * C;
  for (long long p = c0 + threadIdx.x; p < c1; p += blockDim.x) {
    const int b = col[p];
    if ((unsigned)b >= (unsigned)B) continue;
    const float* v = vals + (long long)m0 * C + p;
    for (int j = 0; j < nm; ++j) {
      const float x = to_acc(v[(long long)j * C], round_bf16);
      if (x != 0.f) atomicAdd(sh + j * B + b, x);
    }
  }
  __syncthreads();

  float* dst = out + ((long long)f * M + m0) * B;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = sh[i];
    if (v != 0.f) atomicAdd(dst + i, v);
  }
}

// raise a kernel's dynamic shared-memory limit to `bytes` once it is
// needed (above 48 KB a launch is refused without it)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* current) {
  if (bytes <= *current) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *current = bytes;
  return e;
}

// positions per block: about `blocks` blocks in all, at least `floor`
long long chunk_for(long long C, long long blocks, long long floor) {
  long long chunk = (C + blocks - 1) / blocks;
  return chunk < floor ? floor : chunk;
}

}  // namespace

// K5.  bins: int32, bin of (row r, feature f) at bins[r * row_stride +
// f * feat_stride]; idx: [C] int32 row ids or null (position = row);
// g, h: per-row float32 values; m: per-row mask or null (mask = r <
// n_live); out: zeroed [F, 3, B] float32.
extern "C" int lgbt_hist_gathered(const int* bins, long long row_stride,
                                  long long feat_stride, int F,
                                  const int* idx, long long C,
                                  const float* g, const float* h,
                                  const float* m, long long n_live, int B,
                                  int round_bf16, float* out,
                                  void* stream) {
  static int smem_set = 48 * 1024;
  const int per_feature = (3 * B + 1) * (int)sizeof(float);
  const int f_tile = min(F, kMaxSmem / per_feature);
  if (f_tile < 1) return cudaErrorInvalidValue;
  const int smem = f_tile * per_feature;
  cudaError_t e = allow_smem(hist_gathered_kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const int ftiles = (F + f_tile - 1) / f_tile;
  // about three resident blocks per SM over the feature tiles
  const long long chunk = chunk_for(C, 396 / ftiles + 1, 512);
  const long long nchunks = (C + chunk - 1) / chunk;
  if (nchunks > 0x7fffffffLL || ftiles > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)nchunks, (unsigned)ftiles);
  hist_gathered_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      bins, row_stride, feat_stride, F, f_tile, idx, C, chunk, g, h, m,
      n_live, B, round_bf16, out);
  return cudaGetLastError();
}

// K6.  gb: [F, C] int32; vals: [M, C] float32; out: zeroed [F, M, B]
// float32.
extern "C" int lgbt_hist_multirow(const int* gb, int F, long long C,
                                  const float* vals, int M, int B,
                                  int round_bf16, float* out, void* stream) {
  static int smem_set = 48 * 1024;
  const int per_row = B * (int)sizeof(float);
  const int m_tile = min(M, kMaxSmem / per_row);
  if (m_tile < 1) return cudaErrorInvalidValue;
  const int smem = m_tile * per_row;
  cudaError_t e = allow_smem(hist_multirow_kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const int mtiles = (M + m_tile - 1) / m_tile;
  // about two blocks per SM over the (feature, value-row tile) pairs
  const long long chunk = chunk_for(C, 264 / ((long long)F * mtiles) + 1,
                                    1024);
  const long long nchunks = (C + chunk - 1) / chunk;
  if (nchunks > 0x7fffffffLL || F > 65535 || mtiles > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)nchunks, (unsigned)F, (unsigned)mtiles);
  hist_multirow_kernel<<<grid, kMultiThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      gb, C, chunk, vals, M, m_tile, B, round_bf16, out);
  return cudaGetLastError();
}
