// Nonzero-iterating K-leaf histograms over the CSR/ELL sparse store (K7
// and K8).
//
// Replaces the Pallas TPU kernels `_hist_kernel_sparse_q` (K7, int8
// gradients, exact int32 accumulation) and `_hist_kernel_sparse` (K8,
// float32) reached through lightgbm_tpu/ops/histogram.py
// `hist_sparse_pallas` / `hist_sparse_multileaf`.
//
// Contract (the stored-entry part of the JAX function): out[s, c, ch, b]
// sums vals[ch, n] over the ELL entries (n, j) with srow[n] == s < K,
// cols[n, j] == c in [0, Cp) and min(bins[n, j], B - 1) == b.  A column
// >= Cp (or negative) is an empty slot.  The caller zeroes `out`, and
// rebuilds every column's zero bin from the slot totals afterwards (plain
// torch ops, ops/histogram.py `_apply_zero_bin`), as the JAX function
// does after its kernel.
//
// What bounds it on an H100: the [K, Cp, 3, B] output — 2.4 GB at K=31,
// Cp=50,000, B=128 — which the wrapper zeroes and the zero-bin rebuild
// reads again, and then the ELL read (8 bytes per slot, ~2 GB at
// N=500k, R=512).  The TPU kernel sorted entries into column windows
// (`sparse_window_streams`) so that each grid cell could run a one-hot
// matmul on the MXU; Hopper has fast atomics, so the entries are walked
// in place instead.  One warp takes one row: it reads the row's slot
// once (a broadcast load) and leaves the row before touching its entries
// when the row is in no slot of this pass, or carries no gradient, so
// the ELL arrays of rows outside the pass are never read.  The lanes then
// read the row's R (column, bin) pairs with coalesced loads, drop the
// empty slots, and add (g, h, m) at [slot, column, channel, bin] with
// global atomics: int32 for K7, which makes it exact in any order, and
// float32 for K8, exact up to the order of the additions.  Hot columns
// (the power-law head of a CTR store) take contended atomics from every
// row; privatising them in shared memory is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_sparse_kernel(const int* __restrict__ cols, const int* __restrict__ bins,
                   long long N, int R, const int* __restrict__ srow,
                   const T* __restrict__ vals, int K, int Cp, int B,
                   T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long n = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       n < N; n += nwarps) {
    const int s = srow[n];
    if ((unsigned)s >= (unsigned)K) continue;
    const T g = vals[n];
    const T h = vals[N + n];
    const T m = vals[2 * N + n];
    if (g == T(0) && h == T(0) && m == T(0)) continue;
    const int* crow = cols + n * R;
    const int* brow = bins + n * R;
    T* base = out + (long long)s * Cp * 3 * B;
    for (int j = lane; j < R; j += 32) {
      const int c = crow[j];
      if ((unsigned)c >= (unsigned)Cp) continue;
      const int b = min(brow[j], B - 1);
      if (b < 0) continue;
      T* cell = base + (long long)c * 3 * B + b;
      if (g != T(0)) atomicAdd(cell, g);
      if (h != T(0)) atomicAdd(cell + B, h);
      if (m != T(0)) atomicAdd(cell + 2 * B, m);
    }
  }
}

template <typename T>
cudaError_t launch(const int* cols, const int* bins, long long N, int R,
                   const int* srow, const void* vals, int K, int Cp, int B,
                   void* out, cudaStream_t stream) {
  if (N <= 0 || R <= 0 || K <= 0 || Cp <= 0 || B <= 0) return cudaSuccess;
  // one warp per row, grid-stride beyond 2^20 blocks
  long long blocks = (N + kWarps - 1) / kWarps;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  hist_sparse_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      cols, bins, N, R, srow, static_cast<const T*>(vals), K, Cp, B,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// cols, bins: [N, R] int32 ELL entries; srow: [N] int32 slot per row (K =
// none); vals: [3, N] int32 (quantized=1, K7) or float32 (K8); out: zeroed
// [K, Cp, 3, B] int32 (K7) or float32 (K8).
extern "C" int lgbt_hist_sparse(const int* cols, const int* bins, long long N,
                                int R, const int* srow, const void* vals,
                                int quantized, int K, int Cp, int B, void* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quantized
      ? launch<int>(cols, bins, N, R, srow, vals, K, Cp, B, out, s)
      : launch<float>(cols, bins, N, R, srow, vals, K, Cp, B, out, s);
}
