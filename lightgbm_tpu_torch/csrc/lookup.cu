// Small-table row lookup (K3), optionally fused with the score add.
//
// Replaces the Pallas TPU kernel `_lookup_kernel` reached through
// lightgbm_tpu/ops/lookup.py `_lookup_pallas` / `table_lookup`.
//
// Contract: out[t, n] = tables[t, ids[n]], 0.0 for ids outside [0, S);
// with an addend, out[t, n] = addend[t, n] + that value (the score add
// of lightgbm_tpu/boosting/score_updater.py `_add_from_leaf`).
//
// What bounds it on an H100: device-memory bytes — 4 bytes of id in and
// 4T bytes out per row (plus 4T of addend when fused).  The TPU kernel
// built a [S, chunk] one-hot in VMEM and ran a matmul because the TPU has
// no fast vector gather; Hopper gathers directly, so each block copies the
// table (T*S floats) into shared memory once and every thread reads its
// rows' ids with coalesced loads and gathers from shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const float* __restrict__ tables, int T, int S,
              const int* __restrict__ ids, long long N,
              const float* addend, float* out) {
  extern __shared__ float tb[];
  for (int i = threadIdx.x; i < T * S; i += blockDim.x) tb[i] = tables[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const int id = ids[n];
    const bool in = id >= 0 && id < S;
    for (int t = 0; t < T; ++t) {
      const float v = in ? tb[t * S + id] : 0.0f;
      out[t * N + n] = addend ? addend[t * N + n] + v : v;
    }
  }
}

}  // namespace

// tables: [T, S] float32; ids: [N] int32; addend: [T, N] float32 or null;
// out: [T, N] float32 (may alias addend).
extern "C" int lgbt_table_lookup(const float* tables, int T, int S,
                                 const int* ids, long long N,
                                 const float* addend, float* out,
                                 void* stream) {
  const int smem = T * S * (int)sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  lookup_kernel<<<(unsigned)blocks, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(tables, T, S, ids, N,
                                                       addend, out);
  return cudaGetLastError();
}
