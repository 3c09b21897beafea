// Row partition of one boosting round (K4).
//
// Replaces the Pallas TPU kernel `_partition_kernel` reached through
// lightgbm_tpu/ops/partition.py `_partition_pallas` / `partition_rows`,
// with the contract of that function's XLA branch: per row, look up its
// leaf's split in the [7, S] table (store column, threshold, is-cat, new
// leaf, window lo, window hi inclusive, default-left; 0 for leaf ids
// outside [0, S)), read the row's bin in that column (0 when the column
// is outside [0, F)), decide left or right, and write the new leaf id
// when the row goes right of a splitting leaf (new leaf 0 means "stay").
// The TPU kernel encoded the table in int8 base-128 digits to fit its
// one-hot matmul; here the table is decoded once per block into shared
// memory and every thread handles rows with plain integer compares.
//
// What bounds it on an H100: device-memory bytes — the row's leaf id in,
// one bin of its split column in (a gather of 1 or 4 bytes per row), the
// new leaf id out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
partition_kernel(const float* __restrict__ tbl, int S,
                 const BinT* __restrict__ bins, int F, long long N,
                 int bin_offset, const int* __restrict__ leaf_id,
                 int* __restrict__ out) {
  extern __shared__ int st[];  // [7, S]: rows 2 and 6 hold the "> 0" flags
  for (int i = threadIdx.x; i < 7 * S; i += blockDim.x) {
    const int r = i / S;
    const float v = tbl[i];
    st[i] = (r == 2 || r == 6) ? (v > 0.0f) : (int)v;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const int lid = leaf_id[n];
    int fi = 0, ti = 0, ci = 0, nli = 0, lo = 0, hi1 = 0, dl = 0;
    if (lid >= 0 && lid < S) {
      fi = st[lid];
      ti = st[S + lid];
      ci = st[2 * S + lid];
      nli = st[3 * S + lid];
      lo = st[4 * S + lid];
      hi1 = st[5 * S + lid];
      dl = st[6 * S + lid];
    }
    const int vi =
        ((fi >= 0 && fi < F) ? (int)bins[(long long)fi * N + n] : 0) +
        bin_offset;
    bool gl = ci ? (vi == ti) : (vi <= ti);
    if (!(vi >= lo && vi <= hi1)) gl = dl != 0;
    out[n] = (nli > 0 && !gl) ? nli : lid;
  }
}

}  // namespace

// tbl: [7, S] float32; bins: [F, N] int32 or int8 (value - 128);
// leaf_id, out: [N] int32.
extern "C" int lgbt_partition_rows(const float* tbl, int S, const void* bins,
                                   int bins_int8, int F, long long N,
                                   const int* leaf_id, int* out,
                                   void* stream) {
  const int smem = 7 * S * (int)sizeof(int);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static bool attr_set[2] = {false, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  if (bins_int8) {
    if (!attr_set[1]) {
      cudaError_t e = cudaFuncSetAttribute(
          partition_kernel<int8_t>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
      if (e != cudaSuccess) return e;
      attr_set[1] = true;
    }
    partition_kernel<int8_t><<<(unsigned)blocks, kThreads, smem, s>>>(
        tbl, S, static_cast<const int8_t*>(bins), F, N, 128, leaf_id, out);
  } else {
    if (!attr_set[0]) {
      cudaError_t e = cudaFuncSetAttribute(
          partition_kernel<int32_t>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
      if (e != cudaSuccess) return e;
      attr_set[0] = true;
    }
    partition_kernel<int32_t><<<(unsigned)blocks, kThreads, smem, s>>>(
        tbl, S, static_cast<const int32_t*>(bins), F, N, 0, leaf_id, out);
  }
  return cudaGetLastError();
}
