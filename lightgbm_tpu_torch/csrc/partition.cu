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
// memory, a leaf's split as one 16-byte and one 8-byte word.
//
// What bounds it on an H100: device-memory bytes — the row's leaf id in,
// the new leaf id out (8 B a row), and one bin of the split column of each
// row whose leaf splits.  The bin is a gather whose address depends on
// the row's leaf, so what it costs is the 32-byte sectors it touches, not
// the bin's bytes: one sector a distinct split column in 32 rows of the
// int8 [F, N] store, in 8 rows of the int32 one.  The design: each thread
// takes a quad of 4 consecutive rows (16-byte leaf-id loads and stores),
// issues the 4 gathers before it uses any (evict-first: a gathered sector
// is read once), loads no bin for a row whose leaf does not split (new
// leaf 0: the row keeps its id whatever its bin), and the grid is sized
// to the rows.  The rounds learner hands K4 its int8 store (a bin a byte,
// value - 128) whenever the store has at most 256 bins, the int32 store
// otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// tbl: [7, S]; bins: [F, N], a bin plus bin_offset (128 for the int8
// store).
template <typename BinT>
__global__ void __launch_bounds__(kThreads)
partition_kernel(const float* __restrict__ tbl, int S,
                 const BinT* __restrict__ bins, int F, long long N,
                 int bin_offset,
                 const int* __restrict__ leaf_id, int* __restrict__ out) {
  // a leaf's split: (column, threshold, new leaf, is-cat | default-left
  // << 1) and (window lo, window hi inclusive)
  extern __shared__ __align__(16) int st[];
  int4* split = reinterpret_cast<int4*>(st);
  int2* window = reinterpret_cast<int2*>(st + 4 * S);
  for (int l = threadIdx.x; l < S; l += blockDim.x) {
    split[l] = make_int4((int)tbl[l], (int)tbl[S + l], (int)tbl[3 * S + l],
                         (tbl[2 * S + l] > 0.0f ? 1 : 0) |
                             (tbl[6 * S + l] > 0.0f ? 2 : 0));
    window[l] = make_int2((int)tbl[4 * S + l], (int)tbl[5 * S + l]);
  }
  __syncthreads();
  // 16-byte leaf-id loads and stores where both arrays allow them
  const bool vec =
      ((reinterpret_cast<size_t>(leaf_id) | reinterpret_cast<size_t>(out)) &
       15) == 0;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q < (N + 3) >> 2) {
    const long long n0 = q << 2;
    const bool full = vec && n0 + 3 < N;
    int lid[4];
    if (full) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(leaf_id + n0));
      lid[0] = v.x;
      lid[1] = v.y;
      lid[2] = v.z;
      lid[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        lid[u] = n0 + u < N ? __ldg(leaf_id + n0 + u) : -1;
    }
    int4 sp[4];
    int bin[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      sp[u] = (unsigned)lid[u] < (unsigned)S ? split[lid[u]]
                                              : make_int4(0, 0, 0, 0);
    // every gather issued before any is used; none for a row that stays.
    // A gathered sector is read once: loaded evict-first (__ldcs), it
    // leaves the L2 to the leaf ids, which the learner reads again
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      bin[u] = 0;
      if (sp[u].z > 0 && (unsigned)sp[u].x < (unsigned)F)
        bin[u] = (int)__ldcs(bins + (long long)sp[u].x * N + n0 + u);
    }
    int res[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      res[u] = lid[u];
      if (sp[u].z > 0) {
        const int vi = bin[u] + bin_offset;
        const int2 w = window[lid[u]];   // a splitting leaf is in range
        bool gl = (sp[u].w & 1) ? vi == sp[u].y : vi <= sp[u].y;
        if (!(vi >= w.x && vi <= w.y)) gl = (sp[u].w & 2) != 0;
        if (!gl) res[u] = sp[u].z;
      }
    }
    if (full) {
      *reinterpret_cast<int4*>(out + n0) =
          make_int4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n0 + u < N) out[n0 + u] = res[u];
    }
  }
}

template <typename BinT>
cudaError_t launch(const float* tbl, int S, const void* bins, int F,
                   long long N, int bin_offset, const int* leaf_id, int* out,
                   cudaStream_t s) {
  static int smem_set = 48 * 1024;
  const int smem = 6 * S * (int)sizeof(int);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        partition_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  // a quad of rows a thread
  const long long blocks = ((N + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  partition_kernel<BinT><<<(unsigned)(blocks > 0 ? blocks : 1), kThreads,
                           smem, s>>>(
      tbl, S, static_cast<const BinT*>(bins), F, N, bin_offset, leaf_id,
      out);
  return cudaGetLastError();
}

}  // namespace

// tbl: [7, S] float32; bins: [F, N] int32 or int8 (value - 128);
// leaf_id, out: [N] int32.
extern "C" int lgbt_partition_rows(const float* tbl, int S, const void* bins,
                                   int bins_int8, int F, long long N,
                                   const int* leaf_id, int* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bins_int8)
    return launch<int8_t>(tbl, S, bins, F, N, 128, leaf_id, out, s);
  return launch<int32_t>(tbl, S, bins, F, N, 0, leaf_id, out, s);
}
