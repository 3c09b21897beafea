// K-leaf histograms over the column-sorted entry streams of the CSR/ELL
// sparse store (K7 and K8), zero bin and dequantize fused.
//
// Replaces the Pallas TPU kernels `_hist_kernel_sparse_q` (K7, int8
// gradients, exact int32 accumulation) and `_hist_kernel_sparse` (K8,
// float32) reached through lightgbm_tpu/ops/histogram.py
// `hist_sparse_pallas` / `hist_sparse_multileaf`.
//
// Contract: out[s, c, ch, b] (float32 [K, Cp, 3, B]) is the whole K-leaf
// histogram of the JAX function.  The stored part sums vals[ch, r] over
// the entries (r, bin) of column c's stream with slot[r] == s < K and
// min(bin, B - 1) == b; the column's zero bin zero_bin[c] then gains
// tot[s, ch] minus the column's stored sums (a padded column, zero_bin <
// 0, keeps its stored sums, which are empty); K7 converts the int32 sums
// to float32 and multiplies by scale[ch] = (sg, sh, 1), as the JAX
// function's single dequantize does.
//
// What bounds it on an H100: the [K, Cp, 3, B] output (2.4 GB at K=31,
// Cp=50,000, B=128: 0.71 ms at 3.35 TB/s) and the entry streams (5 B an
// entry, 1.2 GB for the ctr store's 233M entries: 0.35 ms) set the bytes
// bound; what takes the time is one random read per entry (a live-row
// bit) and one per entry of a live row (its 16-byte record in L2), and
// for float32 the shared-memory atomics, which are compare-and-swap loops.
//
// The TPU kernel sorted the entries by column once per dataset
// (`sparse_window_streams`) so that each grid cell owned a window of
// columns and contracted one-hot blocks on the MXU.  Here the same sort
// gives each block one column: it zeroes its slots' histograms in shared
// memory (nb = 1 + the largest stored bin, not the padded B), reads its
// column's (row, bin) entries with coalesced loads (the next step's in
// flight while this one is added), skips the rows outside the pass by one
// bit of a live-row mask that stays in L1, gathers the record (slot and
// three values) of the others, and adds with shared-memory atomics:
// int32 for K7, exact in any order; float32 for K8, exact up to the order
// of the additions.  A first small kernel (pack_rows_kernel) writes the
// per-pass records and the mask.  Then, per (slot, channel), one warp
// reduces the column's stored sums, adds the zero-bin residual and writes
// the [B] row of the output once, so the output is never zeroed, read
// back or dequantized in a second pass.  Work items go heaviest column
// first, so the power-law head columns of a CTR store do not finish last.
// A column longer than `chunk` entries splits into chunks, one block
// each: every chunk block writes its partial histogram to a scratch slab,
// and the last of them to take the column's ticket (an atomic counter,
// after a fence) sums the slabs in chunk order and writes the output.
// Slots beyond the shared-memory budget are cut into tiles, one block per
// (work item, tile).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// the most dynamic shared memory a Hopper block may opt in to
constexpr int kMaxSmem = 227 * 1024;
// a small tile's histogram is kept in up to kWarps copies (warp w adds
// into copy w % copies) while they fit this size, so that the warps of a
// block do not contend for the same cells when few slots take all rows
constexpr int kCopiesSmem = 24 * 1024;

template <typename T>
__device__ __forceinline__ T lane_value(int bits);
template <>
__device__ __forceinline__ int lane_value<int>(int bits) { return bits; }
template <>
__device__ __forceinline__ float lane_value<float>(int bits) {
  return __int_as_float(bits);
}

__device__ __forceinline__ float to_out(int v, float scale) {
  return __int2float_rn(v) * scale;
}
__device__ __forceinline__ float to_out(float v, float) { return v; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The shared histogram of one slot, one row of nbs = nb | 1 words (an odd
// stride, so the lanes of a warp that hit bins 32 apart fall in different
// banks) for each of grad, hess and the count channel; float32 adds a
// fourth row.  Shared-memory atomics are native for int32 but a
// compare-and-swap loop for float32, so K8 counts a row mask of 1 — the
// count channel of every training row — with an integer atomic in the
// third row and adds any other value to the fourth.
template <typename T> struct Slot;
template <> struct Slot<int> {
  static constexpr int kRows = 3;
  __device__ static int get(const int* s, int nbs, int ch, int b) {
    return s[ch * nbs + b];
  }
  __device__ static void set(int* s, int nbs, int ch, int b, int v) {
    s[ch * nbs + b] = v;
  }
  __device__ static bool is_int(int, int) { return true; }
  __device__ static void add(int* s, int nbs, int b, int g, int h, int m) {
    if (g != 0) atomicAdd(s + b, g);
    if (h != 0) atomicAdd(s + nbs + b, h);
    if (m != 0) atomicAdd(s + 2 * nbs + b, m);
  }
};
template <> struct Slot<float> {
  static constexpr int kRows = 4;
  __device__ static float get(const int* s, int nbs, int ch, int b) {
    return ch < 2 ? __int_as_float(s[ch * nbs + b])
                  : __int2float_rn(s[2 * nbs + b]) +
                        __int_as_float(s[3 * nbs + b]);
  }
  __device__ static void set(int* s, int nbs, int ch, int b, float v) {
    if (ch < 2) {
      s[ch * nbs + b] = __float_as_int(v);
    } else {
      s[2 * nbs + b] = 0;
      s[3 * nbs + b] = __float_as_int(v);
    }
  }
  __device__ static bool is_int(int w, int nbs) {
    return w >= 2 * nbs && w < 3 * nbs;
  }
  __device__ static void add(int* s, int nbs, int b, float g, float h,
                             float m) {
    float* f = reinterpret_cast<float*>(s);
    if (g != 0.f) atomicAdd(f + b, g);
    if (h != 0.f) atomicAdd(f + nbs + b, h);
    if (m == 1.f)
      atomicAdd(s + 2 * nbs + b, 1);
    else if (m != 0.f)
      atomicAdd(f + 3 * nbs + b, m);
  }
};

// One block per (work item, slot tile): blockIdx.x = w * n_tiles + tile.
// Shared memory: `copies` x [k_tile] slots (Slot<T>); warp w adds into
// copy w % copies, and the copies are folded into the first before the
// epilogue.
template <typename T, typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_sparse_kernel(const long long* __restrict__ col_off,
                   const int* __restrict__ e_row,
                   const BinT* __restrict__ e_bin,
                   const int* __restrict__ w_col,
                   const int* __restrict__ w_chunk, long long chunk,
                   const int* __restrict__ c_long,
                   const int* __restrict__ long_base,
                   const unsigned char* __restrict__ live,
                   const int4* __restrict__ rec, const T* __restrict__ tot,
                   const float* __restrict__ scale,
                   const int* __restrict__ zero_bin, int K, int k_tile,
                   int n_tiles, int Cp, int B, int nb, int copies,
                   T* __restrict__ scratch, int* __restrict__ tickets,
                   float* __restrict__ out) {
  using S = Slot<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* sh = reinterpret_cast<int*>(smem_raw);
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int nbs = nb | 1;
  const int slot_words = S::kRows * nbs;
  const int w = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - w * n_tiles;
  const int k0 = tile * k_tile;
  const int kt = min(k_tile, K - k0);
  const int c = w_col[w];
  const int j = w_chunk[w];
  const long long c_lo = col_off[c];
  const long long c_hi = col_off[c + 1];
  const long long lo = c_lo + (long long)j * chunk;
  const long long hi = min(lo + chunk, c_hi);

  const int copy_words = k_tile * slot_words;
  for (int i = tid; i < copies * copy_words; i += kThreads) sh[i] = 0;
  __syncthreads();
  int* mine_sh = sh + ((tid >> 5) % copies) * copy_words;

  // the entries of the next step are loaded while this step's records
  // are gathered and added (a software pipeline in registers)
  constexpr long long kStep = (long long)kUnroll * kThreads;
  int rn[kUnroll], bn[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = lo + tid + (long long)u * kThreads;
    rn[u] = e < hi ? __ldg(e_row + e) : -1;
    bn[u] = e < hi ? (int)__ldg(e_bin + e) : 0;
  }
  for (long long e0 = lo + tid; e0 < hi; e0 += kStep) {
    int r[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = rn[u];
      b[u] = bn[u];
      const long long e = e0 + kStep + (long long)u * kThreads;
      rn[u] = e < hi ? __ldg(e_row + e) : -1;
      bn[u] = e < hi ? (int)__ldg(e_bin + e) : 0;
    }
    // the bitmask of rows that add anything this pass (in a slot, with a
    // value) is 1 bit a row, small enough for L1 (62.5 KB at 500k rows):
    // a row outside the pass costs no gather of its record
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r[u] >= 0 && !((__ldg(live + (r[u] >> 3)) >> (r[u] & 7)) & 1))
        r[u] = -1;
    int4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      q[u] = r[u] >= 0 ? __ldg(rec + r[u]) : make_int4(-1, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = q[u].x - k0;
      if ((unsigned)s >= (unsigned)kt) continue;
      S::add(mine_sh + s * slot_words, nbs, min(b[u], B - 1),
             lane_value<T>(q[u].y), lane_value<T>(q[u].z),
             lane_value<T>(q[u].w));
    }
  }
  __syncthreads();
  if (copies > 1) {
    for (int i = tid; i < kt * slot_words; i += kThreads) {
      if (S::is_int(i % slot_words, nbs)) {
        int acc = sh[i];
        for (int p = 1; p < copies; ++p) acc += sh[p * copy_words + i];
        sh[i] = acc;
      } else {
        float acc = __int_as_float(sh[i]);
        for (int p = 1; p < copies; ++p)
          acc += __int_as_float(sh[p * copy_words + i]);
        sh[i] = __float_as_int(acc);
      }
    }
    __syncthreads();
  }

  const int li = c_long[c];
  if (li >= 0) {
    // a chunk of a long column: publish this chunk's partial histogram,
    // [kt][3][nb] values; the last chunk block to arrive sums them all,
    // in chunk order
    const int nch = (int)((c_hi - c_lo + chunk - 1) / chunk);
    const long long slab = (long long)k_tile * 3 * nb;
    const int cells = kt * 3 * nb;
    T* mine = scratch + ((long long)(long_base[li] + j) * n_tiles + tile) * slab;
    for (int i = tid; i < cells; i += kThreads) {
      const int row = i / nb;
      mine[i] = S::get(sh + (row / 3) * slot_words, nbs, row % 3,
                       i - row * nb);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(tickets + li * n_tiles + tile, 1) == nch - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const T* first = scratch + ((long long)long_base[li] * n_tiles + tile) * slab;
    for (int i = tid; i < cells; i += kThreads) {
      T acc = T(0);
      for (int p = 0; p < nch; ++p)
        acc += __ldcg(first + (long long)p * n_tiles * slab + i);
      const int row = i / nb;
      S::set(sh + (row / 3) * slot_words, nbs, row % 3, i - row * nb, acc);
    }
    __syncthreads();
  }

  // epilogue: one warp per (slot, channel) row of the tile
  const int zb = zero_bin[c] >= 0 ? min(zero_bin[c], B - 1) : -1;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int row = warp; row < kt * 3; row += kWarps) {
    const int k = row / 3;
    const int ch = row - 3 * k;
    const int* hs = sh + k * slot_words;
    T part = T(0);
    for (int bb = lane; bb < nb; bb += 32) part += S::get(hs, nbs, ch, bb);
    part = warp_sum(part);
    const T resid = zb >= 0 ? tot[(k0 + k) * 3 + ch] - part : T(0);
    const float sc = scale != nullptr ? scale[ch] : 1.0f;
    float* orow = out + (((long long)(k0 + k) * Cp + c) * 3 + ch) * B;
    for (int bb = lane; bb < B; bb += 32) {
      T v = bb < nb ? S::get(hs, nbs, ch, bb) : T(0);
      if (bb == zb) v += resid;
      orow[bb] = to_out(v, sc);
    }
  }
}

// The per-pass row table the histogram kernel gathers: rec[r] = (slot,
// grad, hess, count bits) and bit r of `live` (32 rows a word, low bit
// first) set when row r is in a slot of the pass and carries a non-zero
// value.  One thread a row; each warp writes the word of its 32 rows.
__global__ void __launch_bounds__(256)
pack_rows_kernel(const int* __restrict__ srow, const int* __restrict__ vals,
                 long long N, int K, int quantized, int4* __restrict__ rec,
                 unsigned* __restrict__ live) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool act = false;
  if (r < N) {
    const int4 q = make_int4(srow[r], vals[r], vals[N + r], vals[2 * N + r]);
    rec[r] = q;
    const bool nz = quantized ? (q.y | q.z | q.w) != 0
                              : (__int_as_float(q.y) != 0.f ||
                                 __int_as_float(q.z) != 0.f ||
                                 __int_as_float(q.w) != 0.f);
    act = (unsigned)q.x < (unsigned)K && nz;
  }
  const unsigned word = __ballot_sync(0xffffffffu, act);
  if ((threadIdx.x & 31) == 0 && r < N) live[r >> 5] = word;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* current) {
  if (bytes <= *current) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *current = bytes;
  return e;
}

template <typename T, typename BinT>
cudaError_t launch(const long long* col_off, const int* e_row,
                   const void* e_bin, const int* w_col, const int* w_chunk,
                   int n_work, long long chunk, const int* c_long,
                   const int* long_base, const int* srow, const void* vals,
                   long long N, unsigned* live, int* rec, const void* tot,
                   const float* scale,
                   const int* zero_bin, int K, int k_tile, int Cp, int B,
                   int nb, void* scratch, int* tickets, float* out,
                   cudaStream_t stream) {
  static int smem_set = 48 * 1024;
  const int tile_bytes = k_tile * Slot<T>::kRows * (nb | 1) * 4;
  const int copies = max(1, min(kWarps, kCopiesSmem / tile_bytes));
  const int smem = copies * tile_bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(hist_sparse_kernel<T, BinT>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const int n_tiles = (K + k_tile - 1) / k_tile;
  const long long blocks = (long long)n_work * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // whole warps over ceil(N / 32) * 32 threads
  const long long row_blocks = ((N + 31) / 32 * 32 + 255) / 256;
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (row_blocks > 0) {
    pack_rows_kernel<<<(unsigned)row_blocks, 256, 0, stream>>>(
        srow, static_cast<const int*>(vals), N, K,
        std::is_same<T, int>::value ? 1 : 0, reinterpret_cast<int4*>(rec),
        live);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  hist_sparse_kernel<T, BinT><<<(unsigned)blocks, kThreads, smem, stream>>>(
      col_off, e_row, static_cast<const BinT*>(e_bin), w_col, w_chunk, chunk,
      c_long, long_base, reinterpret_cast<const unsigned char*>(live),
      reinterpret_cast<const int4*>(rec),
      static_cast<const T*>(tot), scale, zero_bin, K, k_tile, n_tiles, Cp, B,
      nb, copies, static_cast<T*>(scratch), tickets, out);
  return cudaGetLastError();
}

}  // namespace

// col_off: [Cp+1] int64 entry offsets per column; e_row: [nnz] int32 row
// per entry, ascending within a column; e_bin: [nnz] uint8 (bin_bytes=1)
// or uint16 (2) stored bin; w_col, w_chunk: [n_work] int32 column and
// chunk index of each work item, heaviest column first; c_long: [Cp]
// int32 index among the columns of more than one chunk (-1 otherwise);
// long_base: first scratch part of each such column; srow: [N] int32 slot
// of each row (K = none); vals: [3, N] int32 (quantized=1) or float32
// values; live: [ceil(N/32)] int32 and rec: [N, 4] int32 scratch, filled
// here (pack_rows_kernel) before the histogram kernel runs;
// tot: [K, 3] int32 (quantized=1) or float32 slot totals; scale:
// [3] float32 (K7) or null (K8); zero_bin: [Cp] int32; scratch:
// parts x n_tiles x k_tile x 3 x nb of tot's type, or null without long
// columns; tickets: zeroed [long columns x n_tiles] int32, or null; out:
// [K, Cp, 3, B] float32, every cell written.
extern "C" int lgbt_hist_sparse(const long long* col_off, const int* e_row,
                                const void* e_bin, int bin_bytes,
                                const int* w_col, const int* w_chunk,
                                int n_work, long long chunk,
                                const int* c_long, const int* long_base,
                                const int* srow, const void* vals,
                                long long N, unsigned* live, int* rec,
                                const void* tot,
                                const float* scale, int quantized,
                                const int* zero_bin, int K, int k_tile,
                                int Cp, int B, int nb, void* scratch,
                                int* tickets, float* out, void* stream) {
  if (n_work <= 0 || K <= 0 || Cp <= 0 || B <= 0) return cudaSuccess;
  if (k_tile <= 0 || nb <= 0 || nb > B || chunk <= 0 ||
      (bin_bytes != 1 && bin_bytes != 2))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LGBT_SPARSE_ARGS                                                   \
  col_off, e_row, e_bin, w_col, w_chunk, n_work, chunk, c_long, long_base, \
      srow, vals, N, live, rec, tot, scale, zero_bin, K, k_tile, Cp, B, nb,  \
      scratch, tickets, out, s
  if (quantized)
    return bin_bytes == 1 ? launch<int, uint8_t>(LGBT_SPARSE_ARGS)
                          : launch<int, uint16_t>(LGBT_SPARSE_ARGS);
  return bin_bytes == 1 ? launch<float, uint8_t>(LGBT_SPARSE_ARGS)
                        : launch<float, uint16_t>(LGBT_SPARSE_ARGS);
#undef LGBT_SPARSE_ARGS
}
