// Histograms of gathered rows (K5) and of many value rows (K6).
//
// K5 replaces the Pallas TPU kernel `_hist_kernel`, reached through
// lightgbm_tpu/ops/histogram.py `hist_pallas` and, on the exact leaf-wise
// learner's path, `histogram_from_indices`: one leaf's [F, 3, B] float32
// histogram over the rows named by an index vector.
// Contract: out[f, c, b] sums val_c(r) over the positions p < n_pos with
// r = idx[p] (or p without an index) and bins(r, f) == b, where val_0 =
// g[r], val_1 = h[r] and val_2 = m[r], or without a mask row 1 for
// r < n_live and 0 otherwise (the sentinel row N of the padded index).
// Every bin of the store is below nb (<= B); bins nb..B-1 of the output
// are zero.  Positions from n_pos on are not read: the caller passes the
// leaf's row count when the live rows come first.
//
// K6 replaces the Pallas TPU kernel `_hist_kernel_ml`, reached through
// `hist_pallas_multileaf` (`hist_multileaf`): out[f, m, b] sums
// vals[m, p] over the positions p with gb[f, p] == b, for M value rows
// at once.  No production path of the JAX package calls it.
//
// What bounds K5 on an H100: the bytes of the rows it reads (a byte a
// bin in the exact learner's uint8 feed, 40 B a onehot row) and the
// shared-memory adds, 3 per (row, feature).  The TPU kernel built one-hot
// blocks and contracted them on the MXU; here each block takes a run of
// positions sized by the rows (a leaf of 60,000 rows gets about a
// hundred short blocks, the root of 2M rows about two blocks an SM) and
// adds (grad, hess, count) into a shared tile that holds only the
// store's real bins, nb of them (7 in the onehot store, not the padded
// 128).  No atomics: every cell has one owner thread, so each add is a
// plain read-modify-write in a fixed order (float shared atomics compile
// to compare-and-swap loops on this card, and add in a run-dependent
// order).  Two ways, chosen by what fits:
//   - A copy a warp, when 16 copies fit (the onehot store: 16 x 5.4 KB):
//     a warp takes its rows one at a time from a staged batch of 32, lane
//     l owns features l and l + 32 of the block's feature tile and reads
//     their bins from the row (contiguous in the [N+1, C] row-major feed,
//     so the loads coalesce).  The copy is laid out [nb][NF32] with the
//     feature fastest (NF32: the tile's features rounded up to 32), so
//     lane l's cells sit in bank l whatever their bins; grad and hess are
//     one 64-bit pair.
//   - One copy a block otherwise (255 bins: 86 KB a tile, [nf][(3 nb) |
//     1] words): the block stages 256 rows' records and bins in shared
//     memory, warp w owns features w, w + 16, ..., and its 32 lanes take
//     32 rows at once; the lanes holding the same bin sum their values in
//     a tree fixed by their positions (`reduce_peers`) and the group's
//     lowest lane adds the sums.
// The count channel is an integer (its sums are exact), converted to
// float at the write.  The warps' copies are folded in order, the blocks
// of a feature tile combine their tiles through a slab and tickets in a
// fixed order (tile_combine.cuh), and one block writes every output cell
// once: the result is the same bits from run to run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_combine.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMultiThreads = 256;
// shared memory a K6 block may privatise; above it the value rows are
// tiled across blocks
constexpr int kMaxSmem = 200 * 1024;
// rows whose bins a warp loads before it adds them (a copy a warp)
constexpr int kUnroll = 8;
// rows a block stages in shared memory at once (one copy a block)
constexpr int kStage = 256;

__device__ __forceinline__ float to_acc(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The layout of a K5 tile of nf features.  With a copy a warp:
// [nb][NFp] (grad, hess) float pairs, then [nb][NFp] counts, NFp = nf
// rounded up to 32, so that lane l's feature sits in bank l whatever its
// bin.  With one copy a block: [nf][S] words, S = (3 nb) | 1, channels
// (grad, hess, count) of nb bins each.  The count channel is an integer,
// or a float sum of a given mask.
struct TileK5 {
  int nb, nf, nfp, S, warp_layout, mask_float;
  __device__ TileK5(int nb_, int nf_, int warp_layout_, int mask_float_)
      : nb(nb_), nf(nf_), nfp((nf_ + 31) & ~31), S((3 * nb_) | 1),
        warp_layout(warp_layout_), mask_float(mask_float_) {}
  __device__ __forceinline__ int words() const {
    return warp_layout ? 3 * nb * nfp : nf * S;
  }
  __device__ __forceinline__ int at(int f, int c, int b) const {
    if (!warp_layout) return f * S + c * nb + b;
    return c < 2 ? 2 * (b * nfp + f) + c : (2 * nb + b) * nfp + f;
  }
  __device__ __forceinline__ bool is_float(int i) const {
    if (warp_layout) return i < 2 * nb * nfp || mask_float;
    const int c = i % S;
    return c < 2 * nb || (mask_float && c < 3 * nb);
  }
  // adds two words of cell i (tile_combine's Add)
  __device__ __forceinline__ unsigned operator()(int i, unsigned a,
                                                 unsigned b) const {
    return is_float(i)
        ? __float_as_uint(__uint_as_float(a) + __uint_as_float(b))
        : a + b;
  }
};

// Sum x and y over the lanes of `peers` (the calling lane's group of
// lanes holding the same key), in a tree whose order depends only on the
// lanes' positions; the group's lowest lane ends with the sums.  (The
// peer reduction of NVIDIA's "Voting and Shuffling to Optimize Atomic
// Operations", written for two values.)
__device__ __forceinline__ void reduce_peers(unsigned peers, float& x,
                                             float& y) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));   // rank among peers
  peers &= 0xfffffffeu << lane;                    // the peers above
  while (__any_sync(0xffffffffu, peers != 0u)) {
    const int next = __ffs(peers);                 // 1-based, 0: none
    const float tx = __shfl_sync(0xffffffffu, x, (next - 1) & 31);
    const float ty = __shfl_sync(0xffffffffu, y, (next - 1) & 31);
    if (next) {
      x += tx;
      y += ty;
    }
    peers &= ~__ballot_sync(0xffffffffu, rel & 1);
    rel >>= 1;
  }
}

// Two blocks an SM: at most 64 registers a thread.  kWarpCopies: each
// warp owns a copy of the tile and lane l features l and l + 32 (the
// store's few bins); otherwise one copy, warp w owns features w, w + 16,
// ..., and its lanes take 32 rows at once (many bins).
template <typename BinT, bool kWarpCopies>
__global__ void __launch_bounds__(kThreads, 2)
hist_gathered_kernel(const BinT* __restrict__ bins, long long row_stride,
                     long long feat_stride, int F, int f_tile,
                     const int* __restrict__ idx, long long n_pos,
                     long long rows_per_block, int P,
                     const float* __restrict__ g,
                     const float* __restrict__ h,
                     const float* __restrict__ m, long long n_live, int nb,
                     int B, int round_bf16, unsigned* __restrict__ slab,
                     unsigned* __restrict__ gslab, int* __restrict__ tickets,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* sh = reinterpret_cast<unsigned*>(smem_raw);
  const int tile = blockIdx.y;
  const int t = blockIdx.x;
  const int f0 = tile * f_tile;
  const int nf = min(f_tile, F - f0);
  const TileK5 lay(nb, nf, kWarpCopies, m != nullptr);
  const int words = lay.words();
  const int copies = kWarpCopies ? kWarps : 1;
  for (int i = threadIdx.x; i < copies * words; i += kThreads) sh[i] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c0 = (long long)t * rows_per_block;
  const long long c1 = min(n_pos, c0 + rows_per_block);
  const BinT* tile_bins = bins + (long long)f0 * feat_stride;

  if (kWarpCopies) {
    unsigned* mine = sh + warp * words;
    float2* gh = reinterpret_cast<float2*>(mine);
    unsigned* cnt = mine + 2 * nb * lay.nfp;
    // the warp's batch of 32 rows, (row, grad, hess, count or mask)
    // each, staged past the copies and read back as broadcasts
    int4* stage =
        reinterpret_cast<int4*>(sh + ((copies * words + 3) & ~3)) + warp * 32;
    const int fa = lane, fb = lane + 32;         // this lane's features
    const BinT* col_a = tile_bins + (long long)fa * feat_stride;
    const BinT* col_b = tile_bins + (long long)fb * feat_stride;
    for (long long base = c0 + warp * 32; base < c1; base += kWarps * 32) {
      const long long p = base + lane;
      int4 rec = make_int4(-1, 0, 0, 0);
      if (p < c1) {
        const int r = idx ? __ldg(idx + p) : (int)p;
        rec = make_int4(
            r, __float_as_int(to_acc(__ldg(g + r), round_bf16)),
            __float_as_int(to_acc(__ldg(h + r), round_bf16)),
            m ? __float_as_int(to_acc(__ldg(m + r), round_bf16))
              : (int)(r < n_live));
      }
      __syncwarp();
      stage[lane] = rec;
      __syncwarp();
      // then the warp walks the 32 rows, kUnroll rows' bins at once; a
      // lane adds into cells no other thread touches
#pragma unroll 1
      for (int j0 = 0; j0 < 32; j0 += kUnroll) {
        int4 q[kUnroll];
        int ba[kUnroll], bb[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          q[u] = stage[j0 + u];
          const long long off = (long long)q[u].x * row_stride;
          ba[u] = q[u].x >= 0 && fa < nf ? (int)col_a[off] : nb;
          bb[u] = q[u].x >= 0 && fb < nf ? (int)col_b[off] : nb;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float gj = __int_as_float(q[u].y);
          const float hj = __int_as_float(q[u].z);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int b = k ? bb[u] : ba[u];
            if ((unsigned)b >= (unsigned)nb) continue;
            const int cell = b * lay.nfp + (k ? fb : fa);
            float2 v = gh[cell];
            v.x += gj;
            v.y += hj;
            gh[cell] = v;
            if (m)
              cnt[cell] = __float_as_uint(__uint_as_float(cnt[cell]) +
                                          __int_as_float(q[u].w));
            else
              atomicAdd(cnt + cell, (unsigned)q[u].w);
          }
        }
      }
    }
  } else {
    // a stage of kStage rows: their (row, grad, hess, count or mask)
    // records and their bins, loaded by the whole block (the bins of a
    // row are contiguous in the row-major feed), then read from shared
    // memory by every warp for its features
    int4* srec = reinterpret_cast<int4*>(sh + ((words + 3) & ~3));
    unsigned short* sbin = reinterpret_cast<unsigned short*>(srec + kStage);
    const int nfs = nf | 1;                      // odd: no bank conflicts
    for (long long s0 = c0; s0 < c1; s0 += kStage) {
      const int n = (int)min((long long)kStage, c1 - s0);
      __syncthreads();                           // the last stage is used
      for (int j = threadIdx.x; j < kStage; j += kThreads) {
        int4 rec = make_int4(-1, 0, 0, 0);
        if (j < n) {
          const int r = idx ? __ldg(idx + s0 + j) : (int)(s0 + j);
          rec = make_int4(
              r, __float_as_int(to_acc(__ldg(g + r), round_bf16)),
              __float_as_int(to_acc(__ldg(h + r), round_bf16)),
              m ? __float_as_int(to_acc(__ldg(m + r), round_bf16))
                : (int)(r < n_live));
        }
        srec[j] = rec;
      }
      for (int i = threadIdx.x; i < n * nf; i += kThreads) {
        const int j = i / nf;
        const int f = i - j * nf;
        const long long r = idx ? __ldg(idx + s0 + j) : s0 + j;
        sbin[j * nfs + f] = (unsigned short)min(
            (int)tile_bins[r * row_stride + (long long)f * feat_stride], nb);
      }
      __syncthreads();
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const int4 rec = srec[j];
        const float gv = __int_as_float(rec.y);
        const float hv = __int_as_float(rec.z);
        const float mv = m ? __int_as_float(rec.w) : 0.f;
        const unsigned counted = __ballot_sync(0xffffffffu, rec.w != 0);
        // the warp's features: the lanes holding one bin sum their
        // values in a fixed tree and the group's lowest lane adds them
        for (int f = warp; f < nf; f += kWarps) {
          int b = j < n ? (int)sbin[j * nfs + f] : nb;
          if (b >= nb) b = -1;
          const unsigned peers = __match_any_sync(0xffffffffu, b);
          float x = gv, y = hv;
          reduce_peers(peers, x, y);
          float z = mv, unused = 0.f;
          if (m) reduce_peers(peers, z, unused);
          if (b >= 0 && lane == __ffs(peers) - 1) {
            unsigned* cell = sh + lay.at(f, 0, b);
            cell[0] = __float_as_uint(__uint_as_float(cell[0]) + x);
            cell[nb] = __float_as_uint(__uint_as_float(cell[nb]) + y);
            if (m)
              cell[2 * nb] =
                  __float_as_uint(__uint_as_float(cell[2 * nb]) + z);
            else
              cell[2 * nb] += __popc(peers & counted);
          }
        }
      }
    }
  }
  __syncthreads();

  if (copies > 1) {
    // fold the copies into the first, in copy order
    for (int i = threadIdx.x; i < words; i += kThreads) {
      const bool fl = lay.is_float(i);
      unsigned acc = sh[i];
      for (int c = 1; c < copies; ++c) {
        const unsigned v = sh[c * words + i];
        acc = fl ? __float_as_uint(__uint_as_float(acc) + __uint_as_float(v))
                 : acc + v;
      }
      sh[i] = acc;
    }
    __syncthreads();
  }

  const int ng = tile_combine::groups(P);
  const long long item_words =
      TileK5(nb, f_tile, kWarpCopies, m != nullptr).words();
  if (!tile_combine::combine<kThreads>(
          sh, words, t, P, slab + (long long)tile * P * item_words,
          gslab + (long long)tile * ng * item_words,
          tickets + tile * (ng + 1), lay))
    return;
  __syncthreads();

  // one write of every output cell of the tile: a warp a (feature,
  // channel) row, its lanes along the bins
  for (int row = warp; row < nf * 3; row += kWarps) {
    const int f = row / 3;
    const int c = row - 3 * f;
    float* dst = out + ((long long)(f0 + f) * 3 + c) * B;
    const bool fl = c < 2 || m;
    for (int b = lane; b < B; b += 32) {
      float v = 0.f;
      if (b < nb) {
        const unsigned w = sh[lay.at(f, c, b)];
        v = fl ? __uint_as_float(w) : (float)w;
      }
      dst[b] = v;
    }
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

template <typename BinT, bool kWarpCopies>
cudaError_t launch_k5(const void* bins, long long row_stride,
                      long long feat_stride, int F, int f_tile,
                      const int* idx, long long n_pos,
                      long long rows_per_block, int P, const float* g,
                      const float* h, const float* m, long long n_live,
                      int nb, int B, int round_bf16, void* slab, void* gslab,
                      int* tickets, float* out, cudaStream_t stream) {
  static int smem_set = 48 * 1024;
  // the tile's copies, then the staged rows: 32 records a warp (a copy
  // a warp), or kStage records and their bins (one copy)
  const int nfp = (f_tile + 31) & ~31;
  const long long smem =
      kWarpCopies
          ? ((long long)kWarps * 3 * nb * nfp + 3) / 4 * 16 +
                kWarps * 32 * 16
          : ((long long)f_tile * ((3 * nb) | 1) + 3) / 4 * 16 +
                kStage * 16 + kStage * (f_tile | 1) * 2;
  if (!kWarpCopies && nb > 65535) return cudaErrorInvalidValue;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(hist_gathered_kernel<BinT, kWarpCopies>,
                             (int)smem, &smem_set);
  if (e != cudaSuccess) return e;
  const int ftiles = (F + f_tile - 1) / f_tile;
  dim3 grid((unsigned)P, (unsigned)ftiles);
  hist_gathered_kernel<BinT, kWarpCopies>
      <<<grid, kThreads, (int)smem, stream>>>(
          static_cast<const BinT*>(bins), row_stride, feat_stride, F, f_tile,
          idx, n_pos, rows_per_block, P, g, h, m, n_live, nb, B, round_bf16,
          static_cast<unsigned*>(slab), static_cast<unsigned*>(gslab),
          tickets, out);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t launch_k5_mode(int warp_copies, const void* bins,
                           long long row_stride, long long feat_stride, int F,
                           int f_tile, const int* idx, long long n_pos,
                           long long rows_per_block, int P, const float* g,
                           const float* h, const float* m, long long n_live,
                           int nb, int B, int round_bf16, void* slab,
                           void* gslab, int* tickets, float* out,
                           cudaStream_t s) {
  return warp_copies
      ? launch_k5<BinT, true>(bins, row_stride, feat_stride, F, f_tile, idx,
                              n_pos, rows_per_block, P, g, h, m, n_live, nb,
                              B, round_bf16, slab, gslab, tickets, out, s)
      : launch_k5<BinT, false>(bins, row_stride, feat_stride, F, f_tile, idx,
                               n_pos, rows_per_block, P, g, h, m, n_live, nb,
                               B, round_bf16, slab, gslab, tickets, out, s);
}

}  // namespace

// K5.  bins: uint8, uint16 or int32 (bin_bytes 1, 2 or 4), the bin of
// (row r, feature f) at bins[r * row_stride + f * feat_stride], every bin
// below nb; idx: [>= n_pos] int32 row ids or null (position = row); g, h:
// per-row float32 values; m: per-row mask or null (mask = r < n_live).
// The caller sizes the work (ops/histogram.py `_k5_layout`,
// `_k5_blocks`): feature tiles of f_tile <= 64 features, a tile copy a
// warp or one a block (warp_copies), P blocks a tile of rows_per_block
// positions each; slab: [tiles, P, f_tile * S] words, gslab: [tiles,
// ceil(P / 16), f_tile * S] words, tickets: [tiles, ceil(P / 16) + 1]
// int32, zero, left zero (all three unused when P == 1); out: [F, 3, B]
// float32, every cell written.
extern "C" int lgbt_hist_gathered(const void* bins, int bin_bytes,
                                  long long row_stride,
                                  long long feat_stride, int F, int f_tile,
                                  int warp_copies, const int* idx,
                                  long long n_pos, long long rows_per_block,
                                  int P, const float* g, const float* h,
                                  const float* m, long long n_live, int nb,
                                  int B, int round_bf16, void* slab,
                                  void* gslab, int* tickets, float* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_tile < 1 || f_tile > 64 || nb < 1 || nb > B || P < 1 ||
      (F + f_tile - 1) / f_tile > 65535)
    return cudaErrorInvalidValue;
  switch (bin_bytes) {
    case 1:
      return launch_k5_mode<uint8_t>(warp_copies, bins, row_stride,
                                     feat_stride, F, f_tile, idx, n_pos,
                                     rows_per_block, P, g, h, m, n_live, nb,
                                     B, round_bf16, slab, gslab, tickets,
                                     out, s);
    case 2:
      return launch_k5_mode<uint16_t>(warp_copies, bins, row_stride,
                                      feat_stride, F, f_tile, idx, n_pos,
                                      rows_per_block, P, g, h, m, n_live, nb,
                                      B, round_bf16, slab, gslab, tickets,
                                      out, s);
    case 4:
      return launch_k5_mode<int32_t>(warp_copies, bins, row_stride,
                                     feat_stride, F, f_tile, idx, n_pos,
                                     rows_per_block, P, g, h, m, n_live, nb,
                                     B, round_bf16, slab, gslab, tickets,
                                     out, s);
    default:
      return cudaErrorInvalidValue;
  }
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
