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
//
// What bounds K6 on an H100: its F * M * C float adds (7.2e9 at F=28,
// M=128, C=2M), not its bytes (the [M, C] values, 1 GB there, read
// once).  The TPU kernel contracted one-hot blocks on the MXU; a one-hot
// product here would take F * M * B * C * 2 flops (3.7e12, three bf16
// passes for float32 accuracy).  Instead every output cell has one owner
// thread that adds in position order, with no atomics: a block owns one
// item, (a tile of up to 32 features, a tile of value rows), over one
// chunk of positions.  Owner lane l of warp w owns feature l % nfp of the
// tile for value row w * (32 / nfp) + l / nfp (nfp: the tile's features
// rounded up to a power of two), all B bins of it, laid out [bin][lane]
// so that its cells sit in bank l whatever their bins (bin B is a trash
// cell for bins outside [0, B) and for lanes with no feature).  The
// block stages a tile of Pt positions at a time in shared memory: each
// feature's bins as 16-bit words, each value row's values, loaded into
// registers while the owners add the tile before and stored after them.
// A lane takes 4 positions a step (the bins in one 8-byte load, the
// values in one 16-byte load shared by the lanes of its row), loads the
// 4 cells before any store and forwards a sum in registers to a later
// position of the same bin, as K2 does.  The values of an item's chunk
// are read once; the bins once for each value-row tile, and the blocks
// of one chunk are consecutive in the grid, so they run together and
// find the bins in L2.  The P blocks of an item combine their tiles
// through a slab and tickets in a fixed order (tile_combine.cuh), and
// the last one writes every output cell once: the same bits from run to
// run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "tile_combine.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// K6: at most 8 owner warps and kProducerWarps staging warps a block;
// the 16-byte loads of a tile a producer thread holds
constexpr int kProducerWarps = 4;
constexpr int kMultiThreads = (8 + kProducerWarps) * 32;
constexpr int kMultiLoads = 12;
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

// Named barriers of K6's two-slot ring (0 is __syncthreads): slot s is
// full (kFull + s) when the producers have staged it, empty (kEmpty + s)
// when the owners are done with it.
constexpr int kFull = 1;
constexpr int kEmpty = 3;

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// K6: a block owns the cells of one item, (feature tile, value-row
// tile), over one chunk of positions; its first W warps own the cells,
// the last kProducerWarps stage the positions; see the head of this file.
__global__ void __launch_bounds__(kMultiThreads, 1)
hist_multirow_kernel(const int* __restrict__ gb, int F, long long C,
                     const float* __restrict__ vals, int M, int B,
                     int round_bf16, int lg, int W, int Pt, long long chunk,
                     int P, int rtiles, unsigned* __restrict__ slab,
                     unsigned* __restrict__ gslab, int* __restrict__ tickets,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nfp = 1 << lg;                 // lanes a feature group
  const int rpw = 32 >> lg;                // value rows a warp
  const int R = W * rpw;                   // value rows a tile
  const int items = (F + nfp - 1) / nfp * rtiles;
  const int item = blockIdx.x % items;     // consecutive blocks: one chunk
  const int t = blockIdx.x / items;
  const int f0 = item / rtiles * nfp;
  const int m0 = item % rtiles * R;
  const int nf = min(nfp, F - f0);
  const int nR = min(R, M - m0);
  const long long lo = (long long)t * chunk;
  const long long hi = min(C, lo + chunk);
  const int CW = (B + 1) * 32;             // a warp's cells, bin B trash
  const int words = W * CW;
  const int SP = Pt + 4;                   // 16-bit bins a staged row
  const int VS = Pt + 4;                   // floats a staged value row
  // a ring slot: the bins [nfp + 1][SP] (row nfp the trash bin), then the
  // values [R][VS]
  const int bin_bytes = ((nfp + 1) * SP * 2 + 15) & ~15;
  const int slot_bytes = bin_bytes + ((R * VS * 4 + 15) & ~15);
  float* cells = reinterpret_cast<float*>(smem_raw);
  unsigned char* ring = smem_raw + (long long)words * 4;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < (words >> 2); i += nt)
    reinterpret_cast<uint4*>(cells)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int s = 0; s < 2; ++s) {
    unsigned short* sbin =
        reinterpret_cast<unsigned short*>(ring + s * slot_bytes);
    float* svals = reinterpret_cast<float*>(ring + s * slot_bytes + bin_bytes);
    for (int i = tid; i < R * VS; i += nt) svals[i] = 0.f;
    for (int i = tid; i < SP; i += nt) sbin[nfp * SP + i] = (unsigned short)B;
  }
  __syncthreads();
  const int n_tiles = (int)((max(hi - lo, 0LL) + Pt - 1) / Pt);
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (warp >= W) {
    // ---- producers: item i < nf * G is 4 positions of feature row i / G,
    // then 4 positions of value row (i - nf * G) / G, at the same place of
    // every tile: its source row, offset and slot place are worked out
    // once.  A tile's loads are in flight while the producers wait for
    // its slot; positions from hi on stage the trash bin and 0.
    const int G = Pt >> 2;
    const int nbi = nf * G;
    const int n_items = nbi + nR * G;
    const int ptid = tid - W * 32;
    const int pn = nt - W * 32;
    const bool vec =
        (C & 3) == 0 &&
        ((reinterpret_cast<size_t>(gb) | reinterpret_cast<size_t>(vals)) &
         15) == 0;
    const int* src[kMultiLoads];
    int place[kMultiLoads], off[kMultiLoads];
#pragma unroll
    for (int u = 0; u < kMultiLoads; ++u) {
      const int i = ptid + u * pn;
      const bool is_bin = i < nbi;
      const int row = is_bin ? i / G : (i - nbi) / G;
      const int g = (is_bin ? i : i - nbi) - row * G;
      off[u] = 4 * g;
      src[u] = is_bin ? gb + (long long)(f0 + row) * C + lo + 4 * g
                      : reinterpret_cast<const int*>(vals) +
                            (long long)(m0 + row) * C + lo + 4 * g;
      // a bin item's place in halfwords, a value item's in floats past
      // the bins, negative
      place[u] = is_bin ? row * SP + 4 * g : -(row * VS + 4 * g) - 1;
      if (i >= n_items) place[u] = INT_MIN;
    }
    int4 x[kMultiLoads];
    for (int q = 0; q < n_tiles + 2; ++q) {
      const int s = q & 1;
      if (q < n_tiles) {
        const long long p0 = lo + (long long)q * Pt;
#pragma unroll
        for (int u = 0; u < kMultiLoads; ++u) {
          if (place[u] == INT_MIN) continue;
          const int pad = place[u] >= 0 ? B : 0;
          const long long p = p0 + off[u];
          const int* ps = src[u] + (long long)q * Pt;
          if (vec && p + 3 < hi)
            x[u] = __ldg(reinterpret_cast<const int4*>(ps));
          else
            x[u] = make_int4(p < hi ? __ldg(ps) : pad,
                             p + 1 < hi ? __ldg(ps + 1) : pad,
                             p + 2 < hi ? __ldg(ps + 2) : pad,
                             p + 3 < hi ? __ldg(ps + 3) : pad);
        }
      }
      // slot s is free once the owners are done with tile q - 2; the two
      // waits past the last tile take the owners' last two arrivals
      if (q >= 2) named_sync(kEmpty + s, nt);
      if (q >= n_tiles) continue;
      unsigned short* sbin =
          reinterpret_cast<unsigned short*>(ring + s * slot_bytes);
      float* svals =
          reinterpret_cast<float*>(ring + s * slot_bytes + bin_bytes);
#pragma unroll
      for (int u = 0; u < kMultiLoads; ++u) {
        if (place[u] == INT_MIN) continue;
        if (place[u] >= 0) {
          auto bin = [&](int b) {
            return (unsigned)b < (unsigned)B ? (unsigned)b : (unsigned)B;
          };
          *reinterpret_cast<uint2*>(sbin + place[u]) =
              make_uint2(bin(x[u].x) | bin(x[u].y) << 16,
                         bin(x[u].z) | bin(x[u].w) << 16);
        } else {
          *reinterpret_cast<float4*>(svals - place[u] - 1) =
              make_float4(to_acc(__int_as_float(x[u].x), round_bf16),
                          to_acc(__int_as_float(x[u].y), round_bf16),
                          to_acc(__int_as_float(x[u].z), round_bf16),
                          to_acc(__int_as_float(x[u].w), round_bf16));
        }
      }
      named_arrive(kFull + s, nt);
    }
  } else {
    // ---- owners: lane (feature fl, row) of warp w: lane fl of the
    // warp's feature group, value row w * rpw + lane / nfp of the tile.
    // Its cells sit in bank `lane` whatever their bins; a lane with no
    // feature reads the trash row of the bin stage and adds into its
    // trash cell
    const int fl = lane & (nfp - 1);
    const int row = warp * rpw + (lane >> lg);
    const bool owner = warp * rpw < nR;
    float* pl = cells + warp * CW + lane;
    // the cells of 4 positions (bins in w, values in v), all loaded
    // before any store; a position whose bin an earlier one of the 4 hit
    // adds to that one's sum, and the stores go in position order, so
    // the last store of a cell holds its sum
    auto add4 = [&](uint2 w, float4 v) {
      const int b0 = w.x & 0xffffu, b1 = w.x >> 16;
      const int b2 = w.y & 0xffffu, b3 = w.y >> 16;
      float* a0 = pl + b0 * 32;
      float* a1 = pl + b1 * 32;
      float* a2 = pl + b2 * 32;
      float* a3 = pl + b3 * 32;
      float c0 = *a0, c1 = *a1, c2 = *a2, c3 = *a3;
      c0 += v.x;
      c1 = (b1 == b0 ? c0 : c1) + v.y;
      c2 = (b2 == b1 ? c1 : b2 == b0 ? c0 : c2) + v.z;
      c3 = (b3 == b2 ? c2 : b3 == b1 ? c1 : b3 == b0 ? c0 : c3) + v.w;
      *a0 = c0;
      *a1 = c1;
      *a2 = c2;
      *a3 = c3;
    };
    for (int q = 0; q < n_tiles; ++q) {
      const int s = q & 1;
      named_sync(kFull + s, nt);
      if (owner) {
        const unsigned short* my_bins =
            reinterpret_cast<const unsigned short*>(ring + s * slot_bytes) +
            (fl < nf ? fl : nfp) * SP;
        const float* my_vals =
            reinterpret_cast<const float*>(ring + s * slot_bytes +
                                           bin_bytes) +
            row * VS;
        // positions past hi hold the trash bin and 0, so the owners walk
        // whole groups of 8
        const long long p0 = lo + (long long)q * Pt;
        const int n8 = (int)min((long long)Pt, (hi - p0 + 7) & ~7LL);
        uint2 w = *reinterpret_cast<const uint2*>(my_bins);
        float4 v = *reinterpret_cast<const float4*>(my_vals);
#pragma unroll 1
        for (int j0 = 0; j0 < n8; j0 += 8) {
          // each group's bins and values are read before the group ahead
          // of it stores
          const uint2 w2 = *reinterpret_cast<const uint2*>(my_bins + j0 + 4);
          const float4 v2 =
              *reinterpret_cast<const float4*>(my_vals + j0 + 4);
          add4(w, v);
          if (j0 + 8 < n8) {
            w = *reinterpret_cast<const uint2*>(my_bins + j0 + 8);
            v = *reinterpret_cast<const float4*>(my_vals + j0 + 8);
          }
          add4(w2, v2);
        }
      }
      named_arrive(kEmpty + s, nt);
    }
  }
  __syncthreads();

  const int ng = tile_combine::groups(P);
  if (!tile_combine::combine<kMultiThreads>(
          reinterpret_cast<unsigned*>(cells), words, t, P,
          slab + (long long)item * P * words,
          gslab + (long long)item * ng * words, tickets + item * (ng + 1),
          tile_combine::AddFloat{}))
    return;
  __syncthreads();

  // one write of every output cell of the item: lane (fl, row) of owner
  // warp w writes the B bins of out[f0 + fl, m0 + row], 4 a store
  const int fl = lane & (nfp - 1);
  const int row = warp * rpw + (lane >> lg);
  if (warp < W && fl < nf && row < nR) {
    const float* src = cells + warp * CW + lane;
    float* dst = out + ((long long)(f0 + fl) * M + m0 + row) * B;
    if ((B & 3) == 0) {
      for (int b = 0; b < B; b += 4)
        *reinterpret_cast<float4*>(dst + b) =
            make_float4(src[b * 32], src[(b + 1) * 32], src[(b + 2) * 32],
                        src[(b + 3) * 32]);
    } else {
      for (int b = 0; b < B; ++b) dst[b] = src[b * 32];
    }
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

// K6.  gb: [F, C] int32 bins (outside [0, B): nothing added); vals:
// [M, C] float32; out: [F, M, B] float32, every cell written.  The caller
// sizes the work (ops/histogram.py `_k6_layout`): lanes a feature group
// 1 << lg, W owner warps (W * 32 >> lg value rows a tile), positions a
// staged tile Pt (a multiple of 16, at most kMultiLoads 16-byte loads a
// producer thread), P blocks an item of chunk positions each, rtiles
// value-row tiles; slab: [items, P, W * (B + 1) * 32] words, gslab:
// [items, ceil(P / 16), same] words, tickets: [items, ceil(P / 16) + 1]
// int32, zero, left zero (all three unused when P == 1).
extern "C" int lgbt_hist_multirow(const int* gb, int F, long long C,
                                  const float* vals, int M, int B,
                                  int round_bf16, int lg, int W, int Pt,
                                  long long chunk, int P, int rtiles,
                                  void* slab, void* gslab, int* tickets,
                                  float* out, void* stream) {
  static int smem_set = 48 * 1024;
  if (lg < 0 || lg > 5 || W < 1 ||
      (W + kProducerWarps) * 32 > kMultiThreads || Pt < 16 || Pt > 256 ||
      (Pt & 15) || B < 1 || B > 65535 || P < 1 || chunk < 1 || rtiles < 1)
    return cudaErrorInvalidValue;
  const int nfp = 1 << lg;
  const int R = W * (32 >> lg);
  if ((long long)(nfp + R) * (Pt / 4) >
      (long long)kMultiLoads * kProducerWarps * 32)
    return cudaErrorInvalidValue;
  const long long items = (long long)((F + nfp - 1) / nfp) * rtiles;
  const long long slot =
      (((long long)(nfp + 1) * (Pt + 4) * 2 + 15) & ~15LL) +
      (((long long)R * (Pt + 4) * 4 + 15) & ~15LL);
  const long long smem = (long long)W * (B + 1) * 32 * 4 + 2 * slot;
  if (smem > 227 * 1024 || items * P > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(hist_multirow_kernel, (int)smem, &smem_set);
  if (e != cudaSuccess) return e;
  hist_multirow_kernel<<<(unsigned)(items * P), (W + kProducerWarps) * 32,
                         (int)smem, static_cast<cudaStream_t>(stream)>>>(
      gb, F, C, vals, M, B, round_bf16, lg, W, Pt, chunk, P, rtiles,
      static_cast<unsigned*>(slab), static_cast<unsigned*>(gslab), tickets,
      out);
  return cudaGetLastError();
}
