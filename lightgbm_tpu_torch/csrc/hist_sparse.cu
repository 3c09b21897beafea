// K-leaf histograms over the column-sorted entry streams of the CSR/ELL
// sparse store (K7 and K8), zero bin and dequantize fused, and the
// per-slot totals that anchor the zero bins.
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
// function's single dequantize does.  Every float sum is taken in an
// order fixed by the inputs alone, so K8 gives the same bits on every
// run, as K7's integer sums do.
//
// What bounds it on an H100: the [K, Cp, 3, B] output (2.4 GB at K=31,
// Cp=50,000, B=128: 0.71 ms at 3.35 TB/s) and the entry streams (5 B an
// entry, 1.2 GB for the ctr store's 233M entries: 0.35 ms) set the bytes
// bound; what takes the time is one random read per entry (a live-row
// bit) and one per entry of a live row (its 16-byte record in L2), and
// for float32 the adds in a fixed order.
//
// The TPU kernel sorted the entries by column once per dataset
// (`sparse_window_streams`) so that each grid cell owned a window of
// columns and contracted one-hot blocks on the MXU.  Here the same sort
// gives each block one column: it zeroes its slots' histograms in shared
// memory (nb = 1 + the largest stored bin, not the padded B), reads its
// column's (row, bin) entries with coalesced loads (the next step's in
// flight while this one is added), skips the rows outside the pass and
// outside the block's slot tile by one bit of a live-row mask (one mask
// a slot tile) that stays in L1, gathers the record (slot and three
// values) of the others, and adds them.  K7 adds with shared-memory
// int32 atomics, exact in any order.  K8 never lets two threads add into
// one float cell, so that its sums are a function of the inputs: each
// cell has an owner warp (cell % kWarps).  A step's live entries (1,024
// entries, a lane's in a fixed sequence lo + tid + u * kThreads) are
// staged in shared memory, bucketed by owner in entry order (each
// lane's place from ballots, each bucket's start from a scan); then each
// warp walks its bucket 32 entries at a time, the lanes of one cell sum
// their values in a tree fixed by their lane positions (`reduce_peers`)
// and the group's lowest lane adds the sums with a plain load and store.
// One copy of the tile serves the block, as K7's does, so as many blocks
// fit an SM; the staging takes 17 KB more, and four block barriers a
// step.  Where the tile is small (a pass of a few slots, such as the
// fused builder's K=1), each warp keeps a copy of its own instead and
// adds its lanes' group sums into it, without staging; the copies are
// folded in copy order.  (A copy a warp at K=31 fits 16 warps an SM: 2x
// the owner warps' time there, scripts/bench_torch_k8.py.)  A cell's
// sums depend on which slots share its tile, so a K8 pass gives the same
// bits at the same slot tile, which the budget sets.
// A first small kernel (pack_rows_kernel) writes the per-pass records
// and the masks.  Then, per (slot, channel), one warp reduces the
// column's stored sums, adds the zero-bin residual and writes the [B]
// row of the output once, so the output is never zeroed, read back or
// dequantized in a second pass.  Work items go heaviest column first, so
// the power-law head columns of a CTR store do not finish last.  A
// column longer than `chunk` entries splits into chunks, one block each:
// every chunk block writes its partial histogram to a scratch slab, and
// the last of them to take the column's ticket (an atomic counter, after
// a fence) sums the slabs in chunk order and writes the output.  Slots
// beyond the shared-memory budget are cut into tiles, one block per
// (work item, tile).
//
// The slot totals (slot_totals_kernel, then slot_totals_reduce_kernel)
// replace no TPU kernel: the JAX function sums them with an XLA
// scatter-add (`tot.at[srow].add`, lightgbm_tpu/ops/histogram.py:963),
// whose float atomics on this card would add in a run-dependent order.
// Each block sums a fixed range of rows, per warp in a copy of its own
// (the lanes of one slot in `reduce_peers`' tree), folds the warps in
// order and writes its partial [K, 3]; one warp per (slot, channel) then
// sums the partials in block order.  They are bound by reading the slot
// and the three values of every row once.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// entries a block takes a step; K8 stages a step's live ones in shared
// memory (a cell and three values each), and a lane of a warp counts
// one (step group, owner) pair of them
constexpr int kStage = kUnroll * kThreads;
static_assert(kUnroll * kWarps == 32, "one lane a (group, owner) pair");
// K8's staging: cells, values, bucket starts and totals, in bytes
constexpr int kStageBytes = (4 * kStage + kWarps * 32 + kWarps) * 4;
constexpr unsigned kFull = 0xffffffffu;
// the most dynamic shared memory a Hopper block may opt in to
constexpr int kMaxSmem = 227 * 1024;
// K7: a small tile's histogram is kept in up to kWarps copies (warp w
// adds into copy w % copies) while they fit this size, so that the warps
// of a block do not contend for the same cells when few slots take all
// rows.  K8 keeps a copy a warp where kWarps copies fit this size (a pass
// of a few slots, the fused builder's K=1), else one copy, each cell
// owned by one warp.
constexpr int kCopiesSmem = 24 * 1024;
// the slot totals: a block's kWarps copies of [kTotalsTile, 3] sums
// (24 KB of static shared memory); more slots take more tiles
constexpr int kTotalsTile = 256;

template <typename T>
__device__ __forceinline__ T lane_value(int bits);
template <>
__device__ __forceinline__ int lane_value<int>(int bits) { return bits; }
template <>
__device__ __forceinline__ float lane_value<float>(int bits) {
  return __int_as_float(bits);
}

__device__ __forceinline__ int bits_of(int v) { return v; }
__device__ __forceinline__ int bits_of(float v) { return __float_as_int(v); }

__device__ __forceinline__ float to_out(int v, float scale) {
  return __int2float_rn(v) * scale;
}
__device__ __forceinline__ float to_out(float v, float) { return v; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sums the three values of the lanes of `peers` (the calling lane's
// group: lanes with the same key, from __match_any_sync) in a binary tree
// fixed by the group's lane positions; the group's lowest lane ends with
// the sums.  Every lane of the warp calls it.  (The peer reduction of
// NVIDIA's "Voting and Shuffling to Optimize Atomic Operations", as
// csrc/hist_gathered.cu's K5 uses it.)
template <typename T>
__device__ __forceinline__ void reduce_peers(unsigned peers, T (&v)[3]) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));   // rank among peers
  peers &= 0xfffffffeu << lane;                    // the peers above
  while (__any_sync(kFull, peers != 0u)) {
    const int next = __ffs(peers);                 // 1-based, 0: none
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T t = __shfl_sync(kFull, v[i], (next - 1) & 31);
      if (next) v[i] += t;
    }
    peers &= ~__ballot_sync(kFull, rel & 1);
    rel >>= 1;
  }
}

// The shared histogram of one slot: one row of nbs = nb | 1 words (an
// odd stride, so the lanes of a warp that hit bins 32 apart fall in
// different banks) for each of grad, hess and the count channel, holding
// int32 sums (K7) or float32 bits (K8).
template <typename T>
__device__ __forceinline__ T cell_get(const int* s, int i) {
  return lane_value<T>(s[i]);
}

// One block per (work item, slot tile): blockIdx.x = w * n_tiles + tile.
// Shared memory: `copies` x [k_tile] slots; K7's warp w adds into copy
// w % copies with atomics, and the copies are folded into the first, in
// copy order, before the epilogue.  K8 keeps either a copy a warp
// (copies == kWarps), warp w adding into copy w with plain stores, or one
// copy and after it the staging of one step's live entries, warp w
// owning the cells c with c % kWarps == w.
template <typename T, typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_sparse_kernel(const long long* __restrict__ col_off,
                   const int* __restrict__ e_row,
                   const BinT* __restrict__ e_bin,
                   const int* __restrict__ w_col,
                   const int* __restrict__ w_chunk, long long chunk,
                   const int* __restrict__ c_long,
                   const int* __restrict__ long_base,
                   const unsigned* __restrict__ live, long long live_words,
                   const int4* __restrict__ rec, const T* __restrict__ tot,
                   const float* __restrict__ scale,
                   const int* __restrict__ zero_bin, int K, int k_tile,
                   int n_tiles, int Cp, int B, int nb, int copies,
                   T* __restrict__ scratch, int* __restrict__ tickets,
                   float* __restrict__ out) {
  constexpr bool kFloat = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* sh = reinterpret_cast<int*>(smem_raw);
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nbs = nb | 1;
  const int slot_words = 3 * nbs;
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
  // the rows of this tile's slots that carry a value, a bit each
  const unsigned char* live_t =
      reinterpret_cast<const unsigned char*>(live + tile * live_words);

  const int copy_words = k_tile * slot_words;
  for (int i = tid; i < copies * copy_words; i += kThreads) sh[i] = 0;
  int* mine_sh = sh + (warp % copies) * copy_words;
  // K8's staging after the copy: a step's live entries (cell and three
  // values), bucketed by owner warp, and each bucket's start
  int* st_cell = sh + copies * copy_words;
  float* st_v = reinterpret_cast<float*>(st_cell + kStage);
  int* st_start = st_cell + 4 * kStage;            // [kWarps][32 groups]
  int* st_total = st_start + kWarps * 32;          // [kWarps]
  __syncthreads();

  // the entries of the next step are loaded while this step's records
  // are gathered and added (a software pipeline in registers); every
  // lane of the block runs the same steps, so K8's warps stay converged
  constexpr long long kStep = (long long)kUnroll * kThreads;
  int rn[kUnroll], bn[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = lo + tid + (long long)u * kThreads;
    rn[u] = e < hi ? __ldg(e_row + e) : -1;
    bn[u] = e < hi ? (int)__ldg(e_bin + e) : 0;
  }
  for (long long e0 = lo + tid; e0 - tid < hi; e0 += kStep) {
    int r[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = rn[u];
      b[u] = bn[u];
      const long long e = e0 + kStep + (long long)u * kThreads;
      rn[u] = e < hi ? __ldg(e_row + e) : -1;
      bn[u] = e < hi ? (int)__ldg(e_bin + e) : 0;
    }
    // the bitmask of the tile's live rows is 1 bit a row, small enough
    // for L1 (62.5 KB at 500k rows): a row outside the tile costs no
    // gather of its record
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r[u] >= 0 && !((__ldg(live_t + (r[u] >> 3)) >> (r[u] & 7)) & 1))
        r[u] = -1;
    int4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      q[u] = r[u] >= 0 ? __ldg(rec + r[u]) : make_int4(-1, 0, 0, 0);
    if (kFloat && copies == kWarps) {
      // a copy of the tile a warp: the lanes of one cell sum in a fixed
      // tree, the group's lowest lane adds the sums into its warp's copy
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = q[u].x - k0;
        const bool act = (unsigned)s < (unsigned)kt;
        if (!__any_sync(kFull, act)) continue;
        const int cl = act ? s * slot_words + min(b[u], B - 1) : -1;
        const unsigned peers = __match_any_sync(kFull, cl);
        float v[3] = {__int_as_float(q[u].y), __int_as_float(q[u].z),
                      __int_as_float(q[u].w)};
        reduce_peers(peers, v);
        if (act && (peers & ((1u << lane) - 1u)) == 0u) {
          float* f = reinterpret_cast<float*>(mine_sh) + cl;
          f[0] += v[0];
          f[nbs] += v[1];
          f[2 * nbs] += v[2];
        }
        __syncwarp();
      }
    } else if constexpr (kFloat) {
      // bucket the step's live entries by owner warp (cell % kWarps), in
      // entry order: each lane's position in its bucket from ballots
      int cell[kUnroll];
      unsigned same[kUnroll] = {};
      int any_live = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = q[u].x - k0;
        cell[u] = (unsigned)s < (unsigned)kt
                      ? s * slot_words + min(b[u], B - 1) : -1;
        const int own = cell[u] >= 0 ? cell[u] & (kWarps - 1) : -1;
        any_live |= cell[u] >= 0;
#pragma unroll
        for (int o = 0; o < kWarps; ++o) {
          const unsigned m = __ballot_sync(kFull, own == o);
          if (own == o) same[u] = m;
          // entry group g = u * kWarps + warp comes in entry order
          if (lane == u * kWarps + o)
            st_start[o * 32 + u * kWarps + warp] = __popc(m);
        }
      }
      // a step with no live entry in the block stages nothing
      if (!__syncthreads_or(any_live)) continue;
      // warp o turns the counts of its bucket, one a lane (entry group),
      // into starts: an exclusive scan, after the buckets of warps < o
      const int cnt = st_start[warp * 32 + lane];
      int run = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, run, d);
        if (lane >= d) run += t;
      }
      const int n_own = __shfl_sync(kFull, run, 31);
      if (lane == 31) st_total[warp] = run;
      __syncthreads();
      int base = 0;
      for (int o = 0; o < warp; ++o) base += st_total[o];
      st_start[warp * 32 + lane] = base + run - cnt;
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (cell[u] < 0) continue;
        const int pos = st_start[(cell[u] & (kWarps - 1)) * 32 +
                                 u * kWarps + warp] +
                        __popc(same[u] & ((1u << lane) - 1u));
        st_cell[pos] = cell[u];
        st_v[pos] = __int_as_float(q[u].y);
        st_v[kStage + pos] = __int_as_float(q[u].z);
        st_v[2 * kStage + pos] = __int_as_float(q[u].w);
      }
      __syncthreads();
      // owner warp w adds its bucket 32 entries at a time: the lanes of
      // one cell sum in a fixed tree, the group's lowest lane adds the
      // sums with a plain load and store (no other warp owns the cell)
      for (int i0 = 0; i0 < n_own; i0 += 32) {
        const int i = base + i0 + lane;
        const bool in = i0 + lane < n_own;
        const int cl = in ? st_cell[i] : -1;
        const unsigned peers = __match_any_sync(kFull, cl);
        float v[3] = {in ? st_v[i] : 0.f, in ? st_v[kStage + i] : 0.f,
                      in ? st_v[2 * kStage + i] : 0.f};
        reduce_peers(peers, v);
        if (cl >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {
          float* f = reinterpret_cast<float*>(sh) + cl;
          f[0] += v[0];
          f[nbs] += v[1];
          f[2 * nbs] += v[2];
        }
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = q[u].x - k0;
        if ((unsigned)s >= (unsigned)kt) continue;
        const int cell = s * slot_words + min(b[u], B - 1);
        if (q[u].y != 0) atomicAdd(mine_sh + cell, q[u].y);
        if (q[u].z != 0) atomicAdd(mine_sh + cell + nbs, q[u].z);
        if (q[u].w != 0) atomicAdd(mine_sh + cell + 2 * nbs, q[u].w);
      }
    }
  }
  __syncthreads();
  if (copies > 1) {
    for (int i = tid; i < kt * slot_words; i += kThreads) {
      T acc = cell_get<T>(sh, i);
      for (int p = 1; p < copies; ++p)
        acc += cell_get<T>(sh, p * copy_words + i);
      sh[i] = bits_of(acc);
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
      mine[i] = cell_get<T>(sh, row * nbs + i - row * nb);
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
      sh[row * nbs + i - row * nb] = bits_of(acc);
    }
    __syncthreads();
  }

  // epilogue: one warp per (slot, channel) row of the tile
  const int zb = zero_bin[c] >= 0 ? min(zero_bin[c], B - 1) : -1;
  for (int row = warp; row < kt * 3; row += kWarps) {
    const int k = row / 3;
    const int ch = row - 3 * k;
    const int* hs = sh + row * nbs;
    T part = T(0);
    for (int bb = lane; bb < nb; bb += 32) part += cell_get<T>(hs, bb);
    part = warp_sum(part);
    const T resid = zb >= 0 ? tot[(k0 + k) * 3 + ch] - part : T(0);
    const float sc = scale != nullptr ? scale[ch] : 1.0f;
    float* orow = out + (((long long)(k0 + k) * Cp + c) * 3 + ch) * B;
    for (int bb = lane; bb < B; bb += 32) {
      T v = bb < nb ? cell_get<T>(hs, bb) : T(0);
      if (bb == zb) v += resid;
      orow[bb] = to_out(v, sc);
    }
  }
}

// The per-pass row table the histogram kernel gathers: rec[r] = (slot,
// grad, hess, count bits), and for each slot tile t bit r of
// live[t * live_words ...] (32 rows a word, low bit first) set when row
// r is in a slot of tile t and carries a non-zero value.  One thread a
// row; each warp writes the words of its 32 rows.
__global__ void __launch_bounds__(256)
pack_rows_kernel(const int* __restrict__ srow, const int* __restrict__ vals,
                 long long N, int K, int k_tile, int n_tiles, int quantized,
                 int4* __restrict__ rec, unsigned* __restrict__ live,
                 long long live_words) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool act = false;
  int t = -1;
  if (r < N) {
    const int4 q = make_int4(srow[r], vals[r], vals[N + r], vals[2 * N + r]);
    rec[r] = q;
    const bool nz = quantized ? (q.y | q.z | q.w) != 0
                              : (__int_as_float(q.y) != 0.f ||
                                 __int_as_float(q.z) != 0.f ||
                                 __int_as_float(q.w) != 0.f);
    act = (unsigned)q.x < (unsigned)K && nz;
    if (act) t = q.x / k_tile;
  }
  for (int tt = 0; tt < n_tiles; ++tt) {
    const unsigned word = __ballot_sync(kFull, t == tt);
    if ((threadIdx.x & 31) == 0 && r < N)
      live[tt * live_words + (r >> 5)] = word;
  }
}

// Per-slot totals, first pass: block (x, y) sums rows [x * rows_per_block,
// (x + 1) * rows_per_block) of the slots of tile y (kTotalsTile slots)
// into partial[x, slot, channel], the block's warps each in a copy of
// their own (a lane a row, the lanes of one slot summed in reduce_peers'
// tree, the group's lowest lane adding with a plain store), folded in
// warp order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
slot_totals_kernel(const int* __restrict__ srow, const T* __restrict__ vals,
                   long long N, int K, long long rows_per_block,
                   T* __restrict__ partial) {
  __shared__ T acc[kWarps][kTotalsTile * 3];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.y * kTotalsTile;
  const int kt = min(kTotalsTile, K - k0);
  for (int i = tid; i < kWarps * kTotalsTile * 3; i += kThreads)
    (&acc[0][0])[i] = T(0);
  __syncthreads();
  T* mine = acc[warp];
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(N, r0 + rows_per_block);
  for (long long r = r0 + tid; r - tid < r1; r += kThreads) {
    const int s = r < r1 ? srow[r] - k0 : -1;
    const bool act = (unsigned)s < (unsigned)kt;
    if (!__any_sync(kFull, act)) continue;
    const unsigned peers = __match_any_sync(kFull, act ? s : -1);
    T v[3] = {T(0), T(0), T(0)};
    if (act) {
      v[0] = vals[r];
      v[1] = vals[N + r];
      v[2] = vals[2 * N + r];
    }
    reduce_peers(peers, v);
    if (act && (peers & ((1u << lane) - 1u)) == 0u) {
      mine[s * 3] += v[0];
      mine[s * 3 + 1] += v[1];
      mine[s * 3 + 2] += v[2];
    }
    __syncwarp();
  }
  __syncthreads();
  T* dst = partial + ((long long)blockIdx.x * K + k0) * 3;
  for (int i = tid; i < kt * 3; i += kThreads) {
    T a = acc[0][i];
    for (int p = 1; p < kWarps; ++p) a += acc[p][i];
    dst[i] = a;
  }
}

// Per-slot totals, second pass: one warp per (slot, channel) sums the
// row blocks' partials, each lane a fixed stride of blocks in order, then
// the lanes in warp_sum's fixed tree.
template <typename T>
__global__ void __launch_bounds__(kThreads)
slot_totals_reduce_kernel(const T* __restrict__ partial, int n_blocks,
                          int K3, T* __restrict__ tot) {
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (o >= K3) return;
  T a = T(0);
  for (int p = lane; p < n_blocks; p += 32) a += partial[(long long)p * K3 + o];
  a = warp_sum(a);
  if (lane == 0) tot[o] = a;
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
  constexpr bool kFloat = std::is_same<T, float>::value;
  const int tile_bytes = k_tile * 3 * (nb | 1) * 4;
  // K8: a copy a warp where all fit kCopiesSmem, else one copy and the
  // staging of its owner warps
  const int copies =
      kFloat ? (kWarps * tile_bytes <= kCopiesSmem ? kWarps : 1)
             : max(1, min(kWarps, kCopiesSmem / tile_bytes));
  const long long smem_ll = (long long)copies * tile_bytes +
                            (kFloat && copies == 1 ? kStageBytes : 0);
  if (smem_ll > kMaxSmem) return cudaErrorInvalidValue;
  const int smem = (int)smem_ll;
  cudaError_t e = allow_smem(hist_sparse_kernel<T, BinT>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const int n_tiles = (K + k_tile - 1) / k_tile;
  const long long blocks = (long long)n_work * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long live_words = (N + 31) / 32;
  // whole warps over ceil(N / 32) * 32 threads
  const long long row_blocks = (live_words * 32 + 255) / 256;
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (row_blocks > 0) {
    pack_rows_kernel<<<(unsigned)row_blocks, 256, 0, stream>>>(
        srow, static_cast<const int*>(vals), N, K, k_tile, n_tiles,
        std::is_same<T, int>::value ? 1 : 0, reinterpret_cast<int4*>(rec),
        live, live_words);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  hist_sparse_kernel<T, BinT><<<(unsigned)blocks, kThreads, smem, stream>>>(
      col_off, e_row, static_cast<const BinT*>(e_bin), w_col, w_chunk, chunk,
      c_long, long_base, live, live_words,
      reinterpret_cast<const int4*>(rec),
      static_cast<const T*>(tot), scale, zero_bin, K, k_tile, n_tiles, Cp, B,
      nb, copies, static_cast<T*>(scratch), tickets, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_totals(const int* srow, const void* vals, long long N,
                          int K, long long rows_per_block, void* partial,
                          void* tot, cudaStream_t stream) {
  const long long n_blocks = (N + rows_per_block - 1) / rows_per_block;
  const int k_tiles = (K + kTotalsTile - 1) / kTotalsTile;
  if (n_blocks > 0x7fffffffLL || k_tiles > 65535)
    return cudaErrorInvalidValue;
  if (n_blocks > 0) {
    slot_totals_kernel<T><<<dim3((unsigned)n_blocks, k_tiles), kThreads, 0,
                            stream>>>(srow, static_cast<const T*>(vals), N,
                                      K, rows_per_block,
                                      static_cast<T*>(partial));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long K3 = 3LL * K;
  slot_totals_reduce_kernel<T><<<(unsigned)((K3 + kWarps - 1) / kWarps),
                                 kThreads, 0, stream>>>(
      static_cast<const T*>(partial), (int)n_blocks, (int)K3,
      static_cast<T*>(tot));
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
// values; live: [ceil(K / k_tile), ceil(N/32)] int32 and rec: [N, 4]
// int32 scratch, filled here (pack_rows_kernel) before the histogram
// kernel runs; tot: [K, 3] int32 (quantized=1) or float32 slot totals;
// scale: [3] float32 (K7) or null (K8); zero_bin: [Cp] int32; scratch:
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

// srow: [N] int32 slot of each row (K or more = none); vals: [3, N] int32
// (quantized=1) or float32; partial: scratch of ceil(N / rows_per_block)
// x K x 3 of vals' type; tot: [K, 3] of vals' type, every entry written.
extern "C" int lgbt_slot_totals(const int* srow, const void* vals,
                                long long N, int K, int quantized,
                                long long rows_per_block, void* partial,
                                void* tot, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (N < 0 || rows_per_block <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quantized
             ? launch_totals<int>(srow, vals, N, K, rows_per_block, partial,
                                  tot, s)
             : launch_totals<float>(srow, vals, N, K, rows_per_block,
                                    partial, tot, s);
}
