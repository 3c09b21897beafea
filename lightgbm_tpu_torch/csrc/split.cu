// Split search: the best split of each leaf from its histogram.
//
// Replaces no Pallas kernel.  lightgbm_tpu/ops/split.py `best_split` is
// plain XLA code (`split_gain_matrix`, then a flat argmax over features x
// bins), and so was its PyTorch port (ops/split.py), some hundred small
// launches a call.  Here one launch searches one or two histograms of each
// of k leaves and writes the packed 11-field records of `best_split`:
// gain, feature, threshold bin, left (grad, hess, count), right (grad,
// hess, count), left output, right output.  The rounds learner hands it
// both children of a chunk of splits at once and the rows of `leaf_best`
// to write them to.
//
// What bounds it on an H100: reading the histograms, k*F*3*B*4 bytes
// (7.2 MB a side for a chunk of 84 leaves at F=28, B=256: ~2.1 us at 3.35
// TB/s, ~4.3 us for both children; 77 MB for one leaf of the ctr store,
// F=50,000 and B=128: ~23 us).  The work per byte is small (two IEEE
// divisions a cell), so at the rounds learner's shapes what the design
// targets is the launch count: the search, its gate and the record writes
// are one launch a chunk.  At a wide store it must also spread one leaf
// over the whole card.
//
// The design: one block a (leaf, side, feature tile).  A feature tile is
// up to 85 features, as many as fit 96 KB of shared memory in bin tiles of
// up to 256 bins (the caller picks the tile: ops/split.py `split_tile`);
// the 28 features of higgs are one tile, the 50,000 of the ctr store 794.
// A block stages a bin tile in shared memory (a padded row per (feature,
// channel), so the scan below is free of bank conflicts); one thread a
// (feature, channel) then replaces its row by the cumulative sums, added
// in bin order in float64 and rounded to float32 as the plain version's
// `cumsum(hist.double())` does (a categorical feature keeps its bins).
// The count channel is scanned the same way: exact below 2^24 rows a
// leaf.  Each warp then evaluates a feature's cells in registers, every
// thread keeping its best under the first-maximum rule of the flat
// [F x B] argmax (the larger gain, then the smaller flat index); a warp
// shuffle and a pass over the warps pick the block's.  Where a leaf has
// one tile that block writes the record.  Else each block publishes its
// tile's best and takes a ticket (tile_combine.cuh), and the last of the
// leaf's blocks to arrive picks the first maximum of the tiles' bests.
// That rule is a total order, so the pick is the same in any order of
// arrival and every run writes the same bits.  A leaf with no valid cell
// takes flat index 0, as torch.argmax over all -inf does.
//
// The float32 arithmetic follows the plain version op for op, with the
// _rn intrinsics so that nvcc contracts nothing into an FMA:
//   reg = max(|G| - l1, 0), gain = reg * reg / (H + l2),
//   total = gain(L) + gain(R), kept where valid and total > shift + min_gain,
//   record gain = total - shift, output = (-sign(G) * reg) / (H + l2)
//   (its sign set on the bits: see leaf_output).
// A NaN total (0/0) fails the comparison and ends as -inf, as
// torch.where(valid & (total > ...)) makes it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_combine.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// one scan thread a (feature, channel) of a tile
constexpr int kMaxTileFeatures = kThreads / 3;
constexpr int kMaxBinTile = 256;
// dynamic shared memory of a tile: two blocks fit an SM
constexpr int kSmemBudget = 96 * 1024;
constexpr int kRecord = 11;
// words of a tile's best in the scratch: value, flat index, GL, HL, CL
// and padding to 16 bytes
constexpr int kPart = 8;

struct Params {
  const float* hist[2];        // [k, F, 3, B] each; hist[1] null: one side
  const float* sums[2];        // [k, 3] (grad, hess, count) each
  const long long* num_bins;   // [F] or [k, F] (stride 0 or F)
  const uint8_t* is_cat;
  const uint8_t* fmask;
  int nb_stride, cat_stride, fm_stride;
  int k, F, B, FT, BT, T;
  float l1, l2, min_data, min_hess, min_gain;
  int gate;                    // the can-split gate of the learners
  float gate_data, gate_hess;
  const uint8_t* sel;          // record destinations (see lgbt_split_search)
  const long long* rows_a;
  const long long* rows_b;
  float* out;
  unsigned* part;              // [sides, k, T, kPart] tile bests (T > 1)
  int* tickets;                // [sides, k], zero between launches
};

// a candidate split: its total gain, flat index and left sums
struct Best {
  float v;
  int i;
  float gl, hl, cl;
};

__device__ __forceinline__ float reg_grad(float G, float l1) {
  const float r = __fsub_rn(fabsf(G), l1);
  return r < 0.0f ? 0.0f : r;   // torch.clamp(min=0): NaN stays NaN
}

__device__ __forceinline__ float leaf_gain(float G, float H, float l1,
                                           float l2) {
  const float r = reg_grad(G, l1);
  return __fdiv_rn(__fmul_rn(r, r), __fadd_rn(H, l2));
}

// (-sign(G) * reg) / (H + l2) with the plain version's signs of zero,
// the signs set on the bits: a -0.0 factor came out as +0.0 on an H100.
// reg >= 0, so by IEEE the quotient q = reg / (H + l2) has the sign of
// H + l2 where it is zero; -sign(G) * reg negates it unless G < 0 (a
// factor of -1 is exact and the rounding symmetric; torch.sign(+-0.0)
// is +0.0, so a zero G negates too)
__device__ __forceinline__ float leaf_output(float G, float H, float l1,
                                             float l2) {
  const float d = __fadd_rn(H, l2);
  const float q = __fdiv_rn(reg_grad(G, l1), d);
  unsigned bits = __float_as_uint(q);
  if (q == 0.0f) bits = __float_as_uint(d) & 0x80000000u;
  if (!(G < 0.0f)) bits ^= 0x80000000u;
  return __uint_as_float(bits);
}

// b takes c where c comes first in the flat argmax's order: the larger
// value, then the smaller index
__device__ __forceinline__ void take(Best& b, const Best& c) {
  if (c.v > b.v || (c.v == b.v && c.i < b.i)) b = c;
}

// The block's first maximum of every thread's b, in thread 0.
__device__ Best block_best(Best b) {
  __shared__ Best s[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best c;
    c.v = __shfl_down_sync(0xffffffffu, b.v, o);
    c.i = __shfl_down_sync(0xffffffffu, b.i, o);
    c.gl = __shfl_down_sync(0xffffffffu, b.gl, o);
    c.hl = __shfl_down_sync(0xffffffffu, b.hl, o);
    c.cl = __shfl_down_sync(0xffffffffu, b.cl, o);
    take(b, c);
  }
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = b;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) take(b, s[w]);
  return b;
}

// The record of side `side` of leaf `leaf` from its best cell.
__device__ void write_record(const Params& p, int leaf, int side,
                             const Best& b) {
  const float* sums = p.sums[side] + leaf * 3;
  const float sg = sums[0], sh = sums[1], nd = sums[2];
  const float shift = leaf_gain(sg, sh, p.l1, p.l2);
  const float grb = __fsub_rn(sg, b.gl), hrb = __fsub_rn(sh, b.hl);
  const float crb = __fsub_rn(nd, b.cl);
  float gain = isfinite(b.v) ? __fsub_rn(b.v, shift) : -INFINITY;
  if (p.gate && !(nd >= p.gate_data && sh >= p.gate_hess && isfinite(gain)
                  && gain > 0.0f))
    gain = -INFINITY;
  long long dest = (long long)side * p.k + leaf;
  if (p.rows_a != nullptr)
    dest = ((side == 0) == (p.sel[leaf] != 0)) ? p.rows_a[leaf]
                                                : p.rows_b[leaf];
  float* o = p.out + dest * kRecord;
  o[0] = gain;
  o[1] = (float)(b.i / p.B);
  o[2] = (float)(b.i % p.B);
  o[3] = b.gl;
  o[4] = b.hl;
  o[5] = b.cl;
  o[6] = grb;
  o[7] = hrb;
  o[8] = crb;
  o[9] = leaf_output(b.gl, b.hl, p.l1, p.l2);
  o[10] = leaf_output(grb, hrb, p.l1, p.l2);
}

__global__ void __launch_bounds__(kThreads)
split_search_kernel(const Params p) {
  extern __shared__ float tile[];   // [FT * 3][BT + 1]
  __shared__ long long s_nb[kMaxTileFeatures];
  __shared__ uint8_t s_cat[kMaxTileFeatures];
  __shared__ uint8_t s_fm[kMaxTileFeatures];
  __shared__ __align__(16) unsigned s_part[kPart];

  const int leaf = blockIdx.x;
  const int side = blockIdx.y;
  const int z = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int F = p.F, B = p.B, row = p.BT + 1;
  const int f0 = z * p.FT;
  const int nf = min(p.FT, F - f0);
  const float* hist = p.hist[side] + ((long long)leaf * F + f0) * 3 * B;
  const float* sums = p.sums[side] + leaf * 3;
  const float sg = sums[0], sh = sums[1], nd = sums[2];
  const float min_shift = __fadd_rn(leaf_gain(sg, sh, p.l1, p.l2),
                                    p.min_gain);
  if (t < nf) {
    s_nb[t] = p.num_bins[(long long)leaf * p.nb_stride + f0 + t];
    s_cat[t] = p.is_cat[(long long)leaf * p.cat_stride + f0 + t];
    s_fm[t] = p.fmask[(long long)leaf * p.fm_stride + f0 + t];
  }

  Best b{-INFINITY, 0x7fffffff, 0.0f, 0.0f, 0.0f};
  // this thread's scan row, (feature t / 3, channel t % 3), over the
  // bin tiles
  double acc = 0.0;
  for (int b0 = 0; b0 < B; b0 += p.BT) {
    const int nbt = min(p.BT, B - b0);
    __syncthreads();   // the metadata staged, the last tile evaluated
    for (int r = warp; r < nf * 3; r += kWarps) {
      const float* src = hist + (long long)r * B + b0;
#pragma unroll 4
      for (int c = lane; c < nbt; c += 32) tile[r * row + c] = __ldg(src + c);
    }
    __syncthreads();
    if (t < nf * 3 && !s_cat[t / 3]) {
      float* r = tile + t * row;
#pragma unroll 8
      for (int c = 0; c < nbt; ++c) {
        acc += (double)r[c];
        r[c] = __double2float_rn(acc);
      }
    }
    __syncthreads();
    for (int fl = warp; fl < nf; fl += kWarps) {
      const long long nb = s_nb[fl];
      const bool cat = s_cat[fl] != 0, fm = s_fm[fl] != 0;
      const float* r = tile + fl * 3 * row;
      for (int c = lane; c < nbt; c += 32) {
        const float GL = r[c], HL = r[row + c], CL = r[2 * row + c];
        const int bin = b0 + c;
        const float GR = __fsub_rn(sg, GL), HR = __fsub_rn(sh, HL);
        const float CR = __fsub_rn(nd, CL);
        const bool valid = fm && (cat ? bin < nb : bin < nb - 1)
                           && CL >= p.min_data && CR >= p.min_data
                           && HL >= p.min_hess && HR >= p.min_hess;
        float total = -INFINITY;
        if (valid) {
          const float g = __fadd_rn(leaf_gain(GL, HL, p.l1, p.l2),
                                    leaf_gain(GR, HR, p.l1, p.l2));
          if (g > min_shift) total = g;
        }
        take(b, Best{total, (f0 + fl) * B + bin, GL, HL, CL});
      }
    }
  }
  b = block_best(b);
  if (p.T == 1) {
    if (t == 0) write_record(p, leaf, side, b);
    return;
  }

  // the leaf's tiles: publish this one's best; the last to arrive picks
  if (t == 0) {
    s_part[0] = __float_as_uint(b.v);
    s_part[1] = (unsigned)b.i;
    s_part[2] = __float_as_uint(b.gl);
    s_part[3] = __float_as_uint(b.hl);
    s_part[4] = __float_as_uint(b.cl);
  }
  __syncthreads();
  const long long item = (long long)side * p.k + leaf;
  unsigned* slab = p.part + item * p.T * kPart;
  if (!tile_combine::publish_and_wait(s_part, kPart, slab + z * kPart,
                                      p.tickets + item, p.T))
    return;
  Best c{-INFINITY, 0x7fffffff, 0.0f, 0.0f, 0.0f};
  for (int u = t; u < p.T; u += kThreads) {
    const unsigned* q = slab + u * kPart;
    take(c, Best{__uint_as_float(__ldcg(q)), (int)__ldcg(q + 1),
                 __uint_as_float(__ldcg(q + 2)),
                 __uint_as_float(__ldcg(q + 3)),
                 __uint_as_float(__ldcg(q + 4))});
  }
  c = block_best(c);
  if (t == 0) write_record(p, leaf, side, c);
}

}  // namespace

// hist0, hist1: [k, F, 3, B] float32, contiguous (hist1 null: one side);
// sums0, sums1: [k, 3] float32 (grad, hess, count) of each leaf,
// contiguous; num_bins int64, is_cat and fmask bytes, each [F] (stride 0)
// or [k, F] (stride F).  FT features and BT bins a tile (BT a multiple of
// 32, at most 256; FT at most 85; FT * 3 * (BT + 1) floats within 96 KB).
// With T = ceil(F / FT) > 1 tiles a leaf, part holds sides * k * T * 8
// words of scratch and tickets sides * k zeroed counters, left zero.  The
// record of side s of leaf i goes to out row s * k + i when rows_a is
// null; else side 0's to rows_a[i] and side 1's to rows_b[i] where sel[i]
// (bytes) is nonzero, the other way round where it is 0.  gate != 0
// applies the learners' can-split gate: the gain is kept where count >=
// gate_data, hess >= gate_hess and the gain is finite and > 0.
extern "C" int lgbt_split_search(const float* hist0, const float* hist1,
                                 const float* sums0, const float* sums1,
                                 const long long* num_bins, int nb_stride,
                                 const uint8_t* is_cat, int cat_stride,
                                 const uint8_t* fmask, int fm_stride, int k,
                                 int F, int B, int FT, int BT, float l1,
                                 float l2, float min_data, float min_hess,
                                 float min_gain, int gate, float gate_data,
                                 float gate_hess, const uint8_t* sel,
                                 const long long* rows_a,
                                 const long long* rows_b, float* out,
                                 unsigned* part, int* tickets,
                                 void* stream) {
  if (k <= 0 || F <= 0 || B <= 0 || (long long)F * B > 0x7fffffffLL ||
      FT <= 0 || FT > kMaxTileFeatures || BT <= 0 || BT > kMaxBinTile ||
      BT % 32 != 0)
    return cudaErrorInvalidValue;
  const int smem = FT * 3 * (BT + 1) * (int)sizeof(float);
  const int T = (F + FT - 1) / FT;
  if (smem > kSmemBudget || T > 65535 ||
      (T > 1 && (part == nullptr || tickets == nullptr)) ||
      (rows_a != nullptr && (rows_b == nullptr || sel == nullptr)))
    return cudaErrorInvalidValue;
  Params p;
  p.hist[0] = hist0;
  p.hist[1] = hist1;
  p.sums[0] = sums0;
  p.sums[1] = sums1;
  p.num_bins = num_bins;
  p.is_cat = is_cat;
  p.fmask = fmask;
  p.nb_stride = nb_stride;
  p.cat_stride = cat_stride;
  p.fm_stride = fm_stride;
  p.k = k;
  p.F = F;
  p.B = B;
  p.FT = FT;
  p.BT = BT;
  p.T = T;
  p.l1 = l1;
  p.l2 = l2;
  p.min_data = min_data;
  p.min_hess = min_hess;
  p.min_gain = min_gain;
  p.gate = gate;
  p.gate_data = gate_data;
  p.gate_hess = gate_hess;
  p.sel = sel;
  p.rows_a = rows_a;
  p.rows_b = rows_b;
  p.out = out;
  p.part = part;
  p.tickets = tickets;
  // the attribute belongs to the current device: set it on every launch
  // that needs it (a host call of well under a microsecond)
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBudget);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)k, hist1 != nullptr ? 2u : 1u, (unsigned)T);
  split_search_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
