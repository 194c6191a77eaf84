// Kernel G: the sums of one Gruen/BDDT eq-split round of the outer
// sum-check, sum_x eq(tau, x) (A(x) B(x) - C(x)).
//
// Replaces the sums of the JAX package's sc_cubiceq_step
// (spartan2_tpu/sumcheck/prove.py:428-498, jitted :501, tail :509), of the
// fused outer sum-check (sumcheck/fused.py fused_cubiceq :152-201, body
// :213-304) and of its peeled round 0 (_peel_kernel :307-378).  The rest of
// a round is the round finish (round_finish.cu) and a bind
// (sumcheck.cu sp2_bind_dev, or sp2_inner0_bind_dev for the peel).
//
// One entry, sp2_cubiceq_evals, over the low half [0, half) of the current
// vectors, with weight w_g the eq table of the remaining variables:
//   two-level (EL given):  w_g = EL[g >> rlog] ER[g & (2^rlog - 1)]
//                          (Gruen's left/right split, fused.py:152-201);
//   one-level (EL null):   w_g = ER[g] (the table T_j, or ER's prefix).
// It writes one row of three sums to out (the round finish reads it):
//   t0   = sum_g w_g (A_lo B_lo - C_lo)_g             (skipped: zero_check)
//   tinf = sum_g w_g ((A_hi - A_lo)(B_hi - B_lo))_g
//   tm1  = sum_g w_g ((2A_lo - A_hi)(2B_lo - B_hi) - (2C_lo - C_hi))_g
//                                                       (only if fallback)
// The high half is read only below hi_len and taken as zero past it: the
// peeled round 0 of a padded R1CS passes hi_len = live rows x R, so a dead
// row adds A_lo B_lo to tinf (fused.py:340-356).
//
// The two-level sums as the JAX package takes them (fused.py:151-188,
// _inner_lazy / _two_level_vpu under _grid_sums): per left row hi,
// inner(hi) = sum_lo ER[lo] f(hi, lo) with each term an unreduced product
// in an Acc (fe_mul_acc), one reduction (acc_reduce) a row and sum, then
// one product by EL[hi].  The f terms are formed on the carry chains
// (fe_mul_cc, fe_sub_cc, fe_add_cc).  A left row is the 2^(rlog - lw)
// consecutive local pairs of one hi (1 when lw > rlog: every pair its own
// row, handled the same way), cut into sub-rows of Lr pairs, Lr at most
// the least power of two >= NT whose tiles fit G_WAVE blocks (a block an
// SM: the kernel's 124-170 registers a thread leave room for one or two
// blocks of NT an SM): a sub-row stays under its row's EL entry and costs
// one more reduction and EL product, and the main path's rounds 3-8 (rows
// of 1024 pairs, 64 to 2 of them) spread over the SMs instead of taking a
// block a row.  A segment of T threads takes a sub-row, T = NT for
// Lr >= NT (round 0: Lr = 1024, 4 pairs a thread), T = Lr for
// 32 <= Lr < NT, T = 32 below (lanes past Lr idle); a tile is NT / T
// sub-rows, and a block takes the tiles blockIdx.x + gridDim.x k.  A
// segment's Accs are added by a warp shuffle tree, then across its warps
// in shared memory by the segment's thread t (for sum t), which reduces,
// multiplies by EL[hi] and keeps a running sum.  One-level rounds put
// ER[g] straight into the Acc over the block's grid-stride pairs and
// reduce once a block and sum.  The blocks' sums are finished in the
// launch by the last block to arrive (finish.cuh, as kernel A's).
//
// Shard stride (the port's sharded outer sum-check, parallel/sumcheck_shard.py):
// rank s of W = 2^lw holds the global rows s + W i in local order, so its
// local pair i is global pair g = s + (i << lw) and takes the weight of g;
// half and hi_len stay local.  With lw <= rlog the local pairs of one left
// row are consecutive (g >> rlog = i >> (rlog - lw)).  s = 0, lw = 0 is
// the unsharded round.  This replaces the sums of the JAX package's
// shard_cubiceq_step (spartan2_tpu/parallel/sumcheck_shard.py:199) and
// fused_sharded_cubiceq (spartan2_tpu/parallel/fused_shard.py:209).
//
// Bound: per pair and active sum one reduced product for f and one
// unreduced product by ER, and per left row and sum one reduction and one
// product by EL (an unreduced product or a reduction counts half a
// product), over 128-192 bytes a pair read: at the H100's rates the
// products bound the peeled round 0 (one sum), the bytes round 1 (two).

#include "field.cuh"
#include "finish.cuh"

using namespace sp2;

constexpr int NT = 256;
// The grid: a tile a block up to G_MAX_BLOCKS blocks, two an SM of the
// H100's 132; more tiles a block past that.
constexpr int G_MAX_BLOCKS = 264;
// Sub-rows are cut so that the tiles fit a block an SM.
constexpr int G_WAVE = 132;
// The least segment: a warp.
constexpr int G_MIN_SEG = 32;

struct GShape {
  size_t lr;      // local pairs a sub-row of a left row (two-level)
  int seg;        // threads a segment (two-level), NT (one-level)
  size_t ntiles;  // tiles of the round
};

__host__ __device__ inline GShape g_shape(size_t half, int rlog, int lw, bool two) {
  GShape s;
  if (!two) {
    s.lr = 0;
    s.seg = NT;
    s.ntiles = (half + NT - 1) / NT;
    return s;
  }
  size_t cap = NT;  // sub-rows of at most cap pairs
  while (cap * G_WAVE < half) cap <<= 1;
  const size_t row = (size_t)1 << (rlog > lw ? rlog - lw : 0);
  s.lr = row < cap ? row : cap;
  s.seg = s.lr >= (size_t)NT ? NT : (s.lr >= (size_t)G_MIN_SEG ? (int)s.lr : G_MIN_SEG);
  const size_t rows = (half + s.lr - 1) / s.lr, per_tile = NT / s.seg;
  s.ntiles = (rows + per_tile - 1) / per_tile;
  return s;
}

// The grid for a round; the wrapper sizes the partial sums by it.
static int g_blocks(size_t half, int rlog, int lw, bool two) {
  const size_t t = g_shape(half, rlog, lw, two).ntiles;
  return t < 1 ? 1 : (t > (size_t)G_MAX_BLOCKS ? G_MAX_BLOCKS : (int)t);
}

// Pair i's terms, weighted by w into the active sums' accumulators.
template <bool ZC, bool FB>
__device__ __forceinline__ void add_pair(size_t i, size_t half, size_t hi_len, const Fe& w,
                                         const uint32_t* A, const uint32_t* B,
                                         const uint32_t* C, Acc& s0, Acc& s1, Acc& s2,
                                         const Field& F) {
  const bool live = i < hi_len;
  const Fe a0 = fe_load(A, i), b0 = fe_load(B, i);
  const Fe a1 = live ? fe_load(A, half + i) : fe_zero();
  const Fe b1 = live ? fe_load(B, half + i) : fe_zero();
  fe_mul_acc(s1, w, fe_mul_cc(fe_sub_cc(a1, a0, F), fe_sub_cc(b1, b0, F), F));
  if (!ZC || FB) {
    const Fe c0 = fe_load(C, i);
    if (!ZC) fe_mul_acc(s0, w, fe_sub_cc(fe_mul_cc(a0, b0, F), c0, F));
    if (FB) {
      const Fe c1 = live ? fe_load(C, half + i) : fe_zero();
      const Fe am = fe_sub_cc(fe_add_cc(a0, a0, F), a1, F);
      const Fe bm = fe_sub_cc(fe_add_cc(b0, b0, F), b1, F);
      const Fe cm = fe_sub_cc(fe_add_cc(c0, c0, F), c1, F);
      fe_mul_acc(s2, w, fe_sub_cc(fe_mul_cc(am, bm, F), cm, F));
    }
  }
}

// Accumulator t of every thread, added over each segment of ``seg``
// threads (seg >= 32, a power of two) into sh[warp][t] by warps, then by
// the segment's thread t.
template <int S>
__device__ __forceinline__ void warp_tree(Acc a, Acc (*sh)[3]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc_add(a, acc_shfl_down(a, off));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5][S] = a;
}

// The segment's sums of this tile: every thread's accumulators added over
// its segment, then its thread t (t an active sum) reduces sum t once,
// multiplies it by el (two-level) and adds it to run.  sh is this tile's
// half of the double buffer, so a segment's leaders may still read the
// other half while the next tile writes this one.
template <bool ZC, bool FB>
__device__ __forceinline__ void segment_sums(const Acc& s0, const Acc& s1, const Acc& s2,
                                             Acc (*sh)[3], int seg, bool two, const Fe& el,
                                             Fe& run, const Field& F) {
  if (!ZC) warp_tree<0>(s0, sh);
  warp_tree<1>(s1, sh);
  if (FB) warp_tree<2>(s2, sh);
  __syncthreads();
  const int t = threadIdx.x & (seg - 1);
  if (t < 3 && (t != 0 || !ZC) && (t != 2 || FB)) {
    const int w0 = (threadIdx.x - t) >> 5;
    Acc tot = sh[w0][t];
    for (int w = 1; w < seg / 32; ++w) acc_add(tot, sh[w0 + w][t]);
    Fe v = acc_reduce(tot, F);
    if (two) v = fe_mul_cc(v, el, F);
    run = fe_add_cc(run, v, F);
  }
}

template <bool ZC, bool FB>
__global__ void __launch_bounds__(NT) cubiceq_evals_kernel(
    size_t half, size_t hi_len, int rlog, size_t shard, int lw, const uint32_t* EL,
    const uint32_t* ER, const uint32_t* A, const uint32_t* B, const uint32_t* C,
    uint32_t* partial, uint32_t* out, unsigned* ticket, Field F) {
  __shared__ Acc sh[2][NT / 32][3];
  const bool two = EL != nullptr;
  const GShape gs = g_shape(half, rlog, lw, two);
  const size_t mask = ((size_t)1 << rlog) - 1;
  Fe run = fe_zero();  // this thread's sum t, if it is a segment's thread t
  if (two) {
    const int seg = gs.seg, lane = threadIdx.x & (seg - 1);
    const size_t per_tile = NT / seg, lr = gs.lr;
    int buf = 0;
    for (size_t tile = blockIdx.x; tile < gs.ntiles; tile += gridDim.x, buf ^= 1) {
      const size_t q = tile * per_tile + threadIdx.x / seg;  // the sub-row
      Acc s0 = acc_zero(), s1 = acc_zero(), s2 = acc_zero();
      for (size_t k = lane; k < lr; k += seg) {
        const size_t i = q * lr + k;
        if (i >= half) break;
        add_pair<ZC, FB>(i, half, hi_len, fe_load(ER, (shard + (i << lw)) & mask), A, B, C,
                         s0, s1, s2, F);
      }
      const size_t i0 = q * lr;
      const Fe el = i0 < half ? fe_load(EL, (shard + (i0 << lw)) >> rlog) : fe_zero();
      segment_sums<ZC, FB>(s0, s1, s2, sh[buf], seg, true, el, run, F);
    }
  } else {
    Acc s0 = acc_zero(), s1 = acc_zero(), s2 = acc_zero();
    for (size_t i = blockIdx.x * (size_t)NT + threadIdx.x; i < half;
         i += (size_t)gridDim.x * NT)
      add_pair<ZC, FB>(i, half, hi_len, fe_load(ER, shard + (i << lw)), A, B, C, s0, s1, s2,
                       F);
    segment_sums<ZC, FB>(s0, s1, s2, sh[0], NT, false, fe_zero(), run, F);
  }
  const int t = threadIdx.x & (gs.seg - 1);
  Fe s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = t == k ? run : fe_zero();
  store_block_sums<3, NT>(0, s, partial, F);
  finish_sums<3, NT>(partial, out, ticket, F);
}

extern "C" int sp2_cubiceq_evals(size_t half, size_t hi_len, int rlog, int zero_check,
                                 int fallback, size_t shard, int lw, const void* EL,
                                 const void* ER, const void* A, const void* B, const void* C,
                                 void* partial, int nblocks, void* out, void* ticket,
                                 const uint32_t* field_words, void* stream) {
  // an Acc holds at most 2^32 products: half < 2^32
  if (hi_len > half || half >> 32 || rlog < 0 || rlog > 40 || lw < 0 || lw > 20 ||
      shard >= ((size_t)1 << lw) || nblocks != g_blocks(half, rlog, lw, EL != nullptr) ||
      out == nullptr || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  const Field F = field_from_words(field_words);
  const uint32_t *el = (const uint32_t*)EL, *er = (const uint32_t*)ER,
                 *a = (const uint32_t*)A, *b = (const uint32_t*)B, *c = (const uint32_t*)C;
  uint32_t *part = (uint32_t*)partial, *o = (uint32_t*)out;
  unsigned* t = (unsigned*)ticket;
  cudaStream_t s = (cudaStream_t)stream;
#define SP2_G(ZC, FB)                                                                 \
  cubiceq_evals_kernel<ZC, FB><<<nblocks, NT, 0, s>>>(half, hi_len, rlog, shard, lw, el, \
                                                      er, a, b, c, part, o, t, F)
  if (zero_check && fallback)
    SP2_G(true, true);
  else if (zero_check)
    SP2_G(true, false);
  else if (fallback)
    SP2_G(false, true);
  else
    SP2_G(false, false);
#undef SP2_G
  return (int)cudaGetLastError();
}
