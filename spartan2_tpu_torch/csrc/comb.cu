// Kernel 3: fixed-base comb MSM over the P-256 base field (any short
// Weierstrass curve y^2 = x^3 + a x + b; a is a kernel argument).
//
// Replaces the JAX package's comb programs (spartan2_tpu/ec/comb.py:
// FixedBaseComb._build :71 "comb_build", _rows_kernel :123 "comb_rows").
// The group law (complete Jacobian additions) is curve.cuh; the faster
// incomplete adds are a later optimisation.
//
// Entries:
//   sp2_comb_build  one thread per (window w, generator j):
//                   T[w][d][j] = (d * 2^(6w)) * G_j for d in [0, 64).
//                   Table layout (n_win, 64, C, 3, 8) int32.
//   sp2_comb_rows   sum_j s[r, j] G_j = sum over the row's N = n_win * C
//                   points T[w][d_{r,j,w}][j] (the identity where the digit
//                   is 0), point p = w * C + j.  Pass 1: block b of a row
//                   takes points [128 k b, 128 k (b + 1)); its thread t adds
//                   points 128 k b + 128 i + t for i < k in order (the
//                   identity past the row's end) and block_pt_sum's halving
//                   tree sums the threads into partial (r, b).  The chain k
//                   is the wrapper's (ec/comb.py comb_chain, a function of
//                   (C, n_win)): ceil(N / 128^2), so that a full-width row
//                   makes at most 128 partials (6 at [LZ, d_vec], N = 43 *
//                   2048; 1, a point a thread, up to N = 16384), and at
//                   least 32 on tables of at most 11 windows (scalars below
//                   2^66, the witness commits), whose digits are mostly 0:
//                   a zero digit costs a branch, a tree level a complete
//                   addition, so those rows make 6 partials at C = 2048,
//                   not 88 (tools/comb_chain_sweep.py times k = 2-32).
//                   Pass 2: one block per row sums its partials, a thread
//                   adding partials t, t + 128, ... before the same tree.
//                   With one partial (the blinds' table: C = 1) pass 1
//                   writes the row's sum and pass 2 is not launched.  The
//                   order never depends on the row count, so a row gives
//                   the same limbs alone, in a batch or in a mesh rank's
//                   shard.  Scalars are canonical
//                   (R, C, 8); partials (R, P, 3, 8) scratch from the
//                   wrapper; output (R, 3, 8).
//
// Bound: point additions (about 16 Montgomery products each), not bytes.
// The sum's additions are as many as a walk over the windows made; their
// dependency depth falls from n_win + C / 128 + 7 to about k + 7 + 7 (6 at
// C = 1).  Each addition is a long chain of dependent products (an
// estimate from event times, not an instruction count: some 30 us on the
// H100), so depth is what the time is.  k keeps the lanes busy at full
// width: with a point per thread most warps wait in the tree.  A tree over
// windows and columns breaks the argument that lets a lane's chain of
// windows add incompletely (spartan2_tpu/ec/comb.py:135-140), so every
// addition is complete.

#include "curve.cuh"

using namespace sp2;

constexpr int WIN = 6;
constexpr int DIGITS = 1 << WIN;

__global__ void comb_build_kernel(int n_win, int ncols, const uint32_t* gx,
                                  const uint32_t* gy, uint32_t* table, Curve C) {
  const size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (t >= (size_t)n_win * ncols) return;
  const int w = (int)(t / ncols);
  const int j = (int)(t % ncols);
  Pt B;
  B.X = fe_load(gx, j);
  B.Y = fe_load(gy, j);
  B.Z = fe_one(C.F);
  for (int k = 0; k < WIN * w; ++k) B = pt_dbl(B, C);
  const size_t base = (size_t)w * DIGITS * ncols + j;  // entry (w, d=0, j)
  pt_store(table, base, pt_inf(C.F));
  Pt acc = B;
  pt_store(table, base + ncols, acc);
  for (int d = 2; d < DIGITS; ++d) {
    acc = pt_add(acc, B, C);
    pt_store(table, base + (size_t)d * ncols, acc);
  }
}

// Digit w of the canonical scalar at s (8 words).
__device__ __forceinline__ int scalar_digit(const uint32_t* s, int w) {
  const int bit = WIN * w;
  const int limb = bit >> 5;
  uint64_t v = s[limb];
  if (limb + 1 < 8) v |= (uint64_t)s[limb + 1] << 32;
  return (int)((v >> (bit & 31)) & (DIGITS - 1));
}

__global__ void comb_points_kernel(int ncols, int n_win, int chain, int parts,
                                   const uint32_t* scalars, const uint32_t* table,
                                   uint32_t* partial, Curve C) {
  const int n = n_win * ncols;
  const int row = blockIdx.x / parts;
  const int base = (blockIdx.x % parts) * SUM_NT * chain + threadIdx.x;
  const uint32_t* s = scalars + (size_t)row * ncols * 8;
  Pt acc = pt_inf(C.F);
  for (int i = 0; i < chain; ++i) {
    const int p = base + i * SUM_NT;
    if (p >= n) break;
    const int w = p / ncols;
    const int j = p % ncols;
    const int d = scalar_digit(s + (size_t)j * 8, w);
    if (d) acc = pt_add(acc, pt_load(table, ((size_t)w * DIGITS + d) * ncols + j), C);
  }
  acc = block_pt_sum(acc, C);
  if (threadIdx.x == 0) pt_store(partial, blockIdx.x, acc);
}

__global__ void comb_rowsum_kernel(int ncols, const uint32_t* scratch,
                                   uint32_t* out, Curve C) {
  const int row = blockIdx.x;
  Pt acc = pt_inf(C.F);
  for (int j = threadIdx.x; j < ncols; j += SUM_NT)
    acc = pt_add(acc, pt_load(scratch, (size_t)row * ncols + j), C);
  acc = block_pt_sum(acc, C);
  if (threadIdx.x == 0) pt_store(out, row, acc);
}

extern "C" int sp2_comb_build(int n_win, int ncols, const void* gx, const void* gy,
                              void* table, const uint32_t* curve_words,
                              void* stream) {
  Curve C = curve_from_words(curve_words);
  const size_t n = (size_t)n_win * ncols;
  const int nt = 128;
  comb_build_kernel<<<(unsigned)((n + nt - 1) / nt), nt, 0, (cudaStream_t)stream>>>(
      n_win, ncols, (const uint32_t*)gx, (const uint32_t*)gy, (uint32_t*)table, C);
  return (int)cudaGetLastError();
}

extern "C" int sp2_comb_rows(int rows, int ncols, int n_win, int chain,
                             const void* scalars, const void* table, void* scratch,
                             void* out, const uint32_t* curve_words, void* stream) {
  Curve C = curve_from_words(curve_words);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || chain <= 0 || ncols <= 0 || n_win <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t span = (size_t)SUM_NT * chain;
  const size_t parts = ((size_t)n_win * ncols + span - 1) / span;
  if ((size_t)rows * parts > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  comb_points_kernel<<<(unsigned)(rows * parts), SUM_NT, 0, s>>>(
      ncols, n_win, chain, (int)parts, (const uint32_t*)scalars,
      (const uint32_t*)table, (uint32_t*)(parts == 1 ? out : scratch), C);
  int err = (int)cudaGetLastError();
  if (err || parts == 1) return err;
  comb_rowsum_kernel<<<rows, SUM_NT, 0, s>>>((int)parts, (const uint32_t*)scratch,
                                             (uint32_t*)out, C);
  return (int)cudaGetLastError();
}
