// Kernel 3: fixed-base comb MSM over the P-256 base field (any short
// Weierstrass curve y^2 = x^3 + a x + b; a is a kernel argument).
//
// Replaces the JAX package's comb programs (spartan2_tpu/ec/comb.py:
// FixedBaseComb._build :71 "comb_build", _rows_kernel :123 "comb_rows").
// The group law (complete Jacobian additions) is curve.cuh; the build runs
// it on the carry-chain field ops, the rows on fe_mul.
//
// Entries:
//   sp2_comb_build  T[w][d][j] = (d * 2^(6w)) * G_j for d in [0, 64), in
//                   two launches.  Bases: a quad of lanes a generator j
//                   chains the window bases B_w = 2^(6w) G_j, six doublings
//                   a window (curve.cuh pt_dbl_quad_n: a doubling's
//                   independent products one a lane), and writes each at
//                   T[w][1][j].  Digits: a thread a (w, j), window-major,
//                   reads B_w there and writes T[w][d][j] = T[w][d-1][j] +
//                   B_w for d = 2 .. 63 (62 complete additions, every
//                   thread the same work) and the identity at d = 0.  Both
//                   on the carry-chain field ops, the doubling specialised
//                   on a.  The chain is the plain version's (ec/comb.py
//                   comb_build_plain: six successive doublings a window,
//                   then T[d-1] + B_w), every value canonical, so the
//                   limbs are its limbs.  Table layout (n_win, 64, C, 3, 8)
//                   int32.
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
// The build needs 6 (n_win - 1) doublings a generator, chained, and 62
// additions a (w, j): at 43 x 2048, 4.1 M products of doublings and 87 M
// of additions, 1.40 ms at the card's multiply rate; the table's 541 MB
// take 0.16 ms to write.  The bases' launch is latency: 252 quad doublings
// in sequence (about 2 us each).  The digits' launch is throughput: 88064
// equal chains of 62 dependent additions, enough threads to keep the
// multipliers busy.  A thread's B_w from G_j by 6 w doublings of its own
// would cost 111 M products more, most of them in the last windows.
// The rows' sum: its additions are as many as a walk over the windows
// made; their dependency depth falls from n_win + C / 128 + 7 to about k +
// 7 + 7 (6 at C = 1).  Each addition is a long chain of dependent products
// (an estimate from event times, not an instruction count: some 30 us on
// the H100), so depth is what the time is.  k keeps the lanes busy at full
// width: with a point per thread most warps wait in the tree.  A tree over
// windows and columns breaks the argument that lets a lane's chain of
// windows add incompletely (spartan2_tpu/ec/comb.py:135-140), so every
// addition is complete.

#include "curve.cuh"

using namespace sp2;

constexpr int WIN = 6;
constexpr int DIGITS = 1 << WIN;

// The operations of the build: the carry-chain field ops (curve.cuh).
using BuildOps = OpsCC;
constexpr int BUILD_NT = 128;

// Point (w, d, j) of the table.
__device__ __forceinline__ size_t table_index(int w, int d, int j, int ncols) {
  return ((size_t)w * DIGITS + d) * ncols + j;
}

// The window bases: quad q = generator j; each lane of the quad holds the
// same point, and lane c < 3 writes its coordinate c of B_w at T[w][1][j].
__global__ void __launch_bounds__(BUILD_NT) comb_bases_kernel(int n_win, int ncols,
                                                              const uint32_t* gx,
                                                              const uint32_t* gy,
                                                              uint32_t* table, Curve C) {
  const size_t q = (blockIdx.x * (size_t)BUILD_NT + threadIdx.x) >> 2;
  if (q >= (size_t)ncols) return;  // whole quads: ncols quads exactly
  const int j = (int)q, c = threadIdx.x & 3;
  const int ak = curve_a_kind(C);
  Pt B;
  B.X = fe_load(gx, j);
  B.Y = fe_load(gy, j);
  B.Z = fe_one(C.F);
  for (int w = 0; w < n_win; ++w) {
    if (w) B = pt_dbl_quad_n<BuildOps>(B, WIN, C, ak);
    if (c < 3)
      fe_store(table, 3 * table_index(w, 1, j, ncols) + c,
               fe_sel(c == 0, B.X, fe_sel(c == 1, B.Y, B.Z)));
  }
}

// The digits: thread t = w ncols + j adds B_w 62 times in a chain.
__global__ void __launch_bounds__(BUILD_NT) comb_digits_kernel(int n_win, int ncols,
                                                               uint32_t* table, Curve C) {
  const size_t t = blockIdx.x * (size_t)BUILD_NT + threadIdx.x;
  if (t >= (size_t)n_win * ncols) return;
  const int w = (int)(t / ncols), j = (int)(t % ncols);
  const int ak = curve_a_kind(C);
  const Pt B = pt_load(table, table_index(w, 1, j, ncols));
  pt_store(table, table_index(w, 0, j, ncols), pt_inf(C.F));
  Pt acc = B;
  for (int d = 2; d < DIGITS; ++d) {
    acc = pt_add_k<BuildOps>(acc, B, C, ak);
    pt_store(table, table_index(w, d, j, ncols), acc);
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
  cudaStream_t s = (cudaStream_t)stream;
  if (n_win <= 0 || ncols <= 0 || (size_t)n_win * ncols > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const size_t lanes = 4 * (size_t)ncols, n = (size_t)n_win * ncols;
  comb_bases_kernel<<<(unsigned)((lanes + BUILD_NT - 1) / BUILD_NT), BUILD_NT, 0, s>>>(
      n_win, ncols, (const uint32_t*)gx, (const uint32_t*)gy, (uint32_t*)table, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  comb_digits_kernel<<<(unsigned)((n + BUILD_NT - 1) / BUILD_NT), BUILD_NT, 0, s>>>(
      n_win, ncols, (uint32_t*)table, C);
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
