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
//   sp2_comb_rows   one thread per (row, column) walks the windows and
//                   adds T[w][digit_w][col]; then one block per row sums
//                   its C column points (shared-memory tree).
//                   Scalars are canonical (R, C, 8); output (R, 3, 8).
//
// Bound: point additions (about 16 Montgomery products each), not bytes.

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

__device__ __forceinline__ int scalar_digit(const Fe& s, int w) {
  const int bit = WIN * w;
  const int limb = bit >> 5;
  const int sh = bit & 31;
  uint64_t v = s.v[limb];
  if (limb + 1 < 8) v |= (uint64_t)s.v[limb + 1] << 32;
  return (int)((v >> sh) & (DIGITS - 1));
}

__global__ void comb_cols_kernel(int rows, int ncols, int n_win,
                                 const uint32_t* scalars, const uint32_t* table,
                                 uint32_t* scratch, Curve C) {
  const size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (t >= (size_t)rows * ncols) return;
  const int j = (int)(t % ncols);
  const Fe s = fe_load(scalars, t);
  Pt acc = pt_inf(C.F);
  for (int w = 0; w < n_win; ++w) {
    const int d = scalar_digit(s, w);
    if (d) acc = pt_add(acc, pt_load(table, ((size_t)w * DIGITS + d) * ncols + j), C);
  }
  pt_store(scratch, t, acc);
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

extern "C" int sp2_comb_rows(int rows, int ncols, int n_win, const void* scalars,
                             const void* table, void* scratch, void* out,
                             const uint32_t* curve_words, void* stream) {
  Curve C = curve_from_words(curve_words);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)rows * ncols;
  const int nt = 128;
  comb_cols_kernel<<<(unsigned)((n + nt - 1) / nt), nt, 0, s>>>(
      rows, ncols, n_win, (const uint32_t*)scalars, (const uint32_t*)table,
      (uint32_t*)scratch, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  comb_rowsum_kernel<<<rows, SUM_NT, 0, s>>>(ncols, (const uint32_t*)scratch,
                                             (uint32_t*)out, C);
  return (int)cudaGetLastError();
}
