// Kernels 5 and C: windowed MSMs over runtime points, sum_i s_i * Q_i,
// for R independent rows of I points in one entry call.
//
// Replaces the JAX package's DeviceCurve.msm (spartan2_tpu/ec/device.py:
// msm :398, fastkey "msm"; _msm_windowed :358, _table :328, _digits
// :317), which the Hyrax verifier reaches through _msm_auto
// (pcs/hyrax.py:663) to fold the proof's row commitments (kernel 5, one
// row), and DeviceCurve.msm_rows (:424, fastkey "msm_rows"), which
// HyraxPCS.fold_commitments (pcs/hyrax.py:581) uses to fold two
// commitments row by row in the NIFS verifier (kernel C, R rows).  The
// points come from a proof, so every addition is complete (curve.cuh).
//
// Entry sp2_msm_rows (sp2_msm is its one-row case), three launches on
// one stream:
//   msm_table_kernel   one thread per point i of the R * I: T[d][i] =
//                      d * Q_i for d in [0, 16), layout (16, R * I, 3, 8).
//   msm_window_kernel  one block per (4-bit window k, row r): thread t
//                      adds T[digit_k(s_ri)][r I + i] for i = t, t + 128,
//                      ... in order, then a halving tree -> S[r][k],
//                      (R, n_win, 3, 8).
//   msm_horner_kernel  one thread per row: acc = 16 * acc + S[r][k] from
//                      the top window down -> out[r], (R, 3, 8).
// Scalars are canonical (R * I, 8); points Jacobian Montgomery
// (R * I, 3, 8), row-major.
//
// Bound: point additions (about 16 Montgomery products each), not bytes;
// the Horner ladder (4 doublings and an add per window, one thread per
// row) is the serial tail.
//
// Entries sp2_msm_binary, sp2_msm_per_lane and sp2_scalar_mul_base: the
// JAX package's DeviceCurve.msm_binary (ec/device.py:445, _msm_binary_jit
// :436, fastkey "msm_binary"), msm_points_per_lane (:468, _per_lane_jit
// :451, fastkey "msm_lane") and scalar_mul_host_base (:474).  Points are
// affine Montgomery (qx, qy: (n, 8) each, never the identity); outputs
// Jacobian Montgomery.  Every addition is complete: JAX's per-lane ladder
// and binary tree use incomplete adds, sound only on honest inputs.
//   sp2_msm_binary       sum_i [bit_i == 1] Q_i.  msm_binary_kernel: block
//                        b sums lanes [256 b, 256 b + 256) by thread t
//                        adding lanes t and t + 128 if selected, then the
//                        block's halving tree -> partial[b]; pt_sum_kernel:
//                        one block sums the partials the same way.  Lanes
//                        past n are the identity: JAX's padding to a power
//                        of two.  Bound: the additions of the selected
//                        points, a tree of depth 9 + log2(blocks).
//   sp2_msm_per_lane     out_i = s_i Q_i (s_i canonical, below 2^nbits):
//                        one thread per lane, left-to-right double-and-add
//                        over nbits bits with a complete mixed add; no
//                        reduction across lanes.  Bound: nbits doublings
//                        and an addition per set bit in every lane.
//   sp2_scalar_mul_base  out_i = k Q_i for one host scalar k, passed by
//                        value: per_lane_kernel with k broadcast and
//                        nbits = bit length of k.

#include "curve.cuh"

using namespace sp2;

constexpr int MSM_WIN = 4;
constexpr int MSM_DIGITS = 1 << MSM_WIN;

__global__ void msm_table_kernel(int n, const uint32_t* pts, uint32_t* table,
                                 Curve C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt Q = pt_load(pts, i);
  pt_store(table, i, pt_inf(C.F));
  pt_store(table, (size_t)n + i, Q);
  Pt acc = Q;
  for (int d = 2; d < MSM_DIGITS; ++d) {
    acc = pt_add(acc, Q, C);
    pt_store(table, (size_t)d * n + i, acc);
  }
}

__global__ void msm_window_kernel(int npts, int n_win, const uint32_t* scalars,
                                  const uint32_t* table, uint32_t* sums, Curve C) {
  const int k = blockIdx.x, r = blockIdx.y;
  const int n = npts * gridDim.y;  // points of all rows
  const int bit = MSM_WIN * k;  // a window never straddles two limbs
  Pt acc = pt_inf(C.F);
  for (int i = r * npts + threadIdx.x; i < (r + 1) * npts; i += SUM_NT) {
    const uint32_t limb = scalars[8 * (size_t)i + (bit >> 5)];
    const int d = (int)((limb >> (bit & 31)) & (MSM_DIGITS - 1));
    if (d) acc = pt_add(acc, pt_load(table, (size_t)d * n + i), C);
  }
  acc = block_pt_sum(acc, C);
  if (threadIdx.x == 0) pt_store(sums, (size_t)r * n_win + k, acc);
}

__global__ void msm_horner_kernel(int rows, int n_win, const uint32_t* sums,
                                  uint32_t* out, Curve C) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  Pt acc = pt_inf(C.F);
  for (int k = n_win - 1; k >= 0; --k) {
    for (int j = 0; j < MSM_WIN; ++j) acc = pt_dbl(acc, C);
    acc = pt_add(acc, pt_load(sums, (size_t)r * n_win + k), C);
  }
  pt_store(out, r, acc);
}

constexpr int BIN_LANES = 2 * SUM_NT;  // lanes a block of msm_binary sums

__global__ void msm_binary_kernel(int n, const int* bits, const uint32_t* qx,
                                  const uint32_t* qy, uint32_t* partial, Curve C) {
  const int base = blockIdx.x * BIN_LANES;
  const int end = min(n, base + BIN_LANES);
  Pt acc = pt_inf(C.F);
  for (int i = base + threadIdx.x; i < end; i += SUM_NT) {
    if (bits[i] != 1) continue;
    Pt Q;
    Q.X = fe_load(qx, i);
    Q.Y = fe_load(qy, i);
    Q.Z = fe_one(C.F);
    acc = pt_add(acc, Q, C);
  }
  acc = block_pt_sum(acc, C);
  if (threadIdx.x == 0) pt_store(partial, blockIdx.x, acc);
}

// One block: the sum of n Jacobian points, thread t adding points t, t +
// 128, ... in order, then the halving tree -> out[0].
__global__ void pt_sum_kernel(int n, const uint32_t* pts, uint32_t* out, Curve C) {
  Pt acc = pt_inf(C.F);
  for (int i = threadIdx.x; i < n; i += SUM_NT) acc = pt_add(acc, pt_load(pts, i), C);
  acc = block_pt_sum(acc, C);
  if (threadIdx.x == 0) pt_store(out, 0, acc);
}

__global__ void per_lane_kernel(int n, int nbits, const uint32_t* scalars, Fe k,
                                const uint32_t* qx, const uint32_t* qy, uint32_t* out,
                                Curve C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe s = scalars != nullptr ? fe_load(scalars, i) : k;
  const Fe X = fe_load(qx, i);
  const Fe Y = fe_load(qy, i);
  Pt acc = pt_inf(C.F);
  for (int b = nbits - 1; b >= 0; --b) {
    acc = pt_dbl(acc, C);
    if ((s.v[b >> 5] >> (b & 31)) & 1) acc = pt_add_mixed(acc, X, Y, C);
  }
  pt_store(out, i, acc);
}

extern "C" int sp2_msm_binary(int n, const void* bits, const void* qx, const void* qy,
                              void* partial, void* out, const uint32_t* curve_words,
                              void* stream) {
  Curve C = curve_from_words(curve_words);
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + BIN_LANES - 1) / BIN_LANES;
  msm_binary_kernel<<<blocks, SUM_NT, 0, s>>>(n, (const int*)bits, (const uint32_t*)qx,
                                              (const uint32_t*)qy, (uint32_t*)partial, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  pt_sum_kernel<<<1, SUM_NT, 0, s>>>(blocks, (const uint32_t*)partial, (uint32_t*)out, C);
  return (int)cudaGetLastError();
}

static int launch_per_lane(int n, int nbits, const uint32_t* scalars, Fe k,
                           const void* qx, const void* qy, void* out,
                           const uint32_t* curve_words, void* stream) {
  Curve C = curve_from_words(curve_words);
  if (n < 1 || nbits < 0 || nbits > 256) return (int)cudaErrorInvalidValue;
  const int nt = 128;
  per_lane_kernel<<<(n + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      n, nbits, scalars, k, (const uint32_t*)qx, (const uint32_t*)qy, (uint32_t*)out, C);
  return (int)cudaGetLastError();
}

extern "C" int sp2_msm_per_lane(int n, int nbits, const void* scalars, const void* qx,
                                const void* qy, void* out, const uint32_t* curve_words,
                                void* stream) {
  return launch_per_lane(n, nbits, (const uint32_t*)scalars, fe_zero_host(), qx, qy, out,
                         curve_words, stream);
}

extern "C" int sp2_scalar_mul_base(int n, int nbits, const uint32_t* k_words,
                                   const void* qx, const void* qy, void* out,
                                   const uint32_t* curve_words, void* stream) {
  return launch_per_lane(n, nbits, nullptr, fe_from_words(k_words), qx, qy, out,
                         curve_words, stream);
}

extern "C" int sp2_msm_rows(int rows, int npts, int n_win, const void* scalars,
                            const void* points, void* table, void* sums, void* out,
                            const uint32_t* curve_words, void* stream) {
  Curve C = curve_from_words(curve_words);
  if (rows < 1 || rows > 65535 || npts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = rows * npts;
  const int nt = 128;
  msm_table_kernel<<<(n + nt - 1) / nt, nt, 0, s>>>(
      n, (const uint32_t*)points, (uint32_t*)table, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  msm_window_kernel<<<dim3(n_win, rows), SUM_NT, 0, s>>>(
      npts, n_win, (const uint32_t*)scalars, (const uint32_t*)table,
      (uint32_t*)sums, C);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int hn = 64;
  msm_horner_kernel<<<(rows + hn - 1) / hn, hn, 0, s>>>(
      rows, n_win, (const uint32_t*)sums, (uint32_t*)out, C);
  return (int)cudaGetLastError();
}

extern "C" int sp2_msm(int n, int n_win, const void* scalars, const void* points,
                       void* table, void* sums, void* out,
                       const uint32_t* curve_words, void* stream) {
  return sp2_msm_rows(1, n, n_win, scalars, points, table, sums, out, curve_words,
                      stream);
}
