// Kernel 5: windowed MSM over runtime points, sum_i s_i * Q_i.
//
// Replaces the JAX package's DeviceCurve.msm (spartan2_tpu/ec/device.py:
// msm :398, fastkey "msm"; _msm_windowed :358, _table :328, _digits
// :317), which the Hyrax verifier reaches through _msm_auto
// (pcs/hyrax.py:663) to fold the proof's row commitments.  The points
// come from a proof, so every addition is complete (curve.cuh).
//
// Entry sp2_msm, three launches on one stream:
//   msm_table_kernel   one thread per point i: T[d][i] = d * Q_i for
//                      d in [0, 16), layout (16, n, 3, 8).
//   msm_window_kernel  one block per 4-bit window k: thread t adds
//                      T[digit_k(s_i)][i] for i = t, t + 128, ... in
//                      order, then a halving tree -> S[k], (n_win, 3, 8).
//   msm_horner_kernel  one thread: acc = 16 * acc + S[k] from the top
//                      window down -> out, (3, 8).
// Scalars are canonical (n, 8); points Jacobian Montgomery (n, 3, 8).
//
// Bound: point additions (about 16 Montgomery products each), not bytes;
// the single-thread Horner ladder (4 doublings and an add per window)
// is the serial tail.

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

__global__ void msm_window_kernel(int n, const uint32_t* scalars,
                                  const uint32_t* table, uint32_t* sums, Curve C) {
  const int k = blockIdx.x;
  const int bit = MSM_WIN * k;  // a window never straddles two limbs
  Pt acc = pt_inf(C.F);
  for (int i = threadIdx.x; i < n; i += SUM_NT) {
    const uint32_t limb = scalars[8 * (size_t)i + (bit >> 5)];
    const int d = (int)((limb >> (bit & 31)) & (MSM_DIGITS - 1));
    if (d) acc = pt_add(acc, pt_load(table, (size_t)d * n + i), C);
  }
  acc = block_pt_sum(acc, C);
  if (threadIdx.x == 0) pt_store(sums, k, acc);
}

__global__ void msm_horner_kernel(int n_win, const uint32_t* sums, uint32_t* out,
                                  Curve C) {
  Pt acc = pt_inf(C.F);
  for (int k = n_win - 1; k >= 0; --k) {
    for (int j = 0; j < MSM_WIN; ++j) acc = pt_dbl(acc, C);
    acc = pt_add(acc, pt_load(sums, k), C);
  }
  pt_store(out, 0, acc);
}

extern "C" int sp2_msm(int n, int n_win, const void* scalars, const void* points,
                       void* table, void* sums, void* out,
                       const uint32_t* curve_words, void* stream) {
  Curve C = curve_from_words(curve_words);
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = 128;
  msm_table_kernel<<<(n + nt - 1) / nt, nt, 0, s>>>(
      n, (const uint32_t*)points, (uint32_t*)table, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  msm_window_kernel<<<n_win, SUM_NT, 0, s>>>(n, (const uint32_t*)scalars,
                                             (const uint32_t*)table,
                                             (uint32_t*)sums, C);
  err = (int)cudaGetLastError();
  if (err) return err;
  msm_horner_kernel<<<1, 1, 0, s>>>(n_win, (const uint32_t*)sums, (uint32_t*)out, C);
  return (int)cudaGetLastError();
}
