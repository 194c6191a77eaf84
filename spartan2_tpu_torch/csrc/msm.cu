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
// Entry sp2_msm_rows (sp2_msm is its one-row case): one launch,
// msm_rows_kernel, a block per (group of GP <= 8 consecutive points, row),
// the table, the window sums and the ladder in shared memory (the kernel's
// comment has the steps).  Scalars are canonical (R * I, 8), below
// 2^(4 n_win); points Jacobian Montgomery (R * I, 3, 8), row-major; out (R,
// 3, 8).  Scratch from the wrapper: part (R, ng, NW, 3, 8), the blocks'
// window sums, and counters (R, levels, ng) int32, zeroed.  The Jacobian
// output is a function of this order (ec/msm.py msm_rows_plain repeats it):
// the window sums are the adjacent-pair tree over the row's points padded
// with the identity to a power of two, whatever the blocks, and the ladder
// the adjacent-pair tree over the windows padded to NW = 2^lw.
//
// Bounds.  Throughput: about 16 Montgomery products per point addition, 8 a
// doubling at a = -3 and 7 at a = 0, microseconds of work at these
// shapes.  Latency: a 256-bit scalar of a point known only at run time needs
// 255 doublings in sequence (P-256 has no endomorphism), so 255 times one
// doubling's latency is the floor (chip_smoke.py times the ladder's
// doubling alone, tools/curve_latency.py DBL_CHAIN), and at R <= 43 rows
// the card is nearly idle.  The design keeps only the doublings serial: the
// table in four steps, the window sums log2 I levels deep over all the
// row's threads, the ladder a tree over the windows (252 doublings and 6
// additions, not 63 Horner additions); the longest chain is 255 doublings
// and 7 + log2 I additions, 15 at I = 256.  The group law is curve.cuh's
// pt_dbl_k / pt_add_k on the carry-chain field arithmetic (fe_mul_cc,
// fe_add_cc, fe_sub_cc), the doubling specialised to a = -3 (8 products)
// and a = 0 (7), the ladder's doublings by quads of lanes, 3 products deep
// (pt_dbl_quad_n).
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
constexpr int MSM_NT = 256;       // threads a block at most: NW * GP
constexpr int MSM_GROUP_MAX = 8;  // points of a row a block takes at most
using MsmOps = OpsCC;             // the field arithmetic of the MSM's group law

// A point another block wrote: loads that skip this SM's L1.
__device__ __forceinline__ Pt pt_load_cg(const uint32_t* base, size_t i) {
  Pt p;
  p.X = fe_load_cg(base, 3 * i);
  p.Y = fe_load_cg(base, 3 * i + 1);
  p.Z = fe_load_cg(base, 3 * i + 2);
  return p;
}

// One launch: block (g, r) takes points [g GP, g GP + GP) of row r (GP =
// 2^lg), NW = 2^lw >= n_win windows, NW * GP threads rounded up to whole
// warps.
//   table   T[d][j] = d Q_j for d in 1..15, in four dependent steps over
//           the block's threads: 2Q = dbl Q; 3Q = 2Q + Q, 4Q = dbl 2Q; 5Q..7Q
//           = 4Q + (Q..3Q), 8Q = dbl 4Q; 9Q..15Q = 8Q + (Q..7Q).
//   leaves  thread (k, j) holds T[digit_k(s_j)][j], the identity for a zero
//           digit, a window k >= n_win or a point past the row's end.
//   tree    adjacent pairs over the block's GP points (lg levels), then over
//           the row's ng blocks (levels): at each level the block that
//           arrives second (an atomic counter a node) adds its sibling's
//           sums (left + right), the other exits; a node without a sibling
//           passes up.  The row's window sums S_k end in one block.
//   ladder  adjacent pairs over the windows, P_j = P_2j + 2^(4 2^l) P_2j+1
//           at level l (lw levels), the doublings by a quad of lanes
//           (curve.cuh pt_dbl_quad_n: 3 products deep).
// Longest chain at n_win = 64: 3 doublings and an addition (table), log2
// I additions (tree), 252 doublings and 6 additions (ladder).
__global__ void __launch_bounds__(MSM_NT)
msm_rows_kernel(int npts, int n_win, int lw, int lg, int ng, int levels,
                const uint32_t* scalars, const uint32_t* points, uint32_t* part,
                int* counters, uint32_t* out, Curve C) {
  extern __shared__ Pt sm[];
  const int GP = 1 << lg, NW = 1 << lw, nt = blockDim.x;
  Pt* T = sm;             // T[d GP + j], d in 1..15
  Pt* L = sm + 16 * GP;   // L[k GP + j]
  const int g = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const int ak = curve_a_kind(C);
  const size_t row0 = (size_t)r * npts;
  const int i0 = g * GP;
  __shared__ int arrived;

  for (int j = tid; j < GP; j += nt)
    T[GP + j] = i0 + j < npts ? pt_load(points, row0 + i0 + j) : pt_inf(C.F);
  __syncthreads();
  for (int j = tid; j < GP; j += nt) T[2 * GP + j] = pt_dbl_k<MsmOps>(T[GP + j], C, ak);
  __syncthreads();
  // steps 2 and 3: the additions on the first warp, the doubling on the
  // second (where the block has one), so they do not serialise in a warp
  const int dbl0 = nt >= 32 + MSM_GROUP_MAX ? 32 : 3 * GP;
  for (int t = tid; t < GP; t += nt)
    T[3 * GP + t] = pt_add_k<MsmOps>(T[2 * GP + t], T[GP + t], C, ak);
  for (int t = tid - dbl0; t >= 0 && t < GP; t += nt)
    T[4 * GP + t] = pt_dbl_k<MsmOps>(T[2 * GP + t], C, ak);
  __syncthreads();
  for (int t = tid; t < 3 * GP; t += nt) {
    const int j = t & (GP - 1), c = t >> lg;
    T[(5 + c) * GP + j] = pt_add_k<MsmOps>(T[4 * GP + j], T[(1 + c) * GP + j], C, ak);
  }
  for (int t = tid - dbl0; t >= 0 && t < GP; t += nt)
    T[8 * GP + t] = pt_dbl_k<MsmOps>(T[4 * GP + t], C, ak);
  __syncthreads();
  for (int t = tid; t < 7 * GP; t += nt) {
    const int j = t & (GP - 1), c = t >> lg;
    T[(9 + c) * GP + j] = pt_add_k<MsmOps>(T[8 * GP + j], T[(1 + c) * GP + j], C, ak);
  }
  __syncthreads();

  for (int t = tid; t < NW * GP; t += nt) {
    const int k = t >> lg, j = t & (GP - 1), i = i0 + j;
    int d = 0;
    if (k < n_win && i < npts) {
      const int bit = MSM_WIN * k;  // a window never straddles two limbs
      d = (int)((scalars[8 * (row0 + i) + (bit >> 5)] >> (bit & 31)) & (MSM_DIGITS - 1));
    }
    L[t] = d ? T[d * GP + j] : pt_inf(C.F);
  }
  __syncthreads();
  for (int s = 1; s < GP; s <<= 1) {
    for (int t = tid; t < NW * GP; t += nt)
      if ((t & (2 * s - 1)) == 0) L[t] = pt_add_k<MsmOps>(L[t], L[t + s], C, ak);
    __syncthreads();
  }

  int node = g;
  for (int l = 0; l < levels; ++l) {
    const int sib = node ^ 1;
    if (sib >= ((ng - 1) >> l) + 1) {  // no sibling at this level: pass up
      node >>= 1;
      continue;
    }
    uint32_t* mine = part + ((size_t)r * ng + ((size_t)node << l)) * NW * 24;
    for (int k = tid; k < NW; k += nt) pt_store(mine, k, L[k * GP]);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      arrived = atomicAdd(&counters[((size_t)r * levels + l) * ng + (node >> 1)], 1);
    __syncthreads();
    if (arrived == 0) return;  // the sibling's block carries the node on
    __threadfence();
    const uint32_t* other = part + ((size_t)r * ng + ((size_t)sib << l)) * NW * 24;
    for (int k = tid; k < NW; k += nt) {
      const Pt o = pt_load_cg(other, k);
      const bool right = node & 1;  // left + right, whichever block arrived last
      L[k * GP] = pt_add_k<MsmOps>(right ? o : L[k * GP], right ? L[k * GP] : o, C, ak);
    }
    __syncthreads();
    node >>= 1;
  }

  for (int l = 0; l < lw; ++l) {
    const int half = NW >> (l + 1);
    for (int q0 = 0; q0 < half; q0 += nt >> 2) {  // a quad of lanes a pair
      const int q = q0 + (tid >> 2);
      Pt acc;
      if (q < half) {
        const Pt hi = pt_dbl_quad_n<MsmOps>(L[(2 * q + 1) * GP], MSM_WIN << l, C, ak);
        acc = pt_add_k<MsmOps>(L[2 * q * GP], hi, C, ak);
      }
      __syncthreads();
      if (q < half && (tid & 3) == 0) L[q * GP] = acc;
      __syncthreads();
    }
  }
  if (tid == 0) pt_store(out, r, L[0]);
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

extern "C" int sp2_msm_rows(int rows, int npts, int n_win, int lg, const void* scalars,
                            const void* points, void* part, void* counters, void* out,
                            const uint32_t* curve_words, void* stream) {
  Curve C = curve_from_words(curve_words);
  if (rows < 1 || rows > 65535 || npts < 1 || n_win < 1 || n_win > 64 || lg < 0 ||
      (1 << lg) > MSM_GROUP_MAX)
    return (int)cudaErrorInvalidValue;
  int lw = 0;
  while ((1 << lw) < n_win) ++lw;
  const int gp = 1 << lg, nt = ((1 << lw) * gp + 31) / 32 * 32;
  if (nt > MSM_NT) return (int)cudaErrorInvalidValue;
  const int ng = (npts + gp - 1) / gp;
  int levels = 0;
  while ((1 << levels) < ng) ++levels;
  const size_t smem = (size_t)(MSM_DIGITS + (1 << lw)) * gp * sizeof(Pt);
  msm_rows_kernel<<<dim3(ng, rows), nt, smem, (cudaStream_t)stream>>>(
      npts, n_win, lw, lg, ng, levels, (const uint32_t*)scalars, (const uint32_t*)points,
      (uint32_t*)part, (int*)counters, (uint32_t*)out, C);
  return (int)cudaGetLastError();
}

extern "C" int sp2_msm(int n, int n_win, int lg, const void* scalars, const void* points,
                       void* part, void* counters, void* out,
                       const uint32_t* curve_words, void* stream) {
  return sp2_msm_rows(1, n, n_win, lg, scalars, points, part, counters, out, curve_words,
                      stream);
}
