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
// vectors, with weight w_i the eq table of the remaining variables:
//   two-level (EL given):  w_i = EL[i >> rlog] ER[i & (2^rlog - 1)]
//                          (Gruen's left/right split, fused.py:152-201);
//   one-level (EL null):   w_i = ER[i] (the table T_j, or ER's prefix).
// Per block it writes three partial sums (the round finish adds them):
//   t0   = sum_i w_i (A_lo B_lo - C_lo)_i             (skipped: zero_check)
//   tinf = sum_i w_i ((A_hi - A_lo)(B_hi - B_lo))_i
//   tm1  = sum_i w_i ((2A_lo - A_hi)(2B_lo - B_hi) - (2C_lo - C_hi))_i
//                                                       (only if fallback)
// The high half is read only below hi_len and taken as zero past it: the
// peeled round 0 of a padded R1CS passes hi_len = live rows x R, so a dead
// row adds A_lo B_lo to tinf (fused.py:340-356).
//
// Shard stride (the port's sharded outer sum-check, parallel/sumcheck_shard.py):
// rank s of W = 2^lw holds the global rows s + W i in local order, so its
// local pair i is global pair g = s + (i << lw) and takes the weight of g;
// half and hi_len stay local.  s = 0, lw = 0 is the unsharded round.  This
// replaces the sums of the JAX package's shard_cubiceq_step
// (spartan2_tpu/parallel/sumcheck_shard.py:199) and fused_sharded_cubiceq
// (spartan2_tpu/parallel/fused_shard.py:209).
//
// Bound: per pair 5 Montgomery products (2 more with the fallback, 1 less
// one-level, 2 less with zero_check) over 128-192 bytes read: the products bound
// it, as in kernel A.

#include "field.cuh"

using namespace sp2;

constexpr int NT = 256;

__global__ void cubiceq_evals_kernel(size_t half, size_t hi_len, int rlog, int zero_check,
                                     int fallback, size_t shard, int lw,
                                     const uint32_t* EL, const uint32_t* ER,
                                     const uint32_t* A, const uint32_t* B,
                                     const uint32_t* C, uint32_t* partial, Field F) {
  const size_t mask = ((size_t)1 << rlog) - 1;
  Fe s0 = fe_zero(), s1 = fe_zero(), s2 = fe_zero();
  for (size_t i = blockIdx.x * (size_t)NT + threadIdx.x; i < half;
       i += (size_t)gridDim.x * NT) {
    const size_t g = shard + (i << lw);
    const Fe w = EL != nullptr ? fe_mul(fe_load(EL, g >> rlog), fe_load(ER, g & mask), F)
                               : fe_load(ER, g);
    const bool live = i < hi_len;
    const Fe a0 = fe_load(A, i), b0 = fe_load(B, i);
    const Fe a1 = live ? fe_load(A, half + i) : fe_zero();
    const Fe b1 = live ? fe_load(B, half + i) : fe_zero();
    s1 = fe_add(s1, fe_mul(w, fe_mul(fe_sub(a1, a0, F), fe_sub(b1, b0, F), F), F), F);
    if (!zero_check || fallback) {
      const Fe c0 = fe_load(C, i);
      if (!zero_check)
        s0 = fe_add(s0, fe_mul(w, fe_sub(fe_mul(a0, b0, F), c0, F), F), F);
      if (fallback) {
        const Fe c1 = live ? fe_load(C, half + i) : fe_zero();
        const Fe am = fe_sub(fe_double(a0, F), a1, F);
        const Fe bm = fe_sub(fe_double(b0, F), b1, F);
        const Fe cm = fe_sub(fe_double(c0, F), c1, F);
        s2 = fe_add(s2, fe_mul(w, fe_sub(fe_mul(am, bm, F), cm, F), F), F);
      }
    }
  }
  store_partials<3, NT>(s0, s1, s2, partial, F);
}

extern "C" int sp2_cubiceq_evals(size_t half, size_t hi_len, int rlog, int zero_check,
                                 int fallback, size_t shard, int lw, const void* EL,
                                 const void* ER,
                                 const void* A, const void* B, const void* C,
                                 void* partial, int nblocks, const uint32_t* field_words,
                                 void* stream) {
  if (nblocks < 1 || hi_len > half || rlog < 0 || rlog > 40 || lw < 0 || lw > 20 ||
      shard >= ((size_t)1 << lw))
    return (int)cudaErrorInvalidValue;
  cubiceq_evals_kernel<<<nblocks, NT, 0, (cudaStream_t)stream>>>(
      half, hi_len, rlog, zero_check, fallback, shard, lw, (const uint32_t*)EL,
      (const uint32_t*)ER, (const uint32_t*)A, (const uint32_t*)B, (const uint32_t*)C,
      (uint32_t*)partial, field_from_words(field_words));
  return (int)cudaGetLastError();
}
