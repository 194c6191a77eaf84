// Jacobian group law over a short Weierstrass curve y^2 = x^3 + a x + b
// (a is a kernel argument), shared by comb.cu and msm.cu.
//
// Replaces the JAX package's DeviceCurve group law (spartan2_tpu/ec/
// device.py: dbl/add/lane_sum :109-293).  Points are Jacobian (X, Y, Z)
// in Montgomery form, 24 words; Z == 0 is the identity.  Every addition
// is complete (identity, doubling and inverse cases are branches), so
// the kernels are sound on any input, proof-supplied points included.
// The plain PyTorch version is spartan2_tpu_torch/ec/comb.py.
#pragma once

#include "field.cuh"

namespace sp2 {

struct Curve {
  Field F;
  Fe a;  // curve coefficient a, Montgomery form
};

struct Pt {
  Fe X, Y, Z;
};

// Host: the field words followed by a (ec/comb.py curve_words).
static inline Curve curve_from_words(const uint32_t* w) {
  Curve c;
  c.F = field_from_words(w);
  c.a = fe_from_words(w + FIELD_WORDS);
  return c;
}

__device__ __forceinline__ Pt pt_inf(const Field& F) {
  Pt p;
  p.X = fe_one(F);
  p.Y = fe_one(F);
  p.Z = fe_zero();
  return p;
}

__device__ __forceinline__ Pt pt_load(const uint32_t* base, size_t i) {
  Pt p;
  p.X = fe_load(base, 3 * i);
  p.Y = fe_load(base, 3 * i + 1);
  p.Z = fe_load(base, 3 * i + 2);
  return p;
}

__device__ __forceinline__ void pt_store(uint32_t* base, size_t i, const Pt& p) {
  fe_store(base, 3 * i, p.X);
  fe_store(base, 3 * i + 1, p.Y);
  fe_store(base, 3 * i + 2, p.Z);
}

// 2P (dbl-1998-cmo-2 with general a); identity and 2-torsion give identity.
__device__ Pt pt_dbl(const Pt& P, const Curve& C) {
  const Field& F = C.F;
  if (fe_is_zero(P.Z) || fe_is_zero(P.Y)) return pt_inf(F);
  Fe XX = fe_mul(P.X, P.X, F);
  Fe YY = fe_mul(P.Y, P.Y, F);
  Fe ZZ = fe_mul(P.Z, P.Z, F);
  Fe S = fe_double(fe_double(fe_mul(P.X, YY, F), F), F);
  Fe M = fe_add(fe_add(fe_double(XX, F), XX, F), fe_mul(C.a, fe_mul(ZZ, ZZ, F), F), F);
  Pt R;
  R.X = fe_sub(fe_mul(M, M, F), fe_double(S, F), F);
  Fe YYYY8 = fe_double(fe_double(fe_double(fe_mul(YY, YY, F), F), F), F);
  R.Y = fe_sub(fe_mul(M, fe_sub(S, R.X, F), F), YYYY8, F);
  R.Z = fe_double(fe_mul(P.Y, P.Z, F), F);
  return R;
}

// P + Q, complete (add-1998-cmo-2 with the exceptional cases branched).
__device__ Pt pt_add(const Pt& P, const Pt& Q, const Curve& C) {
  const Field& F = C.F;
  if (fe_is_zero(P.Z)) return Q;
  if (fe_is_zero(Q.Z)) return P;
  Fe Z1Z1 = fe_mul(P.Z, P.Z, F);
  Fe Z2Z2 = fe_mul(Q.Z, Q.Z, F);
  Fe U1 = fe_mul(P.X, Z2Z2, F);
  Fe U2 = fe_mul(Q.X, Z1Z1, F);
  Fe S1 = fe_mul(P.Y, fe_mul(Q.Z, Z2Z2, F), F);
  Fe S2 = fe_mul(Q.Y, fe_mul(P.Z, Z1Z1, F), F);
  Fe H = fe_sub(U2, U1, F);
  Fe Rr = fe_sub(S2, S1, F);
  if (fe_is_zero(H)) {
    if (fe_is_zero(Rr)) return pt_dbl(P, C);
    return pt_inf(F);
  }
  Fe HH = fe_mul(H, H, F);
  Fe HHH = fe_mul(H, HH, F);
  Fe V = fe_mul(U1, HH, F);
  Pt R;
  R.X = fe_sub(fe_sub(fe_mul(Rr, Rr, F), HHH, F), fe_double(V, F), F);
  R.Y = fe_sub(fe_mul(Rr, fe_sub(V, R.X, F), F), fe_mul(S1, HHH, F), F);
  R.Z = fe_mul(fe_mul(P.Z, Q.Z, F), H, F);
  return R;
}

// P + (qx, qy) with the second point affine (Z = 1, never the identity),
// complete (madd with the exceptional cases branched): the per-lane
// double-and-add's step (msm.cu).
__device__ Pt pt_add_mixed(const Pt& P, const Fe& qx, const Fe& qy, const Curve& C) {
  const Field& F = C.F;
  if (fe_is_zero(P.Z)) {
    Pt R;
    R.X = qx;
    R.Y = qy;
    R.Z = fe_one(F);
    return R;
  }
  Fe Z1Z1 = fe_mul(P.Z, P.Z, F);
  Fe U2 = fe_mul(qx, Z1Z1, F);
  Fe S2 = fe_mul(qy, fe_mul(P.Z, Z1Z1, F), F);
  Fe H = fe_sub(U2, P.X, F);
  Fe Rr = fe_sub(S2, P.Y, F);
  if (fe_is_zero(H)) {
    if (fe_is_zero(Rr)) return pt_dbl(P, C);
    return pt_inf(F);
  }
  Fe HH = fe_mul(H, H, F);
  Fe HHH = fe_mul(H, HH, F);
  Fe V = fe_mul(P.X, HH, F);
  Pt R;
  R.X = fe_sub(fe_sub(fe_mul(Rr, Rr, F), HHH, F), fe_double(V, F), F);
  R.Y = fe_sub(fe_mul(Rr, fe_sub(V, R.X, F), F), fe_mul(P.Y, HHH, F), F);
  R.Z = fe_mul(P.Z, H, F);
  return R;
}

// Threads per block of a point sum (the plain versions repeat its order).
constexpr int SUM_NT = 128;

// Sum of one point per thread over a SUM_NT-thread block by a halving
// tree in shared memory; the result is valid in thread 0.
__device__ Pt block_pt_sum(Pt acc, const Curve& C) {
  __shared__ Pt part[SUM_NT];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = SUM_NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] = pt_add(part[threadIdx.x], part[threadIdx.x + s], C);
    __syncthreads();
  }
  return part[0];
}

}  // namespace sp2
