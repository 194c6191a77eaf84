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

// The group law, generic in its field arithmetic (OpsC: fe_mul, fe_add,
// fe_sub, the other kernels' pt_dbl and pt_add below; OpsCC: field.cuh's
// carry-chain fe_mul_cc, fe_add_cc, fe_sub_cc, which the windowed MSM of
// msm.cu takes) and specialised on the curve's a.  Every specialisation
// gives the same coordinates, limb for limb: with a = -3, M = 3 (X -
// Z^2)(X + Z^2) = 3 X^2 + a Z^4 (dbl-2001-b's alpha, 8 products); with
// a = 0, M = 3 X^2 (7 products); any other a, dbl-1998-cmo-2 (10).
// Identity and 2-torsion double to the identity.  The doubling takes Y Z
// last, as the hand-written one before it did: taken first, it made
// comb_build (pt_dbl and pt_add at general a) a fifth slower on the H100
// (chip_smoke.py, 13.4 against 11.2 ms).
struct OpsC {
  static __device__ __forceinline__ Fe dbl(const Fe& a, const Field& F) {
    return fe_double(a, F);
  }
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b, const Field& F) {
    return fe_mul(a, b, F);
  }
  static __device__ __forceinline__ Fe add(const Fe& a, const Fe& b, const Field& F) {
    return fe_add(a, b, F);
  }
  static __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b, const Field& F) {
    return fe_sub(a, b, F);
  }
};
struct OpsCC {
  static __device__ __forceinline__ Fe dbl(const Fe& a, const Field& F) {
    return fe_add_cc(a, a, F);
  }
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b, const Field& F) {
    return fe_mul_cc(a, b, F);
  }
  static __device__ __forceinline__ Fe add(const Fe& a, const Fe& b, const Field& F) {
    return fe_add_cc(a, b, F);
  }
  static __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b, const Field& F) {
    return fe_sub_cc(a, b, F);
  }
};

constexpr int A_ZERO = 0, A_MINUS3 = 1, A_GENERAL = 2;

// Which of the three doublings the curve takes.
__device__ __forceinline__ int curve_a_kind(const Curve& C) {
  const Field& F = C.F;
  if (fe_is_zero(C.a)) return A_ZERO;
  const Fe one = fe_one(F);
  const Fe m3 = fe_sub(fe_zero(), fe_add(fe_double(one, F), one, F), F);
  bool eq = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) eq &= m3.v[i] == C.a.v[i];
  return eq ? A_MINUS3 : A_GENERAL;
}

template <class Ops>
__device__ __forceinline__ Pt pt_dbl_k(const Pt& P, const Curve& C, int ak) {
  const Field& F = C.F;
  if (fe_is_zero(P.Z) || fe_is_zero(P.Y)) return pt_inf(F);
  const Fe YY = Ops::mul(P.Y, P.Y, F);
  Fe M;
  if (ak == A_MINUS3) {
    const Fe ZZ = Ops::mul(P.Z, P.Z, F);
    const Fe d = Ops::mul(Ops::sub(P.X, ZZ, F), Ops::add(P.X, ZZ, F), F);
    M = Ops::add(Ops::dbl(d, F), d, F);
  } else {
    const Fe XX = Ops::mul(P.X, P.X, F);
    M = Ops::add(Ops::dbl(XX, F), XX, F);
    if (ak == A_GENERAL) {
      const Fe ZZ = Ops::mul(P.Z, P.Z, F);
      M = Ops::add(M, Ops::mul(C.a, Ops::mul(ZZ, ZZ, F), F), F);
    }
  }
  const Fe S = Ops::dbl(Ops::dbl(Ops::mul(P.X, YY, F), F), F);
  Pt R;
  R.X = Ops::sub(Ops::mul(M, M, F), Ops::dbl(S, F), F);
  const Fe YYYY8 = Ops::dbl(Ops::dbl(Ops::dbl(Ops::mul(YY, YY, F), F), F), F);
  R.Y = Ops::sub(Ops::mul(M, Ops::sub(S, R.X, F), F), YYYY8, F);
  R.Z = Ops::dbl(Ops::mul(P.Y, P.Z, F), F);
  return R;
}

// P + Q, complete (add-1998-cmo-2 with the exceptional cases branched).
// Inlined: as a call (its arguments through the stack) one took 26.5 us
// in a chain against 9.2 inlined (tools/curve_latency.py, H100).
template <class Ops>
__device__ __forceinline__ Pt pt_add_k(const Pt& P, const Pt& Q, const Curve& C, int ak) {
  const Field& F = C.F;
  if (fe_is_zero(P.Z)) return Q;
  if (fe_is_zero(Q.Z)) return P;
  const Fe Z1Z1 = Ops::mul(P.Z, P.Z, F);
  const Fe Z2Z2 = Ops::mul(Q.Z, Q.Z, F);
  const Fe U1 = Ops::mul(P.X, Z2Z2, F);
  const Fe U2 = Ops::mul(Q.X, Z1Z1, F);
  const Fe S1 = Ops::mul(P.Y, Ops::mul(Q.Z, Z2Z2, F), F);
  const Fe S2 = Ops::mul(Q.Y, Ops::mul(P.Z, Z1Z1, F), F);
  const Fe H = Ops::sub(U2, U1, F);
  const Fe Rr = Ops::sub(S2, S1, F);
  if (fe_is_zero(H)) {
    if (fe_is_zero(Rr)) return pt_dbl_k<Ops>(P, C, ak);
    return pt_inf(F);
  }
  const Fe HH = Ops::mul(H, H, F);
  const Fe HHH = Ops::mul(H, HH, F);
  const Fe V = Ops::mul(U1, HH, F);
  Pt R;
  R.X = Ops::sub(Ops::sub(Ops::mul(Rr, Rr, F), HHH, F), Ops::dbl(V, F), F);
  R.Y = Ops::sub(Ops::mul(Rr, Ops::sub(V, R.X, F), F), Ops::mul(S1, HHH, F), F);
  R.Z = Ops::mul(Ops::mul(P.Z, Q.Z, F), H, F);
  return R;
}

// 2P and P + Q with general a on fe_mul (10 and 16 products): the group
// law of every kernel but the windowed MSM.
__device__ Pt pt_dbl(const Pt& P, const Curve& C) { return pt_dbl_k<OpsC>(P, C, A_GENERAL); }

__device__ Pt pt_add(const Pt& P, const Pt& Q, const Curve& C) {
  return pt_add_k<OpsC>(P, Q, C, A_GENERAL);
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

// s ? a : b, word by word.
__device__ __forceinline__ Fe fe_sel(bool s, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = s ? a.v[i] : b.v[i];
  return r;
}

__device__ __forceinline__ Fe fe_shfl_quad(const Fe& a, int src, unsigned mask) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_sync(mask, a.v[i], src, 4);
  return r;
}

// 2^k P by the four lanes of a quad (lanes 4q .. 4q + 3 of a warp), every
// lane holding the same P and returning 2^k P, the values of k pt_dbl.  A
// doubling's independent products run side by side, one a lane, so its
// chain is 3 products deep, not 8 (a = -3) or 7 (a = 0):
//   level 1  YY = Y Y, YZ = Y Z, and d = (X - ZZ)(X + ZZ) (a = -3; M = 3 d)
//            or XX = X X (a = 0; M = 3 XX);
//   level 2  M M, X YY, YY YY, and YY ZZ (a = -3);
//   level 3  M (S - X3) in every lane.
// With a = -3 the quad carries ZZ = Z^2 from one doubling to the next
// (Z3^2 = 4 YY ZZ), so level 1 needs no Z^2 of its own.  Any other a takes
// pt_dbl_k in every lane.  Control flow is uniform in a quad (one point),
// so the shuffles name the quad's lanes only.
template <class Ops>
__device__ __forceinline__ Pt pt_dbl_quad_n(Pt P, int k, const Curve& C, int ak) {
  const Field& F = C.F;
  if (ak == A_GENERAL) {
    for (int i = 0; i < k; ++i) P = pt_dbl_k<Ops>(P, C, ak);
    return P;
  }
  const int c = threadIdx.x & 3;
  const unsigned mask = 0xFu << (threadIdx.x & 28);
  const bool m3 = ak == A_MINUS3;
  Fe ZZ = m3 ? Ops::mul(P.Z, P.Z, F) : fe_zero();
  for (int i = 0; i < k; ++i) {
    if (fe_is_zero(P.Z) || fe_is_zero(P.Y)) return pt_inf(F);
    // one product a lane, its operands selected word by word (no branch
    // in the quad, nothing addressed)
    const Fe xm = fe_sel(m3, Ops::sub(P.X, ZZ, F), P.X);
    const Fe xp = fe_sel(m3, Ops::add(P.X, ZZ, F), P.X);
    const Fe w1 = Ops::mul(fe_sel(c == 2, xm, P.Y),
                           fe_sel(c == 2, xp, fe_sel(c == 1, P.Z, P.Y)), F);
    const Fe YY = fe_shfl_quad(w1, 0, mask);
    const Fe YZ = fe_shfl_quad(w1, 1, mask);
    const Fe d = fe_shfl_quad(w1, 2, mask);
    const Fe M = Ops::add(Ops::dbl(d, F), d, F);
    const Fe w2 = Ops::mul(fe_sel(c == 0, M, fe_sel(c == 1, P.X, YY)),
                           fe_sel(c == 0, M, fe_sel(c == 3, ZZ, YY)), F);
    const Fe MM = fe_shfl_quad(w2, 0, mask);
    const Fe S = Ops::dbl(Ops::dbl(fe_shfl_quad(w2, 1, mask), F), F);
    const Fe YYYY = fe_shfl_quad(w2, 2, mask);
    if (m3) ZZ = Ops::dbl(Ops::dbl(fe_shfl_quad(w2, 3, mask), F), F);
    P.X = Ops::sub(MM, Ops::dbl(S, F), F);
    P.Y = Ops::sub(Ops::mul(M, Ops::sub(S, P.X, F), F),
                   Ops::dbl(Ops::dbl(Ops::dbl(YYYY, F), F), F), F);
    P.Z = Ops::dbl(YZ, F);
  }
  return P;
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
