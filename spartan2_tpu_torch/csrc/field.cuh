// Montgomery arithmetic mod p < 2^256 on 8 x 32-bit limbs, as device
// functions inlined into every kernel of the port.
//
// Replaces the JAX package's FieldOps limb arithmetic
// (spartan2_tpu/field/jnp_ops.py: add/sub :126-146, mont_mul :185,
// to_mont/from_mont :211-228, from_uniform_bytes :302, the canonical byte
// encodings :704/:722), which ran on (22, n) planes of 12-bit
// limbs with R = 2^264.  Here an element is 8 little-endian 32-bit limbs,
// 32 contiguous bytes (two 16-byte loads), R = 2^256, always canonical
// in [0, p).  Both P-256 moduli exceed 2^255, so a + b and the Montgomery
// product can carry out of limb 7: that carry takes part in the
// conditional subtract (fe_reduce_once).
//
// Cost: one product is 64 + 64 32x32->64 partial products (CIOS); the
// kernels that use it are bound by these multiply-adds, not by bytes.
// fe_mul_cc, fe_add_cc and fe_sub_cc compute the same values on PTX carry
// chains, with fewer instructions on a dependent chain (one thread on the
// H100: 0.50 against 0.92 us a product, 0.038 against 0.089 us an
// addition, tools/curve_latency.py); the windowed MSM, the eq tables, the
// sum-check rounds (kernel A) and the round finish (kernel F) use them.
// Acc keeps a sum of unreduced 512-bit products (fe_mul_acc) and reduces
// it once (acc_reduce): the sums of products of kernels A, B, G and 4.
// The plain PyTorch version is spartan2_tpu_torch/field/ops.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sp2 {

struct Fe {
  uint32_t v[8];
};

// Field constants, passed to every kernel by value.
struct Field {
  uint32_t p[8];
  uint32_t one[8];  // R mod p (Montgomery one)
  uint32_t n0;      // -p^{-1} mod 2^32
  uint32_t r2[8];   // R^2 mod p
  uint32_t r3[8];   // R^3 mod p
};

// Host: unpack the FIELD_WORDS words written by field_words() on the
// Python side.
constexpr int FIELD_WORDS = 33;

static inline Field field_from_words(const uint32_t* w) {
  Field f;
  for (int i = 0; i < 8; ++i) f.p[i] = w[i];
  for (int i = 0; i < 8; ++i) f.one[i] = w[8 + i];
  f.n0 = w[16];
  for (int i = 0; i < 8; ++i) f.r2[i] = w[17 + i];
  for (int i = 0; i < 8; ++i) f.r3[i] = w[25 + i];
  return f;
}

static inline Fe fe_from_words(const uint32_t* w) {
  Fe x;
  for (int i = 0; i < 8; ++i) x.v[i] = w[i];
  return x;
}

static inline Fe fe_zero_host() {
  Fe x;
  for (int i = 0; i < 8; ++i) x.v[i] = 0;
  return x;
}

__device__ __forceinline__ Fe fe_load(const uint32_t* base, size_t i) {
  const uint4* q = reinterpret_cast<const uint4*>(base + 8 * i);
  uint4 a = q[0];
  uint4 b = q[1];
  Fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* base, size_t i, const Fe& x) {
  uint4* q = reinterpret_cast<uint4*>(base + 8 * i);
  q[0] = make_uint4(x.v[0], x.v[1], x.v[2], x.v[3]);
  q[1] = make_uint4(x.v[4], x.v[5], x.v[6], x.v[7]);
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one(const Field& F) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = F.one[i];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.v[i];
  return acc == 0;
}

// t + carry * 2^256 < 2p  ->  (t + carry * 2^256) mod p
__device__ __forceinline__ Fe fe_reduce_once(const uint32_t t[8], uint32_t carry,
                                             const Field& F) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)t[i] - (uint64_t)F.p[i] - borrow;
    d.v[i] = (uint32_t)s;
    borrow = (s >> 63) & 1;
  }
  // subtract when the value reached 2^256 or t >= p
  bool take = carry != 0 || borrow == 0;
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = take ? d.v[i] : t[i];
  return r;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const Field& F) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)a.v[i] + (uint64_t)b.v[i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  return fe_reduce_once(t, (uint32_t)c, F);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const Field& F) {
  uint32_t t[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)a.v[i] - (uint64_t)b.v[i] - borrow;
    t[i] = (uint32_t)s;
    borrow = (s >> 63) & 1;
  }
  // a < b: add p back (mod 2^256)
  uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)t[i] + (uint64_t)(F.p[i] & mask) + c;
    r.v[i] = (uint32_t)s;
    c = s >> 32;
  }
  return r;
}

__device__ __forceinline__ Fe fe_double(const Fe& a, const Field& F) {
  return fe_add(a, a, F);
}

// Montgomery product a * b * 2^-256 mod p (CIOS, 32-bit words).
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, const Field& F) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s8 = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s8;
    t[9] = (uint32_t)(s8 >> 32);
    uint32_t m = t[0] * F.n0;
    uint64_t s = (uint64_t)t[0] + (uint64_t)m * F.p[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * F.p[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  return fe_reduce_once(t, t[8], F);
}

// PTX carry chains: the carry flag links consecutive calls (.cc sets it,
// madc/addc consume it).  No other instruction touches the flag.
__device__ __forceinline__ uint32_t cc_mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_madc_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_add(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_addc_end(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_sub(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_subc_end(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// t + carry * 2^256 < 2p -> (t + carry * 2^256) mod p, as fe_reduce_once,
// the subtract on one borrow chain.
__device__ __forceinline__ Fe fe_reduce_cc(const uint32_t t[8], uint32_t carry,
                                           const Field& F) {
  uint32_t d[8];
  d[0] = cc_sub(t[0], F.p[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) d[i] = cc_subc(t[i], F.p[i]);
  const uint32_t borrow = cc_subc_end(0, 0);  // 0 or 0xFFFFFFFF
  const bool take = carry != 0 || borrow == 0;
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = take ? d[i] : t[i];
  return r;
}

// a + b and a - b mod p, as fe_add and fe_sub, on carry chains (the MSM's
// group law, beside fe_mul_cc).
__device__ __forceinline__ Fe fe_add_cc(const Fe& a, const Fe& b, const Field& F) {
  uint32_t t[8];
  t[0] = cc_add(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) t[i] = cc_addc(a.v[i], b.v[i]);
  return fe_reduce_cc(t, cc_addc_end(0, 0), F);
}

__device__ __forceinline__ Fe fe_sub_cc(const Fe& a, const Fe& b, const Field& F) {
  uint32_t t[8];
  t[0] = cc_sub(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) t[i] = cc_subc(a.v[i], b.v[i]);
  const uint32_t mask = cc_subc_end(0, 0);  // a < b: add p back (mod 2^256)
  Fe r;
  r.v[0] = cc_add(t[0], F.p[0] & mask);
#pragma unroll
  for (int i = 1; i < 7; ++i) r.v[i] = cc_addc(t[i], F.p[i] & mask);
  r.v[7] = cc_addc_end(t[7], F.p[7] & mask);
  return r;
}

// x[0..8] += sum over even j of a[j] * b * 2^(32 j): the 64-bit products
// of even limbs do not overlap, so one carry chain adds them all.
__device__ __forceinline__ void cc_add_even(uint32_t x[9], const uint32_t a[8], uint32_t b) {
  x[0] = cc_mad_lo(a[0], b, x[0]);
  x[1] = cc_madc_hi(a[0], b, x[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    x[j] = cc_madc_lo(a[j], b, x[j]);
    x[j + 1] = cc_madc_hi(a[j], b, x[j + 1]);
  }
  x[8] = cc_addc_end(x[8], 0);
}

// Montgomery product a * b * 2^-256 mod p, as fe_mul computes it (the same
// canonical value), on PTX carry chains.  CIOS, each word b_i a row: T += a
// b_i; m = T_0 n0; T += m p; T /= 2^32.  The even limbs' products go into
// t by one carry chain, the odd limbs' into u (one word lower) by plain
// multiplies and one chain of their own, so two independent chains run
// beside each other; the row ends by merging u into t >> 32.  Bounds: T <
// 2p at a row's start (t[8] <= 1), at most 4 * 2^256 inside it (t[8] <=
// 3), u < 2 * 2^256.  Used by the MSM (msm.cu), the eq tables and kernel A
// (sumcheck.cu) and kernel F (round_finish.cu); every other kernel keeps
// fe_mul.
__device__ __forceinline__ Fe fe_mul_cc(const Fe& a, const Fe& b, const Field& F) {
  uint32_t t[9], u[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t bi = b.v[i];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {  // odd limbs' products, one word lower
      u[j] = a.v[j + 1] * bi;
      u[j + 1] = __umulhi(a.v[j + 1], bi);
    }
    u[8] = 0;
    cc_add_even(t, a.v, bi);
    const uint32_t m = t[0] * F.n0;
    cc_add_even(t, F.p, m);
    u[0] = cc_mad_lo(F.p[1], m, u[0]);
    u[1] = cc_madc_hi(F.p[1], m, u[1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      u[j] = cc_madc_lo(F.p[j + 1], m, u[j]);
      u[j + 1] = cc_madc_hi(F.p[j + 1], m, u[j + 1]);
    }
    u[8] = cc_addc_end(0, 0);
    // T / 2^32 = t[1..8] + u[0..8] (t[0] is 0)
    t[0] = cc_add(t[1], u[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = cc_addc(t[j + 1], u[j]);
    t[8] = cc_addc_end(u[8], 0);
  }
  return fe_reduce_cc(t, t[8], F);
}

// lo + r (hi - lo): the bind of one pair, on the carry chains.
__device__ __forceinline__ Fe fe_bind_cc(const Fe& lo, const Fe& hi, const Fe& r,
                                         const Field& F) {
  return fe_add_cc(lo, fe_mul_cc(r, fe_sub_cc(hi, lo, F), F), F);
}

// A sum of unreduced products a b < p^2 (at most 2^32 of them): 17 words.
struct Acc {
  uint32_t w[17];
};

__device__ __forceinline__ Acc acc_zero() {
  Acc a;
#pragma unroll
  for (int i = 0; i < 17; ++i) a.w[i] = 0;
  return a;
}

// acc += a b (512 bits, no reduction).  The product is formed in a fresh
// 16-word w, per word b_i on two carry chains as in fe_mul_cc (the even
// limbs' 64-bit products of a do not overlap, nor the odd ones'): before
// row i the product is below 2^(256 + 32 i), so each chain's carry lands
// in a word that held at most 1 and cannot overflow (the last row's odd
// carry is 0).  Then one chain adds w into the accumulator.
__device__ __forceinline__ void fe_mul_acc(Acc& acc, const Fe& a, const Fe& b) {
  uint32_t w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t bi = b.v[i];
    w[i] = cc_mad_lo(a.v[0], bi, w[i]);
    w[i + 1] = cc_madc_hi(a.v[0], bi, w[i + 1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      w[i + j] = cc_madc_lo(a.v[j], bi, w[i + j]);
      w[i + j + 1] = cc_madc_hi(a.v[j], bi, w[i + j + 1]);
    }
    w[i + 8] = cc_addc_end(w[i + 8], 0);
    w[i + 1] = cc_mad_lo(a.v[1], bi, w[i + 1]);
    w[i + 2] = cc_madc_hi(a.v[1], bi, w[i + 2]);
#pragma unroll
    for (int j = 3; j < 8; j += 2) {
      w[i + j] = cc_madc_lo(a.v[j], bi, w[i + j]);
      w[i + j + 1] = cc_madc_hi(a.v[j], bi, w[i + j + 1]);
    }
    if (i + 9 < 16) w[i + 9] = cc_addc_end(w[i + 9], 0);
  }
  acc.w[0] = cc_add(acc.w[0], w[0]);
#pragma unroll
  for (int j = 1; j < 16; ++j) acc.w[j] = cc_addc(acc.w[j], w[j]);
  acc.w[16] = cc_addc_end(acc.w[16], 0);
}

// acc += x (both sums of products).
__device__ __forceinline__ void acc_add(Acc& acc, const Acc& x) {
  acc.w[0] = cc_add(acc.w[0], x.w[0]);
#pragma unroll
  for (int j = 1; j < 16; ++j) acc.w[j] = cc_addc(acc.w[j], x.w[j]);
  acc.w[16] = cc_addc_end(acc.w[16], x.w[16]);
}

// Lane l + off's sum (a warp's tree of sums of products).
__device__ __forceinline__ Acc acc_shfl_down(const Acc& a, int off) {
  Acc r;
#pragma unroll
  for (int i = 0; i < 17; ++i) r.w[i] = __shfl_down_sync(0xFFFFFFFFu, a.w[i], off);
  return r;
}

// t[i .. 17] += m p 2^(32 i) (one Montgomery reduction row): the even and
// the odd limbs' products on one chain each, the carry rippled to word 17.
__device__ __forceinline__ void acc_redc_row(uint32_t t[18], int i, uint32_t m,
                                             const Field& F) {
  t[i] = cc_mad_lo(F.p[0], m, t[i]);
  t[i + 1] = cc_madc_hi(F.p[0], m, t[i + 1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    t[i + j] = cc_madc_lo(F.p[j], m, t[i + j]);
    t[i + j + 1] = cc_madc_hi(F.p[j], m, t[i + j + 1]);
  }
#pragma unroll
  for (int k = i + 8; k < 17; ++k) t[k] = cc_addc(t[k], 0);
  t[17] = cc_addc_end(t[17], 0);
  t[i + 1] = cc_mad_lo(F.p[1], m, t[i + 1]);
  t[i + 2] = cc_madc_hi(F.p[1], m, t[i + 2]);
#pragma unroll
  for (int j = 3; j < 8; j += 2) {
    t[i + j] = cc_madc_lo(F.p[j], m, t[i + j]);
    t[i + j + 1] = cc_madc_hi(F.p[j], m, t[i + j + 1]);
  }
#pragma unroll
  for (int k = i + 9; k < 17; ++k) t[k] = cc_addc(t[k], 0);
  t[17] = cc_addc_end(t[17], 0);
}

// The canonical acc R^-1 mod p: the Montgomery sum of the products, equal
// to the sum of their fe_mul_cc.  Eight reduction rows leave T = (acc + M
// p) / 2^256 < 2^289 in words 8 .. 17; T = h 2^256 + l with h < 2^33, and
// T mod p = h R mod p (fe_mul_cc(h, R^2)) + (l mod p, by at most 7
// subtractions: 2^256 < 8 p for the port's fields).
__device__ __forceinline__ Fe acc_reduce(const Acc& acc, const Field& F) {
  uint32_t t[18];
#pragma unroll
  for (int i = 0; i < 17; ++i) t[i] = acc.w[i];
  t[17] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc_redc_row(t, i, t[i] * F.n0, F);
  Fe h = fe_zero(), r2, l;
  h.v[0] = t[16];
  h.v[1] = t[17];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r2.v[i] = F.r2[i];
    l.v[i] = t[8 + i];
  }
  for (int it = 0; it < 8; ++it) {  // l mod p
    uint32_t d[8];
    d[0] = cc_sub(l.v[0], F.p[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) d[i] = cc_subc(l.v[i], F.p[i]);
    if (cc_subc_end(0, 0)) break;  // borrow: l < p
#pragma unroll
    for (int i = 0; i < 8; ++i) l.v[i] = d[i];
  }
  return fe_add_cc(fe_mul_cc(h, r2, F), l, F);
}

// A value another block wrote: loads that skip this SM's L1.
__device__ __forceinline__ Fe fe_load_cg(const uint32_t* base, size_t i) {
  const uint4* q = reinterpret_cast<const uint4*>(base + 8 * i);
  const uint4 a = __ldcg(q), b = __ldcg(q + 1);
  Fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

__device__ __forceinline__ Fe fe_from_mont(const Fe& a, const Field& F) {
  Fe one = fe_zero();
  one.v[0] = 1;
  return fe_mul(a, one, F);
}

// 32 little-endian bytes (any alignment) -> 8 limbs, unreduced.
__device__ __forceinline__ Fe fe_from_le_bytes(const uint8_t* b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.v[i] = (uint32_t)b[4 * i] | ((uint32_t)b[4 * i + 1] << 8) |
             ((uint32_t)b[4 * i + 2] << 16) | ((uint32_t)b[4 * i + 3] << 24);
  return r;
}

__device__ __forceinline__ void fe_to_le_bytes(const Fe& a, uint8_t* b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) b[i] = (uint8_t)(a.v[i >> 2] >> (8 * (i & 3)));
}

// A 512-bit little-endian integer (64 bytes) -> its Montgomery form mod p
// (FieldOps.from_uniform_bytes): lo R + hi 2^256 R = REDC(lo R^2) +
// REDC(hi R^3).  REDC(a b) with a < 2^256 and b < p stays below 2p, so the
// unreduced halves need no reduction first.
__device__ __forceinline__ Fe fe_from_uniform(const uint8_t* b, const Field& F) {
  Fe r2, r3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r2.v[i] = F.r2[i];
    r3.v[i] = F.r3[i];
  }
  return fe_add(fe_mul(fe_from_le_bytes(b), r2, F),
                fe_mul(fe_from_le_bytes(b + 32), r3, F), F);
}

__device__ __forceinline__ Fe fe_shfl_down(const Fe& a, int off) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_down_sync(0xFFFFFFFFu, a.v[i], off);
  return r;
}

// Sum of one Fe per thread over a block of NT threads (NT a multiple of
// 32, at most 1024); the result is valid in thread 0.
template <int NT>
__device__ __forceinline__ Fe block_sum(Fe x, const Field& F) {
  __shared__ Fe warp_sums[NT / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fe_add(x, fe_shfl_down(x, off), F);
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < NT / 32 ? warp_sums[lane] : fe_zero();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fe_add(x, fe_shfl_down(x, off), F);
  }
  __syncthreads();
  return x;
}

// Sums of NS values a thread over a block of NT threads, side by side: a
// shuffle tree a warp, then warp 0 over the warps' sums (on the carry
// chains); the results are valid in thread 0.
template <int NT, int NS>
__device__ __forceinline__ void block_sums(Fe* s, const Field& F) {
  __shared__ Fe ws[NT / 32][NS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int t = 0; t < NS; ++t) s[t] = fe_add_cc(s[t], fe_shfl_down(s[t], off), F);
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < NS; ++t) ws[warp][t] = s[t];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int t = 0; t < NS; ++t) s[t] = lane < NT / 32 ? ws[lane][t] : fe_zero();
#pragma unroll
    for (int off = NT / 64; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < NS; ++t) s[t] = fe_add_cc(s[t], fe_shfl_down(s[t], off), F);
    }
  }
}

}  // namespace sp2
