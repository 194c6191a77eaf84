// Kernels 3 and 4: NeutronNova's NIFS rounds over the (instance,
// constraint) grid.
//
// Replaces the JAX package's NifsRoundsDevice programs
// (spartan2_tpu/sumcheck/zk_device.py): nifs_step :365 (from _step :334),
// nifs_final_fold :459 (_final_fold :455) and nifs_weighted_fold :477
// (_weighted_fold :462) as kernel 3; nifs_to_small :387 (_to_small :368)
// and nifs_small_step :445 (_small_step :390), with to_small_planes and
// conv_cols of field/small_value.py :66/:55, as kernel 4.
//
// Layout: A, B, C are (I, n) grids of field elements (8 words each,
// Montgomery), instance i's row starting i * n elements after the
// first.  Instance pairs are ADJACENT, (2q, 2q + 1), as the reference
// folds them (neutronnova_zk.rs:854-1168), not the half-split pairs of a
// sum-check bind.  E (n) and the pair weights w are Montgomery.
//
// Kernel 3 entries:
//   sp2_nifs_round     if bind_first, fold the I instances in place into
//                      I / 2 with r (x_i <- x_2i + r (x_2i+1 - x_2i));
//                      then per (pair q, chunk) the block partials of
//                      sum_k E_k (Ae Be - Ce) and sum_k E_k (Ao - Ae)(Bo - Be),
//                      then one reduction block: out[t] = sum_q w_q S_q[t]
//                      (Montgomery).
//   sp2_nifs_fold      the fold alone (the final I = 2 -> 1 fold).
//   sp2_weighted_fold  out_k = sum_i w_i W_i,k (witness folds).
// Kernel 4 entries (round 0 on small integers):
//   sp2_nifs_to_small  from_mont, then the signed representative v or
//                      v - p, kept when its magnitude is below 2^72 (JAX's
//                      window: to_small_planes keeps v < 2^72 or
//                      p - v < 2^72).  Each entry becomes 4 words:
//                      magnitude m0, m1, m2 and a sign word (1 negative);
//                      entries outside the window become zeros and clear
//                      the grid's ok word.
//   sp2_nifs_small_round  round 0's two sums from the small grid: per
//                      entry the exact integer t = Ae Be - Ce (or
//                      (Ao - Ae)(Bo - Be)), |t| < 2^147, times E_k (the
//                      256-bit Montgomery word), into a positive and a
//                      negative 14-word (448-bit) sum per thread; each sum
//                      is Montgomery-reduced once (REDC gives sum E t, the
//                      plain value, since E carries R), then block partials
//                      and the reduction block as in kernel 3.  The output
//                      is plain (not Montgomery): w_mont * plain * R^-1.
//
// Bound: a round reads the grid once (5 of every 6 entries of a pair:
// Ae, Ao, Be, Bo, Ce) plus E, and does 4 Montgomery products per pair
// entry (kernel 3); the small round reads 16 bytes per entry instead of
// 32 and does 9 + 40 32x32-bit products per sum instead of 2 Montgomery
// products.

#include "field.cuh"

using namespace sp2;

constexpr int NT = 256;
constexpr int WACC = 14;  // 448-bit accumulators

__device__ __forceinline__ uint32_t* grid_pick(uint32_t* A, uint32_t* B, uint32_t* C) {
  return blockIdx.y == 0 ? A : (blockIdx.y == 1 ? B : C);
}

// Fold I instances into I / 2 in place: a thread owns column k and walks
// the pairs in order, so the write to row i never clobbers a row a later
// pair reads (rows 2i', 2i' + 1 > i for i' > i).
__global__ void fold_kernel(int I, size_t n, uint32_t* A, uint32_t* B, uint32_t* C,
                            Fe r, Field F) {
  uint32_t* X = grid_pick(A, B, C);
  for (size_t k = blockIdx.x * (size_t)NT + threadIdx.x; k < n;
       k += (size_t)gridDim.x * NT) {
    for (int i = 0; i < I / 2; ++i) {
      Fe e = fe_load(X, (size_t)(2 * i) * n + k);
      Fe o = fe_load(X, (size_t)(2 * i + 1) * n + k);
      fe_store(X, (size_t)i * n + k, fe_add(e, fe_mul(r, fe_sub(o, e, F), F), F));
    }
  }
}

__device__ __forceinline__ void store_pair_partials(Fe s0, Fe s1, uint32_t* partial,
                                                    const Field& F) {
  const size_t at = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2;
  Fe t0 = block_sum<NT>(s0, F);
  if (threadIdx.x == 0) fe_store(partial, at, t0);
  Fe t1 = block_sum<NT>(s1, F);
  if (threadIdx.x == 0) fe_store(partial, at + 1, t1);
}

// Pair q = blockIdx.y of the (folded) grid, chunk blockIdx.x.
__global__ void round_evals_kernel(size_t n, const uint32_t* A, const uint32_t* B,
                                   const uint32_t* C, const uint32_t* E,
                                   uint32_t* partial, Field F) {
  const size_t ev = (size_t)(2 * blockIdx.y) * n, od = ev + n;
  Fe s0 = fe_zero(), s1 = fe_zero();
  for (size_t k = blockIdx.x * (size_t)NT + threadIdx.x; k < n;
       k += (size_t)gridDim.x * NT) {
    Fe e = fe_load(E, k);
    Fe ae = fe_load(A, ev + k), ao = fe_load(A, od + k);
    Fe be = fe_load(B, ev + k), bo = fe_load(B, od + k);
    Fe ce = fe_load(C, ev + k);
    s0 = fe_add(s0, fe_mul(e, fe_sub(fe_mul(ae, be, F), ce, F), F), F);
    s1 = fe_add(s1, fe_mul(e, fe_mul(fe_sub(ao, ae, F), fe_sub(bo, be, F), F), F), F);
  }
  store_pair_partials(s0, s1, partial, F);
}

// out[t] = sum_q w_q * (sum_c partial[q, c, t]), one block.
__global__ void reduce_pairs_kernel(int pairs, int nchunks, const uint32_t* partial,
                                    const uint32_t* w, uint32_t* out, Field F) {
  for (int t = 0; t < 2; ++t) {
    Fe acc = fe_zero();
    for (int q = 0; q < pairs; ++q) {
      Fe s = fe_zero();
      for (int c = threadIdx.x; c < nchunks; c += NT)
        s = fe_add(s, fe_load(partial, ((size_t)q * nchunks + c) * 2 + t), F);
      s = block_sum<NT>(s, F);
      if (threadIdx.x == 0) acc = fe_add(acc, fe_mul(fe_load(w, q), s, F), F);
    }
    if (threadIdx.x == 0) fe_store(out, t, acc);
  }
}

__global__ void weighted_fold_kernel(int I, size_t n, const uint32_t* w,
                                     const uint32_t* W, uint32_t* out, Field F) {
  for (size_t k = blockIdx.x * (size_t)NT + threadIdx.x; k < n;
       k += (size_t)gridDim.x * NT) {
    Fe acc = fe_zero();
    for (int i = 0; i < I; ++i)
      acc = fe_add(acc, fe_mul(fe_load(w, i), fe_load(W, (size_t)i * n + k), F), F);
    fe_store(out, k, acc);
  }
}

// ---------------------------------------------------------------------------
// kernel 4: small values
// ---------------------------------------------------------------------------

// below 2^72: limbs 3..7 zero and limb 2 below 2^8
__device__ __forceinline__ bool in_window(const Fe& x) {
  return (x.v[3] | x.v[4] | x.v[5] | x.v[6] | x.v[7]) == 0 && x.v[2] < 256u;
}

__global__ void to_small_kernel(size_t total, const uint32_t* A, const uint32_t* B,
                                const uint32_t* C, uint32_t* out, int* ok, Field F) {
  const uint32_t* X = grid_pick((uint32_t*)A, (uint32_t*)B, (uint32_t*)C);
  uint4* o = reinterpret_cast<uint4*>(out) + (size_t)blockIdx.y * total;
  for (size_t k = blockIdx.x * (size_t)NT + threadIdx.x; k < total;
       k += (size_t)gridDim.x * NT) {
    Fe v = fe_from_mont(fe_load(X, k), F);
    Fe ng = fe_sub(fe_zero(), v, F);
    uint4 s = make_uint4(0u, 0u, 0u, 0u);
    if (in_window(v)) {
      s = make_uint4(v.v[0], v.v[1], v.v[2], 0u);
    } else if (in_window(ng)) {
      s = make_uint4(ng.v[0], ng.v[1], ng.v[2], 1u);
    } else {
      *ok = 0;
    }
    o[k] = s;
  }
}

// A signed integer: magnitude words m[0..W) little-endian and a sign.
template <int W>
struct Sgn {
  uint32_t m[W];
  bool neg;
};

__device__ __forceinline__ Sgn<3> load_small(const uint4* S, size_t i) {
  uint4 a = S[i];
  Sgn<3> r;
  r.m[0] = a.x; r.m[1] = a.y; r.m[2] = a.z;
  r.neg = a.w != 0;
  return r;
}

// a + b for signed magnitudes that fit W words
template <int W>
__device__ __forceinline__ Sgn<W> sgn_add(const Sgn<W>& a, const Sgn<W>& b) {
  Sgn<W> r;
  if (a.neg == b.neg) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      uint64_t s = (uint64_t)a.m[i] + b.m[i] + c;
      r.m[i] = (uint32_t)s;
      c = s >> 32;
    }
    r.neg = a.neg;
    return r;
  }
  // |a| - |b|; if it borrows, negate the difference and take b's sign
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t s = (uint64_t)a.m[i] - b.m[i] - borrow;
    r.m[i] = (uint32_t)s;
    borrow = (s >> 63) & 1;
  }
  r.neg = a.neg;
  if (borrow) {
    uint64_t c = 1;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      uint64_t s = (uint64_t)(~r.m[i]) + c;
      r.m[i] = (uint32_t)s;
      c = s >> 32;
    }
    r.neg = b.neg;
  }
  return r;
}

template <int W>
__device__ __forceinline__ Sgn<W> sgn_negate(Sgn<W> a) {
  a.neg = !a.neg;
  return a;
}

template <int W>
__device__ __forceinline__ Sgn<W> widen3(const Sgn<3>& a) {
  Sgn<W> r;
#pragma unroll
  for (int i = 0; i < W; ++i) r.m[i] = i < 3 ? a.m[i] : 0u;
  r.neg = a.neg;
  return r;
}

__device__ __forceinline__ Sgn<6> sgn_mul3(const Sgn<3>& a, const Sgn<3>& b) {
  Sgn<6> r;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.m[i] = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      uint64_t s = (uint64_t)r.m[i + j] + (uint64_t)a.m[i] * b.m[j] + c;
      r.m[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    r.m[i + 3] = (uint32_t)c;
  }
  r.neg = a.neg != b.neg;
  return r;
}

// acc (448 bits) += |t| * e, |t| < 2^160 (first 5 words), e < 2^256
__device__ __forceinline__ void acc_mul_add(uint32_t acc[WACC], const Sgn<6>& t,
                                            const Fe& e) {
  uint32_t prod[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) prod[i] = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)prod[i + j] + (uint64_t)t.m[i] * e.v[j] + c;
      prod[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    prod[i + 8] = (uint32_t)c;
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < WACC; ++i) {
    uint64_t s = (uint64_t)acc[i] + (i < 13 ? prod[i] : 0u) + c;
    acc[i] = (uint32_t)s;
    c = s >> 32;
  }
}

// a * 2^-256 mod p for a < 2^448 (< p * 2^256): word-by-word Montgomery
// reduction; the result is below p + 2^192 < 2p.
__device__ __forceinline__ Fe redc_wide(const uint32_t a[WACC], const Field& F) {
  uint32_t t[17];
#pragma unroll
  for (int i = 0; i < 17; ++i) t[i] = i < WACC ? a[i] : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t m = t[i] * F.n0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)t[i + j] + (uint64_t)m * F.p[j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
#pragma unroll
    for (int j = i + 8; j < 17; ++j) {
      uint64_t s = (uint64_t)t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
  }
  return fe_reduce_once(t + 8, t[16], F);
}

__device__ __forceinline__ void acc_signed(uint32_t pos[WACC], uint32_t neg[WACC],
                                           const Sgn<6>& t, const Fe& e) {
  if (t.neg) acc_mul_add(neg, t, e);
  else acc_mul_add(pos, t, e);
}

// S: (3, I, n) small entries (4 words each), pair q = blockIdx.y.
__global__ void small_round_kernel(int I, size_t n, const uint32_t* S, const uint32_t* E,
                                   uint32_t* partial, Field F) {
  const uint4* Sa = reinterpret_cast<const uint4*>(S);
  const uint4* Sb = Sa + (size_t)I * n;
  const uint4* Sc = Sb + (size_t)I * n;
  const size_t ev = (size_t)(2 * blockIdx.y) * n, od = ev + n;
  uint32_t p0[WACC], n0[WACC], p1[WACC], n1[WACC];
#pragma unroll
  for (int i = 0; i < WACC; ++i) p0[i] = n0[i] = p1[i] = n1[i] = 0;
  for (size_t k = blockIdx.x * (size_t)NT + threadIdx.x; k < n;
       k += (size_t)gridDim.x * NT) {
    Fe e = fe_load(E, k);
    Sgn<3> ae = load_small(Sa, ev + k), ao = load_small(Sa, od + k);
    Sgn<3> be = load_small(Sb, ev + k), bo = load_small(Sb, od + k);
    Sgn<3> ce = load_small(Sc, ev + k);
    // e0 term: Ae Be - Ce
    Sgn<6> t0 = sgn_add<6>(sgn_mul3(ae, be), sgn_negate(widen3<6>(ce)));
    acc_signed(p0, n0, t0, e);
    // quad term: (Ao - Ae)(Bo - Be); the differences fit 73 bits
    Sgn<6> t1 = sgn_mul3(sgn_add<3>(ao, sgn_negate(ae)), sgn_add<3>(bo, sgn_negate(be)));
    acc_signed(p1, n1, t1, e);
  }
  Fe s0 = fe_sub(redc_wide(p0, F), redc_wide(n0, F), F);
  Fe s1 = fe_sub(redc_wide(p1, F), redc_wide(n1, F), F);
  store_pair_partials(s0, s1, partial, F);
}

// ---------------------------------------------------------------------------
// entries
// ---------------------------------------------------------------------------

static unsigned blocks_for(size_t n, unsigned cap) {
  size_t b = (n + NT - 1) / NT;
  if (b < 1) b = 1;
  return (unsigned)(b < cap ? b : cap);
}

static bool bad_grid(int I) { return I < 2 || (I & (I - 1)) != 0 || I > 65536; }

extern "C" int sp2_nifs_round(int I, size_t n, int bind_first, const uint32_t* r_words,
                              void* A, void* B, void* C, const void* E, const void* w,
                              void* partial, int nchunks, void* out,
                              const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  const int cur = bind_first ? I / 2 : I;
  if (bad_grid(I) || cur < 2 || nchunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t *a = (uint32_t*)A, *b = (uint32_t*)B, *c = (uint32_t*)C;
  if (bind_first) {
    fold_kernel<<<dim3(blocks_for(n, 4096), 3), NT, 0, s>>>(I, n, a, b, c,
                                                            fe_from_words(r_words), F);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int pairs = cur / 2;
  round_evals_kernel<<<dim3((unsigned)nchunks, (unsigned)pairs), NT, 0, s>>>(
      n, a, b, c, (const uint32_t*)E, (uint32_t*)partial, F);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_pairs_kernel<<<1, NT, 0, s>>>(pairs, nchunks, (const uint32_t*)partial,
                                       (const uint32_t*)w, (uint32_t*)out, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_nifs_fold(int I, size_t n, const uint32_t* r_words, void* A, void* B,
                             void* C, const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (bad_grid(I)) return (int)cudaErrorInvalidValue;
  fold_kernel<<<dim3(blocks_for(n, 4096), 3), NT, 0, (cudaStream_t)stream>>>(
      I, n, (uint32_t*)A, (uint32_t*)B, (uint32_t*)C, fe_from_words(r_words), F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_weighted_fold(int I, size_t n, const void* w, const void* W, void* out,
                                 const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (I < 1) return (int)cudaErrorInvalidValue;
  weighted_fold_kernel<<<blocks_for(n, 4096), NT, 0, (cudaStream_t)stream>>>(
      I, n, (const uint32_t*)w, (const uint32_t*)W, (uint32_t*)out, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_nifs_to_small(size_t total, const void* A, const void* B, const void* C,
                                 void* out, void* ok, const uint32_t* field_words,
                                 void* stream) {
  Field F = field_from_words(field_words);
  to_small_kernel<<<dim3(blocks_for(total, 4096), 3), NT, 0, (cudaStream_t)stream>>>(
      total, (const uint32_t*)A, (const uint32_t*)B, (const uint32_t*)C,
      (uint32_t*)out, (int*)ok, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_nifs_small_round(int I, size_t n, const void* S, const void* E,
                                    const void* w, void* partial, int nchunks, void* out,
                                    const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (bad_grid(I) || nchunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int pairs = I / 2;
  small_round_kernel<<<dim3((unsigned)nchunks, (unsigned)pairs), NT, 0, s>>>(
      I, n, (const uint32_t*)S, (const uint32_t*)E, (uint32_t*)partial, F);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_pairs_kernel<<<1, NT, 0, s>>>(pairs, nchunks, (const uint32_t*)partial,
                                       (const uint32_t*)w, (uint32_t*)out, F);
  return (int)cudaGetLastError();
}
