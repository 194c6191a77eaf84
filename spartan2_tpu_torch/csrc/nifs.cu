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
//   sp2_nifs_round     one launch a round.  If bind_first, each thread
//                      takes a column k of a folded pair q: it reads
//                      instances 4q .. 4q + 3 of A, B, C, binds them with r
//                      in registers (x'_{2q+s} = x_{4q+2s} + r (x_{4q+2s+1}
//                      - x_{4q+2s})), writes the two folded rows to the
//                      OUTPUT grid (never in place: the block of pair q / 2
//                      still reads rows 2q, 2q + 1 of the input), and adds
//                      E_k (Ae Be - Ce) and E_k (Ao - Ae)(Bo - Be) to its
//                      two sums (without bind_first, the pairs of the input
//                      as they are).  Products that only feed a sum are
//                      added unreduced and reduced once a thread and sum;
//                      the last block to arrive finishes
//                      out[t] = sum_q w_q S_q[t] (Montgomery, finish.cuh).
//   sp2_nifs_fold      the fold alone into an output grid, a thread an
//                      entry (the final I = 2 -> 1 fold).
//   sp2_weighted_fold  out_k = sum_i w_i W_i,k (witness folds), a thread a
//                      column, the I products unreduced, one reduction; the
//                      rows by their pointers (at most WF_MAX_ROWS a launch),
//                      added to out when ``accumulate``.
// Kernel 4 entries (round 0 on small integers):
//   sp2_nifs_to_small  from_mont, then the signed representative v or
//                      v - p, kept when its magnitude is below 2^72 (JAX's
//                      window: to_small_planes keeps v < 2^72 or
//                      p - v < 2^72).  Each entry becomes 4 words:
//                      magnitude m0, m1, m2 and a sign word (1 negative);
//                      entries outside the window become zeros and clear
//                      the grid's ok word.
//   sp2_nifs_small_round  round 0's two sums from the small grid, one
//                      launch: per entry the exact integer t = Ae Be - Ce
//                      (or (Ao - Ae)(Bo - Be)), |t| < 2^147, times E_k (the
//                      256-bit Montgomery word), into one signed 14-word
//                      (448-bit, two's complement) sum a thread and sum; its
//                      magnitude is Montgomery-reduced once and the sign put
//                      back (REDC gives sum E t, the plain value, since E
//                      carries R), then the weighted finish as in kernel 3.
//                      The output is plain (not Montgomery): w_mont * plain
//                      * R^-1.
//
// Bound: a round reads the grid once (with bind_first all of it, else 5 of
// every 6 entries of a pair: Ae, Ao, Be, Bo, Ce) plus E and writes the
// folded half; per folded pair and column 6 bind products, 2 reduced and 2
// unreduced products.  The small round reads 16 bytes per entry instead of
// 32 and does 9 + 40 32x32-bit products per sum instead of 2 Montgomery
// products.

#include "field.cuh"
#include "finish.cuh"

using namespace sp2;

constexpr int NT = 256;
constexpr int WACC = 14;  // 448-bit accumulators
// A round's grid: the pairs on blockIdx.y, each over the largest power of
// two of blocks that keeps all of them within NIFS_MAX_BLOCKS (two blocks
// of NT an SM of the H100's 132), a column a thread where that suffices.
constexpr int NIFS_MAX_BLOCKS = 264;
// The folds: a block of WF_NT threads; the weighted fold's rows by value.
constexpr int WF_NT = 128;
constexpr int WF_MAX_ROWS = 256;

struct Grid3 {
  uint32_t* p[3];  // A, B, C: (rows, n) each
};

struct Rows {
  const uint32_t* p[WF_MAX_ROWS];
};

__device__ __forceinline__ uint32_t* grid_pick(uint32_t* A, uint32_t* B, uint32_t* C) {
  return blockIdx.y == 0 ? A : (blockIdx.y == 1 ? B : C);
}

// Rows 2q', 2q' + 1 of the folded grid from rows 4q' .. 4q' + 3 of x at
// column k (i0 = 4q' n + k), written to y (o0 = 2q' n + k) -> (even, odd).
__device__ __forceinline__ void bind_two(const uint32_t* x, uint32_t* y, size_t i0,
                                         size_t o0, size_t n, const Fe& r, Fe& ev, Fe& od,
                                         const Field& F) {
  ev = fe_bind_cc(fe_load(x, i0), fe_load(x, i0 + n), r, F);
  od = fe_bind_cc(fe_load(x, i0 + 2 * n), fe_load(x, i0 + 3 * n), r, F);
  fe_store(y, o0, ev);
  fe_store(y, o0 + n, od);
}

// Kernel 3's round: pair q = blockIdx.y of the (folded) grid.
template <bool BIND>
__global__ void __launch_bounds__(NT) nifs_round_kernel(size_t n, Grid3 in, Grid3 fo,
                                                        const uint32_t* E, Fe r,
                                                        uint32_t* partial, const uint32_t* w,
                                                        uint32_t* out, unsigned* ticket,
                                                        Field F) {
  const int q = blockIdx.y;
  Acc s0 = acc_zero(), s1 = acc_zero();
  for (size_t k = blockIdx.x * (size_t)NT + threadIdx.x; k < n;
       k += (size_t)gridDim.x * NT) {
    Fe ae, ao, be, bo, ce;
    if (BIND) {
      const size_t i0 = (size_t)(4 * q) * n + k, o0 = (size_t)(2 * q) * n + k;
      Fe co;
      bind_two(in.p[0], fo.p[0], i0, o0, n, r, ae, ao, F);
      bind_two(in.p[1], fo.p[1], i0, o0, n, r, be, bo, F);
      bind_two(in.p[2], fo.p[2], i0, o0, n, r, ce, co, F);
    } else {
      const size_t i0 = (size_t)(2 * q) * n + k;
      ae = fe_load(in.p[0], i0);
      ao = fe_load(in.p[0], i0 + n);
      be = fe_load(in.p[1], i0);
      bo = fe_load(in.p[1], i0 + n);
      ce = fe_load(in.p[2], i0);
    }
    const Fe e = fe_load(E, k);
    fe_mul_acc(s0, e, fe_sub_cc(fe_mul_cc(ae, be, F), ce, F));
    fe_mul_acc(s1, e, fe_mul_cc(fe_sub_cc(ao, ae, F), fe_sub_cc(bo, be, F), F));
  }
  Fe s[2] = {acc_reduce(s0, F), acc_reduce(s1, F)};
  store_block_sums<2, NT>(q, s, partial, F);
  finish_weighted_sums<2, NT>(partial, w, out, ticket, F);
}

// Row i = blockIdx.z of the output <- x_2i + r (x_2i+1 - x_2i), a thread
// an entry; blockIdx.y picks A, B or C.
__global__ void __launch_bounds__(WF_NT) fold_kernel(size_t n, Grid3 in, Grid3 fo, Fe r,
                                                     Field F) {
  const uint32_t* x = grid_pick(in.p[0], in.p[1], in.p[2]);
  uint32_t* y = grid_pick(fo.p[0], fo.p[1], fo.p[2]);
  const size_t i0 = (size_t)(2 * blockIdx.z) * n, o0 = (size_t)blockIdx.z * n;
  for (size_t k = blockIdx.x * (size_t)WF_NT + threadIdx.x; k < n;
       k += (size_t)gridDim.x * WF_NT)
    fe_store(y, o0 + k, fe_bind_cc(fe_load(x, i0 + k), fe_load(x, i0 + n + k), r, F));
}

// A thread a column: the I products unreduced, one reduction.
__global__ void __launch_bounds__(WF_NT) weighted_fold_kernel(int I, size_t n,
                                                              const uint32_t* w,
                                                              const Rows rows,
                                                              int accumulate,
                                                              uint32_t* out, Field F) {
  for (size_t k = blockIdx.x * (size_t)WF_NT + threadIdx.x; k < n;
       k += (size_t)gridDim.x * WF_NT) {
    Acc acc = acc_zero();
    for (int i = 0; i < I; ++i) fe_mul_acc(acc, fe_load(w, i), fe_load(rows.p[i], k));
    Fe s = acc_reduce(acc, F);
    if (accumulate) s = fe_add_cc(s, fe_load(out, k), F);
    fe_store(out, k, s);
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

// acc (448 bits, two's complement) += t e, t signed with |t| < 2^160
// (first 5 words), e < 2^256: |t| e is formed in 13 words, complemented
// when t < 0 and added with t's sign as the carry in (word 13 all ones).
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
  const uint32_t mask = t.neg ? 0xFFFFFFFFu : 0u;
  uint64_t c = t.neg ? 1u : 0u;
#pragma unroll
  for (int i = 0; i < WACC; ++i) {
    uint64_t s = (uint64_t)acc[i] + ((i < 13 ? prod[i] : 0u) ^ mask) + c;
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

// The field element of a signed sum (two's complement, |sum| < 2^447):
// its magnitude reduced once, the sign put back.
__device__ __forceinline__ Fe redc_signed(uint32_t acc[WACC], const Field& F) {
  const bool neg = acc[WACC - 1] >> 31;
  if (neg) {
    uint64_t c = 1;
#pragma unroll
    for (int i = 0; i < WACC; ++i) {
      uint64_t s = (uint64_t)(~acc[i]) + c;
      acc[i] = (uint32_t)s;
      c = s >> 32;
    }
  }
  const Fe m = redc_wide(acc, F);
  return neg ? fe_sub_cc(fe_zero(), m, F) : m;
}

// S: (3, I, n) small entries (4 words each), pair q = blockIdx.y; the
// blocks of a pair and the weighted finish as kernel 3's round.
__global__ void __launch_bounds__(NT) small_round_kernel(int I, size_t n, const uint32_t* S,
                                                         const uint32_t* E, uint32_t* partial,
                                                         const uint32_t* w, uint32_t* out,
                                                         unsigned* ticket, Field F) {
  const uint4* Sa = reinterpret_cast<const uint4*>(S);
  const uint4* Sb = Sa + (size_t)I * n;
  const uint4* Sc = Sb + (size_t)I * n;
  const int q = blockIdx.y;
  const size_t ev = (size_t)(2 * q) * n, od = ev + n;
  uint32_t a0[WACC], a1[WACC];
#pragma unroll
  for (int i = 0; i < WACC; ++i) a0[i] = a1[i] = 0;
  for (size_t k = blockIdx.x * (size_t)NT + threadIdx.x; k < n;
       k += (size_t)gridDim.x * NT) {
    Fe e = fe_load(E, k);
    Sgn<3> ae = load_small(Sa, ev + k), ao = load_small(Sa, od + k);
    Sgn<3> be = load_small(Sb, ev + k), bo = load_small(Sb, od + k);
    Sgn<3> ce = load_small(Sc, ev + k);
    // e0 term: Ae Be - Ce
    acc_mul_add(a0, sgn_add<6>(sgn_mul3(ae, be), sgn_negate(widen3<6>(ce))), e);
    // quad term: (Ao - Ae)(Bo - Be); the differences fit 73 bits
    acc_mul_add(a1, sgn_mul3(sgn_add<3>(ao, sgn_negate(ae)), sgn_add<3>(bo, sgn_negate(be))),
                e);
  }
  Fe s[2] = {redc_signed(a0, F), redc_signed(a1, F)};
  store_block_sums<2, NT>(q, s, partial, F);
  finish_weighted_sums<2, NT>(partial, w, out, ticket, F);
}

// ---------------------------------------------------------------------------
// entries
// ---------------------------------------------------------------------------

static unsigned blocks_for(size_t n, unsigned nt, unsigned cap) {
  size_t b = (n + nt - 1) / nt;
  if (b < 1) b = 1;
  return (unsigned)(b < cap ? b : cap);
}

// Blocks a pair of a round over `pairs` pairs of n columns (mirrored by
// sumcheck/nifs.py _nifs_blocks).
static unsigned nifs_blocks(int pairs, size_t n) {
  size_t cap = 1;
  while (cap * 2 * (size_t)pairs <= (size_t)NIFS_MAX_BLOCKS) cap *= 2;
  return blocks_for(n, NT, (unsigned)cap);
}

static bool bad_grid(int I) { return I < 2 || (I & (I - 1)) != 0 || I > 65536; }

// [a, a + na) and [b, b + nb) bytes overlap
static bool overlap(const void* a, size_t na, const void* b, size_t nb) {
  const char *x = (const char*)a, *y = (const char*)b;
  return x < y + nb && y < x + na;
}

// The fold's output grid: present, and apart from every input row.
static bool bad_fold_out(const Grid3& in, size_t in_bytes, const Grid3& fo,
                         size_t out_bytes) {
  for (int i = 0; i < 3; ++i) {
    if (fo.p[i] == nullptr) return true;
    for (int j = 0; j < 3; ++j)
      if (overlap(fo.p[i], out_bytes, in.p[j], in_bytes)) return true;
  }
  return false;
}

extern "C" int sp2_nifs_round(int I, size_t n, int bind_first, const uint32_t* r_words,
                              const void* A, const void* B, const void* C, void* Ao,
                              void* Bo, void* Co, const void* E, const void* w,
                              void* partial, int nblocks, void* out, void* ticket,
                              const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  const int cur = bind_first ? I / 2 : I;
  if (bad_grid(I) || cur < 2 || out == nullptr || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  const int pairs = cur / 2;
  const unsigned nb = nifs_blocks(pairs, n);
  if (nblocks != (int)nb) return (int)cudaErrorInvalidValue;
  Grid3 in = {{(uint32_t*)A, (uint32_t*)B, (uint32_t*)C}};
  Grid3 fo = {{(uint32_t*)Ao, (uint32_t*)Bo, (uint32_t*)Co}};
  const size_t row = n * 32;
  if (bind_first && bad_fold_out(in, I * row, fo, cur * row))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(nb, (unsigned)pairs);
  uint32_t *part = (uint32_t*)partial, *o = (uint32_t*)out;
  if (bind_first)
    nifs_round_kernel<true><<<grid, NT, 0, s>>>(n, in, fo, (const uint32_t*)E,
                                                fe_from_words(r_words), part,
                                                (const uint32_t*)w, o, (unsigned*)ticket, F);
  else
    nifs_round_kernel<false><<<grid, NT, 0, s>>>(n, in, fo, (const uint32_t*)E,
                                                 fe_zero_host(), part, (const uint32_t*)w, o,
                                                 (unsigned*)ticket, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_nifs_fold(int I, size_t n, const uint32_t* r_words, const void* A,
                             const void* B, const void* C, void* Ao, void* Bo, void* Co,
                             const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  Grid3 in = {{(uint32_t*)A, (uint32_t*)B, (uint32_t*)C}};
  Grid3 fo = {{(uint32_t*)Ao, (uint32_t*)Bo, (uint32_t*)Co}};
  if (bad_grid(I) || bad_fold_out(in, I * n * 32, fo, (I / 2) * n * 32))
    return (int)cudaErrorInvalidValue;
  fold_kernel<<<dim3(blocks_for(n, WF_NT, 4096), 3, (unsigned)(I / 2)), WF_NT, 0,
                (cudaStream_t)stream>>>(n, in, fo, fe_from_words(r_words), F);
  return (int)cudaGetLastError();
}

// rows: I host words of 64 bits, the rows' device addresses.
extern "C" int sp2_weighted_fold(int I, size_t n, const void* w, const uint64_t* rows,
                                 int accumulate, void* out, const uint32_t* field_words,
                                 void* stream) {
  Field F = field_from_words(field_words);
  if (I < 1 || I > WF_MAX_ROWS) return (int)cudaErrorInvalidValue;
  Rows R;
  for (int i = 0; i < WF_MAX_ROWS; ++i)
    R.p[i] = i < I ? (const uint32_t*)rows[i] : nullptr;
  weighted_fold_kernel<<<blocks_for(n, WF_NT, 4096), WF_NT, 0, (cudaStream_t)stream>>>(
      I, n, (const uint32_t*)w, R, accumulate, (uint32_t*)out, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_nifs_to_small(size_t total, const void* A, const void* B, const void* C,
                                 void* out, void* ok, const uint32_t* field_words,
                                 void* stream) {
  Field F = field_from_words(field_words);
  to_small_kernel<<<dim3(blocks_for(total, NT, 4096), 3), NT, 0, (cudaStream_t)stream>>>(
      total, (const uint32_t*)A, (const uint32_t*)B, (const uint32_t*)C,
      (uint32_t*)out, (int*)ok, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_nifs_small_round(int I, size_t n, const void* S, const void* E,
                                    const void* w, void* partial, int nblocks, void* out,
                                    void* ticket, const uint32_t* field_words,
                                    void* stream) {
  Field F = field_from_words(field_words);
  if (bad_grid(I) || out == nullptr || ticket == nullptr) return (int)cudaErrorInvalidValue;
  const int pairs = I / 2;
  const unsigned nb = nifs_blocks(pairs, n);
  if (nblocks != (int)nb) return (int)cudaErrorInvalidValue;
  small_round_kernel<<<dim3(nb, (unsigned)pairs), NT, 0, (cudaStream_t)stream>>>(
      I, n, (const uint32_t*)S, (const uint32_t*)E, (uint32_t*)partial, (const uint32_t*)w,
      (uint32_t*)out, (unsigned*)ticket, F);
  return (int)cudaGetLastError();
}
