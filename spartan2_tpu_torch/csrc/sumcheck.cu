// Kernel 2: sum-check rounds and the eq table, with kernels A (rounds
// batched over K instances) and B (the structured inner round 0).
//
// Replaces the sums of the JAX package's per-round provers
// (spartan2_tpu/sumcheck/prove.py: sc_cubic_step :244 with its explicit eq
// table, sc_quad_step/_tail :337/:344) and of the fused quad
// (sumcheck/fused.py FusedSumcheckQuad._kernel :464), the eq tables
// (polys/eq.py eq_evals_device :79, eq_table / eq_evals_device_oneshot
// :116/:135), the power table of NeutronNova's NIFS (polys/eq.py
// pow_evals_device :97, jitted by _pow_table_jit :121 under fastkey
// "pow_table", called through pow_evals_device_oneshot :128), the ZK rounds (sumcheck/zk_device.py zk_cubic_step/_final
// :102/:116, zk_quad_step/_final :190/:201: kernel A) and the structured
// inner round 0 (zk_device.py zk_inner0_evals/_bind :284/:308, which
// also serves the non-ZK SpartanInnerRound0, sumcheck/prove.py:627:
// kernel B).  A non-ZK round is this file's partial sums (out = NULL
// leaves them per block), the round finish (round_finish.cu: the round
// polynomial, the device transcript's squeeze, r and 1 - r into device
// memory) and a bind that reads r from there (sp2_bind_dev,
// sp2_inner0_bind_dev), all enqueued with no host round trip.  The ZK and
// NeutronNova rounds take their challenges from the host (a reduced
// evaluation launch, a pull, sp2_bind with r by value).
//
// Entries:
//   sp2_eq_table     out[i] = prod_j (bit_j(i) ? r_j : 1 - r_j), where r_0
//                    drives the most significant index bit (eq.py:79-94).
//                    One product an element: a block owns a prefix of the
//                    top m - 10 bits and writes its 2^10 elements as
//                    prefix * A[hi] * B[lo], A and B the doubling tables of
//                    the next 5 and the last 5 bits, built in the block
//                    (eq_tables_kernel, on the carry-chain product).
//   sp2_eq_tables    the same for a list of tables in one launch (factors
//                    and outputs back to back): the outer sum-check's plan.
//   sp2_pow_table    out[k] = prod_j (bit_j(k) ? g_j : 1) = t^k from the m
//                    powers g_j = t^(2^(m-1-j)); g_0 drives the most
//                    significant index bit, as in the eq table.
//   sp2_round_evals  per instance k < K (instance k's vectors start k *
//                    stride elements after the first; the eq vector is
//                    shared), per-block partial sums then one reduction
//                    block per instance:
//                    CUBIC  sum_j eq(X) (A(X) B(X) - C(X)) at X = 0, 2, 3
//                    QUAD   sum_j A_lo B_lo and sum_j (A_hi-A_lo)(B_hi-B_lo)
//                    DOT    sum_j A_j B_j
//   sp2_bind         x_j <- x_lo_j + r (x_hi_j - x_lo_j) for up to four
//                    vectors of K instances (or one, for a shared vector),
//                    in place into the low half.
//   sp2_inner0_evals the structured inner round 0 over abc and z at width
//                    num_cols = num_vars + num_extra (nothing past it is
//                    read; the virtual 2 num_vars domain is zero there):
//                    sum_{j<num_vars} abc_j z_j, sum_{j<num_extra} abc_j z_j
//                    and sum_{j<num_extra} (abc_{nv+j} - abc_j)(z_{nv+j} - z_j).
//   sp2_inner0_bind  in place into width num_vars: x_j + r (x_{nv+j} - x_j)
//                    for j < num_extra, (1 - r) x_j for the rest.
//   sp2_bind_dev, sp2_inner0_bind_dev  the same binds of up to four vectors
//                    of one instance, with r (and 1 - r) read from device
//                    memory; the second is also the peeled outer round 0's
//                    bind (live rows bound, the zero tail scaled by 1 - r).
//
// An explicit eq table is bound alongside A, B, C, so any tau works,
// including tau in {0, 1} where the JAX Gruen split had to fall back.
//
// Bound: the eq table writes 2^m elements of 32 bytes and needs one
// Montgomery product each; at 2^20 the products bound it (16 us at the
// card's multiply rate, 10 us of stores); the outer plan's 20 small tables
// are latency: a block's chain is about 12 products.  A cubic round reads
// 4 halves-pairs (256 bytes per pair) and does 6 Montgomery products per
// pair; the products bound it.  Round 0
// of the inner sum-check reads abc and z once at width num_cols instead
// of the padded 2 num_vars, and does num_vars + 2 num_extra products.

#include "field.cuh"

using namespace sp2;

constexpr int NT = 256;
constexpr int MODE_CUBIC = 0;
constexpr int MODE_QUAD = 1;
constexpr int MODE_DOT = 2;

// Tables of one eq-table launch: table k has m[k] variables, its factors
// [r_0 .. r_{m-1}, 1 - r_0 .. 1 - r_{m-1}] at rs[fac[k]], its 2^m[k]
// elements at out[first[k]], its blocks from block0[k].
constexpr int EQ_MAX_TABLES = 64;
constexpr int EQ_LOW_BITS = 10;  // elements a block writes: 2^10, 4 a thread

struct EqPlan {
  int n;
  int m[EQ_MAX_TABLES];
  int fac[EQ_MAX_TABLES];
  long long first[EQ_MAX_TABLES];
  int block0[EQ_MAX_TABLES + 1];
};

// T[x] for x < 2^nb: the product of factors j0 .. j0 + nb - 1, each r_j or
// 1 - r_j by a bit of x (j0 on the top bit), built by doubling in shared
// memory by one warp.
__device__ __forceinline__ void eq_doubling(Fe* T, const Fe* r, int m, int j0, int nb,
                                            const Field& F) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) T[0] = fe_one(F);
  __syncwarp();
  for (int s = 0; s < nb; ++s) {
    Fe lo, hi;
    if (lane < (1 << s)) {
      const Fe o = T[lane];
      lo = fe_mul_cc(o, r[m + j0 + s], F);
      hi = fe_mul_cc(o, r[j0 + s], F);
    }
    __syncwarp();
    if (lane < (1 << s)) {
      T[2 * lane] = lo;
      T[2 * lane + 1] = hi;
    }
    __syncwarp();
  }
}

// Block b of table k writes the 2^b elements under one prefix of the top
// m - b bits (b = min(m, 10)): warp 0 builds A over the next b1 = b / 2
// bits and warp 1 B over the last b2 = b - b1, by doubling; warp 2 forms
// the prefix's product; then A' = prefix A, and element t = A'[t >> b2]
// B[t & (2^b2 - 1)]: one product an element, neighbouring threads on
// neighbouring elements.
__global__ void __launch_bounds__(NT) eq_tables_kernel(const Fe* rs, uint32_t* out,
                                                       EqPlan plan, Field F) {
  __shared__ Fe A[1 << (EQ_LOW_BITS / 2)], B[1 << (EQ_LOW_BITS - EQ_LOW_BITS / 2)];
  __shared__ Fe base;
  int k = 0;
  while ((int)blockIdx.x >= plan.block0[k + 1]) ++k;
  const int m = plan.m[k];
  const Fe* r = rs + plan.fac[k];
  const int b = m < EQ_LOW_BITS ? m : EQ_LOW_BITS, top = m - b;
  const int b1 = b / 2, b2 = b - b1;
  const size_t prefix = blockIdx.x - plan.block0[k];
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    eq_doubling(A, r, m, top, b1, F);
  } else if (warp == 1) {
    eq_doubling(B, r, m, top + b1, b2, F);
  } else if (threadIdx.x == 64) {
    Fe acc = fe_one(F);
    for (int j = 0; j < top; ++j)
      acc = fe_mul_cc(acc, (prefix >> (top - 1 - j)) & 1 ? r[j] : r[m + j], F);
    base = acc;
  }
  __syncthreads();
  if ((int)threadIdx.x < (1 << b1)) A[threadIdx.x] = fe_mul_cc(base, A[threadIdx.x], F);
  __syncthreads();
  uint32_t* o = out + 8 * (plan.first[k] + ((size_t)prefix << b));
  for (int t = threadIdx.x; t < (1 << b); t += NT)
    fe_store(o, t, fe_mul_cc(A[t >> b2], B[t & ((1 << b2) - 1)], F));
}

__global__ void pow_table_kernel(int m, const Fe* gs, uint32_t* out, Field F) {
  __shared__ Fe sg[64];
  for (int j = threadIdx.x; j < m; j += blockDim.x) sg[j] = gs[j];
  __syncthreads();
  const size_t n = (size_t)1 << m;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    Fe acc = fe_one(F);
    for (int j = 0; j < m; ++j)
      if ((i >> (m - 1 - j)) & 1) acc = fe_mul(acc, sg[j], F);
    fe_store(out, i, acc);
  }
}

// Instance blockIdx.y's vector: ``stride`` elements of 8 words apart.
__device__ __forceinline__ const uint32_t* inst(const uint32_t* v, size_t stride) {
  return v + (size_t)blockIdx.y * stride * 8;
}

template <int MODE>
__global__ void round_evals_kernel(size_t half, size_t stride, const uint32_t* eq,
                                   const uint32_t* A, const uint32_t* B,
                                   const uint32_t* C, uint32_t* partial,
                                   Field F) {
  A = inst(A, stride);
  B = inst(B, stride);
  if (MODE == MODE_CUBIC) C = inst(C, stride);
  Fe s0 = fe_zero(), s1 = fe_zero(), s2 = fe_zero();
  for (size_t j = blockIdx.x * (size_t)NT + threadIdx.x; j < half;
       j += (size_t)gridDim.x * NT) {
    if (MODE == MODE_DOT) {
      s0 = fe_add(s0, fe_mul(fe_load(A, j), fe_load(B, j), F), F);
    } else if (MODE == MODE_QUAD) {
      Fe a0 = fe_load(A, j), a1 = fe_load(A, half + j);
      Fe b0 = fe_load(B, j), b1 = fe_load(B, half + j);
      s0 = fe_add(s0, fe_mul(a0, b0, F), F);
      s1 = fe_add(s1, fe_mul(fe_sub(a1, a0, F), fe_sub(b1, b0, F), F), F);
    } else {
      Fe e0 = fe_load(eq, j), a0 = fe_load(A, j), b0 = fe_load(B, j), c0 = fe_load(C, j);
      Fe de = fe_sub(fe_load(eq, half + j), e0, F);
      Fe da = fe_sub(fe_load(A, half + j), a0, F);
      Fe db = fe_sub(fe_load(B, half + j), b0, F);
      Fe dc = fe_sub(fe_load(C, half + j), c0, F);
      // X = 0
      s0 = fe_add(s0, fe_mul(e0, fe_sub(fe_mul(a0, b0, F), c0, F), F), F);
      // X = 2: v(2) = v(0) + 2 d
      Fe e2 = fe_add(e0, fe_double(de, F), F);
      Fe a2 = fe_add(a0, fe_double(da, F), F);
      Fe b2 = fe_add(b0, fe_double(db, F), F);
      Fe c2 = fe_add(c0, fe_double(dc, F), F);
      s1 = fe_add(s1, fe_mul(e2, fe_sub(fe_mul(a2, b2, F), c2, F), F), F);
      // X = 3: v(3) = v(2) + d
      Fe e3 = fe_add(e2, de, F), a3 = fe_add(a2, da, F);
      Fe b3 = fe_add(b2, db, F), c3 = fe_add(c2, dc, F);
      s2 = fe_add(s2, fe_mul(e3, fe_sub(fe_mul(a3, b3, F), c3, F), F), F);
    }
  }
  constexpr int NS = MODE == MODE_CUBIC ? 3 : (MODE == MODE_QUAD ? 2 : 1);
  store_partials<NS, NT>(s0, s1, s2, partial, F);
}

// out[k, t] = sum_b partial[k, b, t], one block per instance k
__global__ void sum_partials_kernel(int nparts, int NS, const uint32_t* partial,
                                    uint32_t* out, Field F) {
  const size_t base = (size_t)blockIdx.x * nparts * NS;
  for (int t = 0; t < NS; ++t) {
    Fe s = fe_zero();
    for (int b = threadIdx.x; b < nparts; b += NT)
      s = fe_add(s, fe_load(partial, base + (size_t)b * NS + t), F);
    s = block_sum<NT>(s, F);
    if (threadIdx.x == 0) fe_store(out, (size_t)blockIdx.x * NS + t, s);
  }
}

// The structured inner round 0 (kernel B): per instance blockIdx.y, the
// three product sums over abc and z at width num_vars + num_extra.
__global__ void inner0_evals_kernel(size_t num_vars, size_t num_extra, size_t stride,
                                    const uint32_t* abc, const uint32_t* z,
                                    uint32_t* partial, Field F) {
  abc = inst(abc, stride);
  z = inst(z, stride);
  Fe s0 = fe_zero(), s1 = fe_zero(), s2 = fe_zero();
  for (size_t j = blockIdx.x * (size_t)NT + threadIdx.x; j < num_vars;
       j += (size_t)gridDim.x * NT) {
    Fe a = fe_load(abc, j), x = fe_load(z, j);
    Fe prod = fe_mul(a, x, F);
    s0 = fe_add(s0, prod, F);
    if (j < num_extra) {
      s1 = fe_add(s1, prod, F);
      Fe da = fe_sub(fe_load(abc, num_vars + j), a, F);
      Fe dz = fe_sub(fe_load(z, num_vars + j), x, F);
      s2 = fe_add(s2, fe_mul(da, dz, F), F);
    }
  }
  store_partials<3, NT>(s0, s1, s2, partial, F);
}

struct Vec4 {
  uint32_t* p[4];
};

// Vector blockIdx.y of instance blockIdx.z; a vector whose bit is set in
// ``shared`` has one instance.
__device__ __forceinline__ uint32_t* inst_vec(const Vec4& v, int shared,
                                              size_t stride) {
  if ((shared >> blockIdx.y) & 1) return blockIdx.z ? nullptr : v.p[blockIdx.y];
  return v.p[blockIdx.y] + (size_t)blockIdx.z * stride * 8;
}

// r is the host value, or read from r_dev when that is given (the round
// finish wrote it there).
__global__ void bind_kernel(size_t half, size_t stride, int shared, Vec4 v, Fe r,
                            const uint32_t* r_dev, Field F) {
  uint32_t* x = inst_vec(v, shared, stride);
  if (x == nullptr) return;
  if (r_dev != nullptr) r = fe_load(r_dev, 0);
  for (size_t j = blockIdx.x * (size_t)blockDim.x + threadIdx.x; j < half;
       j += (size_t)gridDim.x * blockDim.x) {
    Fe lo = fe_load(x, j);
    Fe hi = fe_load(x, half + j);
    fe_store(x, j, fe_add(lo, fe_mul(r, fe_sub(hi, lo, F), F), F));
  }
}

// Kernel B's bind, in place into width num_vars (each j reads only j and
// num_vars + j, and writes j < num_vars); r and 1 - r are host values, or
// read from r_dev[0] and r_dev[1] when that is given.
__global__ void inner0_bind_kernel(size_t num_vars, size_t num_extra, size_t stride,
                                   Vec4 v, Fe r, Fe one_minus_r, const uint32_t* r_dev,
                                   Field F) {
  uint32_t* x = inst_vec(v, 0, stride);
  if (r_dev != nullptr) {
    r = fe_load(r_dev, 0);
    one_minus_r = fe_load(r_dev, 1);
  }
  for (size_t j = blockIdx.x * (size_t)blockDim.x + threadIdx.x; j < num_vars;
       j += (size_t)gridDim.x * blockDim.x) {
    Fe lo = fe_load(x, j);
    if (j < num_extra) {
      Fe hi = fe_load(x, num_vars + j);
      fe_store(x, j, fe_add(lo, fe_mul(r, fe_sub(hi, lo, F), F), F));
    } else {
      fe_store(x, j, fe_mul(one_minus_r, lo, F));
    }
  }
}

static unsigned blocks_for(size_t n, unsigned cap) {
  size_t b = (n + NT - 1) / NT;
  if (b < 1) b = 1;
  return (unsigned)(b < cap ? b : cap);
}

// Tables of m[0 .. n) variables, factors back to back in rs (2 m[k] each),
// outputs back to back in out (2^m[k] elements each).
extern "C" int sp2_eq_tables(int n, const int* ms, const void* rs, void* out,
                             const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (n < 1 || n > EQ_MAX_TABLES) return (int)cudaErrorInvalidValue;
  EqPlan plan;
  plan.n = n;
  int fac = 0, blocks = 0;
  long long first = 0;
  for (int k = 0; k < n; ++k) {
    const int m = ms[k];
    if (m < 0 || m > 40) return (int)cudaErrorInvalidValue;
    plan.m[k] = m;
    plan.fac[k] = fac;
    plan.first[k] = first;
    plan.block0[k] = blocks;
    fac += 2 * m;
    first += 1LL << m;
    const long long nb = 1LL << (m > EQ_LOW_BITS ? m - EQ_LOW_BITS : 0);
    if (blocks + nb > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    blocks += (int)nb;
  }
  plan.block0[n] = blocks;
  eq_tables_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>((const Fe*)rs, (uint32_t*)out,
                                                            plan, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_eq_table(int m, const void* rs, void* out,
                            const uint32_t* field_words, void* stream) {
  return sp2_eq_tables(1, &m, rs, out, field_words, stream);
}

extern "C" int sp2_pow_table(int m, const void* gs, void* out,
                             const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (m < 0 || m > 40) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)1 << m;
  pow_table_kernel<<<blocks_for(n, 65535), NT, 0, (cudaStream_t)stream>>>(
      m, (const Fe*)gs, (uint32_t*)out, F);
  return (int)cudaGetLastError();
}

static int check_instances(int K) {
  return (K < 1 || K > 65535) ? (int)cudaErrorInvalidValue : 0;
}

extern "C" int sp2_round_evals(int mode, size_t half, int K, size_t stride,
                               const void* eq, const void* A, const void* B,
                               const void* C, void* partial, int nblocks, void* out,
                               const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (check_instances(K)) return check_instances(K);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *e = (const uint32_t*)eq, *a = (const uint32_t*)A,
                 *b = (const uint32_t*)B, *c = (const uint32_t*)C;
  uint32_t* part = (uint32_t*)partial;
  dim3 grid((unsigned)nblocks, (unsigned)K);
  int NS;
  if (mode == MODE_CUBIC) {
    round_evals_kernel<MODE_CUBIC><<<grid, NT, 0, s>>>(half, stride, e, a, b, c, part, F);
    NS = 3;
  } else if (mode == MODE_QUAD) {
    round_evals_kernel<MODE_QUAD><<<grid, NT, 0, s>>>(half, stride, e, a, b, c, part, F);
    NS = 2;
  } else if (mode == MODE_DOT) {
    round_evals_kernel<MODE_DOT><<<grid, NT, 0, s>>>(half, stride, e, a, b, c, part, F);
    NS = 1;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err || out == nullptr) return err;
  sum_partials_kernel<<<K, NT, 0, s>>>(nblocks, NS, part, (uint32_t*)out, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_bind(size_t half, int K, size_t stride, int nvec, int shared,
                        void* v0, void* v1, void* v2, void* v3,
                        const uint32_t* r_words, const uint32_t* field_words,
                        void* stream) {
  Field F = field_from_words(field_words);
  if (nvec < 1 || nvec > 4 || check_instances(K)) return (int)cudaErrorInvalidValue;
  Vec4 v = {{(uint32_t*)v0, (uint32_t*)v1, (uint32_t*)v2, (uint32_t*)v3}};
  dim3 grid(blocks_for(half, 4096), (unsigned)nvec, (unsigned)K);
  bind_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(half, stride, shared, v,
                                                     fe_from_words(r_words), nullptr, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_bind_dev(size_t half, int nvec, void* v0, void* v1, void* v2, void* v3,
                            const void* r_dev, const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (nvec < 1 || nvec > 4) return (int)cudaErrorInvalidValue;
  Vec4 v = {{(uint32_t*)v0, (uint32_t*)v1, (uint32_t*)v2, (uint32_t*)v3}};
  dim3 grid(blocks_for(half, 4096), (unsigned)nvec, 1);
  bind_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(half, 0, 0, v, fe_zero_host(),
                                                     (const uint32_t*)r_dev, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_inner0_evals(size_t num_vars, size_t num_extra, int K,
                                size_t stride, const void* abc, const void* z,
                                void* partial, int nblocks, void* out,
                                const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (check_instances(K) || num_extra > num_vars) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)nblocks, (unsigned)K);
  inner0_evals_kernel<<<grid, NT, 0, s>>>(num_vars, num_extra, stride,
                                          (const uint32_t*)abc, (const uint32_t*)z,
                                          (uint32_t*)partial, F);
  int err = (int)cudaGetLastError();
  if (err || out == nullptr) return err;
  sum_partials_kernel<<<K, NT, 0, s>>>(nblocks, 3, (const uint32_t*)partial,
                                       (uint32_t*)out, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_inner0_bind(size_t num_vars, size_t num_extra, int K,
                               size_t stride, void* abc, void* z,
                               const uint32_t* r_words,
                               const uint32_t* one_minus_r_words,
                               const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (check_instances(K) || num_extra > num_vars) return (int)cudaErrorInvalidValue;
  Vec4 v = {{(uint32_t*)abc, (uint32_t*)z, nullptr, nullptr}};
  dim3 grid(blocks_for(num_vars, 4096), 2, (unsigned)K);
  inner0_bind_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      num_vars, num_extra, stride, v, fe_from_words(r_words),
      fe_from_words(one_minus_r_words), nullptr, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_inner0_bind_dev(size_t num_vars, size_t num_extra, int nvec, void* v0,
                                   void* v1, void* v2, void* v3, const void* r_dev,
                                   const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (nvec < 1 || nvec > 4 || num_extra > num_vars) return (int)cudaErrorInvalidValue;
  Vec4 v = {{(uint32_t*)v0, (uint32_t*)v1, (uint32_t*)v2, (uint32_t*)v3}};
  dim3 grid(blocks_for(num_vars, 4096), (unsigned)nvec, 1);
  inner0_bind_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      num_vars, num_extra, 0, v, fe_zero_host(), fe_zero_host(), (const uint32_t*)r_dev, F);
  return (int)cudaGetLastError();
}
