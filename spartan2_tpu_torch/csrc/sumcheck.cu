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
// kernel B).  A round is one launch of kernel A: with the previous round's
// bind folded in (sp2_round_bind_evals, as the JAX steps' bind_first,
// zk_device.py:60-67), its sums finished by the last block to arrive.  A
// non-ZK round adds the round finish (round_finish.cu: the round
// polynomial, the device transcript's squeeze, r and 1 - r into device
// memory), whose r the next round's bind reads there; the ZK and
// NeutronNova rounds pull their sums and pass the host's challenge by
// value.  Each sum-check ends with one plain bind (sp2_bind, sp2_bind_dev).
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
//                    shared), the sums, into out (K x sums):
//                    CUBIC  sum_j eq(X) (A(X) B(X) - C(X)) at X = 0, 2, 3
//                    QUAD   sum_j A_lo B_lo and sum_j (A_hi-A_lo)(B_hi-B_lo)
//                    DOT    sum_j A_j B_j
//                    each block's sums to partial, then the last block to
//                    take the atomic ticket adds them (and zeroes the ticket).
//   sp2_round_bind_evals  the same CUBIC or QUAD round over vectors that
//                    still carry the previous round's variable: each thread
//                    binds its four quarter-rows with r (by value, or read
//                    from r_dev) in registers, writes the bound halves in
//                    place and sums from them; the shared eq of K > 1
//                    instances is bound into a second buffer, eq_out.
//   sp2_bind         x_j <- x_lo_j + r (x_hi_j - x_lo_j) for up to four
//                    vectors of K instances (or one, for a shared vector),
//                    in place into the low half.
//   sp2_inner0_evals the structured inner round 0 over abc and z at width
//                    num_cols = num_vars + num_extra (nothing past it is
//                    read; the virtual 2 num_vars domain is zero there):
//                    sum_{j<num_vars} abc_j z_j, sum_{j<num_extra} abc_j z_j
//                    and sum_{j<num_extra} (abc_{nv+j} - abc_j)(z_{nv+j} - z_j),
//                    the extra columns in blocks of their own, finished as
//                    kernel A's.
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
// are latency: a block's chain is about 12 products.  A cubic round with
// its bind reads the four vectors' 4 quarter-rows (512 bytes a pair),
// writes 256 bytes, and does 8 bind products, 3 reduced and 3 unreduced
// products a pair on the carry chains: the products bound it.  Past two
// blocks an SM a thread takes several pairs, so that its one reduction a
// sum is amortized; below, a pair a thread keeps the short rounds'
// latency to one pair's chain.  Round 0 of the inner sum-check (kernel
// B's sums) reads abc and z once at width num_cols instead of the padded
// 2 num_vars and does num_vars + num_extra unreduced products: bytes bound
// it (33.6 MB at SHA-256 1 KiB, 10 us), so its threads load several
// columns before their products.

#include "field.cuh"
#include "finish.cuh"

using namespace sp2;

constexpr int NT = 256;
constexpr int MODE_CUBIC = 0;
constexpr int MODE_QUAD = 1;
constexpr int MODE_DOT = 2;
// Kernel A's and B's grid: a pair (an entry for DOT) a thread up to
// ROUND_MAX_BLOCKS blocks, two an SM of the H100's 132 (at 160-170
// registers a thread one block of NT fits an SM), more pairs a thread past
// that.
constexpr int ROUND_MAX_BLOCKS = 264;

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

// Instance k's vector: ``stride`` elements of 8 words apart.
__device__ __forceinline__ uint32_t* inst(uint32_t* v, int k, size_t stride) {
  return v + (size_t)k * stride * 8;
}

// Pair j of a round over 2q rows: (x[j], x[q + j]).  With BIND the vector
// still carries the previous round's variable over 4q rows: the pair is
// bound with r from its four quarter-rows x[j], x[q + j], x[2q + j],
// x[3q + j] and written back in place (each thread writes only the rows
// j, q + j of its own pairs and reads no row another thread writes).
template <bool BIND>
__device__ __forceinline__ void load_pair(uint32_t* x, size_t q, size_t j, const Fe& r,
                                          Fe& lo, Fe& hi, const Field& F) {
  if (BIND) {
    lo = fe_bind_cc(fe_load(x, j), fe_load(x, 2 * q + j), r, F);
    hi = fe_bind_cc(fe_load(x, q + j), fe_load(x, 3 * q + j), r, F);
    fe_store(x, j, lo);
    fe_store(x, q + j, hi);
  } else {
    lo = fe_load(x, j);
    hi = fe_load(x, q + j);
  }
}

// Kernel A: the round's sums of K instances (instance k's A, B, C start k
// stride rows after the first; eq is shared), one launch, a grid row
// (blockIdx.y) an instance.  With BIND every instance binds the shared eq
// from eq's unbound rows in registers, and instance 0's blocks write it to
// eq_out: in place when K = 1, else into a second buffer, since another
// instance's block may still read the rows it would overwrite.  Each
// product that only feeds a sum is added unreduced (fe_mul_acc) and
// reduced once a thread and sum (acc_reduce).
template <int MODE, bool BIND>
__global__ void __launch_bounds__(NT) round_kernel(size_t work, size_t stride, uint32_t* eq,
                                                   uint32_t* eq_out, uint32_t* A, uint32_t* B,
                                                   uint32_t* C, Fe r, const uint32_t* r_dev,
                                                   uint32_t* partial, uint32_t* out,
                                                   unsigned* ticket, Field F) {
  constexpr int NS = MODE == MODE_CUBIC ? 3 : (MODE == MODE_QUAD ? 2 : 1);
  if (BIND && r_dev != nullptr) r = fe_load(r_dev, 0);
  const size_t q = work;
  const int k = blockIdx.y;
  uint32_t* a = inst(A, k, stride);
  uint32_t* b = inst(B, k, stride);
  Acc s0 = acc_zero(), s1 = acc_zero(), s2 = acc_zero();
  for (size_t j = blockIdx.x * (size_t)NT + threadIdx.x; j < q;
       j += (size_t)gridDim.x * NT) {
    if (MODE == MODE_DOT) {
      fe_mul_acc(s0, fe_load(a, j), fe_load(b, j));
    } else if (MODE == MODE_QUAD) {
      Fe a0, a1, b0, b1;
      load_pair<BIND>(a, q, j, r, a0, a1, F);
      load_pair<BIND>(b, q, j, r, b0, b1, F);
      fe_mul_acc(s0, a0, b0);
      fe_mul_acc(s1, fe_sub_cc(a1, a0, F), fe_sub_cc(b1, b0, F));
    } else {
      Fe e0, e1, a0, a1, b0, b1, c0, c1;
      if (BIND) {
        e0 = fe_bind_cc(fe_load(eq, j), fe_load(eq, 2 * q + j), r, F);
        e1 = fe_bind_cc(fe_load(eq, q + j), fe_load(eq, 3 * q + j), r, F);
        if (k == 0) {
          fe_store(eq_out, j, e0);
          fe_store(eq_out, q + j, e1);
        }
      } else {
        e0 = fe_load(eq, j);
        e1 = fe_load(eq, q + j);
      }
      load_pair<BIND>(a, q, j, r, a0, a1, F);
      load_pair<BIND>(b, q, j, r, b0, b1, F);
      load_pair<BIND>(inst(C, k, stride), q, j, r, c0, c1, F);
      // X = 0
      fe_mul_acc(s0, e0, fe_sub_cc(fe_mul_cc(a0, b0, F), c0, F));
      // X = 2: v(2) = v(1) + d, d = v(1) - v(0)
      const Fe de = fe_sub_cc(e1, e0, F), da = fe_sub_cc(a1, a0, F);
      const Fe db = fe_sub_cc(b1, b0, F), dc = fe_sub_cc(c1, c0, F);
      e1 = fe_add_cc(e1, de, F);
      a1 = fe_add_cc(a1, da, F);
      b1 = fe_add_cc(b1, db, F);
      c1 = fe_add_cc(c1, dc, F);
      fe_mul_acc(s1, e1, fe_sub_cc(fe_mul_cc(a1, b1, F), c1, F));
      // X = 3: v(3) = v(2) + d
      e1 = fe_add_cc(e1, de, F);
      a1 = fe_add_cc(a1, da, F);
      b1 = fe_add_cc(b1, db, F);
      c1 = fe_add_cc(c1, dc, F);
      fe_mul_acc(s2, e1, fe_sub_cc(fe_mul_cc(a1, b1, F), c1, F));
    }
  }
  Fe s[3];
  s[0] = acc_reduce(s0, F);
  if (NS > 1) s[1] = acc_reduce(s1, F);
  if (NS > 2) s[2] = acc_reduce(s2, F);
  store_block_sums<NS, NT>(k, s, partial, F);
  finish_sums<NS, NT>(partial, out, ticket, F);
}

// The structured inner round 0 (kernel B): per instance k = blockIdx.y,
// eval0 = sum_{j<nv} a_j z_j, corr_low = sum_{j<ne} a_j z_j and corr_cross =
// sum_{j<ne} (a_{nv+j} - a_j)(z_{nv+j} - z_j), the products unreduced.
// The grid's first nextra blocks take the ne extra columns, a column a
// thread (four loads, two products); the other blocks take columns ne ..
// nv - 1 for eval0 alone, one 17-word sum a thread, in chunks of B_NT
// B_U columns: a thread loads its B_U columns of a chunk (stride B_NT)
// before their products, so their loads are in flight together and their
// products independent.  An extra block's columns add to eval0 what they
// add to corr_low, so its partial row is (corr_low, corr_low, corr_cross)
// and a main block's (eval0, 0, 0); the last block adds the rows
// (finish.cuh).
constexpr int B_NT = 256;
constexpr int B_U = 4;
constexpr int B_BLOCKS_PER_SM = 2;

__global__ void __launch_bounds__(B_NT, B_BLOCKS_PER_SM) inner0_evals_kernel(
    size_t num_vars, size_t num_extra, size_t stride, int nextra, const uint32_t* abc,
    const uint32_t* z, uint32_t* partial, uint32_t* out, unsigned* ticket, Field F) {
  const int k = blockIdx.y, t = threadIdx.x;
  const uint32_t* a_k = abc + (size_t)k * stride * 8;
  const uint32_t* z_k = z + (size_t)k * stride * 8;
  Fe s[3];
  if ((int)blockIdx.x < nextra) {
    Acc low = acc_zero(), cross = acc_zero();
    for (size_t j = blockIdx.x * (size_t)B_NT + t; j < num_extra; j += (size_t)nextra * B_NT) {
      const Fe a = fe_load(a_k, j), x = fe_load(z_k, j);
      const Fe ah = fe_load(a_k, num_vars + j), xh = fe_load(z_k, num_vars + j);
      fe_mul_acc(low, a, x);
      fe_mul_acc(cross, fe_sub_cc(ah, a, F), fe_sub_cc(xh, x, F));
    }
    s[1] = acc_reduce(low, F);
    s[2] = acc_reduce(cross, F);
    block_sums<B_NT, 2>(s + 1, F);
    s[0] = s[1];
  } else {
    const size_t chunk = (size_t)B_NT * B_U;
    Acc e0 = acc_zero();
    for (size_t j0 = num_extra + (blockIdx.x - nextra) * chunk + t; j0 < num_vars;
         j0 += (gridDim.x - nextra) * chunk) {
      Fe a[B_U], x[B_U];
#pragma unroll
      for (int u = 0; u < B_U; ++u) {
        const size_t j = j0 + (size_t)u * B_NT;
        if (j < num_vars) {
          a[u] = fe_load(a_k, j);
          x[u] = fe_load(z_k, j);
        }
      }
#pragma unroll
      for (int u = 0; u < B_U; ++u)
        if (j0 + (size_t)u * B_NT < num_vars) fe_mul_acc(e0, a[u], x[u]);
    }
    s[0] = acc_reduce(e0, F);
    block_sums<B_NT, 1>(s, F);
    s[1] = s[2] = fe_zero();
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      fe_store(partial, ((size_t)k * gridDim.x + blockIdx.x) * 3 + i, s[i]);
  }
  finish_sums<3, B_NT>(partial, out, ticket, F);
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
    fe_store(x, j, fe_bind_cc(fe_load(x, j), fe_load(x, half + j), r, F));
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

// Kernel A's grid over ``work`` pairs (entries for DOT): the
// wrapper sizes the partial sums by it.
static int round_blocks(size_t work) {
  const size_t b = (work + NT - 1) / NT;
  return b < 1 ? 1 : (b > ROUND_MAX_BLOCKS ? ROUND_MAX_BLOCKS : (int)b);
}

static int check_instances(int K) {
  return (K < 1 || K > 65535) ? (int)cudaErrorInvalidValue : 0;
}

// Kernel A's launch: one grid of nblocks over the pairs (entries for DOT);
// the sums land in out (K x sums), partial and ticket are its scratch.
template <bool BIND>
static int round_launch(int mode, size_t work, int K, size_t stride, void* eq, void* eq_out,
                        void* A, void* B, void* C, Fe r, const void* r_dev, void* partial,
                        int nblocks, void* out, void* ticket, const Field& F,
                        cudaStream_t s) {
  if (check_instances(K) || nblocks != round_blocks(work) || out == nullptr ||
      ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  if (eq_out == nullptr) eq_out = eq;
  if (BIND && mode == MODE_CUBIC && K > 1 && eq_out == eq)
    return (int)cudaErrorInvalidValue;  // the shared eq's bind needs its own buffer
  uint32_t *e = (uint32_t*)eq, *eo = (uint32_t*)eq_out, *a = (uint32_t*)A,
           *b = (uint32_t*)B, *c = (uint32_t*)C;
  const uint32_t* rd = (const uint32_t*)r_dev;
  uint32_t *part = (uint32_t*)partial, *o = (uint32_t*)out;
  unsigned* t = (unsigned*)ticket;
  const dim3 grid((unsigned)nblocks, (unsigned)K);
  if (mode == MODE_CUBIC)
    round_kernel<MODE_CUBIC, BIND><<<grid, NT, 0, s>>>(work, stride, e, eo, a, b, c, r, rd,
                                                       part, o, t, F);
  else if (mode == MODE_QUAD)
    round_kernel<MODE_QUAD, BIND><<<grid, NT, 0, s>>>(work, stride, e, eo, a, b, c, r, rd,
                                                      part, o, t, F);
  else if (mode == MODE_DOT && !BIND)
    round_kernel<MODE_DOT, false><<<grid, NT, 0, s>>>(work, stride, e, eo, a, b, c, r, rd,
                                                      part, o, t, F);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int sp2_round_evals(int mode, size_t work, int K, size_t stride,
                               void* eq, void* A, void* B, void* C, void* partial,
                               int nblocks, void* out, void* ticket,
                               const uint32_t* field_words, void* stream) {
  return round_launch<false>(mode, work, K, stride, eq, nullptr, A, B, C, fe_zero_host(),
                             nullptr, partial, nblocks, out, ticket,
                             field_from_words(field_words), (cudaStream_t)stream);
}

// The bind of the previous round's r (host words, or r_dev when given)
// folded into the round: the vectors carry 4 work rows, bound in place to
// 2 work; the shared eq is bound into eq_out (in place when null).
extern "C" int sp2_round_bind_evals(int mode, size_t work, int K, size_t stride,
                                    void* eq, void* eq_out, void* A, void* B, void* C,
                                    const uint32_t* r_words, const void* r_dev,
                                    void* partial, int nblocks, void* out, void* ticket,
                                    const uint32_t* field_words, void* stream) {
  return round_launch<true>(mode, work, K, stride, eq, eq_out, A, B, C,
                            r_dev != nullptr ? fe_zero_host() : fe_from_words(r_words),
                            r_dev, partial, nblocks, out, ticket,
                            field_from_words(field_words), (cudaStream_t)stream);
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

// Kernel B's grid: the extra columns a column a thread in at most
// INNER0_MAX_EXTRA blocks, the rest a chunk a block up to B_BLOCKS_PER_SM
// blocks an SM of the H100's 132 in all, more chunks a block past that.
constexpr int INNER0_MAX_EXTRA = 132;
constexpr int INNER0_MAX_BLOCKS = 132 * B_BLOCKS_PER_SM;
static void inner0_blocks(size_t num_vars, size_t num_extra, int* nmain, int* nextra) {
  const size_t e = (num_extra + B_NT - 1) / B_NT;
  *nextra = e > INNER0_MAX_EXTRA ? INNER0_MAX_EXTRA : (int)e;
  const size_t m = (num_vars - num_extra + (size_t)B_NT * B_U - 1) / ((size_t)B_NT * B_U);
  const size_t cap = (size_t)(INNER0_MAX_BLOCKS - *nextra);
  *nmain = (int)(m < cap ? m : cap);
}

extern "C" int sp2_inner0_evals(size_t num_vars, size_t num_extra, int K,
                                size_t stride, const void* abc, const void* z,
                                void* partial, int nblocks, void* out, void* ticket,
                                const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  int nmain, nextra;
  if (check_instances(K) || num_extra > num_vars || out == nullptr || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  inner0_blocks(num_vars, num_extra, &nmain, &nextra);
  if (nmain + nextra < 1 || nblocks != nmain + nextra) return (int)cudaErrorInvalidValue;
  inner0_evals_kernel<<<dim3((unsigned)nblocks, (unsigned)K), B_NT, 0, (cudaStream_t)stream>>>(
      num_vars, num_extra, stride, nextra, (const uint32_t*)abc, (const uint32_t*)z,
      (uint32_t*)partial, (uint32_t*)out, (unsigned*)ticket, F);
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
