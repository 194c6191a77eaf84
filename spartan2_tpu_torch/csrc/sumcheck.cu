// Kernel 2: sum-check rounds and the eq table.
//
// Replaces the JAX package's fused sum-check programs
// (spartan2_tpu/sumcheck/fused.py: FusedSumcheckCubicEq._peel_kernel
// :307 and _kernel :213, FusedSumcheckQuad._kernel :464), the inner round
// 0 (sumcheck/prove.py SpartanInnerRound0._step :627) and the eq table
// (polys/eq.py eq_evals_device :79).  The JAX programs ran every round and
// the Keccak transcript inside one launch; here a round is one evaluation
// launch pair and one bind launch, and the host squeezes each challenge
// from the 3 or 2 evaluations it pulls.
//
// Entries:
//   sp2_eq_table     out[i] = prod_j (bit_j(i) ? r_j : 1 - r_j), where r_0
//                    drives the most significant index bit (eq.py:79-94).
//   sp2_round_evals  per-block partial sums then one reduction block:
//                    CUBIC  sum_j eq(X) (A(X) B(X) - C(X)) at X = 0, 2, 3
//                    QUAD   sum_j A_lo B_lo and sum_j (A_hi-A_lo)(B_hi-B_lo)
//                    DOT    sum_j A_j B_j
//   sp2_bind         x_j <- x_lo_j + r (x_hi_j - x_lo_j) for up to four
//                    vectors, in place into the low half.
//
// An explicit eq table is bound alongside A, B, C, so any tau works,
// including tau in {0, 1} where the JAX Gruen split had to fall back.
//
// Bound: a cubic round reads 4 halves-pairs (256 bytes per pair) and
// does 6 Montgomery products per pair; the products bound it.

#include "field.cuh"

using namespace sp2;

constexpr int NT = 256;
constexpr int MODE_CUBIC = 0;
constexpr int MODE_QUAD = 1;
constexpr int MODE_DOT = 2;

__global__ void eq_table_kernel(int m, const Fe* rs, uint32_t* out, Field F) {
  // rs: 2m factors in Montgomery form, r_j then (1 - r_j)
  __shared__ Fe sr[128];
  for (int j = threadIdx.x; j < 2 * m; j += blockDim.x) sr[j] = rs[j];
  __syncthreads();
  const size_t n = (size_t)1 << m;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    Fe acc = fe_one(F);
    for (int j = 0; j < m; ++j) {
      const int bit = (int)((i >> (m - 1 - j)) & 1);
      acc = fe_mul(acc, bit ? sr[j] : sr[m + j], F);
    }
    fe_store(out, i, acc);
  }
}

template <int MODE>
__global__ void round_evals_kernel(size_t half, const uint32_t* eq,
                                   const uint32_t* A, const uint32_t* B,
                                   const uint32_t* C, uint32_t* partial,
                                   Field F) {
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
  constexpr int K = MODE == MODE_CUBIC ? 3 : (MODE == MODE_QUAD ? 2 : 1);
  Fe t0 = block_sum<NT>(s0, F);
  if (threadIdx.x == 0) fe_store(partial, (size_t)blockIdx.x * K, t0);
  if (K > 1) {
    Fe t1 = block_sum<NT>(s1, F);
    if (threadIdx.x == 0) fe_store(partial, (size_t)blockIdx.x * K + 1, t1);
  }
  if (K > 2) {
    Fe t2 = block_sum<NT>(s2, F);
    if (threadIdx.x == 0) fe_store(partial, (size_t)blockIdx.x * K + 2, t2);
  }
}

// out[k] = sum_b partial[b * K + k], one block
__global__ void sum_partials_kernel(int nparts, int K, const uint32_t* partial,
                                    uint32_t* out, Field F) {
  for (int k = 0; k < K; ++k) {
    Fe s = fe_zero();
    for (int b = threadIdx.x; b < nparts; b += NT)
      s = fe_add(s, fe_load(partial, (size_t)b * K + k), F);
    s = block_sum<NT>(s, F);
    if (threadIdx.x == 0) fe_store(out, k, s);
  }
}

struct Vec4 {
  uint32_t* p[4];
};

__global__ void bind_kernel(size_t half, Vec4 v, Fe r, Field F) {
  uint32_t* x = v.p[blockIdx.y];
  for (size_t j = blockIdx.x * (size_t)blockDim.x + threadIdx.x; j < half;
       j += (size_t)gridDim.x * blockDim.x) {
    Fe lo = fe_load(x, j);
    Fe hi = fe_load(x, half + j);
    fe_store(x, j, fe_add(lo, fe_mul(r, fe_sub(hi, lo, F), F), F));
  }
}

static unsigned blocks_for(size_t n, unsigned cap) {
  size_t b = (n + NT - 1) / NT;
  if (b < 1) b = 1;
  return (unsigned)(b < cap ? b : cap);
}

extern "C" int sp2_eq_table(int m, const void* rs, void* out,
                            const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (m > 40) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)1 << m;
  eq_table_kernel<<<blocks_for(n, 65535), NT, 0, (cudaStream_t)stream>>>(
      m, (const Fe*)rs, (uint32_t*)out, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_round_evals(int mode, size_t half, const void* eq, const void* A,
                               const void* B, const void* C, void* partial,
                               int nblocks, void* out,
                               const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *e = (const uint32_t*)eq, *a = (const uint32_t*)A,
                 *b = (const uint32_t*)B, *c = (const uint32_t*)C;
  uint32_t* part = (uint32_t*)partial;
  int K;
  if (mode == MODE_CUBIC) {
    round_evals_kernel<MODE_CUBIC><<<nblocks, NT, 0, s>>>(half, e, a, b, c, part, F);
    K = 3;
  } else if (mode == MODE_QUAD) {
    round_evals_kernel<MODE_QUAD><<<nblocks, NT, 0, s>>>(half, e, a, b, c, part, F);
    K = 2;
  } else if (mode == MODE_DOT) {
    round_evals_kernel<MODE_DOT><<<nblocks, NT, 0, s>>>(half, e, a, b, c, part, F);
    K = 1;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  sum_partials_kernel<<<1, NT, 0, s>>>(nblocks, K, part, (uint32_t*)out, F);
  return (int)cudaGetLastError();
}

extern "C" int sp2_bind(size_t half, int nvec, void* v0, void* v1, void* v2,
                        void* v3, const uint32_t* r_words,
                        const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (nvec < 1 || nvec > 4) return (int)cudaErrorInvalidValue;
  Vec4 v = {{(uint32_t*)v0, (uint32_t*)v1, (uint32_t*)v2, (uint32_t*)v3}};
  dim3 grid(blocks_for(half, 4096), (unsigned)nvec);
  bind_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(half, v, fe_from_words(r_words), F);
  return (int)cudaGetLastError();
}
