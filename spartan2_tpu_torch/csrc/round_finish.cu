// Kernel F: the finish of one sum-check round on the card, so that a whole
// sum-check is enqueued with no host round trip.
//
// Replaces the per-round algebra and transcript of the JAX package's
// provers (spartan2_tpu/sumcheck/prove.py: gruen_finish :188-228,
// from_evals3_dev/from_evals4_dev :38-63, unipoly_eval_dev :66,
// absorb_unipoly :98-108, and the round tails of sc_cubic_step :244,
// sc_quad_step :337 and SpartanInnerRound0 :627), which the fused programs
// (sumcheck/fused.py :213, :307, :464) inline into every round.
//
// One block.  It adds the per-block partial sums of the round's evaluation
// kernel (kernel A, B or G), then thread 0 runs the round algebra of the
// mode, with the running claim and eq prefix P read from ctx:
//   GRUEN        t0, tinf, tm1 -> gruen_finish's
//                [c0, c1, c2, c3]; zero_check takes T0 = c0 = e1 = 0, and
//                fallback (tau_j = 0) takes t(-1) from tm1, not from 1/tau_j;
//   CUBIC_EVALS  sums at 0, 2, 3 -> from_evals4 with e1 = claim - e0;
//   QUAD         t0, tinf -> from_evals3 with e2 = 2 claim - 3 t0 + 2 tinf;
//   INNER0       eval0, corr_low, corr_cross -> QUAD's with tinf = eval0 -
//                corr_low + corr_cross.
// It stores the Montgomery coefficients, absorbs the compressed ones
// canonical little-endian under b"p" and squeezes b"c" (keccak.cuh; the
// two hashes in threads 0 and 1), then writes r and 1 - r, the new claim
// p(r), the new P = P eq(tau_j, r) (GRUEN) and the new transcript state.
//
// ctx: 4 x 8 words, rows claim, P (Montgomery) and the 64-byte state.
// consts (GRUEN): eq_0 = 1 - tau, eq_slope = 2 tau - 1, eq_m1 = 2 - 3 tau
// and 1/tau (0 when tau = 0), Montgomery.
//
// Bound: serial work in one block, about 20 Montgomery products and 4
// Keccak-f[1600] permutations: a latency floor of a few microseconds, not
// the card's rates.

#include "field.cuh"
#include "keccak.cuh"

using namespace sp2;

constexpr int NT = 256;
constexpr int GRUEN = 0;
constexpr int CUBIC_EVALS = 1;
constexpr int QUAD = 2;
constexpr int INNER0 = 3;

// e0, e1, e2 -> [c, b, a] (from_evals3_dev)
__device__ __forceinline__ void from_evals3(Fe e0, Fe e1, Fe e2, Fe half, Fe* c,
                                            const Field& F) {
  c[0] = e0;
  c[2] = fe_mul(fe_add(fe_sub(e0, fe_double(e1, F), F), e2, F), half, F);
  c[1] = fe_sub(fe_sub(e1, c[0], F), c[2], F);
}

// e0 .. e3 -> [d, c, b, a] (from_evals4_dev)
__device__ __forceinline__ void from_evals4(Fe e0, Fe e1, Fe e2, Fe e3, Fe half, Fe sixth,
                                            Fe* c, const Field& F) {
  const Fe e1_3 = fe_add(fe_double(e1, F), e1, F);
  const Fe e2_3 = fe_add(fe_double(e2, F), e2, F);
  const Fe delta3 = fe_sub(fe_add(fe_sub(e3, e2_3, F), e1_3, F), e0, F);
  const Fe a = fe_mul(delta3, sixth, F);
  const Fe delta2 = fe_add(fe_sub(e2, fe_double(e1, F), F), e0, F);
  const Fe b = fe_sub(fe_mul(delta2, half, F), fe_add(fe_double(a, F), a, F), F);
  c[0] = e0;
  c[1] = fe_sub(fe_sub(fe_sub(e1, e0, F), b, F), a, F);
  c[2] = b;
  c[3] = a;
}

__global__ void round_finish_kernel(int mode, int nblocks, int ns, int zero_check,
                                    int fallback, int round, const uint32_t* partial,
                                    uint32_t* ctx, const uint32_t* consts,
                                    uint32_t* coeffs_out, uint32_t* r_out, Fe half,
                                    Fe sixth, Field F) {
  __shared__ Fe sums[3];
  __shared__ uint8_t msg[1 + 3 * 32 + 4 + 2 + 64 + 1];
  __shared__ uint8_t out[64];
  __shared__ int len;
  for (int t = 0; t < ns; ++t) {
    Fe s = fe_zero();
    for (int b = threadIdx.x; b < nblocks; b += NT)
      s = fe_add(s, fe_load(partial, (size_t)b * ns + t), F);
    s = block_sum<NT>(s, F);
    if (threadIdx.x == 0) sums[t] = s;
  }
  Fe c[4];
  int k = 0;
  if (threadIdx.x == 0) {
    const Fe claim = fe_load(ctx, 0);
    if (mode == GRUEN) {
      const Fe P = fe_load(ctx, 1);
      const Fe eq0 = fe_load(consts, 0), slope = fe_load(consts, 1);
      const Fe eqm1 = fe_load(consts, 2), inv_tau = fe_load(consts, 3);
      const Fe Tinf = fe_mul(sums[1], P, F);
      c[3] = fe_mul(slope, Tinf, F);
      Fe T0 = fe_zero(), e1 = fe_zero();
      c[0] = fe_zero();
      if (!zero_check) {
        T0 = fe_mul(sums[0], P, F);
        c[0] = fe_mul(eq0, T0, F);
        e1 = fe_sub(claim, c[0], F);
      }
      const Fe Tm1 =
          fallback ? fe_mul(sums[2], P, F)
                   : fe_sub(fe_add(fe_double(Tinf, F), fe_double(T0, F), F),
                            fe_mul(e1, inv_tau, F), F);
      const Fe sm1 = fe_mul(eqm1, Tm1, F);
      c[1] = fe_sub(fe_mul(fe_sub(e1, sm1, F), half, F), c[3], F);
      c[2] = fe_sub(fe_mul(fe_add(e1, sm1, F), half, F), c[0], F);
      k = 4;
    } else if (mode == CUBIC_EVALS) {
      from_evals4(sums[0], fe_sub(claim, sums[0], F), sums[1], sums[2], half, sixth, c, F);
      k = 4;
    } else {
      const Fe t0 = sums[0];
      const Fe tinf = mode == QUAD ? sums[1]
                                   : fe_add(fe_sub(t0, sums[1], F), sums[2], F);
      const Fe e2 = fe_add(fe_sub(fe_double(claim, F), fe_add(fe_double(t0, F), t0, F), F),
                           fe_double(tinf, F), F);
      from_evals3(t0, fe_sub(claim, t0, F), e2, half, c, F);
      k = 3;
    }
    for (int i = 0; i < k; ++i) fe_store(coeffs_out, i, c[i]);
    // b"p" || the compressed coefficients [c0, c2, (c3)], canonical LE
    msg[0] = 'p';
    int n = 1;
    for (int i = 0; i < k; ++i) {
      if (i == 1) continue;
      fe_to_le_bytes(fe_from_mont(c[i], F), msg + n);
      n += 32;
    }
    const uint8_t label = 'c';
    len = squeeze_message(msg, n, round, reinterpret_cast<const uint8_t*>(ctx + 16),
                          &label, 1);
  }
  __syncthreads();
  cus_half(msg, len, out);
  __syncthreads();
  if (threadIdx.x == 0) {
    const Fe r = fe_from_uniform(out, F);
    Fe acc = c[k - 1];
    for (int i = k - 2; i >= 0; --i) acc = fe_add(fe_mul(acc, r, F), c[i], F);
    fe_store(ctx, 0, acc);
    if (mode == GRUEN) {
      const Fe eq_r = fe_add(fe_load(consts, 0), fe_mul(fe_load(consts, 1), r, F), F);
      fe_store(ctx, 1, fe_mul(fe_load(ctx, 1), eq_r, F));
    }
    uint8_t* state = reinterpret_cast<uint8_t*>(ctx + 16);
    for (int i = 0; i < 64; ++i) state[i] = out[i];
    fe_store(r_out, 0, r);
    fe_store(r_out, 1, fe_sub(fe_one(F), r, F));
  }
}

extern "C" int sp2_round_finish(int mode, int nblocks, int zero_check, int fallback,
                                int round, const void* partial, void* ctx,
                                const void* consts, void* coeffs_out, void* r_out,
                                const uint32_t* inv_words, const uint32_t* field_words,
                                void* stream) {
  if (mode < GRUEN || mode > INNER0 || nblocks < 1 || round < 0 || round > 0xFFFF ||
      (mode == GRUEN && consts == nullptr))
    return (int)cudaErrorInvalidValue;
  const int ns = mode == QUAD ? 2 : 3;
  round_finish_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      mode, nblocks, ns, zero_check, fallback, round, (const uint32_t*)partial,
      (uint32_t*)ctx, (const uint32_t*)consts, (uint32_t*)coeffs_out, (uint32_t*)r_out,
      fe_from_words(inv_words), fe_from_words(inv_words + 8),
      field_from_words(field_words));
  return (int)cudaGetLastError();
}
