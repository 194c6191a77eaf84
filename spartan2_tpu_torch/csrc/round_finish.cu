// Kernel F: the finish of one sum-check round on the card, so that a whole
// sum-check is enqueued with no host round trip.
//
// Replaces the per-round algebra and transcript of the JAX package's
// provers (spartan2_tpu/sumcheck/prove.py: gruen_finish :188-228,
// from_evals3_dev/from_evals4_dev :38-63, unipoly_eval_dev :66,
// absorb_unipoly :98-108, and the round tails of sc_cubic_step :244,
// sc_quad_step :337 and SpartanInnerRound0 :604), which the fused programs
// (sumcheck/fused.py :213, :307, :464) inline into every round.
//
// One block of NT threads.  It adds the round's sums (kernel A's finished
// sums, kernel B's, kernel G's, or the ranks' gathered
// ones), then runs the round algebra of the mode with the running claim
// and eq prefix P read from ctx:
//   GRUEN        t0, tinf, tm1 -> gruen_finish's
//                [c0, c1, c2, c3]; zero_check takes T0 = c0 = e1 = 0, and
//                fallback (tau_j = 0) takes t(-1) from tm1, not from 1/tau_j;
//   CUBIC_EVALS  sums at 0, 2, 3 -> from_evals4 with e1 = claim - e0;
//   QUAD         t0, tinf -> from_evals3 with e2 = 2 claim - 3 t0 + 2 tinf;
//   INNER0       eval0, corr_low, corr_cross -> QUAD's with tinf = eval0 -
//                corr_low + corr_cross.
// It stores the Montgomery coefficients, absorbs the compressed ones
// canonical little-endian under b"p" and squeezes b"c" (keccak.cuh), then
// writes r and 1 - r, the new claim p(r), the new P = P eq(tau_j, r)
// (GRUEN) and the new transcript state.
//
// Bound: a chain of dependent products and two Keccak-f[1600]
// permutations, a few microseconds, far from the card's rates.  The chain
// is kept short: the products that do not depend on each other run side
// by side, lane 0 of one warp each, joined through shared memory between
// stages (GRUEN: Tinf, T0, t(-1) P and eqm1 / 2, then c3 and c0, then e1
// / 2, e1 / tau and the canonical c0 and c3, then t(-1)'s product, then
// the canonical c2: 5 products deep; from_uniform's two products, then
// p(r) as (c3 r + c2) r^2 + (c1 r + c0) and P eq(tau, r): 3 more), every
// product fe_mul_cc.  The message is built as 64-bit lanes by 34 threads
// at once, and the two hashes of the squeeze run in warps 0 and 1, each
// permutation spread over a warp.
//
// ctx: 4 x 8 words, rows claim, P (Montgomery) and the 64-byte state.
// consts (GRUEN): eq_0 = 1 - tau, eq_slope = 2 tau - 1, eq_m1 = 2 - 3 tau
// and 1/tau (0 when tau = 0), Montgomery.

#include "field.cuh"
#include "keccak.cuh"

using namespace sp2;

constexpr int NT = 256;
constexpr int GRUEN = 0;
constexpr int CUBIC_EVALS = 1;
constexpr int QUAD = 2;
constexpr int INNER0 = 3;
// the message: b"p", at most 3 compressed coefficients, the squeeze suffix
// and the label b"c", then the extra byte: 2 Keccak blocks
constexpr int MSG_LANES = 2 * KECCAK_RATE_LANES;

// Shared slots of the round's values, written in one stage and read in a
// later one.
enum Slot { S0, S1, S2, TINF, T0, TM1P, EQM1H, C0, C3, E1H, E1T, SM1H, A3, DH, B2, R_LO,
            R_HI, HU, HV, RR, EQR, NSLOTS };

// The sums of the rows of ``partial`` (nrows x ns) into V[S0 ..], the ns
// sums side by side: warp 0's shuffle tree when the rows are few, else the
// block's.
__device__ __forceinline__ void add_rows(int nrows, int ns, const uint32_t* partial, Fe* V,
                                         const Field& F) {
  Fe s[3] = {fe_zero(), fe_zero(), fe_zero()};
  for (int b = threadIdx.x; b < nrows; b += NT) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
      if (t < ns) s[t] = fe_add_cc(s[t], fe_load(partial, (size_t)b * ns + t), F);
  }
  if (nrows > 32) {
    block_sums<NT, 3>(s, F);
  } else if (threadIdx.x < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < 3; ++t) s[t] = fe_add_cc(s[t], fe_shfl_down(s[t], off), F);
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < 3; ++t) V[S0 + t] = s[t];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT) round_finish_kernel(
    int mode, int nrows, int ns, int zero_check, int fallback, int round,
    const uint32_t* partial, uint32_t* ctx, const uint32_t* consts, uint32_t* coeffs_out,
    uint32_t* r_out, Fe half, Fe sixth, Field F) {
  __shared__ Fe V[NSLOTS];
  __shared__ Fe cm[3];  // the compressed coefficients, canonical
  __shared__ uint64_t lanes[MSG_LANES];
  __shared__ uint64_t digest[8];
  const int warp = threadIdx.x >> 5;
  const bool lead = (threadIdx.x & 31) == 0;  // lane 0 of its warp
  const int kc = mode == GRUEN || mode == CUBIC_EVALS ? 3 : 2;  // compressed
  const Fe one = fe_one(F);
  Fe raw1 = fe_zero();  // fe_from_mont's multiplier: the integer 1
  raw1.v[0] = 1;

  // the round's context, loaded before the sums so that the loads overlap
  const Fe claim = fe_load(ctx, 0);
  Fe P = fe_zero(), eq0 = fe_zero(), slope = fe_zero(), eqm1 = fe_zero(), inv_tau = fe_zero();
  if (mode == GRUEN) {
    P = fe_load(ctx, 1);
    eq0 = fe_load(consts, 0);
    slope = fe_load(consts, 1);
    eqm1 = fe_load(consts, 2);
    inv_tau = fe_load(consts, 3);
  }
  add_rows(nrows, ns, partial, V, F);
  // the coefficients in Montgomery form, every thread's own copy once formed
  Fe c0, c1, c2, c3;
  if (mode == GRUEN) {
    if (lead) {
      if (warp == 0) V[TINF] = fe_mul_cc(V[S1], P, F);
      if (warp == 1) V[T0] = zero_check ? fe_zero() : fe_mul_cc(V[S0], P, F);
      if (warp == 2 && fallback) V[TM1P] = fe_mul_cc(V[S2], P, F);
      if (warp == 3) V[EQM1H] = fe_mul_cc(eqm1, half, F);
    }
    __syncthreads();
    if (lead) {
      if (warp == 0) V[C3] = fe_mul_cc(slope, V[TINF], F);
      if (warp == 1) V[C0] = zero_check ? fe_zero() : fe_mul_cc(eq0, V[T0], F);
      if (warp == 2 && fallback) V[SM1H] = fe_mul_cc(V[EQM1H], V[TM1P], F);
    }
    __syncthreads();
    c0 = V[C0];
    c3 = V[C3];
    const Fe e1 = zero_check ? fe_zero() : fe_sub_cc(claim, c0, F);
    if (lead) {
      if (warp == 0) V[E1H] = fe_mul_cc(e1, half, F);
      if (warp == 1 && !fallback) V[E1T] = fe_mul_cc(e1, inv_tau, F);
      if (warp == 2) cm[0] = fe_mul_cc(c0, raw1, F);
      if (warp == 3) cm[2] = fe_mul_cc(c3, raw1, F);
    }
    __syncthreads();
    if (!fallback) {  // t(-1) = 2 Tinf + 2 T0 - e1 / tau
      if (lead && warp == 0) {
        const Fe ti = V[TINF], t0 = V[T0];
        const Fe Tm1 = fe_sub_cc(fe_add_cc(fe_add_cc(ti, ti, F), fe_add_cc(t0, t0, F), F),
                                 V[E1T], F);
        V[SM1H] = fe_mul_cc(V[EQM1H], Tm1, F);
      }
      __syncthreads();
    }
    // c1 = (e1 - s(-1)) / 2 - c3, c2 = (e1 + s(-1)) / 2 - c0
    const Fe e1h = V[E1H], sm1h = V[SM1H];
    c1 = fe_sub_cc(fe_sub_cc(e1h, sm1h, F), c3, F);
    c2 = fe_sub_cc(fe_add_cc(e1h, sm1h, F), c0, F);
    if (lead && warp == 0) cm[1] = fe_mul_cc(c2, raw1, F);
  } else if (mode == CUBIC_EVALS) {
    // from_evals4: e0, e1 = claim - e0, e2, e3 -> [d, c, b, a]
    const Fe e0 = V[S0], e1 = fe_sub_cc(claim, e0, F), e2 = V[S1], e3 = V[S2];
    if (lead) {
      if (warp == 0) {
        const Fe e1_3 = fe_add_cc(fe_add_cc(e1, e1, F), e1, F);
        const Fe e2_3 = fe_add_cc(fe_add_cc(e2, e2, F), e2, F);
        const Fe delta3 = fe_sub_cc(fe_add_cc(fe_sub_cc(e3, e2_3, F), e1_3, F), e0, F);
        V[A3] = fe_mul_cc(delta3, sixth, F);
      }
      if (warp == 1) {
        const Fe delta2 = fe_add_cc(fe_sub_cc(e2, fe_add_cc(e1, e1, F), F), e0, F);
        V[DH] = fe_mul_cc(delta2, half, F);
      }
      if (warp == 2) cm[0] = fe_mul_cc(e0, raw1, F);
    }
    __syncthreads();
    c3 = V[A3];
    c2 = fe_sub_cc(V[DH], fe_add_cc(fe_add_cc(c3, c3, F), c3, F), F);
    c1 = fe_sub_cc(fe_sub_cc(fe_sub_cc(e1, e0, F), c2, F), c3, F);
    c0 = e0;
    if (lead && warp == 0) cm[1] = fe_mul_cc(c2, raw1, F);
    if (lead && warp == 1) cm[2] = fe_mul_cc(c3, raw1, F);
  } else {
    // from_evals3 of t0, claim - t0, e2 = 2 claim - 3 t0 + 2 tinf -> [c, b, a]
    const Fe t0 = V[S0];
    const Fe tinf = mode == QUAD ? V[S1] : fe_add_cc(fe_sub_cc(t0, V[S1], F), V[S2], F);
    const Fe e1 = fe_sub_cc(claim, t0, F);
    if (lead) {
      if (warp == 0) {
        const Fe e2 = fe_add_cc(fe_sub_cc(fe_add_cc(claim, claim, F),
                                          fe_add_cc(fe_add_cc(t0, t0, F), t0, F), F),
                                fe_add_cc(tinf, tinf, F), F);
        V[B2] = fe_mul_cc(fe_add_cc(fe_sub_cc(t0, fe_add_cc(e1, e1, F), F), e2, F), half, F);
      }
      if (warp == 2) cm[0] = fe_mul_cc(t0, raw1, F);
    }
    __syncthreads();
    c2 = V[B2];
    c1 = fe_sub_cc(fe_sub_cc(e1, t0, F), c2, F);
    c0 = t0;
    c3 = fe_zero();
    if (lead && warp == 0) cm[1] = fe_mul_cc(c2, raw1, F);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    fe_store(coeffs_out, 0, c0);
    fe_store(coeffs_out, 1, c1);
    fe_store(coeffs_out, 2, c2);
    if (kc == 3) fe_store(coeffs_out, 3, c3);
  }

  // the message b"p" || compressed || DOM_SEP_TAG || round || state || b"c"
  // as 64-bit little-endian lanes, zero past its length
  const uint8_t* state = reinterpret_cast<const uint8_t*>(ctx + 16);
  const int len = 1 + 32 * kc + SQUEEZE_SUFFIX + 1;
  if (threadIdx.x < MSG_LANES) {
    uint64_t w = 0;
    for (int b = 0; b < 8; ++b) {
      const int k = 8 * threadIdx.x + b;
      uint32_t v = 0;
      if (k == 0) {
        v = 'p';
      } else if (k <= 32 * kc) {
        const int i = (k - 1) >> 5, byte = (k - 1) & 31;
        v = (cm[i].v[byte >> 2] >> (8 * (byte & 3))) & 0xFF;
      } else if (k < len - 1) {
        v = squeeze_suffix_byte(k - 1 - 32 * kc, round, state, nullptr);
      } else if (k == len - 1) {
        v = 'c';
      }
      w |= (uint64_t)v << (8 * b);
    }
    lanes[threadIdx.x] = w;
  }
  __syncthreads();
  cus_warps([&](int i) { return lanes[i]; }, len, digest);
  __syncthreads();

  // r = from_uniform(new state): lo R^2 + hi R^3 (REDC), the halves side by side
  if (lead && warp < 2) {
    Fe h, m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h.v[2 * i] = (uint32_t)digest[4 * warp + i];
      h.v[2 * i + 1] = (uint32_t)(digest[4 * warp + i] >> 32);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) m.v[i] = warp == 0 ? F.r2[i] : F.r3[i];
    V[R_LO + warp] = fe_mul_cc(h, m, F);
  }
  __syncthreads();
  const Fe r = fe_add_cc(V[R_LO], V[R_HI], F);
  // p(r) = (c3 r + c2) r^2 + (c1 r + c0), or (c2 r + c1) r + c0; P eq(tau, r)
  Fe top = c2, next = c1;
  if (kc == 3) {
    top = c3;
    next = c2;
  }
  if (lead) {
    if (warp == 0) V[HU] = fe_add_cc(fe_mul_cc(top, r, F), next, F);
    if (warp == 1 && kc == 3) V[HV] = fe_add_cc(fe_mul_cc(c1, r, F), c0, F);
    if (warp == 2 && kc == 3) V[RR] = fe_mul_cc(r, r, F);
    if (warp == 3 && mode == GRUEN) V[EQR] = fe_add_cc(eq0, fe_mul_cc(slope, r, F), F);
  }
  __syncthreads();
  if (lead) {
    if (warp == 0)
      fe_store(ctx, 0, kc == 3 ? fe_add_cc(fe_mul_cc(V[HU], V[RR], F), V[HV], F)
                               : fe_add_cc(fe_mul_cc(V[HU], r, F), c0, F));
    if (warp == 1 && mode == GRUEN) fe_store(ctx, 1, fe_mul_cc(P, V[EQR], F));
    if (warp == 2) {
      fe_store(r_out, 0, r);
      fe_store(r_out, 1, fe_sub_cc(one, r, F));
    }
  }
  if (threadIdx.x < 8) reinterpret_cast<uint64_t*>(ctx + 16)[threadIdx.x] = digest[threadIdx.x];
}

extern "C" int sp2_round_finish(int mode, int nrows, int zero_check, int fallback,
                                int round, const void* partial, void* ctx,
                                const void* consts, void* coeffs_out, void* r_out,
                                const uint32_t* inv_words, const uint32_t* field_words,
                                void* stream) {
  if (mode < GRUEN || mode > INNER0 || nrows < 1 || round < 0 || round > 0xFFFF ||
      (mode == GRUEN && consts == nullptr))
    return (int)cudaErrorInvalidValue;
  const int ns = mode == QUAD ? 2 : 3;
  round_finish_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      mode, nrows, ns, zero_check, fallback, round, (const uint32_t*)partial,
      (uint32_t*)ctx, (const uint32_t*)consts, (uint32_t*)coeffs_out, (uint32_t*)r_out,
      fe_from_words(inv_words), fe_from_words(inv_words + 8),
      field_from_words(field_words));
  return (int)cudaGetLastError();
}
