"""The port's device-transcript sum-check provers (kernels A, B, F and G
on their plain versions, CPU) against the JAX package's host provers
(sumcheck/host.py) driven by its host Transcript: every compressed
coefficient, the challenges, the finals and the final transcript state
and round are equal.  JAX's jitted provers are not called: their XLA:CPU
compiles would take minutes."""

import pytest
import torch

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.polys.eq import eq_evals_host
from spartan2_tpu.sumcheck.host import prove_cubic_with_three_inputs
from spartan2_tpu.sumcheck.host import prove_quad as jax_prove_quad
from spartan2_tpu.transcript.transcript import Transcript as JaxTranscript
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.sumcheck.device import eq_factors, eq_table
from spartan2_tpu_torch.sumcheck.prove import (SpartanInnerRound0, SumcheckProverCubic,
                                               SumcheckProverCubicEq, SumcheckProverQuad)
from spartan2_tpu_torch.transcript.device import DeviceTranscript
from spartan2_tpu_torch.transcript.transcript import Transcript
from tests.torch_helpers import mont_vector, rand_ints, taus_with_0_and_1

F = get_field("p256_scalar")
JF = jax_get_field("p256_scalar")
p = F.modulus


def _ints(t):
    return limbs_to_ints(t.reshape(-1, 8), F, mont=True)


def _claim_dev(claim: int):
    return to_device([claim], F, "cpu", mont=True)[0]


def _check(out, td, ref, k: int):
    """Port prover output against a JAX host prove (proof, rs, finals,
    transcript)."""
    coeffs, rs, finals = out[:3]
    proof, r_ref, fin_ref, t_ref = ref
    vals = _ints(coeffs)
    comp = [[vals[k * j]] + vals[k * j + 2 : k * j + k] for j in range(len(vals) // k)]
    assert comp == [c.coeffs_except_linear for c in proof.compressed_polys]
    assert _ints(rs[:, 0]) == r_ref
    assert _ints(rs[:, 1]) == [(1 - r) % p for r in r_ref]
    assert [_ints(f)[0] for f in finals] == list(fin_ref)
    assert td.state.numpy().tobytes() == t_ref.state and td.round == t_ref.round


def _cubic_inputs(m: int, seed: int, eff: int = None, satisfied: bool = False):
    n = 1 << m
    eff = n if eff is None else eff
    A, _ = mont_vector(F, n, seed)
    B, _ = mont_vector(F, n, seed + 1)
    C, _ = mont_vector(F, n, seed + 2)
    if satisfied:
        C = [a * b % p for a, b in zip(A, B)]
    A, B, C = ([v if i < eff else 0 for i, v in enumerate(x)] for x in (A, B, C))
    return A, B, C


def _cubic_case(m, seed, taus, run, eff=None, satisfied=False):
    """Run ``run(td, A, B, C, claim_dev)`` on the port and the JAX host
    cubic prover on the same inputs; compare."""
    A, B, C = _cubic_inputs(m, seed, eff, satisfied)
    eq = eq_evals_host(JF, taus)
    claim = sum(e * (a * b - c) for e, a, b, c in zip(eq, A, B, C)) % p
    t_ref = JaxTranscript(JF, b"sc")
    proof, r_ref, fin_ref = prove_cubic_with_three_inputs(JF, claim, taus, A, B, C, t_ref)
    td = DeviceTranscript.from_host(Transcript(F, b"sc"), "cpu")
    vecs = [to_device(v, F, "cpu", mont=True) for v in (A, B, C)]
    _check(run(td, *vecs, _claim_dev(claim)), td, (proof, r_ref, fin_ref, t_ref), 4)


@pytest.mark.parametrize("m", [10, 11])
def test_fused_cubic_matches_jax_host(m):
    """Every round enqueued, both parities of the EL/ER split."""
    taus = rand_ints(p, m, 20 + m)
    _cubic_case(m, m, taus, lambda td, A, B, C, claim: SumcheckProverCubicEq(F).prove(
        td, A, B, C, claim, taus))


@pytest.mark.parametrize("taus_kind", ["random", "with_0_and_1"])
@pytest.mark.parametrize("zero_check", [True, False])
def test_peeled_cubic_matches_jax_host(zero_check, taus_kind):
    """Round 0 peeled at eff = 0.67 * 2^m: past eff every entry is zero and
    round 0 reads the upper half only below it; with zero_check the R1CS
    is satisfied (claim 0) and the t(0) sum is skipped; tau_0 = 0 adds the
    t(-1) sum over the peeled half."""
    m, eff = 11, 1372
    taus = rand_ints(p, m, 40) if taus_kind == "random" else taus_with_0_and_1(p, m, 41)
    _cubic_case(m, 50, taus, lambda td, A, B, C, claim: SumcheckProverCubicEq(F).prove(
        td, A, B, C, claim, taus, zero_check=zero_check, eff=eff), eff,
        satisfied=zero_check)


@pytest.mark.parametrize("m", [6, 10])
def test_per_round_gruen_with_tau_0_and_1_matches_jax_host(m):
    """tau_0 = 0 takes t(-1) from kernel G's third sum; tau_1 = 1 zeroes
    eq_0.  The JAX package's fused provers refuse such taus."""
    taus = taus_with_0_and_1(p, m, 60 + m)
    _cubic_case(m, 70 + m, taus, lambda td, A, B, C, claim: SumcheckProverCubicEq(F).prove(
        td, A, B, C, claim, taus))


def test_per_round_gruen_small_m_matches_jax_host():
    m = 6
    taus = rand_ints(p, m, 80)
    _cubic_case(m, 81, taus, lambda td, A, B, C, claim: SumcheckProverCubicEq(F).prove(
        td, A, B, C, claim, taus, zero_check=True), satisfied=True)


def test_explicit_eq_cubic_matches_jax_host():
    """sc_cubic_step's prover: the eq table bound as a fourth vector."""
    m = 6
    taus = taus_with_0_and_1(p, m, 90)

    def run(td, A, B, C, claim):
        E = eq_table(eq_factors(taus, F, "cpu"), F)
        return SumcheckProverCubic(F).prove(td, E, A, B, C, claim)

    _cubic_case(m, 91, taus, run)


@pytest.mark.parametrize("m", [10, 11])
def test_quad_matches_jax_host(m):
    n = 1 << m
    A, At = mont_vector(F, n, 100 + m)
    B, Bt = mont_vector(F, n, 101 + m)
    claim = sum(a * b for a, b in zip(A, B)) % p
    t_ref = JaxTranscript(JF, b"q")
    ref = jax_prove_quad(JF, claim, m, A, B, t_ref)
    td = DeviceTranscript.from_host(Transcript(F, b"q"), "cpu")
    _check(SumcheckProverQuad(F).prove(td, At, Bt, _claim_dev(claim), m), td,
           (*ref, t_ref), 3)


def test_inner_round0_then_quad_matches_padded_jax_host():
    """Spartan's inner sum-check: kernel B's structured round 0 over abc
    and z at width num_cols = num_vars + num_extra, then the quad rounds
    over num_vars, equal to JAX's quad prover over the zero-padded
    2 num_vars domain."""
    nv, ne = 512, 5
    abc, abc_t = mont_vector(F, nv + ne, 110)
    z, z_t = mont_vector(F, nv + ne, 111)
    claim = sum(a * b for a, b in zip(abc, z)) % p
    pad = [0] * (nv - ne)
    t_ref = JaxTranscript(JF, b"inner")
    proof, r_ref, fin_ref = jax_prove_quad(JF, claim, 10, abc + pad, z + pad, t_ref)
    td = DeviceTranscript.from_host(Transcript(F, b"inner"), "cpu")
    claim0, r0, c0 = SpartanInnerRound0(F).run(td, abc_t, z_t, _claim_dev(claim), nv, ne)
    cq, rq, finals, _ = SumcheckProverQuad(F).prove(td, abc_t[:nv], z_t[:nv], claim0, 9)
    _check((torch.cat([c0[None], cq]), torch.cat([r0[None], rq]), finals), td,
           (proof, r_ref, fin_ref, t_ref), 3)
