"""The port's sum-check provers (kernel 2's plain version, CPU) against the
JAX package's host provers: equal proofs, byte for byte, that JAX's
SumcheckProof.verify accepts."""

import pytest
import torch

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.polys.eq import eq_evals_host
from spartan2_tpu.sumcheck.host import prove_cubic_with_three_inputs
from spartan2_tpu.sumcheck.host import prove_quad as jax_prove_quad
from spartan2_tpu.transcript.transcript import Transcript as JaxTranscript
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.sumcheck.device import (EQ_MAX_TABLES, eq_factors, eq_table,
                                                eq_table_plain, eq_tables)
from spartan2_tpu_torch.sumcheck.prove import SumcheckProverCubicEq, prove_cubic_eq, prove_quad
from spartan2_tpu_torch.transcript.device import DeviceTranscript
from spartan2_tpu_torch.transcript.transcript import Transcript
from tests.torch_helpers import rand_ints

F = get_field("p256_scalar")
JF = jax_get_field("p256_scalar")


def _polys(proof):
    return [c.coeffs_except_linear for c in proof.compressed_polys]


def test_eq_table_matches_jax_host():
    r = rand_ints(F.modulus, 7, 0) + [0, 1]
    got = limbs_to_ints(eq_table(eq_factors(r, F, "cpu"), F), F, mont=True)
    assert got == eq_evals_host(JF, r)


def _plan_tables(m: int, seed: int):
    """The outer sum-check's eq-table ranges at m variables, its taus, and
    their factors back to back."""
    taus = rand_ints(F.modulus, m, seed)
    keys = SumcheckProverCubicEq.table_keys(m)
    ranges = sorted({k for pair in keys for k in pair if k is not None})
    fac = [eq_factors(taus[a:b], F, "cpu") for a, b in ranges]
    return taus, ranges, fac


def test_eq_tables_equal_eq_table_per_table():
    """The batched entry's plain version, on the outer plan's 9 tables at
    m = 9 (a table of m = 0 among them): each equals eq_table_plain and
    JAX's host eq table."""
    taus, ranges, fac = _plan_tables(9, 3)
    got = eq_tables(torch.cat(fac), [b - a for a, b in ranges], F)
    assert len(got) == len(ranges) == 9 and min(b - a for a, b in ranges) == 0
    for t, f, (a, b) in zip(got, fac, ranges):
        assert torch.equal(t, eq_table_plain(f, F))
        assert limbs_to_ints(t, F, mont=True) == eq_evals_host(JF, taus[a:b])


@pytest.mark.parametrize("m", [6, 8])
@pytest.mark.parametrize("taus_kind", ["random", "with_0_and_1"])
def test_outer_cubic_batched_plan_matches_jax(m, taus_kind):
    """The prove's outer sum-check, its eq tables from one batched build
    (SumcheckProverCubicEq.plan), on the device transcript: the same
    polynomials, challenges, finals and transcript as JAX's host prover."""
    p = F.modulus
    n = 1 << m
    taus = rand_ints(p, m, 20 + m)
    if taus_kind == "with_0_and_1":
        taus[1], taus[-1] = 0, 1
    A, B = rand_ints(p, n, 5), rand_ints(p, n, 6)
    C = [a * b % p for a, b in zip(A, B)]
    C[2] = (C[2] + 1) % p
    eq = eq_evals_host(JF, taus)
    claim = sum(e * (a * b - c) for e, a, b, c in zip(eq, A, B, C)) % p
    t_ref = JaxTranscript(JF, b"sc")
    ref, r_ref, fin_ref = prove_cubic_with_three_inputs(JF, claim, taus, A, B, C, t_ref)
    td = DeviceTranscript.from_host(Transcript(F, b"sc"), "cpu")
    vecs = [to_device(v, F, "cpu", mont=True) for v in (A, B, C)]
    coeffs, rs, finals, _ = SumcheckProverCubicEq(F).prove(
        td, *vecs, to_device([claim], F, "cpu", mont=True)[0], taus)
    vals = limbs_to_ints(coeffs.reshape(-1, 8), F, mont=True)
    assert [[vals[4 * j]] + vals[4 * j + 2 : 4 * j + 4] for j in range(m)] == _polys(ref)
    assert limbs_to_ints(rs[:, 0].reshape(-1, 8), F, mont=True) == r_ref
    assert [limbs_to_ints(f.reshape(-1, 8), F, mont=True)[0] for f in finals] == list(fin_ref)
    assert td.state.numpy().tobytes() == t_ref.state


def test_eq_tables_refuses_more_than_one_launch():
    """One launch holds EQ_MAX_TABLES tables; more is refused, on the CPU
    as on the card, where no caller sends more."""
    fac = eq_factors([], F, "cpu")
    assert len(eq_tables(fac, [0] * EQ_MAX_TABLES, F)) == EQ_MAX_TABLES
    with pytest.raises(ValueError, match="at most"):
        eq_tables(fac, [0] * (EQ_MAX_TABLES + 1), F)


@pytest.mark.parametrize("m", [6, 8])
@pytest.mark.parametrize("taus_kind", ["random", "with_0_and_1"])
def test_outer_cubic_matches_jax(m, taus_kind):
    p = F.modulus
    n = 1 << m
    taus = rand_ints(p, m, 10 + m)
    if taus_kind == "with_0_and_1":  # the JAX fused prover's fallback case
        taus[1], taus[-1] = 0, 1
    A, B = rand_ints(p, n, 1), rand_ints(p, n, 2)
    C = [a * b % p for a, b in zip(A, B)]
    C[3] = (C[3] + 1) % p  # a nonzero sum: the claim comes from the inputs
    eq = eq_evals_host(JF, taus)
    claim = sum(e * (a * b - c) for e, a, b, c in zip(eq, A, B, C)) % p

    t_ref = JaxTranscript(JF, b"sc")
    ref, r_ref, fin_ref = prove_cubic_with_three_inputs(JF, claim, taus, A, B, C,
                                                        t_ref)
    t = Transcript(F, b"sc")
    vecs = [to_device(v, F, "cpu", mont=True) for v in (A, B, C)]
    ours, r_ours, fin = prove_cubic_eq(t, taus, *vecs, F, claim=claim)
    assert _polys(ours) == _polys(ref)
    assert r_ours == r_ref and fin == fin_ref and t.state == t_ref.state
    ref.compressed_polys = ours.compressed_polys  # JAX's verifier on our proof
    e, rs = ref.verify(claim, m, 3, JaxTranscript(JF, b"sc"))
    assert rs == r_ours


@pytest.mark.parametrize("m", [6, 8])
def test_inner_quad_matches_jax(m):
    p = F.modulus
    n = 1 << m
    A, B = rand_ints(p, n, 3), rand_ints(p, n, 4)
    B[n // 2 + 3 :] = [0] * (n // 2 - 3)  # the inner z's zero tail
    claim = sum(a * b for a, b in zip(A, B)) % p
    t_ref = JaxTranscript(JF, b"q")
    ref, r_ref, fin_ref = jax_prove_quad(JF, claim, m, A, B, t_ref)
    t = Transcript(F, b"q")
    ours, r_ours, fin = prove_quad(t, claim, to_device(A, F, "cpu", mont=True),
                                   to_device(B, F, "cpu", mont=True), F)
    assert _polys(ours) == _polys(ref)
    assert r_ours == r_ref and fin == fin_ref and t.state == t_ref.state
    ref.compressed_polys = ours.compressed_polys
    e, rs = ref.verify(claim, m, 2, JaxTranscript(JF, b"q"))
    assert rs == r_ours and e == fin[0] * fin[1] % p
