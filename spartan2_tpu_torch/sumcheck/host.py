"""Sum-check provers over Python ints, for the verifier circuit's small
instances (a few hundred entries), where a launch per round costs more
than the host arithmetic.

Reference: src/sumcheck.rs; the JAX package's sumcheck/host.py.  The
messages equal the device provers' (sumcheck/prove.py): the compressed
round polynomial is absorbed under b"p" and the challenge squeezed under
b"c", unless a ``challenge_fn(round_index, poly) -> r`` takes the
transcript's place (the ZK provers route each round through the
verifier circuit's commit-then-challenge protocol).
"""

from __future__ import annotations

from ..field.constants import FieldSpec
from ..polys.eq import eq_evals_host
from ..polys.univariate import UniPoly
from ..transcript.transcript import Transcript
from .verify import SumcheckProof


def _bind(field: FieldSpec, arr: list[int], r: int) -> list[int]:
    p = field.modulus
    half = len(arr) // 2
    return [(arr[j] + r * (arr[half + j] - arr[j])) % p for j in range(half)]


def transcript_challenge_fn(transcript: Transcript):
    """Plain Fiat-Shamir: absorb the round polynomial, squeeze the
    challenge."""

    def fn(round_index: int, poly: UniPoly) -> int:
        transcript.absorb_bytes(b"p", poly.to_transcript_bytes())
        return transcript.squeeze(b"c")

    return fn


def prove_cubic_with_three_inputs(
    field: FieldSpec, claim: int, taus: list[int],
    Az: list[int], Bz: list[int], Cz: list[int],
    transcript: Transcript = None, challenge_fn=None,
) -> tuple[SumcheckProof, list[int], list[int]]:
    """claim = sum_x eq(tau, x) (Az(x) Bz(x) - Cz(x))
    (reference prove_cubic_with_three_inputs, sumcheck.rs:502-571)."""
    p = field.modulus
    if challenge_fn is None:
        challenge_fn = transcript_challenge_fn(transcript)
    eq = eq_evals_host(field, taus)
    Az, Bz, Cz = list(Az), list(Bz), list(Cz)
    e = claim % p
    polys, rs = [], []
    while len(Az) > 1:
        half = len(Az) // 2

        def eval_at(shift):
            acc = 0
            for j in range(half):
                eqv = eq[j] + shift * (eq[half + j] - eq[j])
                a = Az[j] + shift * (Az[half + j] - Az[j])
                b = Bz[j] + shift * (Bz[half + j] - Bz[j])
                c = Cz[j] + shift * (Cz[half + j] - Cz[j])
                acc += eqv * (a * b - c)
            return acc % p

        t0 = eval_at(0)
        poly = UniPoly.from_evals_deg3(field, [t0, (e - t0) % p, eval_at(2),
                                               eval_at(3)])
        r = challenge_fn(len(rs), poly)
        rs.append(r)
        e = poly.evaluate(r)
        eq, Az, Bz, Cz = (_bind(field, v, r) for v in (eq, Az, Bz, Cz))
        polys.append(poly.compress())
    return SumcheckProof(field, polys), rs, [Az[0], Bz[0], Cz[0]]


def prove_quad(
    field: FieldSpec, claim: int, num_rounds: int,
    A: list[int], B: list[int], transcript: Transcript = None,
    challenge_fn=None,
) -> tuple[SumcheckProof, list[int], list[int]]:
    """claim = sum_x A(x) B(x), the evaluation at 2 derived from the claim
    (reference prove_quad, sumcheck.rs:190-247)."""
    p = field.modulus
    if challenge_fn is None:
        challenge_fn = transcript_challenge_fn(transcript)
    A, B = list(A), list(B)
    assert len(A) == 1 << num_rounds
    e = claim % p
    polys, rs = [], []
    for _ in range(num_rounds):
        half = len(A) // 2
        t0 = sum(A[j] * B[j] for j in range(half)) % p
        t_inf = sum((A[half + j] - A[j]) * (B[half + j] - B[j])
                    for j in range(half)) % p
        e2 = (2 * e - 3 * t0 + 2 * t_inf) % p
        poly = UniPoly.from_evals_deg2(field, [t0, (e - t0) % p, e2])
        r = challenge_fn(len(rs), poly)
        rs.append(r)
        e = poly.evaluate(r)
        A = _bind(field, A, r)
        B = _bind(field, B, r)
        polys.append(poly.compress())
    return SumcheckProof(field, polys), rs, [A[0], B[0]]
