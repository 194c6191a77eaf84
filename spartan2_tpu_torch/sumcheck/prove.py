"""Sum-check provers on kernel 2, with the Fiat-Shamir transcript on the
host.

Each round launches one evaluation (3 or 2 sums pulled to the host), the
host builds the round polynomial, absorbs it and squeezes the challenge
(labels b"p" / b"c", as the reference's sumcheck.rs and the JAX
package's provers), then one bind launch halves the vectors in place.
The round polynomial is the unique one through its evaluations, so the
messages equal the JAX package's fused provers byte for byte.
"""

from __future__ import annotations

import torch

from ..field.constants import FieldSpec
from ..field.limbs import limbs_to_ints
from ..polys.univariate import UniPoly
from ..transcript.transcript import Transcript
from .device import CUBIC, QUAD, bind, eq_factors, eq_table, round_evals
from .verify import SumcheckProof


def _challenge(transcript: Transcript, poly: UniPoly) -> int:
    transcript.absorb_bytes(b"p", poly.to_transcript_bytes())
    return transcript.squeeze(b"c")


def prove_cubic_eq(transcript: Transcript, taus: list[int], A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, spec: FieldSpec,
                   claim: int = 0):
    """claim = sum_x eq(tau, x) (A(x) B(x) - C(x)) over 2^len(taus) points
    (reference prove_cubic_with_three_inputs, sumcheck.rs:502-571).
    A, B, C are (n, 8) Montgomery tensors, bound in place.
    -> (proof, r_x, [A(r_x), B(r_x), C(r_x)])."""
    p = spec.modulus
    n = A.shape[0]
    vecs = [eq_table(eq_factors(taus, spec, A.device), spec), A, B, C]
    e = claim % p
    polys, rs = [], []
    while n > 1:
        t0, t2, t3 = round_evals(CUBIC, n, vecs, spec)
        poly = UniPoly.from_evals_deg3(spec, [t0, (e - t0) % p, t2, t3])
        r = _challenge(transcript, poly)
        e = poly.evaluate(r)
        bind(vecs, n, r, spec)
        n //= 2
        polys.append(poly.compress())
        rs.append(r)
    finals = limbs_to_ints(torch.stack([A[0], B[0], C[0]]), spec, mont=True)
    return SumcheckProof(spec, polys), rs, finals


def prove_quad(transcript: Transcript, claim: int, A: torch.Tensor,
               B: torch.Tensor, spec: FieldSpec):
    """claim = sum_x A(x) B(x), degree-2 rounds with the evaluation at 2
    derived from the claim (reference prove_quad, sumcheck.rs:190-247).
    A, B are (n, 8) Montgomery tensors, bound in place.
    -> (proof, r, [A(r), B(r)])."""
    p = spec.modulus
    n = A.shape[0]
    e = claim % p
    polys, rs = [], []
    while n > 1:
        t0, t_inf = round_evals(QUAD, n, [A, B], spec)
        e2 = (2 * e - 3 * t0 + 2 * t_inf) % p
        poly = UniPoly.from_evals_deg2(spec, [t0, (e - t0) % p, e2])
        r = _challenge(transcript, poly)
        e = poly.evaluate(r)
        bind([A, B], n, r, spec)
        n //= 2
        polys.append(poly.compress())
        rs.append(r)
    finals = limbs_to_ints(torch.stack([A[0], B[0]]), spec, mont=True)
    return SumcheckProof(spec, polys), rs, finals
