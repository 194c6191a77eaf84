"""Sum-check provers on kernel 2, with the Fiat-Shamir transcript on the
host.

The rounds are the drivers of sumcheck/zk_device.py with one instance:
each round launches one evaluation (3 or 2 sums pulled to the host), the
host builds the round polynomial, absorbs it and squeezes the challenge
(labels b"p" / b"c", as the reference's sumcheck.rs and the JAX
package's provers), then one bind launch halves the vectors in place.
The round polynomial is the unique one through its evaluations, so the
messages equal the JAX package's fused provers byte for byte.
"""

from __future__ import annotations

import torch

from ..field.constants import FieldSpec
from ..polys.univariate import UniPoly
from ..transcript.transcript import Transcript
from .device import eq_factors, eq_table
from .verify import SumcheckProof
from .zk_device import prove_zk_cubic, prove_zk_quad


def challenge(transcript: Transcript, poly: UniPoly) -> int:
    """Absorb a round polynomial, squeeze the round's challenge."""
    transcript.absorb_bytes(b"p", poly.to_transcript_bytes())
    return transcript.squeeze(b"c")


def _recording(transcript: Transcript, polys: list):
    """A challenge_fn that keeps each round's compressed polynomial."""

    def fn(round_index: int, unis) -> int:
        polys.append(unis[0].compress())
        return challenge(transcript, unis[0])

    return fn


def prove_cubic_eq(transcript: Transcript, taus: list[int], A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, spec: FieldSpec,
                   claim: int = 0):
    """claim = sum_x eq(tau, x) (A(x) B(x) - C(x)) over 2^len(taus) points
    (reference prove_cubic_with_three_inputs, sumcheck.rs:502-571).
    A, B, C are (n, 8) Montgomery tensors, bound in place.
    -> (proof, r_x, [A(r_x), B(r_x), C(r_x)])."""
    polys: list = []
    E = eq_table(eq_factors(taus, spec, A.device), spec)
    rs, finals, _ = prove_zk_cubic(spec, [claim], E, (A[None], B[None], C[None]),
                                   _recording(transcript, polys))
    return SumcheckProof(spec, polys), rs, list(finals[0])


def prove_quad(transcript: Transcript, claim: int, A: torch.Tensor,
               B: torch.Tensor, spec: FieldSpec):
    """claim = sum_x A(x) B(x), degree-2 rounds with the evaluation at 2
    derived from the claim (reference prove_quad, sumcheck.rs:190-247).
    A, B are (n, 8) Montgomery tensors, bound in place.
    -> (proof, r, [A(r), B(r)])."""
    polys: list = []
    rs, finals = prove_zk_quad(spec, [claim], (A[None], B[None]),
                               A.shape[0].bit_length() - 1,
                               _recording(transcript, polys))
    return SumcheckProof(spec, polys), rs, list(finals[0])
