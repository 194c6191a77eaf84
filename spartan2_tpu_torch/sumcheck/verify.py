"""Host-side sum-check verifier (reference: SumcheckProof::verify,
src/sumcheck.rs:67-114)."""

from __future__ import annotations

from ..errors import InvalidSumcheckProofError
from ..field.constants import FieldSpec
from ..polys.univariate import CompressedUniPoly
from ..transcript.transcript import Transcript


class SumcheckProof:
    """A list of compressed univariate polynomials (one per round)."""

    def __init__(self, field: FieldSpec, compressed_polys: list[CompressedUniPoly]):
        self.field = field
        self.compressed_polys = compressed_polys

    def prepend_round(self, round0) -> "SumcheckProof":
        return SumcheckProof(
            self.field, [round0.compress()] + list(self.compressed_polys)
        )

    def verify(
        self,
        claim: int,
        num_rounds: int,
        degree_bound: int,
        transcript: Transcript,
    ) -> tuple[int, list[int]]:
        if len(self.compressed_polys) != num_rounds:
            raise InvalidSumcheckProofError(
            "invalid sumcheck proof: wrong number of rounds")
        e = claim % self.field.modulus
        rs: list[int] = []
        for comp in self.compressed_polys:
            poly = comp.decompress(e)
            if poly.degree() != degree_bound:
                raise InvalidSumcheckProofError("invalid sumcheck proof: bad degree")
            transcript.absorb_bytes(b"p", poly.to_transcript_bytes())
            r_i = transcript.squeeze(b"c")
            rs.append(r_i)
            e = poly.evaluate(r_i)
        return e, rs
