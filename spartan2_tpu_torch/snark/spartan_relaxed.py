"""Non-ZK Spartan for relaxed R1CS: Az o Bz = u Cz + E.

Reference: src/spartan_relaxed.rs; the JAX package's
snark/spartan_relaxed.py.  It proves the folded verifier-circuit
instance inside the ZK wrapper, with direct openings (a random linear
combination of Hyrax rows, width + 1 scalars per polynomial) instead of
an IPA.  Its sizes are the verifier circuit's (a few hundred entries), so
it runs on the host.

Soundness (spartan_relaxed.rs:73-78): the transcript absorbs only
(u, X), not the commitments; it is sound only inside an outer protocol
that has already bound the commitments.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import ProofVerifyError
from ..polys.eq import eq_evals_host, eq_evaluate
from ..r1cs.relaxed import R1CSShape, RelaxedR1CSInstance, RelaxedR1CSWitness
from ..sumcheck.host import prove_cubic_with_three_inputs, prove_quad
from ..sumcheck.verify import SumcheckProof
from ..transcript.transcript import Transcript


def _bind_matrix_row_vars(field, M, rx: list[int], num_cols: int) -> list[int]:
    p = field.modulus
    evals = [0] * num_cols
    for row in range(M.rows):
        w = rx[row] % p
        if w == 0:
            continue
        for k in range(M.indptr[row], M.indptr[row + 1]):
            evals[M.indices[k]] = (evals[M.indices[k]] + w * M.data[k]) % p
    return evals


def _evaluate_matrix(field, M, T_x: list[int], T_y: list[int]) -> int:
    p = field.modulus
    acc = 0
    for row in range(M.rows):
        tx = T_x[row] % p
        if tx == 0:
            continue
        s = 0
        for k in range(M.indptr[row], M.indptr[row + 1]):
            s += M.data[k] * T_y[M.indices[k]]
        acc = (acc + tx * s) % p
    return acc


@dataclass
class RelaxedR1CSSpartanProof:
    sc_proof_outer: SumcheckProof
    claims_outer: tuple  # (Az, Bz, uCz+E) at r_x
    sc_proof_inner: SumcheckProof
    v_W: list[int]
    blind_W: int
    v_E: list[int]
    blind_E: int

    @classmethod
    def prove(cls, pcs, S: R1CSShape, ck, u: int, X: list[int],
              W: RelaxedR1CSWitness, transcript: Transcript):
        """(spartan_relaxed.rs:98-212)."""
        field = S.field
        p = field.modulus
        transcript.absorb_scalar(b"u_relaxed", u)
        transcript.absorb_scalars(b"X_relaxed", X)

        num_rounds_x = (S.num_cons - 1).bit_length()
        assert S.num_cons == 1 << num_rounds_x
        num_vars_padded = 1 << max(S.num_vars - 1, 0).bit_length()
        num_rounds_y = (num_vars_padded).bit_length() - 1 + 1
        z_len = num_vars_padded * 2

        z_unpadded = W.W + [u] + X
        Az, Bz, Cz = S.multiply_vec(z_unpadded)

        taus = [transcript.squeeze(b"t") for _ in range(num_rounds_x)]
        uCzE = [(u * c + e) % p for c, e in zip(Cz, W.E)]

        sc_proof_outer, r_x, claims = prove_cubic_with_three_inputs(
            field, 0, taus, Az, Bz, uCzE, transcript
        )
        claim_Az, claim_Bz, claim_uCzE = claims
        transcript.absorb_scalars(b"claims_outer", [claim_Az, claim_Bz, claim_uCzE])

        r = transcript.squeeze(b"r")
        r_sq = r * r % p
        evals_rx = eq_evals_host(field, r_x)
        claim_E = sum(e * q for e, q in zip(W.E, evals_rx)) % p
        claim_inner = (claim_Az + r * claim_Bz + r_sq * (claim_uCzE - claim_E)) % p

        num_cols = S.num_vars + 1 + S.num_io
        eA = _bind_matrix_row_vars(field, S.A, evals_rx, num_cols)
        eB = _bind_matrix_row_vars(field, S.B, evals_rx, num_cols)
        eC = _bind_matrix_row_vars(field, S.C, evals_rx, num_cols)
        poly_ABC = [(a + r * b + r_sq * u * c) % p for a, b, c in zip(eA, eB, eC)]
        poly_ABC += [0] * (z_len - len(poly_ABC))
        poly_z = z_unpadded + [0] * (z_len - len(z_unpadded))

        sc_proof_inner, r_y, _ = prove_quad(
            field, claim_inner, num_rounds_y, poly_ABC, poly_z, transcript
        )

        v_W, blind_W = pcs.prove_direct(ck, W.W, W.r_W, r_y[1:])
        v_E, blind_E = pcs.prove_direct(ck, W.E, W.r_E, r_x)
        transcript.absorb_scalars(b"v_W", v_W)
        transcript.absorb_scalars(b"v_E", v_E)

        return cls(sc_proof_outer, (claim_Az, claim_Bz, claim_uCzE),
                   sc_proof_inner, v_W, blind_W, v_E, blind_E)

    def verify(self, pcs, S: R1CSShape, vk_ee, U: RelaxedR1CSInstance,
               transcript: Transcript) -> None:
        """(spartan_relaxed.rs:215-307)."""
        field = S.field
        p = field.modulus
        transcript.absorb_scalar(b"u_relaxed", U.u)
        transcript.absorb_scalars(b"X_relaxed", U.X)

        num_rounds_x = (S.num_cons - 1).bit_length()
        num_vars_padded = 1 << max(S.num_vars - 1, 0).bit_length()
        num_rounds_y = (num_vars_padded).bit_length() - 1 + 1

        taus = [transcript.squeeze(b"t") for _ in range(num_rounds_x)]
        claim_outer_final, r_x = self.sc_proof_outer.verify(
            0, num_rounds_x, 3, transcript
        )
        claim_Az, claim_Bz, claim_uCzE = self.claims_outer
        expected = eq_evaluate(field, taus, r_x) * (
            claim_Az * claim_Bz - claim_uCzE
        ) % p
        if claim_outer_final % p != expected:
            raise ProofVerifyError("relaxed: invalid outer sum-check")

        transcript.absorb_scalars(b"claims_outer",
                                  [claim_Az, claim_Bz, claim_uCzE])
        r = transcript.squeeze(b"r")
        r_sq = r * r % p

        eval_E = pcs.verify_direct(vk_ee, U.comm_E, self.v_E, self.blind_E, r_x)
        claim_inner = (claim_Az + r * claim_Bz + r_sq * (claim_uCzE - eval_E)) % p
        claim_inner_final, r_y = self.sc_proof_inner.verify(
            claim_inner, num_rounds_y, 2, transcript
        )

        eval_W = pcs.verify_direct(vk_ee, U.comm_W, self.v_W, self.blind_W, r_y[1:])

        T_x = eq_evals_host(field, r_x)
        T_y = eq_evals_host(field, r_y)
        eval_Z = (1 - r_y[0]) * eval_W % p
        eval_Z = (eval_Z + U.u * T_y[S.num_vars]) % p
        for j, x_j in enumerate(U.X):
            eval_Z = (eval_Z + x_j * T_y[S.num_vars + 1 + j]) % p

        eval_A = _evaluate_matrix(field, S.A, T_x, T_y)
        eval_B = _evaluate_matrix(field, S.B, T_x, T_y)
        eval_C = _evaluate_matrix(field, S.C, T_x, T_y)
        eval_ABC = (eval_A + r * eval_B + r_sq * U.u * eval_C) % p
        if claim_inner_final % p != eval_ABC * eval_Z % p:
            raise ProofVerifyError("relaxed: invalid inner sum-check")

        transcript.absorb_scalars(b"v_W", self.v_W)
        transcript.absorb_scalars(b"v_E", self.v_E)
