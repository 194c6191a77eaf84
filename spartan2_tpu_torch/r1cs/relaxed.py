"""Regular and relaxed R1CS over Python ints: shapes, instances,
witnesses, folding and the Nova NIFS.

Reference: src/r1cs/mod.rs (R1CSShape, RelaxedR1CS*), src/r1cs/folds.rs
(commit_T, fold), src/nifs.rs (NovaNIFS); the JAX package's
r1cs/relaxed.py.  These carry the ZK wrapper's verifier-circuit
instances, a few hundred entries, so the vector arithmetic stays on the
host; commitments go through the PCS (the comb MSM on the key's device).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..errors import SpartanError, UnSatError
from ..field.constants import FieldSpec
from ..pcs.hyrax import HyraxBlind, HyraxCommitment
from ..transcript.transcript import Transcript
from .sparse import SparseMatrix


@dataclass
class R1CSShape:
    """Plain (non-split) R1CS shape (r1cs/mod.rs:170-179)."""

    field: FieldSpec
    num_cons: int
    num_vars: int
    num_io: int
    A: SparseMatrix
    B: SparseMatrix
    C: SparseMatrix

    def multiply_vec(self, z: list[int]):
        assert len(z) == self.num_vars + 1 + self.num_io
        return (self.A.multiply_vec_host(z), self.B.multiply_vec_host(z),
                self.C.multiply_vec_host(z))

    def is_sat_relaxed(self, U: "RelaxedR1CSInstance", W: "RelaxedR1CSWitness") -> None:
        """Az o Bz = u Cz + E (r1cs/mod.rs:430-471; the commitments are the
        caller's to check)."""
        p = self.field.modulus
        az, bz, cz = self.multiply_vec(W.W + [U.u] + U.X)
        for i in range(self.num_cons):
            if az[i] * bz[i] % p != (U.u * cz[i] + W.E[i]) % p:
                raise UnSatError(f"relaxed constraint {i} unsatisfied")

    def sample_random_instance_witness(self, pcs, ck, rng=None):
        """ZK blinder: a uniformly random relaxed instance
        (r1cs/mod.rs:474-531).  Draws Z, then r_W, then r_E."""
        p = self.field.modulus
        rand = rng if rng is not None else secrets.randbelow
        Z = [rand(p) for _ in range(self.num_vars + self.num_io + 1)]
        r_W = pcs.blind(ck, self.num_vars, rng=rng)
        r_E = pcs.blind(ck, self.num_cons, rng=rng)
        u = Z[self.num_vars]
        az, bz, cz = self.multiply_vec(Z)
        E_vec = [(a * b - u * c) % p for a, b, c in zip(az, bz, cz)]
        W_vec = Z[: self.num_vars]
        U = RelaxedR1CSInstance(comm_W=pcs.commit(ck, W_vec, r_W),
                                comm_E=pcs.commit(ck, E_vec, r_E),
                                u=u, X=Z[self.num_vars + 1 :])
        return U, RelaxedR1CSWitness(W=W_vec, r_W=r_W, E=E_vec, r_E=r_E)

    def commit_T(self, pcs, ck, U1, W1, U2, W2, r_T: HyraxBlind):
        """Cross term T = AZ o BZ - u CZ - E for Z = Z1 + Z2
        (r1cs/folds.rs:28-88)."""
        p = self.field.modulus
        Z = [(a + b) % p for a, b in zip(W1.W, W2.W)]
        u = (U1.u + 1) % p
        Z.append(u)
        Z.extend((a + b) % p for a, b in zip(U1.X, U2.X))
        az, bz, cz = self.multiply_vec(Z)
        T = [(a * b - u * c - e) % p for a, b, c, e in zip(az, bz, cz, W1.E)]
        is_small = all(t < (1 << 64) for t in T)
        return T, pcs.commit(ck, T, r_T, is_small)


@dataclass
class R1CSInstance:
    comm_W: HyraxCommitment
    X: list[int]

    def to_transcript_bytes(self, curve, field) -> bytes:
        return self.comm_W.to_transcript_bytes(curve) + b"".join(
            field.to_transcript_bytes(x) for x in self.X)


@dataclass
class R1CSWitnessHost:
    W: list[int]
    r_W: HyraxBlind


@dataclass
class RelaxedR1CSInstance:
    comm_W: HyraxCommitment
    comm_E: HyraxCommitment
    u: int
    X: list[int]

    def to_transcript_bytes(self, curve, field) -> bytes:
        return (self.comm_W.to_transcript_bytes(curve)
                + self.comm_E.to_transcript_bytes(curve)
                + field.to_transcript_bytes(self.u)
                + b"".join(field.to_transcript_bytes(x) for x in self.X))

    def fold(self, pcs, U2: R1CSInstance, comm_T: HyraxCommitment, r: int,
             device) -> "RelaxedR1CSInstance":
        """(r1cs/folds.rs:178-210); the commitment folds run on ``device``
        (HyraxPCS.fold_commitments)."""
        p = pcs.curve.scalar.modulus
        X = [(a + r * b) % p for a, b in zip(self.X, U2.X)]
        comm_W = pcs.fold_commitments([self.comm_W, U2.comm_W], [1, r], device)
        comm_E = pcs.fold_commitments([self.comm_E, comm_T], [1, r], device)
        return RelaxedR1CSInstance(comm_W=comm_W, comm_E=comm_E,
                                   u=(self.u + r) % p, X=X)


@dataclass
class RelaxedR1CSWitness:
    W: list[int]
    r_W: HyraxBlind
    E: list[int]
    r_E: HyraxBlind

    def fold(self, pcs, field: FieldSpec, W2: R1CSWitnessHost, T: list[int],
             r_T: HyraxBlind, r: int) -> "RelaxedR1CSWitness":
        """W + r W2, E + r T (r1cs/folds.rs:112-153)."""
        p = field.modulus
        if len(self.W) != len(W2.W) or len(self.E) != len(T):
            raise SpartanError("fold: dimension mismatch")
        return RelaxedR1CSWitness(
            W=[(a + r * b) % p for a, b in zip(self.W, W2.W)],
            r_W=pcs.fold_blinds([self.r_W, W2.r_W], [1, r]),
            E=[(a + r * b) % p for a, b in zip(self.E, T)],
            r_E=pcs.fold_blinds([self.r_E, r_T], [1, r]))


@dataclass
class NovaNIFS:
    """Nova folding proof: the cross-term commitment (nifs.rs:20-25)."""

    comm_T: HyraxCommitment

    @classmethod
    def prove(cls, pcs, ck, S: R1CSShape, U1: RelaxedR1CSInstance,
              W1: RelaxedR1CSWitness, U2: R1CSInstance, W2: R1CSWitnessHost,
              transcript: Transcript, rng=None):
        """(nifs.rs:34-61) -> (nifs, W_folded, u_folded, X_folded)."""
        curve, field = pcs.curve, S.field
        p = field.modulus
        transcript.absorb_bytes(b"U1", U1.to_transcript_bytes(curve, field))
        transcript.absorb_bytes(b"U2", U2.to_transcript_bytes(curve, field))
        r_T = pcs.blind(ck, S.num_cons, rng=rng)
        T, comm_T = S.commit_T(pcs, ck, U1, W1, U2, W2, r_T)
        transcript.absorb_bytes(b"comm_T", comm_T.to_transcript_bytes(curve))
        r = transcript.squeeze(b"r")
        W = W1.fold(pcs, field, W2, T, r_T, r)
        X_folded = [(a + r * b) % p for a, b in zip(U1.X, U2.X)]
        return cls(comm_T=comm_T), W, (U1.u + r) % p, X_folded

    def verify(self, pcs, field, transcript: Transcript, U1: RelaxedR1CSInstance,
               U2: R1CSInstance, device) -> RelaxedR1CSInstance:
        """(nifs.rs:65-77)."""
        curve = pcs.curve
        transcript.absorb_bytes(b"U1", U1.to_transcript_bytes(curve, field))
        transcript.absorb_bytes(b"U2", U2.to_transcript_bytes(curve, field))
        transcript.absorb_bytes(b"comm_T", self.comm_T.to_transcript_bytes(curve))
        r = transcript.squeeze(b"r")
        return U1.fold(pcs, U2, self.comm_T, r, device)
