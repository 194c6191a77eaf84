"""Multi-round split R1CS: shapes, instances and the per-round witness
protocol of the ZK wrapper's verifier circuit.

Reference: SplitMultiRoundR1CSShape/Instance (r1cs/mod.rs:1401-1430,
1553-1819) and the multi-round witness machinery (bellpepper/r1cs.rs:
605-848); the JAX package's r1cs/multiround.py.  ``process_round`` is the
ZK Fiat-Shamir engine: synthesize a round, commit its variables, absorb
the commitment, squeeze the round's challenges.

Multi-round circuits inputize challenges BEFORE public values, so the
regular instance X = challenges ++ public (r1cs/mod.rs:1801-1819),
the opposite of single-round split instances.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Optional, Protocol

from ..errors import SpartanError
from ..field.constants import FieldSpec
from ..frontend.constraint_system import ConstraintSystem, Num
from ..pcs.hyrax import HyraxCommitment
from ..transcript.transcript import Transcript
from ..utils.tracing import span
from .relaxed import R1CSInstance, R1CSShape, R1CSWitnessHost
from .shape import _next_pow2, pad_to_width
from .sparse import SparseMatrix

class MultiRoundCircuitAPI(Protocol):
    """MultiRoundCircuit (traits/circuit.rs:59-88)."""

    def num_challenges(self, round_index: int) -> int: ...

    def rounds(self, cs: ConstraintSystem, round_index: int,
               prior_round_vars: list[list[Num]],
               prev_challenges: list[list[Num]],
               challenges: Optional[list[int]]) -> tuple[list[Num], list[Num]]: ...

    def num_rounds(self) -> int: ...

    def commitment_width(self) -> int: ...


class SplitMultiRoundR1CSShape:
    def __init__(self, field: FieldSpec, width: int, num_cons: int,
                 num_vars_per_round: list[int],
                 num_challenges_per_round: list[int], num_public: int,
                 A: SparseMatrix, B: SparseMatrix, C: SparseMatrix):
        assert width > 0 and width & (width - 1) == 0
        num_rounds = len(num_vars_per_round)
        assert len(num_challenges_per_round) == num_rounds
        self.field = field
        self.commitment_width = width
        self.num_rounds = num_rounds
        self.num_vars_per_round_unpadded = list(num_vars_per_round)
        self.num_vars_per_round = [pad_to_width(width, n) for n in num_vars_per_round]
        self.num_challenges_per_round = list(num_challenges_per_round)
        self.num_public = num_public
        self.num_cons_unpadded = num_cons
        self.num_cons = _next_pow2(num_cons)

        total_vars = sum(num_vars_per_round)
        total_vars_p = sum(self.num_vars_per_round)

        # per-round column remap into the padded layout
        offsets, padded_offsets = [], []
        cur = curp = 0
        for r in range(num_rounds):
            offsets.append(cur)
            padded_offsets.append(curp)
            cur += num_vars_per_round[r]
            curp += self.num_vars_per_round[r]

        def remap(col: int) -> int:
            for r in range(num_rounds):
                if offsets[r] <= col < offsets[r] + num_vars_per_round[r]:
                    return padded_offsets[r] + (col - offsets[r])
            assert col >= total_vars
            return col + total_vars_p - total_vars

        def apply_pad(M: SparseMatrix) -> SparseMatrix:
            indices = [remap(c) for c in M.indices]
            indptr = list(M.indptr) + [M.indptr[-1]] * (self.num_cons - num_cons)
            return SparseMatrix(field, list(M.data), indices, indptr,
                                M.cols + total_vars_p - total_vars)

        self.A = apply_pad(A)
        self.B = apply_pad(B)
        self.C = apply_pad(C)

    @property
    def total_vars(self) -> int:
        return sum(self.num_vars_per_round)

    @property
    def total_challenges(self) -> int:
        return sum(self.num_challenges_per_round)

    def to_regular_shape(self) -> R1CSShape:
        return R1CSShape(self.field, self.num_cons, self.total_vars,
                         self.total_challenges + self.num_public,
                         self.A, self.B, self.C)

    @classmethod
    def from_circuit(cls, circuit: MultiRoundCircuitAPI,
                     field: FieldSpec) -> "SplitMultiRoundR1CSShape":
        """multiround_r1cs_shape (bellpepper/r1cs.rs:605-695)."""
        cs = ConstraintSystem(field, shape_mode=True)
        vars_per_round: list[list[Num]] = []
        challenges_per_round: list[list[Num]] = []
        num_vars_per_round: list[int] = []
        num_challenges_per_round: list[int] = []
        for rnd in range(circuit.num_rounds()):
            num_challenges_per_round.append(circuit.num_challenges(rnd))
            prev_aux = cs.num_aux
            rv, rc = circuit.rounds(cs, rnd, vars_per_round,
                                    challenges_per_round, None)
            num_vars_per_round.append(cs.num_aux - prev_aux)
            vars_per_round.append(rv)
            challenges_per_round.append(rc)

        total_vars = cs.num_aux
        num_inputs = cs.num_inputs

        def var_col(var) -> int:
            kind, idx = var
            if kind == "aux":
                return idx
            if kind == "one":
                return total_vars
            return total_vars + idx

        p = field.modulus
        mats = []
        for pick in range(3):
            entries = []
            for row, cons in enumerate(cs.constraints):
                for var, coeff in cons[pick].items():
                    if coeff % p != 0:
                        entries.append((row, var_col(var), coeff % p))
            mats.append(SparseMatrix.from_coo(
                field, entries, len(cs.constraints), total_vars + num_inputs))
        num_public = num_inputs - 1 - sum(num_challenges_per_round)
        return cls(field, circuit.commitment_width(), len(cs.constraints),
                   num_vars_per_round, num_challenges_per_round, num_public,
                   mats[0], mats[1], mats[2])


@dataclass
class SplitMultiRoundR1CSInstance:
    comm_w_per_round: list[HyraxCommitment]
    public_values: list[int]
    challenges_per_round: list[list[int]]

    def validate(self, s: SplitMultiRoundR1CSShape, pcs,
                 transcript: Transcript) -> None:
        """(r1cs/mod.rs:1774-1799): re-derive the per-round challenges."""
        if len(self.comm_w_per_round) != s.num_rounds or len(
                self.challenges_per_round) != s.num_rounds:
            raise SpartanError("verifier instance has the wrong number of rounds")
        for rnd in range(s.num_rounds):
            pcs.check_commitment(self.comm_w_per_round[rnd],
                                 s.num_vars_per_round[rnd], s.commitment_width)
            transcript.absorb_bytes(
                b"comm_w_round",
                self.comm_w_per_round[rnd].to_transcript_bytes(pcs.curve))
            derived = [transcript.squeeze(b"challenge")
                       for _ in range(s.num_challenges_per_round[rnd])]
            if self.challenges_per_round[rnd] != derived:
                raise SpartanError(f"challenges do not match for round {rnd}")

    def to_regular_instance(self, pcs) -> R1CSInstance:
        comm_w = pcs.combine_commitments(self.comm_w_per_round)
        challenges = [c for rnd in self.challenges_per_round for c in rnd]
        return R1CSInstance(comm_W=comm_w, X=challenges + self.public_values)


@dataclass
class MultiRoundState:
    """(bellpepper/r1cs.rs:697-715)."""

    cs: ConstraintSystem
    s: SplitMultiRoundR1CSShape
    vars_per_round: list = dfield(default_factory=list)
    challenges_per_round_vars: list = dfield(default_factory=list)
    challenges: list = dfield(default_factory=list)
    comm_w_per_round: list = dfield(default_factory=list)
    r_w_per_round: list = dfield(default_factory=list)
    w: list = dfield(default_factory=list)
    current_round: int = 0

    @classmethod
    def initialize(cls, s: SplitMultiRoundR1CSShape) -> "MultiRoundState":
        cs = ConstraintSystem(s.field, shape_mode=False)
        return cls(cs=cs, s=s, w=[0] * s.total_vars)

    def process_round(self, pcs, ck, circuit: MultiRoundCircuitAPI,
                      round_index: int, transcript: Transcript,
                      rng=None) -> list[int]:
        """(bellpepper/r1cs.rs:735-816): synthesize, commit (one blind per
        row), absorb, squeeze this round's challenges."""
        s = self.s
        if round_index != self.current_round:
            raise SpartanError(
                f"expected round {self.current_round}, got {round_index}")
        chals = self.challenges[round_index - 1] if round_index > 0 else None
        rv, rc = circuit.rounds(self.cs, round_index, self.vars_per_round,
                                self.challenges_per_round_vars, chals)

        start_u = sum(s.num_vars_per_round_unpadded[:round_index])
        start_p = sum(s.num_vars_per_round[:round_index])
        n_u = s.num_vars_per_round_unpadded[round_index]
        if len(self.cs.aux_assignment) >= start_u + n_u:
            self.w[start_p : start_p + n_u] = self.cs.aux_assignment[
                start_u : start_u + n_u]

        n_p = s.num_vars_per_round[round_index]
        r_w = pcs.blind(ck, n_p, rng=rng)
        seg = self.w[start_p : start_p + n_p]
        # a round holds one commitment-width row (16 values): a host
        # commit, a 17-point MSM in C (native/ec_host.c).  The JAX package
        # commits on the host up to 4096 values when its C library loads
        # and 256 without (r1cs/multiround.py:231); a row here is always
        # below both, and the port's C library always loads, so every
        # round commits on the host.
        with span("vc_commit"):
            comm = pcs.commit_host(ck, seg, r_w)
            transcript.absorb_bytes(b"comm_w_round",
                                    comm.to_transcript_bytes(pcs.curve))
            challenges = [transcript.squeeze(b"challenge")
                          for _ in range(s.num_challenges_per_round[round_index])]

        self.vars_per_round.append(rv)
        self.challenges_per_round_vars.append(rc)
        self.comm_w_per_round.append(comm)
        self.r_w_per_round.append(r_w)
        self.challenges.append(challenges)
        self.current_round += 1
        return challenges

    def finalize(self, pcs) -> tuple[SplitMultiRoundR1CSInstance, R1CSWitnessHost]:
        """(bellpepper/r1cs.rs:818-848)."""
        s = self.s
        if self.current_round != s.num_rounds:
            raise SpartanError("not all rounds processed")
        public_values = self.cs.input_assignment[1 + s.total_challenges :]
        if len(public_values) != s.num_public:
            raise SpartanError(
                f"expected {s.num_public} public values, got {len(public_values)}")
        U = SplitMultiRoundR1CSInstance(
            comm_w_per_round=list(self.comm_w_per_round),
            public_values=list(public_values),
            challenges_per_round=[list(c) for c in self.challenges])
        W = R1CSWitnessHost(W=list(self.w),
                            r_W=pcs.combine_blinds(self.r_w_per_round))
        return U, W
