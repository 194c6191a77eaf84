"""Split R1CS shapes, instances and witnesses (reference: src/r1cs/mod.rs).

``SplitR1CSShape`` carries the padded constraint matrices and the
shared / precommitted / rest witness segmentation with per-segment
padding to the commitment width, total variables padded to a power of
two, and constraints padded to a power of two (reference
SplitR1CSShape::new, r1cs/mod.rs:810-911).  The host part is the JAX
package's (spartan2_tpu/r1cs/shape.py).

Device part: ``attach_device`` uploads the matrices as CSR with
Montgomery coefficients; Az/Bz/Cz, the transposed bind that builds
poly_ABC, and the verifier's MLE evaluation all run on kernel 1
(csrc/spmv.cu), the eq tables and dot products on kernel 2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..errors import IncorrectWitnessError, UnSatError
from ..field.constants import FieldSpec
from ..frontend.constraint_system import ConstraintSystem, SpartanCircuitAPI
from ..pcs.hyrax import HyraxCommitment
from ..sumcheck.device import DOT, eq_factors, eq_table, round_evals
from ..transcript.transcript import Transcript
from .sparse import (DeviceCSR, RowClasses, SparseMatrix, mont_values, spmv,
                     spmv_batched, spmv_combine)

DEFAULT_COMMITMENT_WIDTH = 2048  # reference lib.rs:63


def pad_to_width(width: int, n: int) -> int:
    """Round n up to the next multiple of width; 0 stays 0
    (r1cs/mod.rs:304-311)."""
    if n == 0:
        return 0
    return (n + width - 1) & ~(width - 1)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 0 else 1


class SplitR1CSShape:
    def __init__(self, field: FieldSpec, num_cons: int, num_shared: int,
                 num_precommitted: int, num_rest: int, num_public: int,
                 num_challenges: int, A: SparseMatrix, B: SparseMatrix,
                 C: SparseMatrix, width: int = DEFAULT_COMMITMENT_WIDTH):
        self.field = field
        self.width = width

        num_shared_p = pad_to_width(width, num_shared)
        num_precommitted_p = pad_to_width(width, num_precommitted)
        num_rest_p = pad_to_width(width, num_rest)

        num_vars_p = num_shared_p + num_precommitted_p + num_rest_p
        if num_vars_p < num_public + num_challenges + 1:
            num_rest_p = max(num_public + num_challenges + 1, num_vars_p) - (
                num_shared_p + num_precommitted_p
            )
        num_vars_p = num_shared_p + num_precommitted_p + num_rest_p
        if _next_pow2(num_vars_p) != num_vars_p:
            num_rest_p = _next_pow2(num_vars_p) - (num_shared_p + num_precommitted_p)

        num_vars = num_shared + num_precommitted + num_rest
        num_vars_p = num_shared_p + num_precommitted_p + num_rest_p
        num_cons_p = _next_pow2(num_cons)

        # re-index columns into the padded layout (r1cs/mod.rs:858-888)
        def remap(col: int) -> int:
            if col < num_shared:
                return col
            if col < num_shared + num_precommitted:
                return col + num_shared_p - num_shared
            if col < num_vars:
                return col + (num_shared_p + num_precommitted_p) - (
                    num_shared + num_precommitted
                )
            return col + num_vars_p - num_vars

        def apply_pad(M: SparseMatrix) -> SparseMatrix:
            indices = [remap(c) for c in M.indices]
            indptr = list(M.indptr) + [M.indptr[-1]] * (num_cons_p - num_cons)
            return SparseMatrix(field, list(M.data), indices, indptr,
                                M.cols + num_vars_p - num_vars)

        self.num_cons = num_cons_p
        self.num_cons_unpadded = num_cons
        self.num_shared_unpadded = num_shared
        self.num_precommitted_unpadded = num_precommitted
        self.num_rest_unpadded = num_rest
        self.num_shared = num_shared_p
        self.num_precommitted = num_precommitted_p
        self.num_rest = num_rest_p
        self.num_public = num_public
        self.num_challenges = num_challenges
        self.A = apply_pad(A)
        self.B = apply_pad(B)
        self.C = apply_pad(C)

        self.dev: Optional[dict] = None

    @staticmethod
    def equalize(S_a: "SplitR1CSShape", S_b: "SplitR1CSShape") -> None:
        """Grow both shapes to common (num_cons, num_vars) by extending
        num_rest and shifting the public and challenge columns (reference
        equalize, r1cs/mod.rs:913-974).  Call before attach_device."""
        num_cons_p = max(S_a.num_cons, S_b.num_cons)
        num_vars_p = max(S_a.num_vars, S_b.num_vars)
        for S in (S_a, S_b):
            if S.dev is not None:
                raise ValueError("equalize must run before attach_device")
            shift = num_vars_p - S.num_vars
            for M in (S.A, S.B, S.C):
                if shift:
                    M.indices = [c + shift if c >= S.num_vars else c
                                 for c in M.indices]
                M.cols += shift
                M.indptr.extend([M.indptr[-1]] * (num_cons_p - S.num_cons))
            S.num_rest = num_vars_p - (S.num_shared + S.num_precommitted)
            S.num_cons = num_cons_p

    @property
    def num_vars(self) -> int:
        return self.num_shared + self.num_precommitted + self.num_rest

    @property
    def num_cols(self) -> int:
        """Matrix column count: vars + 1 + public + challenges."""
        return self.num_vars + 1 + self.num_public + self.num_challenges

    def sizes(self) -> list[int]:
        return [
            self.num_cons_unpadded, self.num_shared_unpadded,
            self.num_precommitted_unpadded, self.num_rest_unpadded,
            self.num_cons, self.num_shared, self.num_precommitted,
            self.num_rest, self.num_public, self.num_challenges,
        ]

    @classmethod
    def from_circuit(cls, circuit: SpartanCircuitAPI, field: FieldSpec,
                     width: int = DEFAULT_COMMITMENT_WIDTH) -> "SplitR1CSShape":
        """ShapeCS::r1cs_shape (bellpepper/r1cs.rs:134-231): run the 3
        synthesis phases on a shape-only CS and collect CSR matrices."""
        cs = ConstraintSystem(field, shape_mode=True)
        shared = circuit.shared(cs)
        num_shared = cs.num_aux
        precommitted = circuit.precommitted(cs, shared)
        num_precommitted = cs.num_aux - num_shared
        circuit.synthesize(cs, shared, precommitted, None)
        num_challenges = circuit.num_challenges()

        num_vars = cs.num_aux
        num_inputs = cs.num_inputs  # includes ONE
        assert num_inputs > num_challenges
        num_rest = num_vars - num_shared - num_precommitted

        def var_col(var) -> int:
            kind, idx = var
            if kind == "aux":
                return idx
            if kind == "one":
                return num_vars
            return num_vars + idx  # input idx >= 1 offsets past ONE

        p = field.modulus
        mats = []
        for pick in range(3):
            entries = []
            for row, cons in enumerate(cs.constraints):
                comb = cons[pick]
                for var, coeff in comb.items():
                    if coeff % p != 0:
                        entries.append((row, var_col(var), coeff % p))
            mats.append(
                SparseMatrix.from_coo(field, entries, len(cs.constraints),
                                      num_vars + num_inputs)
            )
        return cls(
            field, len(cs.constraints), num_shared, num_precommitted, num_rest,
            num_inputs - 1 - num_challenges, num_challenges,
            mats[0], mats[1], mats[2], width,
        )

    # ------------------------------------------------------------------
    # device
    # ------------------------------------------------------------------
    def attach_device(self, device) -> None:
        """Upload A, B, C, their transposes over num_cols rows (with their
        joint row classes), and the prefix / suffix column slices used with
        a prep cache."""
        if self.dev is not None:
            return
        d = {"device": torch.device(device)}
        lo = self.num_shared + self.num_precommitted
        for name, M in (("A", self.A), ("B", self.B), ("C", self.C)):
            mv = mont_values(M)
            d[name] = DeviceCSR.build(M, device, mvals=mv)
            d[name + "t"] = DeviceCSR.build(M, device, transpose_rows=self.num_cols,
                                            mvals=mv)
            if 0 < lo < self.num_cols:
                d[name + "_pre"] = DeviceCSR.build(M, device, col_max=lo, mvals=mv)
                d[name + "_sfx"] = DeviceCSR.build(M, device, col_min=lo, mvals=mv)
        d["t_classes"] = RowClasses.joint([d[n + "t"] for n in "ABC"])
        self.dev = d

    def _mats(self, suffix: str = "") -> list:
        return [self.dev[n + suffix] for n in "ABC"]

    def multiply_vec(self, z: torch.Tensor) -> torch.Tensor:
        """(num_cols, 8) Montgomery z -> (3, num_cons, 8) Az, Bz, Cz
        (reference multiply_vec, r1cs/mod.rs:1075-1107)."""
        return spmv(self._mats(), z, self.field)

    def multiply_vec_batched(self, z: torch.Tensor) -> torch.Tensor:
        """(I, num_cols, 8) Montgomery z of I instances -> (3, I, num_cons, 8)
        Az, Bz, Cz, in one launch (reference multiply_vec_batched,
        r1cs/mod.rs:1132-1166)."""
        return spmv_batched(self._mats(), z, self.field)

    def multiply_vec_precommitted(self, z_prefix: torch.Tensor) -> torch.Tensor:
        """Cacheable products over the shared + precommitted columns
        (reference multiply_vec_precommitted, r1cs/mod.rs:1112-1128)."""
        return spmv(self._mats("_pre"), z_prefix, self.field)

    def multiply_vec_incremental(self, z: torch.Tensor,
                                 cached: torch.Tensor) -> torch.Tensor:
        """cached prefix products + the suffix columns' products
        (reference multiply_vec_incremental_into, r1cs/mod.rs:1170-1211)."""
        return spmv(self._mats("_sfx"), z, self.field, prefix=cached)

    def bind_and_prepare_poly_ABC(self, r_x: list[int], r: int) -> torch.Tensor:
        """poly_ABC[j] = sum_i eq(r_x, i) (A + r B + r^2 C)[i, j] over the
        num_cols domain (reference r1cs/mod.rs:1235-1398)."""
        return self.bind_and_prepare_poly_ABC_dev(
            eq_factors(r_x, self.field, self.dev["device"]), r)

    def bind_and_prepare_poly_ABC_dev(self, factors: torch.Tensor, r: int) -> torch.Tensor:
        """``bind_and_prepare_poly_ABC`` from the eq factors [r_x, 1 - r_x]
        ((2m, 8) Montgomery) already on the device, as the sum-check's
        round finishes wrote them (the JAX package's
        bind_and_prepare_poly_ABC_device)."""
        eq = eq_table(factors, self.field)
        return spmv_combine(self._mats("t"), eq, r, self.field, self.dev["t_classes"])

    def evaluate_at(self, r_x: list[int], r_y: list[int]):
        """(eval_A, eval_B, eval_C) MLE evaluations at (r_x, r_y): eq
        tables, one SpMV over T_y and three dot products with T_x, on the
        shape's device (the reference's evaluate_with_tables,
        r1cs/mod.rs:36-146, 1216-1226)."""
        dev = self.dev["device"]
        F = self.field
        Tx = eq_table(eq_factors(r_x, F, dev), F)
        Ty = eq_table(eq_factors(r_y, F, dev), F)[: self.num_cols]
        M = self.multiply_vec(Ty)
        return tuple(round_evals(DOT, self.num_cons, [Tx, M[k]], F)[0]
                     for k in range(3))

    def is_sat_host(self, z: list[int]) -> None:
        """Raise UnSatError unless (A z) * (B z) = C z row by row, over
        Python ints (z = (W, 1, X) at width num_cols)."""
        p = self.field.modulus
        az = self.A.multiply_vec_host(z)
        bz = self.B.multiply_vec_host(z)
        cz = self.C.multiply_vec_host(z)
        for i, (a, b, c) in enumerate(zip(az, bz, cz)):
            if a * b % p != c % p:
                raise UnSatError(f"constraint {i} unsatisfied")


@dataclass
class SplitR1CSInstance:
    """r1cs/mod.rs:797-806 SplitR1CSInstance."""

    comm_W_shared: Optional[HyraxCommitment]
    comm_W_precommitted: Optional[HyraxCommitment]
    comm_W_rest: HyraxCommitment
    public_values: list[int]
    challenges: list[int]

    def validate(self, S: SplitR1CSShape, pcs, transcript: Transcript) -> None:
        """Re-derive challenges from the transcript and check commitment
        shapes (r1cs/mod.rs:1490-1533)."""
        if S.num_shared > 0:
            if self.comm_W_shared is None:
                raise IncorrectWitnessError("comm_W_shared is missing")
            pcs.check_commitment(self.comm_W_shared, S.num_shared, S.width)
            transcript.absorb_bytes(
                b"comm_W_shared", self.comm_W_shared.to_transcript_bytes(pcs.curve))
        if S.num_precommitted > 0:
            if self.comm_W_precommitted is None:
                raise IncorrectWitnessError("comm_W_precommitted is missing")
            pcs.check_commitment(self.comm_W_precommitted, S.num_precommitted,
                                 S.width)
            transcript.absorb_bytes(
                b"comm_W_precommitted",
                self.comm_W_precommitted.to_transcript_bytes(pcs.curve))
        challenges = [transcript.squeeze(b"challenge")
                      for _ in range(S.num_challenges)]
        if challenges != self.challenges:
            raise IncorrectWitnessError("challenges do not match")
        pcs.check_commitment(self.comm_W_rest, S.num_rest, S.width)
        transcript.absorb_bytes(
            b"comm_W_rest", self.comm_W_rest.to_transcript_bytes(pcs.curve))

    def to_regular(self, pcs) -> tuple[HyraxCommitment, list[int]]:
        """Combine partial commitments; X = public ++ challenges
        (r1cs/mod.rs:1535-1553)."""
        parts = [cm for cm in (self.comm_W_shared, self.comm_W_precommitted,
                               self.comm_W_rest) if cm is not None]
        return pcs.combine_commitments(parts), self.public_values + self.challenges


@dataclass
class R1CSWitness:
    """Witness: (num_vars, 8) Montgomery device tensor + combined blind."""

    W: torch.Tensor
    r_W: object  # HyraxBlind
