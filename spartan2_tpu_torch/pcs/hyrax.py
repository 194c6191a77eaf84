"""Hyrax polynomial commitments and the linear inner-product argument.

Reference: src/provider/pcs/hyrax_pc.rs and src/provider/pcs/ipa.rs; the
protocol, labels and order of random draws are the JAX package's
(spartan2_tpu/pcs/hyrax.py), so proofs match it byte for byte.

Card work: row commitments and the blinds' multiples of h are comb MSMs
(kernel 3, ec/comb.py; many vectors' rows in one launch for
NeutronNova's batched commits), the L-fold of the evaluation argument is
kernel 4 (csrc/hyrax_bind.cu, ``hyrax_bind`` below), the verifier's fold
of the row commitments is the runtime-point MSM (kernel 5, ec/msm.py),
and the row-by-row folds of commitments (``fold_commitments``: the ZK
NIFS, NeutronNova's instance folds) are the row-batched MSM (kernel C,
ec/msm.py).  The IPA on the width-sized
remainder, the direct openings of the ZK wrapper's small relaxed
instance and the folds below 64 points run on the host.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import torch

from ..errors import (
    InvalidCommitmentLengthError,
    InvalidInputLengthError,
    InvalidPCSError,
    SpartanError,
)
from ..ec.comb import FixedBaseComb, to_affine
from ..ec.curve import Affine, CurveSpec
from ..ec.msm import MSM_MIN_POINTS, msm_points, msm_rows, to_jacobian
from ..field import ops
from ..field.constants import FieldSpec
from ..field.limbs import limbs_to_ints, to_device
from ..polys.eq import eq_evals_host
from ..transcript.transcript import Transcript
from ..utils.cuda import CudaKernel, I, P, check_cuda, field_words
from ..utils.tracing import span

HYRAX_BIND = CudaKernel("hyrax_bind", {"sp2_hyrax_bind": [I, I, P, P, P, P]})
_INT_MAX = (1 << 31) - 1

FULL_BITS = 256
SMALL_BITS = 64


def _div_ceil(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# kernel 4: LZ[j] = sum_r L[r] * poly[r, j]
# ---------------------------------------------------------------------------


def hyrax_bind_plain(L: torch.Tensor, poly: torch.Tensor,
                     spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``hyrax_bind``."""
    R, C = poly.shape[:2]
    prod = ops.mont_mul(L[:, None, :], poly, spec)  # (R, C, 8)
    d = ops.digits(prod).sum(1)
    return ops.from_mont(ops.reduce_digit_sums(d, spec), spec)


def hyrax_bind(L: torch.Tensor, poly: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(R, 8) Montgomery L and (R, C, 8) Montgomery rows -> (C, 8)
    canonical LZ (hyrax bind_with_delayed, hyrax_pc.rs:38-54).  On the
    card one launch: a block of 16 columns x up to 32 row slices,
    unreduced sums, one reduction a column (csrc/hyrax_bind.cu)."""
    if poly.device.type == "cpu":
        return hyrax_bind_plain(L, poly, spec)
    check_cuda(L, poly)
    R, C = poly.shape[:2]
    if poly.shape != (R, C, 8) or L.shape != (R, 8):
        raise ValueError("hyrax_bind: L must be (R, 8) and poly (R, C, 8)")
    if not (1 <= R <= _INT_MAX and 1 <= C <= _INT_MAX):  # the C side's int shapes
        raise ValueError("hyrax_bind: need 1 <= R, C < 2^31")
    out = torch.empty(C, 8, dtype=torch.int32, device=poly.device)
    HYRAX_BIND.call("sp2_hyrax_bind", R, C, L.data_ptr(), poly.data_ptr(), out.data_ptr(),
                    field_words(spec))
    return out


# ---------------------------------------------------------------------------
# commitments
# ---------------------------------------------------------------------------


@dataclass
class HyraxCommitment:
    comm: list[Affine]  # one point per row

    def to_transcript_bytes(self, curve: CurveSpec) -> bytes:
        return b"".join(curve.to_transcript_bytes(pt) for pt in self.comm)

    def __eq__(self, other):
        return isinstance(other, HyraxCommitment) and self.comm == other.comm


@dataclass
class HyraxBlind:
    blind: list[int]  # one scalar per row


@dataclass
class IpaProof:
    """Linear-size sigma protocol for c = <a, b> (ipa.rs:83-121)."""

    delta: Affine
    beta: Affine
    z_vec: list[int]
    z_delta: int
    z_beta: int


@dataclass
class HyraxEvaluationArgument:
    ipa: IpaProof


class HyraxCommitmentKey:
    """Column generators and the blind generator h (hyrax_pc.rs:57-75),
    with comb tables built on ``device`` at first use."""

    def __init__(self, curve: CurveSpec, label: bytes, width: int, device):
        self.curve = curve
        self.num_cols = width
        self.device = torch.device(device)
        gens = curve.from_label(label, width + 1)
        self.ck: list[Affine] = gens[:width]
        self.h: Affine = gens[width]
        self._combs: dict = {}

    def comb(self, nbits: int) -> FixedBaseComb:
        """Comb tables over the column generators for scalars < 2^nbits."""
        if nbits not in self._combs:
            self._combs[nbits] = FixedBaseComb(self.curve, self.ck, nbits,
                                               self.device)
        return self._combs[nbits]

    def comb_h(self) -> FixedBaseComb:
        """Comb tables for the blind generator h (full scalar width)."""
        if "h" not in self._combs:
            self._combs["h"] = FixedBaseComb(self.curve, [self.h], FULL_BITS,
                                             self.device)
        return self._combs["h"]


# The verifier key carries the same generators (hyrax_pc.rs:100-110).
HyraxVerifierKey = HyraxCommitmentKey


class HyraxPCS:
    """PCSEngineTrait equivalent (traits/pcs.rs:32-200) for one curve."""

    def __init__(self, curve: CurveSpec):
        self.curve = curve

    def setup(self, label: bytes, n: int, width: int, device="cuda"):
        ck = HyraxCommitmentKey(self.curve, label, width, device)
        return ck, ck

    def blind(self, ck: HyraxCommitmentKey, n: int, rng=None) -> HyraxBlind:
        num_rows = _div_ceil(n, ck.num_cols)
        rand = rng if rng is not None else secrets.randbelow
        p = self.curve.scalar.modulus
        return HyraxBlind([rand(p) for _ in range(num_rows)])

    # ------------------------------------------------------------------
    def _blinds_times_h(self, ck: HyraxCommitmentKey, blinds: list[int]) -> torch.Tensor:
        sc = to_device(blinds, self.curve.scalar, ck.device).reshape(-1, 1, 8)
        return ck.comb_h().rows_msm(sc)

    def commit(self, ck: HyraxCommitmentKey, v: list[int], r: HyraxBlind,
               is_small: bool = False) -> HyraxCommitment:
        """Commit to canonical values ``v``: one comb row MSM per row of
        ``num_cols`` values plus r_i * h (hyrax_pc.rs:230-300)."""
        return self.commit_from_raw_batch(ck, self.commit_raw_batch(ck, [v], is_small),
                                          [r])[0]

    def commit_raw_batch(self, ck: HyraxCommitmentKey, vecs: list,
                         is_small: bool = False) -> list[torch.Tensor]:
        """Unblinded row MSMs of several vectors of canonical values in one
        comb launch, their rows stacked on the kernel's row axis
        (pcs/hyrax.py:166-191 of the JAX package) -> one (R_i, 3, 8)
        Jacobian tensor per vector."""
        C = ck.num_cols
        rows, vals = [], []
        for v in vecs:
            R = _div_ceil(len(v), C)
            rows.append(R)
            vals += list(v) + [0] * (R * C - len(v))
        sc = to_device(vals, self.curve.scalar, ck.device).reshape(-1, C, 8)
        raw = ck.comb(SMALL_BITS if is_small else FULL_BITS).rows_msm(sc)
        return list(torch.split(raw, rows))

    def commit_from_raw_batch(self, ck: HyraxCommitmentKey, raws: list,
                              rs: list[HyraxBlind]) -> list[HyraxCommitment]:
        """Blind the raw row MSMs of ``commit_raw_batch``: every blind's
        multiple of h in one comb launch, then row + r_i h per row
        (pcs/hyrax.py:193-211 of the JAX package)."""
        bl = self._blinds_times_h(ck, [b for r in rs for b in r.blind])
        pts = to_affine(torch.cat([*raws, bl]), self.curve)
        n = bl.shape[0]
        sums = [self.curve.add(a, b) for a, b in zip(pts[:n], pts[n:])]
        out, lo = [], 0
        for raw in raws:
            out.append(HyraxCommitment(sums[lo : lo + raw.shape[0]]))
            lo += raw.shape[0]
        return out

    def commit_zeros_batch(self, ck: HyraxCommitmentKey,
                           rs: list[HyraxBlind]) -> list[HyraxCommitment]:
        """``commit_zeros`` of several blinds in one comb launch."""
        rows = [len(r.blind) for r in rs]
        flat = [b for r in rs for b in r.blind]
        pts = to_affine(self._blinds_times_h(ck, flat), self.curve) if flat else []
        out, lo = [], 0
        for R in rows:
            out.append(HyraxCommitment(pts[lo : lo + R]))
            lo += R
        return out

    def commit_host(self, ck: HyraxCommitmentKey, v: list[int], r: HyraxBlind,
                    is_small: bool = False) -> HyraxCommitment:
        """Host commit for tiny vectors (evaluation commitments)."""
        C = ck.num_cols
        R = _div_ceil(len(v), C)
        v = list(v) + [0] * (R * C - len(v))
        comm = []
        for i in range(R):
            row = v[i * C : (i + 1) * C]
            comm.append(self.curve.msm(row + [r.blind[i]], ck.ck + [ck.h]))
        return HyraxCommitment(comm)

    def commit_zeros(self, ck: HyraxCommitmentKey, n: int,
                     r: HyraxBlind) -> HyraxCommitment:
        """Blind-only commitment r_i * h per row (hyrax_pc.rs:305-319)."""
        return self.commit_zeros_batch(ck, [r])[0]

    def rerandomize_commitment(self, ck: HyraxCommitmentKey, comm: HyraxCommitment,
                               r_old: HyraxBlind, r_new: HyraxBlind) -> HyraxCommitment:
        """Row i + (r_new_i - r_old_i) h: fresh blinds without a recommit
        (bellpepper/r1cs.rs:540-603).  The multiples of h are one comb
        launch; the affine points equal the JAX package's host scalar
        multiplications."""
        if len(comm.comm) != len(r_old.blind) or len(comm.comm) != len(r_new.blind):
            raise InvalidCommitmentLengthError(
                "rerandomize_commitment: length mismatch")
        q = self.curve.scalar.modulus
        deltas = [(rn - ro) % q for ro, rn in zip(r_old.blind, r_new.blind)]
        shifts = to_affine(self._blinds_times_h(ck, deltas), self.curve)
        return HyraxCommitment([self.curve.add(pt, sh)
                                for pt, sh in zip(comm.comm, shifts)])

    def check_commitment(self, comm: HyraxCommitment, n: int, width: int) -> None:
        if len(comm.comm) != _div_ceil(n, width):
            raise SpartanError(
                f"InvalidCommitmentLength: actual {len(comm.comm)}, "
                f"expected {_div_ceil(n, width)}")

    @staticmethod
    def combine_commitments(comms: list[HyraxCommitment]) -> HyraxCommitment:
        if not comms:
            raise InvalidCommitmentLengthError("combine_commitments: empty")
        out = []
        for cm in comms:
            out.extend(cm.comm)
        return HyraxCommitment(out)

    @staticmethod
    def combine_blinds(blinds: list[HyraxBlind]) -> HyraxBlind:
        if not blinds:
            raise InvalidInputLengthError("combine_blinds: empty")
        out = []
        for b in blinds:
            out.extend(b.blind)
        return HyraxBlind(out)

    # ------------------------------------------------------------------
    # evaluation argument
    # ------------------------------------------------------------------
    def prove(self, ck: HyraxCommitmentKey, ck_eval: HyraxCommitmentKey,
              transcript: Transcript, comm: HyraxCommitment,
              poly_mont: torch.Tensor, blind: HyraxBlind, point: list[int],
              comm_eval: HyraxCommitment, blind_eval: HyraxBlind,
              rng=None) -> HyraxEvaluationArgument:
        """Reference flow at hyrax_pc.rs:387-478; ``poly_mont`` is the
        (n, 8) Montgomery evaluation table."""
        scalar = self.curve.scalar
        p = scalar.modulus
        n = poly_mont.shape[0]
        if n != (1 << len(point)):
            raise InvalidInputLengthError("Hyrax prove: poly/point size mismatch")
        rand = rng if rng is not None else secrets.randbelow

        transcript.absorb_bytes(b"poly_com", comm.to_transcript_bytes(self.curve))
        num_rows = _div_ceil(n, ck.num_cols)
        num_vars_rows = num_rows.bit_length() - 1

        if num_vars_rows == 0:
            comm_LZ = comm.comm[0]
            Rv = eq_evals_host(scalar, point)
            LZ = limbs_to_ints(poly_mont, scalar, mont=True)
            r_LZ = blind.blind[0]
            d_vec = [rand(p) for _ in Rv]
            r_delta = rand(p)
            delta = self.curve.add(self.msm_gens(ck, d_vec),
                                   self.curve.scalar_mul(r_delta, ck.h))
        else:
            # n = num_rows * num_cols, so Rv has exactly num_cols entries
            L = eq_evals_host(scalar, point[:num_vars_rows])
            Rv = eq_evals_host(scalar, point[num_vars_rows:])
            r_LZ = sum(l * b for l, b in zip(L, blind.blind)) % p
            with span("hyrax_bind_LZ"):
                Lm = to_device(L, scalar, poly_mont.device, mont=True)
                LZ_dev = hyrax_bind(Lm, poly_mont.reshape(num_rows, -1, 8), scalar)
            with span("hyrax_msm_LZ"):
                # ONE comb rows-MSM over [LZ, d_vec]; the blinds ride host
                # scalar multiples of h
                d_vec = [rand(p) for _ in Rv]
                r_delta = rand(p)
                dv = to_device(d_vec, scalar, poly_mont.device)
                pts = ck.comb(FULL_BITS).rows_msm(torch.stack([LZ_dev, dv]))
                LZ = limbs_to_ints(LZ_dev, scalar)
                affs = to_affine(pts, self.curve)
                comm_LZ = self.curve.add(affs[0], self.curve.scalar_mul(r_LZ, ck.h))
                delta = self.curve.add(affs[1], self.curve.scalar_mul(r_delta, ck.h))

        ipa = self._ipa_prove(ck_eval, comm_LZ, Rv, comm_eval.comm[0], LZ, r_LZ,
                              blind_eval.blind[0], transcript, rand,
                              delta, d_vec, r_delta)
        return HyraxEvaluationArgument(ipa)

    def verify(self, vk: HyraxVerifierKey, ck_eval: HyraxCommitmentKey,
               transcript: Transcript, comm: HyraxCommitment, point: list[int],
               comm_eval: HyraxCommitment, arg: HyraxEvaluationArgument) -> None:
        """Reference flow at hyrax_pc.rs:480-531."""
        scalar = self.curve.scalar
        transcript.absorb_bytes(b"poly_com", comm.to_transcript_bytes(self.curve))
        n = 1 << len(point)
        num_rows = _div_ceil(n, vk.num_cols)
        num_vars_rows = num_rows.bit_length() - 1
        if num_vars_rows == 0:
            Rv = eq_evals_host(scalar, point)
            comm_LZ = comm.comm[0]
        else:
            L = eq_evals_host(scalar, point[:num_vars_rows])
            Rv = eq_evals_host(scalar, point[num_vars_rows:])
            # proof-supplied points: kernel 5's adds are complete
            with span("hyrax_verify_fold"):
                comm_LZ = msm_points(L, comm.comm, self.curve, vk.device)
        self._ipa_verify(vk, ck_eval, comm_LZ, Rv, comm_eval.comm[0], arg.ipa,
                         transcript)

    # ------------------------------------------------------------------
    # direct openings (hyrax_pc.rs:609-711): a random linear combination
    # of the rows, width + 1 scalars per opening instead of an IPA
    # ------------------------------------------------------------------
    def prove_direct(self, ck: HyraxCommitmentKey, poly: list[int],
                     blind: HyraxBlind, point: list[int]) -> tuple[list[int], int]:
        """-> (v, combined blind): v = L . poly-as-matrix; the evaluation
        is <v, eq(point_right)>."""
        p = self.curve.scalar.modulus
        num_cols = ck.num_cols
        n = 1 << len(point)
        num_rows = _div_ceil(n, num_cols)
        if num_rows == 1:
            return list(poly) + [0] * (num_cols - len(poly)), blind.blind[0]
        num_vars_rows = num_rows.bit_length() - 1
        L = eq_evals_host(self.curve.scalar, point[:num_vars_rows])
        padded = list(poly) + [0] * (n - len(poly))
        v = [0] * num_cols
        for r_i, l in enumerate(L):
            row = padded[r_i * num_cols : (r_i + 1) * num_cols]
            for j in range(num_cols):
                v[j] = (v[j] + l * row[j]) % p
        return v, sum(l * b for l, b in zip(L, blind.blind)) % p

    def verify_direct(self, vk: HyraxVerifierKey, comm: HyraxCommitment,
                      v: list[int], combined_blind: int, point: list[int]) -> int:
        """Check the combination against the row commitments; -> the
        evaluation <v, eq(point_right)>."""
        scalar = self.curve.scalar
        num_cols = vk.num_cols
        if len(v) != num_cols:
            raise InvalidPCSError("direct opening: v length mismatch")
        num_rows = _div_ceil(1 << len(point), num_cols)
        num_vars_rows = num_rows.bit_length() - 1
        if num_vars_rows == 0:
            comm_LZ = comm.comm[0]
        else:
            L = eq_evals_host(scalar, point[:num_vars_rows])
            # proof-supplied points: the MSMs' adds are complete
            comm_LZ = msm_points(L[: len(comm.comm)], comm.comm, self.curve,
                                 vk.device)
        expected = self.curve.add(self.msm_gens(vk, v),
                                  self.curve.scalar_mul(combined_blind, vk.h))
        if comm_LZ != expected:
            raise InvalidPCSError("direct opening: commitment mismatch")
        Rv = eq_evals_host(scalar, point[num_vars_rows:])
        return sum(x * y for x, y in zip(v, Rv)) % scalar.modulus

    # ------------------------------------------------------------------
    # folding (FoldingEngineTrait, traits/pcs.rs:204-232)
    # ------------------------------------------------------------------
    def fold_commitments(self, comms: list[HyraxCommitment], weights: list[int],
                         device) -> HyraxCommitment:
        """Row i of the result is sum_k weights[k] comms[k][i].  With 64
        points or more and none at infinity, kernel C folds every row in
        one launch on ``device``; else the host Pippenger folds each row
        (the JAX package's threshold, pcs/hyrax.py:581-609).  The points
        may come from a proof: every addition is complete."""
        if len(comms) != len(weights) or not comms:
            raise InvalidInputLengthError("fold_commitments: bad input")
        rows = len(comms[0].comm)
        if any(len(cm.comm) != rows for cm in comms):
            raise InvalidCommitmentLengthError("fold_commitments: row counts differ")
        pts = [[cm.comm[i] for cm in comms] for i in range(rows)]
        no_inf = all(pt is not None for row in pts for pt in row)
        if rows * len(comms) >= MSM_MIN_POINTS and no_inf:
            q = self.curve.scalar.modulus
            w = [x % q for x in weights]
            sc = to_device(w, self.curve.scalar, device)
            sc = sc.expand(rows, len(comms), 8).contiguous()
            jac = to_jacobian([pt for row in pts for pt in row], self.curve, device)
            out = msm_rows(sc, jac.reshape(rows, len(comms), 3, 8), self.curve,
                           max(w).bit_length())
            return HyraxCommitment(to_affine(out, self.curve))
        return HyraxCommitment([msm_points(list(weights), row, self.curve, device)
                                for row in pts])

    def fold_commitments_partial(self, comms: list[HyraxCommitment],
                                 weights: list[int], num_data_rows: int,
                                 folded_blind: HyraxBlind, ck: HyraxCommitmentKey,
                                 device) -> HyraxCommitment:
        """Fold only the first ``num_data_rows`` rows; the rows after them
        are blind-only in every commitment (commits to zeros), so the
        folded row is folded_blind[row] h (hyrax_pc.rs:821-874; the JAX
        package's pcs/hyrax.py:611-640): one comb launch for 8 rows or
        more, host multiples of h below."""
        if not comms or len(comms) != len(weights):
            raise InvalidInputLengthError("fold_commitments_partial: bad input")
        total_rows = len(comms[0].comm)
        if num_data_rows > total_rows:
            raise InvalidInputLengthError(
                f"fold_commitments_partial: num_data_rows {num_data_rows} "
                f"exceeds total_rows {total_rows}")
        if num_data_rows == total_rows:
            return self.fold_commitments(comms, weights, device)
        data = self.fold_commitments(
            [HyraxCommitment(cm.comm[:num_data_rows]) for cm in comms], weights, device)
        rest_blinds = folded_blind.blind[num_data_rows:]
        if len(rest_blinds) >= 8:
            rest = to_affine(self._blinds_times_h(ck, rest_blinds), self.curve)
        else:
            rest = [self.curve.scalar_mul(b, ck.h) for b in rest_blinds]
        return HyraxCommitment(data.comm + rest)

    def fold_blinds(self, blinds: list[HyraxBlind], weights: list[int]) -> HyraxBlind:
        if len(blinds) != len(weights) or not blinds:
            raise InvalidInputLengthError("fold_blinds: bad input")
        p = self.curve.scalar.modulus
        rows = len(blinds[0].blind)
        return HyraxBlind([sum(w * b.blind[i] for w, b in zip(weights, blinds)) % p
                           for i in range(rows)])

    # ------------------------------------------------------------------
    # linear IPA (ipa.rs:125-221)
    # ------------------------------------------------------------------
    IPA_NAME = b"inner product argument (linear)"

    def _absorb_ipa_instance(self, transcript: Transcript, comm_a: Affine,
                             comm_c: Affine) -> None:
        transcript.dom_sep(self.IPA_NAME)
        transcript.absorb_bytes(b"U", self.curve.to_transcript_bytes(comm_a)
                                + self.curve.to_transcript_bytes(comm_c))

    def _ipa_prove(self, ck_eval, comm_a: Affine, b_vec: list[int],
                   comm_c: Affine, a_vec: list[int], r_a: int, r_c: int,
                   transcript: Transcript, rand, delta: Affine,
                   d_vec: list[int], r_delta: int) -> IpaProof:
        p = self.curve.scalar.modulus
        self._absorb_ipa_instance(transcript, comm_a, comm_c)
        r_beta = rand(p)
        ip_bd = sum(x * y for x, y in zip(b_vec, d_vec)) % p
        beta = self.curve.add(self.curve.scalar_mul(ip_bd, ck_eval.ck[0]),
                              self.curve.scalar_mul(r_beta, ck_eval.h))
        transcript.absorb_bytes(b"delta", self.curve.to_transcript_bytes(delta))
        transcript.absorb_bytes(b"beta", self.curve.to_transcript_bytes(beta))
        r = transcript.squeeze(b"r")
        z_vec = [(r * a + d) % p for a, d in zip(a_vec, d_vec)]
        z_delta = (r * r_a + r_delta) % p
        z_beta = (r * r_c + r_beta) % p
        return IpaProof(delta, beta, z_vec, z_delta, z_beta)

    def _ipa_verify(self, vk, ck_eval, comm_a: Affine, b_vec: list[int],
                    comm_c: Affine, proof: IpaProof, transcript: Transcript) -> None:
        curve = self.curve
        p = curve.scalar.modulus
        self._absorb_ipa_instance(transcript, comm_a, comm_c)
        transcript.absorb_bytes(b"delta", curve.to_transcript_bytes(proof.delta))
        transcript.absorb_bytes(b"beta", curve.to_transcript_bytes(proof.beta))
        r = transcript.squeeze(b"r")
        if len(proof.z_vec) != len(b_vec) or len(vk.ck) < len(proof.z_vec):
            raise InvalidPCSError("IPA verify: z_vec length mismatch")
        lhs1 = curve.add(curve.scalar_mul(r, comm_a), proof.delta)
        rhs1 = curve.add(self.msm_gens(vk, proof.z_vec),
                         curve.scalar_mul(proof.z_delta, vk.h))
        if lhs1 != rhs1:
            raise InvalidPCSError("IPA verify: first equation failed")
        ip_zb = sum(x * y for x, y in zip(proof.z_vec, b_vec)) % p
        lhs2 = curve.add(curve.scalar_mul(r, comm_c), proof.beta)
        rhs2 = curve.add(curve.scalar_mul(ip_zb, ck_eval.ck[0]),
                         curve.scalar_mul(proof.z_beta, ck_eval.h))
        if lhs2 != rhs2:
            raise InvalidPCSError("IPA verify: second equation failed")

    def msm_gens(self, ck: HyraxCommitmentKey, scalars: list[int]) -> Affine:
        """sum_j scalars[j] * ck[j]: host MSM below 32 scalars, else one
        full-width comb row on the key's device (complete adds); the JAX
        package's _msm_gens (pcs/hyrax.py:649), whose runtime-point MSM
        for more scalars than columns gives the same point."""
        n = len(scalars)
        C = ck.num_cols
        if n < 32 or n > C:
            return self.curve.msm(scalars, ck.ck[:n])
        sc = to_device(list(scalars) + [0] * (C - n), self.curve.scalar, ck.device)
        return to_affine(ck.comb(FULL_BITS).rows_msm(sc.reshape(1, C, 8)),
                         self.curve)[0]
