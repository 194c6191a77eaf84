"""SpartanZkSNARK: zero knowledge by Nova folding against a random
relaxed instance.

Reference: src/spartan_zk.rs; the protocol, transcript labels, absorb
order and order of random draws are the JAX package's
(spartan2_tpu/snark/spartan_zk.py, its device branch), so with the same
blinds the proof bytes are equal.  The prover runs the non-ZK Spartan
protocol, but every sum-check round polynomial becomes witness of the
SpartanVerifierCircuit, committed round by round by
MultiRoundState.process_round (Fiat-Shamir through those commitments).
The verifier-circuit instance is then hidden by folding it with a random
relaxed instance (NIFS) and proved with a small relaxed-Spartan proof; a
final PCS argument opens the original witness against the eval_W commit
round.

Card work: the Az/Bz/Cz SpMV over the whole z and poly_ABC (kernel 1),
the eq table and the ZK sum-check rounds (kernel A), the structured
inner round 0 (kernel B), the witness commits and blinds (kernel 3), the
PCS L-fold (kernel 4); in verify, the MLE evaluation of A, B, C and the
row folds of the Hyrax and NIFS verifiers (kernels 5 and C).  The
verifier circuit's commits, NIFS and relaxed SNARK are host work at its
size (43 rounds of 16 values).  The entry points run under
torch.inference_mode, as SpartanSNARK's do.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from ..errors import DivisionByZeroError, ProofVerifyError, SpartanError
from ..pcs.hyrax import HyraxEvaluationArgument
from ..polys.eq import eq_evaluate
from ..polys.multilinear import sparse_poly_evaluate_host
from ..provider.engines import Engine
from ..r1cs.multiround import (MultiRoundState, SplitMultiRoundR1CSInstance,
                               SplitMultiRoundR1CSShape)
from ..r1cs.relaxed import NovaNIFS, R1CSShape, RelaxedR1CSInstance
from ..r1cs.shape import SplitR1CSInstance, SplitR1CSShape
from ..sumcheck.device import eq_factors, eq_table, new_ticket
from ..sumcheck.zk_device import inner_round0, prove_zk_cubic, prove_zk_quad
from ..utils.digest import vk_digest
from ..utils.tracing import span
from .spartan import (PrecommittedState, SpartanPrepSNARK, _log2, _upload_mont,
                      precommitted_witness, r1cs_instance_and_witness,
                      shared_witness)
from .spartan_relaxed import RelaxedR1CSSpartanProof
from .zk_circuits import SpartanVerifierCircuit


@dataclass
class SpartanZkProverKey:
    engine: Engine
    S: SplitR1CSShape
    ck: object
    vc_shape: SplitMultiRoundR1CSShape
    vc_shape_regular: R1CSShape
    vc_ck: object
    vk_digest: bytes

    @property
    def device(self) -> torch.device:
        return self.S.dev["device"]


@dataclass
class SpartanZkVerifierKey:
    engine: Engine
    S: SplitR1CSShape
    vk_ee: object
    vc_shape: SplitMultiRoundR1CSShape
    vc_shape_regular: R1CSShape
    vc_ck: object
    vc_vk: object
    digest: bytes


@dataclass
class SpartanZkSNARKProof:
    U: SplitR1CSInstance
    U_verifier: SplitMultiRoundR1CSInstance
    random_U: RelaxedR1CSInstance
    nifs: NovaNIFS
    relaxed_snark: RelaxedR1CSSpartanProof
    eval_arg: HyraxEvaluationArgument


def rerandomize_in_place(engine: Engine, ps: PrecommittedState,
                         S: SplitR1CSShape, ck, rng=None) -> None:
    """Fresh blinds on the shared and precommitted commitments without
    re-synthesis (bellpepper/r1cs.rs:540-603): the shared blinds are
    drawn first, then the precommitted ones."""
    pcs = engine.pcs
    if ps.comm_W_shared is not None:
        new_blind = pcs.blind(ck, S.num_shared, rng=rng)
        ps.comm_W_shared = pcs.rerandomize_commitment(
            ck, ps.comm_W_shared, ps.r_W_shared, new_blind)
        ps.r_W_shared = new_blind
    if ps.comm_W_precommitted is not None:
        new_blind = pcs.blind(ck, S.num_precommitted, rng=rng)
        ps.comm_W_precommitted = pcs.rerandomize_commitment(
            ck, ps.comm_W_precommitted, ps.r_W_precommitted, new_blind)
        ps.r_W_precommitted = new_blind


class SpartanZkSNARK:
    VC_COMMITMENT_WIDTH = 16  # reference spartan_zk.rs:196

    @staticmethod
    @torch.inference_mode()
    def setup(engine: Engine, circuit, width: int = 2048, device="cuda"):
        """Keys whose device state (matrices, comb tables) lives on
        ``device``."""
        with span("setup_shape"):
            S = SplitR1CSShape.from_circuit(circuit, engine.scalar, width)
        return SpartanZkSNARK.setup_from_shape(engine, S, device)

    @staticmethod
    @torch.inference_mode()
    def setup_from_shape(engine: Engine, S: SplitR1CSShape, device="cuda"):
        """Keys from a shape (synthesized, or read back from bytes): every
        other key component derives from it (spartan_zk.rs:163-232)."""
        with span("setup_upload"):
            S.attach_device(device)
        with span("setup_generators"):
            ck, vk_ee = engine.pcs.setup(b"ck", S.num_vars, S.width, device)
        with span("setup_verifier_circuit"):
            vc = SpartanVerifierCircuit(engine.scalar, _log2(S.num_cons),
                                        _log2(S.num_vars) + 1,
                                        SpartanZkSNARK.VC_COMMITMENT_WIDTH)
            vc_shape = SplitMultiRoundR1CSShape.from_circuit(vc, engine.scalar)
            vc_ck, vc_vk = engine.pcs.setup(b"ck", vc_shape.total_vars,
                                            vc_shape.commitment_width, device)
        with span("setup_digest"):
            h = hashlib.sha256()
            h.update(vk_digest(S, ck, ck))
            for M in (vc_shape.A, vc_shape.B, vc_shape.C):
                h.update(M.digest_bytes())
            for pt in vc_ck.ck:
                h.update(engine.curve.point_bytes(pt))
            digest = h.digest()
        regular = vc_shape.to_regular_shape()
        return (SpartanZkProverKey(engine, S, ck, vc_shape, regular, vc_ck, digest),
                SpartanZkVerifierKey(engine, S, vk_ee, vc_shape, regular, vc_ck,
                                     vc_vk, digest))

    @staticmethod
    @torch.inference_mode()
    def prep_prove(pk: SpartanZkProverKey, circuit, is_small: bool = False,
                   rng=None) -> SpartanPrepSNARK:
        with span("prep_synthesize_commit"):
            ps = shared_witness(pk.engine, pk.S, pk.ck, circuit, is_small, rng)
            precommitted_witness(pk.engine, ps, pk.S, pk.ck, circuit, is_small, rng)
        return SpartanPrepSNARK(ps=ps)

    @staticmethod
    @torch.inference_mode()
    def prove(pk: SpartanZkProverKey, circuit, prep: SpartanPrepSNARK,
              is_small: bool = False, rng=None):
        engine = pk.engine
        S = pk.S
        F = engine.scalar
        p = F.modulus
        pcs = engine.pcs
        device = pk.device

        with span("rerandomize"):
            rerandomize_in_place(engine, prep.ps, S, pk.ck, rng)

        transcript = engine.transcript(b"SpartanZkSNARK")
        transcript.absorb_bytes(b"vk", pk.vk_digest)
        transcript.absorb_scalars(b"public_values", circuit.public_values())

        with span("witness_and_instance"):
            U, W = r1cs_instance_and_witness(engine, prep.ps, S, pk.ck, circuit,
                                             is_small, transcript, rng)

        num_vars = S.num_vars
        num_rounds_x = _log2(S.num_cons)
        num_rounds_y = _log2(num_vars) + 1
        taus = [transcript.squeeze(b"t") for _ in range(num_rounds_x)]

        vc = SpartanVerifierCircuit(F, num_rounds_x, num_rounds_y,
                                    pk.vc_shape.commitment_width)
        state = MultiRoundState.initialize(pk.vc_shape)

        def vc_round(i: int) -> list[int]:
            return state.process_round(pcs, pk.vc_ck, vc, i, transcript, rng)

        # z at its nonzero width num_cols = num_vars + num_extra: the
        # structured inner round 0 never reads the zero tail
        tail = _upload_mont(engine, [1] + U.public_values + U.challenges, device)
        z = torch.cat([W.W, tail])
        with span("matrix_vector_multiply"):
            ABC = S.multiply_vec(z)

        def outer_challenge(i: int, unis) -> int:
            vc.outer_polys[i] = list(unis[0].coeffs)
            return vc_round(i)[0]

        with span("outer_sumcheck"):
            E = eq_table(eq_factors(taus, F, device), F)
            r_x, finals_outer, tau_at_rx = prove_zk_cubic(
                F, [0], E, (ABC[0:1], ABC[1:2], ABC[2:3]), outer_challenge)
        claims_outer = finals_outer[0]
        vc.claim_Az, vc.claim_Bz, vc.claim_Cz = claims_outer
        vc.tau_at_rx = tau_at_rx
        r = vc_round(num_rounds_x)[0]

        claim_inner = (claims_outer[0] + r * claims_outer[1]
                       + r * r % p * claims_outer[2]) % p
        num_extra = S.num_cols - num_vars  # 1, public values, challenges
        with span("prepare_poly_ABC"):
            abc = S.bind_and_prepare_poly_ABC(r_x, r)

        def inner0_challenge(unis) -> int:
            vc.inner_polys[0] = list(unis[0].coeffs)
            return vc_round(num_rounds_x + 1)[0]

        def inner_challenge(j: int, unis) -> int:
            vc.inner_polys[1 + j] = list(unis[0].coeffs)
            return vc_round(num_rounds_x + 2 + j)[0]

        with span("inner_sumcheck"):
            abc_k, z_k = abc[None], z[None]
            ticket = new_ticket(abc_k.device)  # one arrival counter for every round
            r0, _, claims_r0 = inner_round0(F, [claim_inner], abc_k, z_k, num_vars,
                                            num_extra, inner0_challenge, ticket)
            r_y_rest, finals_inner = prove_zk_quad(F, claims_r0, (abc_k, z_k),
                                                   num_rounds_y - 1, inner_challenge, ticket)
        r_y = [r0] + r_y_rest
        eval_Z = finals_inner[0][1]

        X = U.public_values + U.challenges
        eval_X = sparse_poly_evaluate_host(F, num_rounds_y - 1, [1] + X, r_y[1:])
        denom = (1 - r_y[0]) % p
        if denom == 0:
            raise DivisionByZeroError("division by zero in eval_W")
        eval_W = (eval_Z - r_y[0] * eval_X) * pow(denom, -1, p) % p

        vc.eval_W = eval_W
        vc.eval_X = eval_X
        eval_w_round = num_rounds_x + 1 + num_rounds_y + 1
        vc_round(eval_w_round - 1)
        vc_round(eval_w_round)

        U_verifier, W_verifier = state.finalize(pcs)
        U_verifier_regular = U_verifier.to_regular_instance(pcs)
        S_verifier = pk.vc_shape_regular
        with span("nifs"):
            random_U, random_W = S_verifier.sample_random_instance_witness(
                pcs, pk.vc_ck, rng=rng)
            nifs, folded_W, folded_u, folded_X = NovaNIFS.prove(
                pcs, pk.vc_ck, S_verifier, random_U, random_W, U_verifier_regular,
                W_verifier, transcript, rng=rng)
        with span("relaxed_snark"):
            relaxed_snark = RelaxedR1CSSpartanProof.prove(
                pcs, S_verifier, pk.vc_ck, folded_u, folded_X, folded_W, transcript)

        comm_W, _ = U.to_regular(pcs)
        with span("pcs_prove"):
            eval_arg = pcs.prove(pk.ck, pk.vc_ck, transcript, comm_W, W.W, W.r_W,
                                 r_y[1:], U_verifier.comm_w_per_round[eval_w_round],
                                 state.r_w_per_round[eval_w_round], rng=rng)
        proof = SpartanZkSNARKProof(U=U, U_verifier=U_verifier, random_U=random_U,
                                    nifs=nifs, relaxed_snark=relaxed_snark,
                                    eval_arg=eval_arg)
        return proof, prep

    @staticmethod
    @torch.inference_mode()
    def verify(proof: SpartanZkSNARKProof, vk: SpartanZkVerifierKey) -> list[int]:
        """(spartan_zk.rs:723-838); the MLE evaluation of A, B and C and the
        row folds run on the key's device."""
        engine = vk.engine
        S = vk.S
        F = engine.scalar
        p = F.modulus
        pcs = engine.pcs

        transcript = engine.transcript(b"SpartanZkSNARK")
        transcript.absorb_bytes(b"vk", vk.digest)
        transcript.absorb_scalars(b"public_values", proof.U.public_values)
        proof.U.validate(S, pcs, transcript)

        num_rounds_x = _log2(S.num_cons)
        taus = [transcript.squeeze(b"t") for _ in range(num_rounds_x)]
        proof.U_verifier.validate(vk.vc_shape, pcs, transcript)

        num_vars = S.num_vars
        num_rounds_y = _log2(num_vars) + 1
        U_verifier_regular = proof.U_verifier.to_regular_instance(pcs)
        num_challenges = num_rounds_x + 1 + num_rounds_y
        if len(U_verifier_regular.X) != num_challenges + 3:
            raise ProofVerifyError("verifier instance has wrong public IO size")
        challenges = U_verifier_regular.X[:num_challenges]
        tau_claim, eval_X_claim, quotient_claim = U_verifier_regular.X[num_challenges:]

        r_x = challenges[:num_rounds_x]
        r = challenges[num_rounds_x]
        r_y = challenges[num_rounds_x + 1 :]
        with span("verify_evaluate_ABC"):
            eval_A, eval_B, eval_C = S.evaluate_at(r_x, r_y)
        quotient = (eval_A + r * eval_B + r * r * eval_C) % p

        _, X_orig = proof.U.to_regular(pcs)
        eval_X = sparse_poly_evaluate_host(F, _log2(num_vars), [1] + X_orig, r_y[1:])
        if (tau_claim != eq_evaluate(F, taus, r_x) or eval_X_claim != eval_X
                or quotient_claim != quotient):
            raise SpartanError(
                "verifier instance public values do not match recomputed "
                "(tau_at_rx, eval_X, quotient)")

        with span("verify_nifs"):
            folded_U = proof.nifs.verify(pcs, F, transcript, proof.random_U,
                                         U_verifier_regular, vk.vc_vk.device)
        with span("verify_relaxed_snark"):
            proof.relaxed_snark.verify(pcs, vk.vc_shape_regular, vk.vc_vk, folded_U,
                                       transcript)
        comm_W, _ = proof.U.to_regular(pcs)
        eval_w_round = num_rounds_x + 1 + num_rounds_y + 1
        with span("verify_pcs"):
            pcs.verify(vk.vk_ee, vk.vc_ck, transcript, comm_W, r_y[1:],
                       proof.U_verifier.comm_w_per_round[eval_w_round],
                       proof.eval_arg)
        return list(proof.U.public_values)
