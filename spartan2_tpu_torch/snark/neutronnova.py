"""NeutronNovaZkSNARK: non-recursive folding of N step circuits plus one
core circuit.

Reference: src/neutronnova_zk.rs; the protocol, transcript labels, absorb
order and order of random draws are the JAX package's
(spartan2_tpu/snark/neutronnova.py, its device branch), so with the same
blinds the proof bytes are equal.  The N step instances are folded into
one by the NIFS, a batch zero-check over the instance axis whose round
polynomials are witness of the NeutronNovaVerifierCircuit; the folded
step instance and the core instance are then proved together by outer
and inner ZK sum-checks in lockstep (K = 2), the verifier circuit is
hidden by a Nova fold against a random relaxed instance and proved by a
relaxed-Spartan proof, and one PCS argument opens the c_eval-folded
witness.

Card work: the precommitted and rest commits of all steps in batched
comb launches (kernel 3 of PR 1), the power table E (kernel 2's
``sp2_pow_table``), the batched Az/Bz/Cz of every step (kernel 1, one
launch), the NIFS rounds and folds (kernels 3 and 4 of csrc/nifs.cu),
the folds of the step commitments (kernel C), the core's SpMV and both
sum-checks (kernels 1, A, B), poly_ABC, the PCS L-fold; in verify the
MLE evaluations and the fold of the step commitments.  The entry points
run under torch.inference_mode.
"""

from __future__ import annotations

import copy
import hashlib
from dataclasses import dataclass, field as dfield

import torch

from ..errors import (DivisionByZeroError, InvalidInputLengthError, ProofVerifyError,
                      SpartanError)
from ..field.limbs import to_device
from ..polys.eq import eq_evaluate, pow_evaluate, pow_generators
from ..polys.multilinear import sparse_poly_evaluate_host
from ..parallel.sumcheck_shard import ShardedZkSumcheckCubic, ShardedZkSumcheckQuad
from ..polys.univariate import UniPoly
from ..provider.engines import Engine
from ..r1cs.multiround import (MultiRoundState, SplitMultiRoundR1CSInstance,
                               SplitMultiRoundR1CSShape)
from ..r1cs.relaxed import NovaNIFS, R1CSInstance, R1CSShape, RelaxedR1CSInstance
from ..r1cs.shape import SplitR1CSInstance, SplitR1CSShape
from ..sumcheck.device import new_ticket, pow_table
from ..sumcheck.nifs import run_nifs, to_small, weighted_fold
from ..sumcheck.zk_device import inner_round0, prove_zk_cubic, prove_zk_quad
from ..utils.digest import vk_digest
from ..utils.tracing import span
from .spartan import (_log2, _upload_mont, commit_pending_batch, instance_witness_begin,
                      instance_witness_finish, precommitted_witness,
                      precommitted_witness_batch, r1cs_instance_and_witness,
                      shared_witness)
from .spartan_relaxed import RelaxedR1CSSpartanProof
from .spartan_zk import rerandomize_in_place
from .zk_circuits import NeutronNovaVerifierCircuit


def weights_from_r(field, r_bs: list[int], n: int) -> list[int]:
    """eq tensor weights, LSB-first bit order (r1cs/mod.rs:153-166)."""
    p = field.modulus
    out = []
    for i in range(n):
        w, k = 1, i
        for r_t in r_bs:
            w = w * (r_t if k & 1 else (1 - r_t) % p) % p
            k >>= 1
        out.append(w)
    return out


def nifs_finish_round(field, state: dict, rho_t: int, e0: int, quad: int) -> list[int]:
    """finish_round (neutronnova_zk.rs:703-735): the round's cubic
    coefficients from the (e0, quad) sums and the running claim
    state['T_cur'] / state['acc_eq'].  Raises on a zero rho."""
    p = field.modulus
    one_minus_rho = (1 - rho_t) % p
    two_rho_minus_one = (rho_t - one_minus_rho) % p
    c = e0 * state["acc_eq"] % p
    a = quad * state["acc_eq"] % p
    if rho_t % p == 0:
        raise SpartanError("zero rho challenge")
    a_b_c = (state["T_cur"] - c * one_minus_rho) * pow(rho_t, -1, p) % p
    b = (a_b_c - a - c) % p
    return [
        c * one_minus_rho % p,
        (c * two_rho_minus_one + b * one_minus_rho) % p,
        (b * two_rho_minus_one + a * one_minus_rho) % p,
        a * two_rho_minus_one % p,
    ]


def nifs_update_state(field, state: dict, coeffs: list[int], rho_t: int,
                      r_b: int) -> None:
    """Advance the running claim past challenge r_b."""
    p = field.modulus
    one_minus_rho = (1 - rho_t) % p
    state["acc_eq"] = (state["acc_eq"]
                       * ((1 - r_b) * one_minus_rho + r_b * rho_t) % p)
    state["T_cur"] = UniPoly(field, coeffs).evaluate(r_b)


def _padded(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# keys / prep / proof
# ---------------------------------------------------------------------------


@dataclass
class NeutronNovaProverKey:
    engine: Engine
    S_step: SplitR1CSShape
    S_core: SplitR1CSShape
    ck: object
    vc_shape: SplitMultiRoundR1CSShape
    vc_shape_regular: R1CSShape
    vc_ck: object
    vk_digest: bytes

    @property
    def device(self) -> torch.device:
        return self.S_step.dev["device"]


@dataclass
class NeutronNovaVerifierKey:
    engine: Engine
    S_step: SplitR1CSShape
    S_core: SplitR1CSShape
    vk_ee: object
    vc_shape: SplitMultiRoundR1CSShape
    vc_shape_regular: R1CSShape
    vc_ck: object
    vc_vk: object
    digest: bytes


@dataclass
class NeutronNovaPrep:
    ps_step: list
    ps_core: object
    # device caches filled by the first prove when the step circuit takes
    # no challenges (its witnesses are then the same in every prove):
    # "ABC", the batched Az/Bz/Cz, and "small", the gated small grid
    # (neutronnova_zk.rs:1524-1603); never serialized
    cache: dict = dfield(default_factory=dict)


@dataclass
class NeutronNovaProof:
    comm_W_shared: object
    step_instances: list[SplitR1CSInstance]
    core_instance: SplitR1CSInstance
    U_verifier: SplitMultiRoundR1CSInstance
    random_U: RelaxedR1CSInstance
    nifs: NovaNIFS
    relaxed_snark: RelaxedR1CSSpartanProof
    eval_arg: object


# ---------------------------------------------------------------------------
# NeutronNova NIFS (multi-fold zero-check)
# ---------------------------------------------------------------------------


class NeutronNovaNIFS:
    """The batch zero-check folding rounds (neutronnova_zk.rs:511-1262).
    Round t's cubic P_t(X) = eq(rho_t, X) Q_t(X) with Q_t = c + bX + aX^2,
    c = e0 acc_eq, a = quad acc_eq and b from the running claim."""

    @staticmethod
    def prove(engine: Engine, S: SplitR1CSShape, Us: list[R1CSInstance], Ws: list,
              vc: NeutronNovaVerifierCircuit, vc_state: MultiRoundState, vc_ck,
              transcript, rng=None, ck=None, cache: dict | None = None):
        """``Ws``: the steps' R1CSWitness (witness on the card).  -> (E,
        folded Az, Bz, Cz, folded witness (num_vars, 8), its blind, the
        folded instance, t_out, r_bs); E is (num_cons, 8) Montgomery."""
        F = engine.scalar
        p = F.modulus
        pcs = engine.pcs
        dev = S.dev["device"]

        n_padded = _padded(len(Us))
        ell_b = _log2(n_padded)
        Us = list(Us) + [Us[0]] * (n_padded - len(Us))
        Ws = list(Ws) + [Ws[0]] * (n_padded - len(Ws))
        for U in Us:
            transcript.absorb_bytes(b"U", U.to_transcript_bytes(engine.curve, F))
        transcript.absorb_scalar(b"T", 0)

        ell_cons = _log2(S.num_cons)
        tau = transcript.squeeze(b"tau")
        rhos = [transcript.squeeze(b"rho") for _ in range(ell_b)]
        # E[k] = tau^k (the split_evals outer product, power.rs:65-86),
        # built on the card from ell_cons powers of tau
        E = pow_table(to_device(pow_generators(F, tau, ell_cons), F, dev, mont=True), F)

        if cache is not None and "ABC" in cache:
            ABC = cache["ABC"]
        else:
            z = torch.stack([torch.cat([W.W, _upload_mont(engine, [1] + U.X, dev)])
                             for U, W in zip(Us, Ws)])
            with span("nn_matvec_batched"):
                ABC = S.multiply_vec_batched(z)  # (3, I, num_cons, 8)
            if cache is not None:
                cache["ABC"] = ABC

        state = {"T_cur": 0, "acc_eq": 1}

        def round_cb(t: int, e0: int, quad: int) -> int:
            coeffs = nifs_finish_round(F, state, rhos[t], e0, quad)
            vc.nifs_polys[t] = list(coeffs)
            r_b = vc_state.process_round(pcs, vc_ck, vc, t, transcript, rng)[0]
            nifs_update_state(F, state, coeffs, rhos[t], r_b)
            return r_b

        # round 0 on small integers when the whole grid passes the gate
        # (neutronnova_zk.rs:1550-1560); else on the Montgomery grid
        small = None
        if ell_b > 0:
            if cache is not None and "small" in cache:
                S_small, ok = cache["small"]
            else:
                S_small, ok = to_small(ABC[0], ABC[1], ABC[2], F)
                if cache is not None:
                    cache["small"] = (S_small, ok)
            if ok:
                small = S_small
        with span("nn_nifs_rounds"):  # the rounds only read the grid: the cache stays
            r_bs, (AzF, BzF, CzF) = run_nifs(F, ABC[0], ABC[1], ABC[2], E, rhos, round_cb,
                                             small)

        t_out = state["T_cur"] * pow(state["acc_eq"], -1, p) % p
        vc.t_out_step = t_out
        vc.eq_rho_at_rb = state["acc_eq"]  # == eq(rhos, r_bs)
        vc_state.process_round(pcs, vc_ck, vc, ell_b, transcript, rng)

        # fold the witnesses (kernel 3) and instances.  When the step
        # circuit allocates nothing in its rest phase, every rest segment
        # is zero: fold only the shared + precommitted prefix, and the
        # folded commitment's rest rows are blind-only
        # (neutronnova_zk.rs:1217-1262)
        weights = weights_from_r(F, r_bs, n_padded)
        w_dev = to_device(weights, F, dev, mont=True)
        eff = S.num_shared + S.num_precommitted
        truncate = ck is not None and 0 < eff < S.num_vars and S.num_rest_unpadded == 0
        with span("nn_fold_witnesses"):
            if truncate:
                W_eff = weighted_fold([W.W[:eff] for W in Ws], w_dev, F)
                W_fold = torch.cat([W_eff, torch.zeros(S.num_vars - eff, 8,
                                                       dtype=torch.int32, device=dev)])
            else:
                W_fold = weighted_fold([W.W for W in Ws], w_dev, F)
        r_W_folded = pcs.fold_blinds([W.r_W for W in Ws], weights)
        with span("nn_fold_commitments"):
            if truncate:
                comm_folded = pcs.fold_commitments_partial(
                    [U.comm_W for U in Us], weights, -(-eff // S.width), r_W_folded,
                    ck, dev)
            else:
                comm_folded = pcs.fold_commitments([U.comm_W for U in Us], weights,
                                                   dev)
        X_folded = [sum(w_i * U.X[j] for w_i, U in zip(weights, Us)) % p
                    for j in range(len(Us[0].X))]
        folded_U = R1CSInstance(comm_W=comm_folded, X=X_folded)
        return E, AzF, BzF, CzF, W_fold, r_W_folded, folded_U, t_out, r_bs


# ---------------------------------------------------------------------------
# the SNARK
# ---------------------------------------------------------------------------


class NeutronNovaZkSNARK:
    VC_COMMITMENT_WIDTH = 32  # reference neutronnova_zk.rs:1437

    @staticmethod
    @torch.inference_mode()
    def setup(engine: Engine, step_circuit, core_circuit, num_steps: int,
              width: int = 2048, device="cuda"):
        """Keys whose device state (matrices, comb tables) lives on
        ``device``."""
        F = engine.scalar
        with span("setup_shape"):
            S_step = SplitR1CSShape.from_circuit(step_circuit, F, width)
            S_core = SplitR1CSShape.from_circuit(core_circuit, F, width)
            SplitR1CSShape.equalize(S_step, S_core)
        return NeutronNovaZkSNARK.setup_from_shapes(engine, S_step, S_core, num_steps,
                                                    device)

    @staticmethod
    @torch.inference_mode()
    def setup_from_shapes(engine: Engine, S_step: SplitR1CSShape,
                          S_core: SplitR1CSShape, num_steps: int, device="cuda"):
        """Keys from equalized shapes (synthesized, or read back from
        bytes) (neutronnova_zk.rs:1352-1460)."""
        with span("setup_upload"):
            S_step.attach_device(device)
            S_core.attach_device(device)
        with span("setup_generators"):
            ck, vk_ee = engine.pcs.setup(b"ck", max(S_step.num_vars, S_core.num_vars),
                                         S_step.width, device)
        with span("setup_verifier_circuit"):
            vc = NeutronNovaVerifierCircuit(
                engine.scalar, _log2(_padded(num_steps)), _log2(S_step.num_cons),
                _log2(S_step.num_vars) + 1, NeutronNovaZkSNARK.VC_COMMITMENT_WIDTH)
            vc_shape = SplitMultiRoundR1CSShape.from_circuit(vc, engine.scalar)
            vc_ck, vc_vk = engine.pcs.setup(b"ck", vc_shape.total_vars,
                                            vc_shape.commitment_width, device)
        with span("setup_digest"):
            h = hashlib.sha256()
            h.update(vk_digest(S_step, ck, ck))
            h.update(vk_digest(S_core, ck, ck))
            h.update(vc_shape.A.digest_bytes())
            for pt in vc_ck.ck:
                h.update(engine.curve.point_bytes(pt))
            digest = h.digest()
        regular = vc_shape.to_regular_shape()
        pk = NeutronNovaProverKey(engine, S_step, S_core, ck, vc_shape, regular, vc_ck,
                                  digest)
        vk = NeutronNovaVerifierKey(engine, S_step, S_core, vk_ee, vc_shape, regular,
                                    vc_ck, vc_vk, digest)
        return pk, vk

    @staticmethod
    @torch.inference_mode()
    def prep_prove(pk: NeutronNovaProverKey, step_circuits, core_circuit,
                   is_small: bool = False, rng=None) -> NeutronNovaPrep:
        """The shared witness once, cloned per step (the core reuses it);
        every step's precommitted segment, then their commits in batched
        launches, then the core's (neutronnova_zk.rs:1477-1603)."""
        engine = pk.engine
        with span("prep_synthesize_commit"):
            ps = shared_witness(engine, pk.S_step, pk.ck, step_circuits[0], is_small,
                                rng)
            ps_step = [ps.clone_after_shared() for _ in step_circuits]
            precommitted_witness_batch(engine, ps_step, pk.S_step, pk.ck, step_circuits,
                                       is_small, rng)
            precommitted_witness(engine, ps, pk.S_core, pk.ck, core_circuit, is_small,
                                 rng)
        return NeutronNovaPrep(ps_step=ps_step, ps_core=ps)

    @staticmethod
    @torch.inference_mode()
    def prove(pk: NeutronNovaProverKey, step_circuits, core_circuit,
              prep: NeutronNovaPrep, is_small: bool = False, rng=None, mesh=None):
        """A proof.  With ``mesh`` (parallel/mesh.py), every rank of it
        calls prove with the same arguments: the outer and inner ZK
        sum-checks run sharded across the ranks, the rest replicated, and
        every rank returns the single-device proof.  The ranks must draw
        the same blinds: pass one deterministic ``rng`` to each, or None,
        and rank 0's seed drives every rank's draws."""
        if mesh is not None and rng is None:
            rng = mesh.common_rng()
        engine = pk.engine
        F = engine.scalar
        p = F.modulus
        pcs = engine.pcs
        dev = pk.device
        n_steps = len(step_circuits)

        with span("nn_rerandomize"):
            rerandomize_in_place(engine, prep.ps_core, pk.S_core, pk.ck, rng)
            for ps_i in prep.ps_step:
                # the steps share the core's (rerandomized) shared commitment
                ps_i.comm_W_shared = prep.ps_core.comm_W_shared
                ps_i.r_W_shared = prep.ps_core.r_W_shared
                if ps_i.comm_W_precommitted is not None:
                    new_blind = pcs.blind(pk.ck, pk.S_step.num_precommitted, rng=rng)
                    ps_i.comm_W_precommitted = pcs.rerandomize_commitment(
                        pk.ck, ps_i.comm_W_precommitted, ps_i.r_W_precommitted,
                        new_blind)
                    ps_i.r_W_precommitted = new_blind

        # per-instance transcripts (neutronnova_zk.rs:1662-1722); the steps'
        # rest commits run batched
        with span("nn_instances"):
            pendings, step_trs = [], []
            for i, (ps_i, circ) in enumerate(zip(prep.ps_step, step_circuits)):
                tr = engine.transcript(b"neutronnova_prove")
                tr.absorb_bytes(b"vk", pk.vk_digest)
                tr.absorb_scalar(b"num_circuits", n_steps)
                tr.absorb_scalar(b"circuit_index", i)
                tr.absorb_scalars(b"public_values", circ.public_values())
                pendings.append(instance_witness_begin(engine, ps_i, pk.S_step, pk.ck,
                                                       circ, is_small, tr, rng))
                step_trs.append(tr)
            comms_rest = commit_pending_batch(engine, pk.ck, pk.S_step, pendings)
            step_instances, step_W = [], []
            for pend, tr, cm in zip(pendings, step_trs, comms_rest):
                U_i, W_i = instance_witness_finish(engine, pend, pk.S_step, cm, tr)
                step_instances.append(U_i)
                step_W.append(W_i)

            tr = engine.transcript(b"neutronnova_prove")
            tr.absorb_bytes(b"vk", pk.vk_digest)
            tr.absorb_scalars(b"public_values", core_circuit.public_values())
            core_instance, core_W = r1cs_instance_and_witness(
                engine, prep.ps_core, pk.S_core, pk.ck, core_circuit, is_small, tr, rng)

        step_regular = [R1CSInstance(*U.to_regular(pcs)) for U in step_instances]
        core_regular = R1CSInstance(*core_instance.to_regular(pcs))

        transcript = engine.transcript(b"neutronnova_prove")
        transcript.absorb_bytes(b"vk", pk.vk_digest)
        transcript.absorb_bytes(b"core_instance",
                                core_regular.to_transcript_bytes(engine.curve, F))

        num_rounds_b = _log2(_padded(n_steps))
        num_rounds_x = _log2(pk.S_step.num_cons)
        num_vars = pk.S_step.num_vars
        num_rounds_y = _log2(num_vars) + 1
        vc = NeutronNovaVerifierCircuit(F, num_rounds_b, num_rounds_x, num_rounds_y,
                                        pk.vc_shape.commitment_width)
        vc_state = MultiRoundState.initialize(pk.vc_shape)
        outer_start = num_rounds_b + 1
        inner_start = outer_start + num_rounds_x + 1

        def vc_round(i: int) -> list[int]:
            return vc_state.process_round(pcs, pk.vc_ck, vc, i, transcript, rng)

        with span("nn_nifs"):
            (E, AzF, BzF, CzF, W_fold, r_W_folded, folded_U, t_out,
             r_bs) = NeutronNovaNIFS.prove(
                engine, pk.S_step, step_regular, step_W, vc, vc_state, pk.vc_ck,
                transcript, rng, ck=pk.ck,
                cache=prep.cache if pk.S_step.num_challenges == 0 else None)

        with span("nn_core_matvec"):
            tail = _upload_mont(engine, [1] + core_instance.public_values
                                + core_instance.challenges, dev)
            ABC_c = pk.S_core.multiply_vec(torch.cat([core_W.W, tail]))

        def outer_challenge(i: int, unis) -> int:
            vc.outer_polys_step[i] = list(unis[0].coeffs)
            vc.outer_polys_core[i] = list(unis[1].coeffs)
            return vc_round(outer_start + i)[0]

        with span("nn_outer_zk_sumcheck"):
            stack3 = tuple(torch.stack([s, c]) for s, c in zip((AzF, BzF, CzF), ABC_c))
            if mesh is None:
                r_x, finals_outer, tau_rx = prove_zk_cubic(F, [t_out, 0], E, stack3,
                                                           outer_challenge)
            else:
                r_x, finals_outer, tau_rx = ShardedZkSumcheckCubic(F, mesh).prove(
                    [t_out, 0], E, stack3, outer_challenge)
        claims_s, claims_c = finals_outer
        vc.claim_Az_step, vc.claim_Bz_step, vc.claim_Cz_step = claims_s
        vc.claim_Az_core, vc.claim_Bz_core, vc.claim_Cz_core = claims_c
        vc.tau_at_rx = tau_rx

        r = vc_round(outer_start + num_rounds_x)[0]
        r_sq = r * r % p
        claim_inner_s = (claims_s[0] + r * claims_s[1] + r_sq * claims_s[2]) % p
        claim_inner_c = (claims_c[0] + r * claims_c[1] + r_sq * claims_c[2]) % p

        # abc and z at the nonzero width num_vars + ne; step and core may
        # differ in num_cols, so both pad to the larger (zeros past a
        # shape's num_cols leave the sums unchanged)
        ne = max(pk.S_step.num_cols, pk.S_core.num_cols) - num_vars

        def pad(x: torch.Tensor) -> torch.Tensor:
            return torch.cat([x, torch.zeros(num_vars + ne - x.shape[0], 8,
                                             dtype=torch.int32, device=dev)])

        with span("nn_prepare_poly_ABC"):
            abc_k = torch.stack([pad(pk.S_step.bind_and_prepare_poly_ABC(r_x, r)),
                                 pad(pk.S_core.bind_and_prepare_poly_ABC(r_x, r))])
        z_k = torch.stack([
            pad(torch.cat([W_fold, _upload_mont(engine, [1] + folded_U.X, dev)])),
            pad(torch.cat([core_W.W, _upload_mont(engine, [1] + core_regular.X, dev)]))])

        def inner0_challenge(unis) -> int:
            vc.inner_polys_step[0] = list(unis[0].coeffs)
            vc.inner_polys_core[0] = list(unis[1].coeffs)
            return vc_round(inner_start)[0]

        def inner_challenge(j: int, unis) -> int:
            vc.inner_polys_step[1 + j] = list(unis[0].coeffs)
            vc.inner_polys_core[1 + j] = list(unis[1].coeffs)
            return vc_round(inner_start + 1 + j)[0]

        with span("nn_inner_zk_sumcheck"):
            ticket = new_ticket(abc_k.device)  # one arrival counter for every round
            r0, _, claims_r0 = inner_round0(F, [claim_inner_s, claim_inner_c], abc_k,
                                            z_k, num_vars, ne, inner0_challenge, ticket)
            if mesh is None:
                r_y_rest, finals_inner = prove_zk_quad(F, claims_r0, (abc_k, z_k),
                                                       num_rounds_y - 1, inner_challenge,
                                                       ticket)
            else:
                r_y_rest, finals_inner = ShardedZkSumcheckQuad(F, mesh).prove(
                    claims_r0, (abc_k, z_k), num_rounds_y - 1, inner_challenge, ticket)
        r_y = [r0] + r_y_rest
        eval_Z_step = finals_inner[0][1]
        eval_Z_core = finals_inner[1][1]

        def eval_x(X):
            return sparse_poly_evaluate_host(F, _log2(num_vars), [1] + X, r_y[1:])

        eval_X_step = eval_x(folded_U.X)
        eval_X_core = eval_x(core_regular.X)
        denom = (1 - r_y[0]) % p
        if denom == 0:
            raise DivisionByZeroError("division by zero in eval_W")
        inv = pow(denom, -1, p)
        vc.eval_W_step = (eval_Z_step - r_y[0] * eval_X_step) * inv % p
        vc.eval_W_core = (eval_Z_core - r_y[0] * eval_X_core) * inv % p
        vc.eval_X_step = eval_X_step
        vc.eval_X_core = eval_X_core

        vc_round(inner_start + num_rounds_y)
        eval_w_step_round = inner_start + num_rounds_y + 1
        vc_round(eval_w_step_round)
        vc_round(eval_w_step_round + 1)

        U_verifier, W_verifier = vc_state.finalize(pcs)
        U_verifier_regular = U_verifier.to_regular_instance(pcs)
        with span("nn_vc_fold_relaxed"):
            random_U, random_W = pk.vc_shape_regular.sample_random_instance_witness(
                pcs, pk.vc_ck, rng=rng)
            nifs, folded_W_vc, folded_u, folded_X = NovaNIFS.prove(
                pcs, pk.vc_ck, pk.vc_shape_regular, random_U, random_W,
                U_verifier_regular, W_verifier, transcript, rng=rng)
            relaxed_snark = RelaxedR1CSSpartanProof.prove(
                pcs, pk.vc_shape_regular, pk.vc_ck, folded_u, folded_X, folded_W_vc,
                transcript)

        comm_eval_W_step = U_verifier.comm_w_per_round[eval_w_step_round]
        blind_eval_W_step = vc_state.r_w_per_round[eval_w_step_round]
        comm_eval_W_core = U_verifier.comm_w_per_round[eval_w_step_round + 1]
        blind_eval_W_core = vc_state.r_w_per_round[eval_w_step_round + 1]

        c_eval = transcript.squeeze(b"c_eval")
        comm = pcs.fold_commitments([folded_U.comm_W, core_regular.comm_W], [1, c_eval],
                                    dev)
        blind = pcs.fold_blinds([r_W_folded, core_W.r_W], [1, c_eval])
        comm_eval = pcs.fold_commitments([comm_eval_W_step, comm_eval_W_core],
                                         [1, c_eval], dev)
        blind_eval = pcs.fold_blinds([blind_eval_W_step, blind_eval_W_core], [1, c_eval])
        # W_fold + c_eval core_W: kernel 3's weighted fold at I = 2
        W_comb = weighted_fold([W_fold, core_W.W],
                               to_device([1, c_eval], F, dev, mont=True), F)
        with span("nn_pcs_prove"):
            eval_arg = pcs.prove(pk.ck, pk.vc_ck, transcript, comm, W_comb, blind,
                                 r_y[1:], comm_eval, blind_eval, rng=rng)

        # the shared commitment is the same in every instance: sent once
        stripped_steps = []
        for u in step_instances:
            u2 = copy.copy(u)
            u2.comm_W_shared = None
            stripped_steps.append(u2)
        core_stripped = copy.copy(core_instance)
        core_stripped.comm_W_shared = None
        proof = NeutronNovaProof(
            comm_W_shared=step_instances[0].comm_W_shared, step_instances=stripped_steps,
            core_instance=core_stripped, U_verifier=U_verifier, random_U=random_U,
            nifs=nifs, relaxed_snark=relaxed_snark, eval_arg=eval_arg)
        return proof, prep

    @staticmethod
    @torch.inference_mode()
    def verify(proof: NeutronNovaProof, vk: NeutronNovaVerifierKey, num_instances: int):
        """(neutronnova_zk.rs:2096-2342) -> (the steps' public values, the
        core's).  The MLE evaluations of both shapes and the fold of the
        step commitments run on the key's device."""
        engine = vk.engine
        F = engine.scalar
        p = F.modulus
        pcs = engine.pcs
        dev = vk.S_step.dev["device"]

        if num_instances == 0 or num_instances != len(proof.step_instances):
            raise InvalidInputLengthError("wrong number of instances")
        step_instances = []
        for u in proof.step_instances:
            u2 = copy.copy(u)
            u2.comm_W_shared = proof.comm_W_shared
            step_instances.append(u2)
        core_instance = copy.copy(proof.core_instance)
        core_instance.comm_W_shared = proof.comm_W_shared

        for i, u in enumerate(step_instances):
            tr = engine.transcript(b"neutronnova_prove")
            tr.absorb_bytes(b"vk", vk.digest)
            tr.absorb_scalar(b"num_circuits", len(step_instances))
            tr.absorb_scalar(b"circuit_index", i)
            tr.absorb_scalars(b"public_values", u.public_values)
            u.validate(vk.S_step, pcs, tr)
        tr = engine.transcript(b"neutronnova_prove")
        tr.absorb_bytes(b"vk", vk.digest)
        tr.absorb_scalars(b"public_values", core_instance.public_values)
        core_instance.validate(vk.S_core, pcs, tr)

        n_padded = _padded(len(step_instances))
        padded = step_instances + [step_instances[0]] * (n_padded - len(step_instances))
        step_regular = [R1CSInstance(*u.to_regular(pcs)) for u in padded]
        core_regular = R1CSInstance(*core_instance.to_regular(pcs))

        transcript = engine.transcript(b"neutronnova_prove")
        transcript.absorb_bytes(b"vk", vk.digest)
        transcript.absorb_bytes(b"core_instance",
                                core_regular.to_transcript_bytes(engine.curve, F))
        for U in step_regular:
            transcript.absorb_bytes(b"U", U.to_transcript_bytes(engine.curve, F))
        transcript.absorb_scalar(b"T", 0)

        num_rounds_b = _log2(n_padded)
        num_vars = vk.S_step.num_vars
        num_rounds_x = _log2(vk.S_step.num_cons)
        num_rounds_y = _log2(num_vars) + 1
        tau = transcript.squeeze(b"tau")
        rhos = [transcript.squeeze(b"rho") for _ in range(num_rounds_b)]

        proof.U_verifier.validate(vk.vc_shape, pcs, transcript)
        U_verifier_regular = proof.U_verifier.to_regular_instance(pcs)
        num_challenges = num_rounds_b + num_rounds_x + 1 + num_rounds_y
        if len(U_verifier_regular.X) != num_challenges + 6:
            raise ProofVerifyError("verifier instance has wrong public IO size")
        challenges = U_verifier_regular.X[:num_challenges]
        public_values = U_verifier_regular.X[num_challenges : num_challenges + 6]
        r_b = challenges[:num_rounds_b]
        r_x = challenges[num_rounds_b : num_rounds_b + num_rounds_x]
        r = challenges[num_rounds_b + num_rounds_x]
        r_y = challenges[num_rounds_b + num_rounds_x + 1 :]

        weights = weights_from_r(F, r_b, n_padded)
        with span("verify_fold_steps"):
            folded_comm = pcs.fold_commitments([u.comm_W for u in step_regular], weights,
                                               dev)
        folded_X = [sum(w_i * u.X[j] for w_i, u in zip(weights, step_regular)) % p
                    for j in range(len(step_regular[0].X))]
        folded_U = R1CSInstance(comm_W=folded_comm, X=folded_X)

        with span("verify_nifs"):
            folded_U_verifier = proof.nifs.verify(pcs, F, transcript, proof.random_U,
                                                  U_verifier_regular, dev)
        with span("verify_relaxed_snark"):
            proof.relaxed_snark.verify(pcs, vk.vc_shape_regular, vk.vc_vk,
                                       folded_U_verifier, transcript)

        with span("verify_evaluate_ABC"):
            eA_s, eB_s, eC_s = vk.S_step.evaluate_at(r_x, r_y)
            eA_c, eB_c, eC_c = vk.S_core.evaluate_at(r_x, r_y)

        def eval_x(X):
            return sparse_poly_evaluate_host(F, _log2(num_vars), [1] + X, r_y[1:])

        if (public_values[0] != pow_evaluate(F, tau, r_x)
                or public_values[1] != eval_x(folded_U.X)
                or public_values[2] != eval_x(core_regular.X)
                or public_values[3] != eq_evaluate(F, r_b, rhos)
                or public_values[4] != (eA_s + r * eB_s + r * r * eC_s) % p
                or public_values[5] != (eA_c + r * eB_c + r * r * eC_c) % p):
            raise SpartanError(
                "verifier instance public values do not match recomputation")

        c_eval = transcript.squeeze(b"c_eval")
        eval_w_step_round = num_rounds_b + 1 + num_rounds_x + 1 + num_rounds_y + 1
        comm_eval_W_step = proof.U_verifier.comm_w_per_round[eval_w_step_round]
        comm_eval_W_core = proof.U_verifier.comm_w_per_round[eval_w_step_round + 1]
        comm = pcs.fold_commitments([folded_U.comm_W, core_regular.comm_W], [1, c_eval],
                                    dev)
        comm_eval = pcs.fold_commitments([comm_eval_W_step, comm_eval_W_core],
                                         [1, c_eval], dev)
        with span("verify_pcs"):
            pcs.verify(vk.vk_ee, vk.vc_ck, transcript, comm, r_y[1:], comm_eval,
                       proof.eval_arg)
        return ([u.public_values for u in step_instances[:num_instances]],
                core_instance.public_values)
