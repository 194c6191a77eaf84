"""SpartanSNARK (non-ZK): setup / prep_prove / prove / verify.

Reference: src/spartan.rs; the protocol, transcript labels, absorb order
and order of random draws are the JAX package's (spartan2_tpu/snark/
spartan.py), so with the same blinds the proof bytes are equal.

The prover keeps the bulk data on the keys' device: witness commits on
the comb MSM (kernel 3), Az/Bz/Cz and poly_ABC on the SpMV (kernel 1),
the PCS L-fold on kernel 4.  Both sum-checks run on the device
transcript (JAX's spartan.py:478-640): the host state moves to a
DeviceTranscript, every round is enqueued (kernels G or A/B for the
sums, F for the round finish and squeeze, kernel A's binds), the
claims_outer absorb and the squeeze of r run on the card too (kernel T),
and the host pulls twice: the outer finals and r (``outer_sync_pull``),
then the state, coefficients and challenges (``tail_sync_pull``).  The
entry points run under torch.inference_mode: nothing here needs
autograd, and its bookkeeping would cost every small launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..errors import DivisionByZeroError, IncorrectWitnessError, ProofVerifyError
from ..field.limbs import limbs_to_ints, to_device
from ..frontend.constraint_system import ConstraintSystem
from ..pcs.hyrax import HyraxBlind, HyraxCommitment, HyraxEvaluationArgument
from ..polys.eq import eq_evaluate
from ..polys.multilinear import sparse_poly_evaluate_host
from ..polys.univariate import UniPoly
from ..provider.engines import Engine
from ..r1cs.shape import R1CSWitness, SplitR1CSInstance, SplitR1CSShape
from ..parallel.sumcheck_shard import ShardedSumcheckCubicEq, ShardedSumcheckQuad
from ..sumcheck.device import new_ticket
from ..sumcheck.prove import SpartanInnerRound0, SumcheckProverCubicEq, SumcheckProverQuad
from ..sumcheck.verify import SumcheckProof
from ..transcript.device import DeviceTranscript
from ..transcript.transcript import Transcript
from ..utils.digest import vk_digest
from ..utils.tracing import span


def _log2(n: int) -> int:
    assert n & (n - 1) == 0 and n > 0
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# keys / prep state / proof
# ---------------------------------------------------------------------------


@dataclass
class SpartanProverKey:
    engine: Engine
    S: SplitR1CSShape
    ck: object
    ck_s: object
    vk_digest: bytes

    @property
    def device(self) -> torch.device:
        return self.S.dev["device"]


@dataclass
class SpartanVerifierKey:
    engine: Engine
    S: SplitR1CSShape
    vk_ee: object  # Hyrax verifier key (same generators as ck)
    ck_s: object
    digest: bytes


@dataclass
class PrecommittedState:
    """bellpepper/r1cs.rs:290-301: witness prefix + partial commitments."""

    cs: ConstraintSystem
    shared: list
    precommitted: list
    W: list  # host ints, length num_vars (padded layout)
    comm_W_shared: Optional[HyraxCommitment] = None
    r_W_shared: Optional[HyraxBlind] = None
    comm_W_precommitted: Optional[HyraxCommitment] = None
    r_W_precommitted: Optional[HyraxBlind] = None
    # device copy of the static shared + precommitted witness (Montgomery)
    W_prefix: Optional[torch.Tensor] = None
    # cached prefix Az/Bz/Cz products, (3, num_cons, 8) (spartan.rs:176-216)
    matvec_cache: Optional[torch.Tensor] = None

    def clone_after_shared(self) -> "PrecommittedState":
        """Per-step copy of the shared-phase state (NeutronNova preps one
        shared witness and clones it for every step circuit,
        neutronnova_zk.rs:1495-1509): shares the commitments and the
        shared handles, copies the lists a step's synthesis changes."""
        cs = ConstraintSystem(self.cs.field, shape_mode=False)
        cs.num_aux = self.cs.num_aux
        cs.aux_assignment = list(self.cs.aux_assignment)
        cs.input_assignment = list(self.cs.input_assignment)
        return PrecommittedState(
            cs=cs, shared=self.shared, precommitted=list(self.precommitted),
            W=list(self.W), comm_W_shared=self.comm_W_shared,
            r_W_shared=self.r_W_shared,
            comm_W_precommitted=self.comm_W_precommitted,
            r_W_precommitted=self.r_W_precommitted, W_prefix=self.W_prefix,
            matvec_cache=self.matvec_cache)


@dataclass
class SpartanPrepSNARK:
    ps: PrecommittedState


@dataclass
class SpartanSNARKProof:
    U: SplitR1CSInstance
    sc_proof_outer: SumcheckProof
    claims_outer: tuple  # (Az, Bz, Cz) at r_x
    sc_proof_inner: SumcheckProof
    eval_W: int
    blind_eval_W: HyraxBlind  # non-ZK: the blind is sent (spartan.rs:136)
    eval_arg: HyraxEvaluationArgument


# ---------------------------------------------------------------------------
# witness machinery (bellpepper/r1cs.rs SpartanWitness equivalents)
# ---------------------------------------------------------------------------


def _upload_mont(engine: Engine, vals: list[int], device) -> torch.Tensor:
    return to_device(vals, engine.scalar, device, mont=True)


def shared_witness(engine: Engine, S: SplitR1CSShape, ck, circuit,
                   is_small: bool, rng=None) -> PrecommittedState:
    """bellpepper/r1cs.rs:306-357."""
    cs = ConstraintSystem(engine.scalar, shape_mode=False)
    W = [0] * S.num_vars
    shared = circuit.shared(cs)
    if len(cs.aux_assignment) < S.num_shared_unpadded:
        raise IncorrectWitnessError("shared variables not allocated correctly")
    W[: S.num_shared_unpadded] = cs.aux_assignment[: S.num_shared_unpadded]
    comm = blind = None
    if S.num_shared_unpadded > 0:
        blind = engine.pcs.blind(ck, S.num_shared, rng=rng)
        comm = engine.pcs.commit(ck, W[: S.num_shared], blind, is_small)
    return PrecommittedState(cs=cs, shared=shared, precommitted=[], W=W,
                             comm_W_shared=comm, r_W_shared=blind)


def _precommitted_segment(ps: PrecommittedState, S: SplitR1CSShape,
                          circuit) -> None:
    """Synthesize the precommitted phase into ps.W."""
    precommitted = circuit.precommitted(ps.cs, ps.shared)
    aux = ps.cs.aux_assignment
    lo = S.num_shared_unpadded
    if len(aux) - lo < S.num_precommitted_unpadded:
        raise IncorrectWitnessError("precommitted variables not allocated correctly")
    ps.W[S.num_shared : S.num_shared + S.num_precommitted_unpadded] = aux[
        lo : lo + S.num_precommitted_unpadded]
    ps.precommitted = precommitted


def precommitted_witness(engine: Engine, ps: PrecommittedState,
                         S: SplitR1CSShape, ck, circuit, is_small: bool,
                         rng=None) -> None:
    """bellpepper/r1cs.rs:359-409."""
    _precommitted_segment(ps, S, circuit)
    if S.num_precommitted_unpadded > 0:
        blind = engine.pcs.blind(ck, S.num_precommitted, rng=rng)
        seg = ps.W[S.num_shared : S.num_shared + S.num_precommitted]
        ps.comm_W_precommitted = engine.pcs.commit(ck, seg, blind, is_small)
        ps.r_W_precommitted = blind


def precommitted_witness_batch(engine: Engine, ps_list: list, S: SplitR1CSShape,
                               ck, circuits, is_small: bool, rng=None) -> None:
    """``precommitted_witness`` of many states: each circuit synthesizes in
    turn, then every blind is drawn (in state order, after all the
    syntheses, as the JAX package draws them), and the segments are
    committed together: one comb launch for all rows, one for the blinds
    (neutronnova_zk.rs:1477-1603; the JAX package's spartan.py:192-228)."""
    for ps, circ in zip(ps_list, circuits):
        _precommitted_segment(ps, S, circ)
    if S.num_precommitted_unpadded == 0:
        return
    pcs = engine.pcs
    blinds = [pcs.blind(ck, S.num_precommitted, rng=rng) for _ in ps_list]
    segs = [ps.W[S.num_shared : S.num_shared + S.num_precommitted] for ps in ps_list]
    comms = pcs.commit_from_raw_batch(ck, pcs.commit_raw_batch(ck, segs, is_small),
                                      blinds)
    for ps, blind, comm in zip(ps_list, blinds, comms):
        ps.comm_W_precommitted = comm
        ps.r_W_precommitted = blind


def cache_prefix(S: SplitR1CSShape, engine: Engine, ps: PrecommittedState) -> None:
    """Upload the witness prefix and cache its Az/Bz/Cz products, so every
    prove runs only the suffix SpMV (reference prep caching,
    spartan.rs:176-216 + r1cs/mod.rs:1112-1211)."""
    lo = S.num_shared + S.num_precommitted
    if 0 < lo < S.num_cols:
        ps.W_prefix = _upload_mont(engine, ps.W[:lo], S.dev["device"])
        ps.matvec_cache = S.multiply_vec_precommitted(ps.W_prefix)


@dataclass
class PendingInstance:
    """An instance synthesized up to its rest commitment, so that a batch
    of them (NeutronNova's steps) can commit their rest segments together
    (the JAX package's spartan.py:229-242)."""

    ps: PrecommittedState
    challenges: list
    r_W_rest: HyraxBlind
    rest: Optional[list]  # the rest segment; None when it is all padding
    is_small: bool
    public_values: list


def instance_witness_begin(engine: Engine, ps: PrecommittedState,
                           S: SplitR1CSShape, ck, circuit, is_small: bool,
                           transcript: Transcript, rng=None) -> PendingInstance:
    """Phase 1 of bellpepper/r1cs.rs:411-537: absorb the partial
    commitments, squeeze the challenges, synthesize the rest, draw its
    blind."""
    if ps.comm_W_shared is not None:
        transcript.absorb_bytes(b"comm_W_shared",
                                ps.comm_W_shared.to_transcript_bytes(engine.curve))
    if ps.comm_W_precommitted is not None:
        transcript.absorb_bytes(
            b"comm_W_precommitted",
            ps.comm_W_precommitted.to_transcript_bytes(engine.curve))
    challenges = [transcript.squeeze(b"challenge") for _ in range(S.num_challenges)]

    skip_synthesize = S.num_rest_unpadded == 0 and not challenges
    lo = S.num_shared + S.num_precommitted
    if not skip_synthesize:
        prep_aux = S.num_shared_unpadded + S.num_precommitted_unpadded
        del ps.cs.aux_assignment[prep_aux:]
        del ps.cs.input_assignment[1:]
        circuit.synthesize(ps.cs, ps.shared, ps.precommitted,
                           challenges if challenges else None)
        ps.W[lo : lo + S.num_rest_unpadded] = ps.cs.aux_assignment[
            prep_aux : prep_aux + S.num_rest_unpadded]

    r_W_rest = engine.pcs.blind(ck, S.num_rest, rng=rng)
    if lo and ps.W_prefix is None:
        ps.W_prefix = _upload_mont(engine, ps.W[:lo], S.dev["device"])
    if skip_synthesize:
        public_values = circuit.public_values()
    else:
        public_values = ps.cs.input_assignment[1 : 1 + S.num_public]
    if S.num_rest_unpadded == 0:
        return PendingInstance(ps, challenges, r_W_rest, None, True, public_values)
    small = is_small or all(v < (1 << 64) for v in ps.W[lo : lo + S.num_rest_unpadded])
    return PendingInstance(ps, challenges, r_W_rest, ps.W[lo : lo + S.num_rest], small,
                           public_values)


def instance_witness_finish(engine: Engine, pend: PendingInstance, S: SplitR1CSShape,
                            comm_W_rest: HyraxCommitment, transcript: Transcript):
    """Phase 2: absorb the rest commitment -> (SplitR1CSInstance,
    R1CSWitness with the witness on the shape's device)."""
    ps = pend.ps
    device = S.dev["device"]
    transcript.absorb_bytes(b"comm_W_rest", comm_W_rest.to_transcript_bytes(engine.curve))
    U = SplitR1CSInstance(
        comm_W_shared=ps.comm_W_shared,
        comm_W_precommitted=ps.comm_W_precommitted,
        comm_W_rest=comm_W_rest,
        public_values=pend.public_values,
        challenges=pend.challenges,
    )
    blinds = [b for b in (ps.r_W_shared, ps.r_W_precommitted) if b is not None]
    blinds.append(pend.r_W_rest)
    if pend.rest is None:
        rest_mont = torch.zeros(S.num_rest, 8, dtype=torch.int32, device=device)
    else:
        rest_mont = _upload_mont(engine, pend.rest, device)
    lo = S.num_shared + S.num_precommitted
    W_dev = torch.cat([ps.W_prefix, rest_mont]) if lo else rest_mont
    return U, R1CSWitness(W=W_dev, r_W=engine.pcs.combine_blinds(blinds))


def commit_pending_batch(engine: Engine, ck, S: SplitR1CSShape,
                         pendings: list[PendingInstance]) -> list[HyraxCommitment]:
    """The rest commitments of many pending instances: the all-padding
    ones in one comb launch over their blinds, the others' rows in one
    comb launch and their blinds in another (the JAX package's
    spartan.py:338-373)."""
    pcs = engine.pcs
    out: list = [None] * len(pendings)
    zeros = [i for i, p in enumerate(pendings) if p.rest is None]
    live = [i for i, p in enumerate(pendings) if p.rest is not None]
    if zeros:
        with span("commit_rest_zeros_batch"):
            comms = pcs.commit_zeros_batch(ck, [pendings[i].r_W_rest for i in zeros])
        for i, cm in zip(zeros, comms):
            out[i] = cm
    if live:
        with span("commit_rest_batch"):
            raws = pcs.commit_raw_batch(ck, [pendings[i].rest for i in live],
                                        all(pendings[i].is_small for i in live))
            comms = pcs.commit_from_raw_batch(ck, raws,
                                              [pendings[i].r_W_rest for i in live])
        for i, cm in zip(live, comms):
            out[i] = cm
    return out


def r1cs_instance_and_witness(engine: Engine, ps: PrecommittedState,
                              S: SplitR1CSShape, ck, circuit, is_small: bool,
                              transcript: Transcript, rng=None):
    """bellpepper/r1cs.rs:411-537: absorb partial commitments, squeeze
    challenges, synthesize the rest, commit it."""
    pcs = engine.pcs
    pend = instance_witness_begin(engine, ps, S, ck, circuit, is_small, transcript, rng)
    if pend.rest is None:
        with span("commit_rest_zeros"):
            comm_W_rest = pcs.commit_zeros(ck, S.num_rest, pend.r_W_rest)
    else:
        with span("commit_rest"):
            comm_W_rest = pcs.commit(ck, pend.rest, pend.r_W_rest, pend.is_small)
    return instance_witness_finish(engine, pend, S, comm_W_rest, transcript)


# ---------------------------------------------------------------------------
# SNARK
# ---------------------------------------------------------------------------


class SpartanSNARK:
    """R1CSSNARKTrait equivalent (traits/snark.rs:15-51)."""

    @staticmethod
    @torch.inference_mode()
    def setup(engine: Engine, circuit, width: int = 2048, device="cuda"):
        """Keys whose device state (matrices, comb tables) lives on
        ``device``."""
        with span("setup_shape"):
            S = SplitR1CSShape.from_circuit(circuit, engine.scalar, width)
        with span("setup_upload"):
            S.attach_device(device)
        with span("setup_generators"):
            ck, vk_ee = engine.pcs.setup(b"ck", S.num_vars, width, device)
            ck_s, _ = engine.pcs.setup(b"ck_s", 1, 1, device)
        with span("setup_digest"):
            digest = vk_digest(S, ck, ck_s)
        return (SpartanProverKey(engine, S, ck, ck_s, digest),
                SpartanVerifierKey(engine, S, vk_ee, ck_s, digest))

    @staticmethod
    @torch.inference_mode()
    def prep_prove(pk: SpartanProverKey, circuit, is_small: bool = False,
                   rng=None) -> SpartanPrepSNARK:
        with span("prep_synthesize_commit"):
            ps = shared_witness(pk.engine, pk.S, pk.ck, circuit, is_small, rng)
            precommitted_witness(pk.engine, ps, pk.S, pk.ck, circuit, is_small, rng)
        with span("prep_matvec_cache"):
            cache_prefix(pk.S, pk.engine, ps)
        return SpartanPrepSNARK(ps=ps)

    @staticmethod
    def instance(pk: SpartanProverKey, circuit, prep: SpartanPrepSNARK,
                 is_small: bool = False, rng=None):
        """The prove up to its outer sum-check: the transcript after the
        taus, the instance and witness, z = (W, 1, X) on the device, the
        taus and Az/Bz/Cz -> (transcript, U, W, z, taus, ABC)."""
        engine, S = pk.engine, pk.S
        transcript = engine.transcript(b"SpartanSNARK")
        transcript.absorb_bytes(b"vk", pk.vk_digest)
        transcript.absorb_scalars(b"public_values", circuit.public_values())

        with span("witness_and_instance"):
            U, W = r1cs_instance_and_witness(engine, prep.ps, S, pk.ck, circuit,
                                             is_small, transcript, rng)
        tail = _upload_mont(engine, [1] + U.public_values + U.challenges, pk.device)
        z = torch.cat([W.W, tail])  # (num_cols, 8)
        taus = [transcript.squeeze(b"t") for _ in range(_log2(S.num_cons))]

        with span("matrix_vector_multiply"):
            if prep.ps.matvec_cache is not None:
                ABC = S.multiply_vec_incremental(z, prep.ps.matvec_cache)
            else:
                ABC = S.multiply_vec(z)
        return transcript, U, W, z, taus, ABC

    @staticmethod
    def outer_sumcheck(F, td: DeviceTranscript, ABC, taus: list[int], eff: int,
                       mesh=None):
        """The outer sum-check on the device transcript, Az/Bz/Cz zero past
        the ``eff`` unpadded constraints (round 0 reads the upper half only
        below it), sharded across ``mesh`` when each rank gets two rows or
        more -> (coeffs (m, 4, 8), challenges (m, 2, 8), finals)."""
        zero = torch.zeros(8, dtype=torch.int32, device=ABC.device)
        prover = (SumcheckProverCubicEq(F) if mesh is None
                  else ShardedSumcheckCubicEq(F, mesh))
        return prover.prove(td, ABC[0], ABC[1], ABC[2], zero, taus, zero_check=True,
                            eff=eff)[:3]

    @staticmethod
    def inner_sumcheck(F, td: DeviceTranscript, abc, z, claim, num_vars: int,
                       num_extra: int, mesh=None):
        """The inner sum-check over the 2 num_vars domain, on the device
        transcript: kernel B's structured round 0 over abc and z at width
        num_cols (both zero past it), then the quad rounds over num_vars,
        sharded across ``mesh`` when each rank gets two rows or more
        -> (coeffs (1 + n, 3, 8), challenges (1 + n, 2, 8), eval_Z)."""
        ticket = new_ticket(abc.device)  # one arrival counter for every round
        claim0, r0, coeffs0 = SpartanInnerRound0(F).run(td, abc, z, claim, num_vars,
                                                        num_extra, ticket)
        n = _log2(num_vars)
        prover = SumcheckProverQuad(F) if mesh is None else ShardedSumcheckQuad(F, mesh)
        cq, rq, finals, _ = prover.prove(td, abc[:num_vars], z[:num_vars], claim0, n, ticket)
        return torch.cat([coeffs0[None], cq]), torch.cat([r0[None], rq]), finals[1]

    @staticmethod
    @torch.inference_mode()
    def prove(pk: SpartanProverKey, circuit, prep: SpartanPrepSNARK,
              is_small: bool = False, rng=None, mesh=None):
        """A proof.  With ``mesh`` (parallel/mesh.py), every rank of it
        calls prove with the same arguments: the outer sum-check and the
        inner quad rounds run sharded across the ranks, the rest
        replicated, and every rank returns the single-device proof.  The
        ranks must draw the same blinds: pass one deterministic ``rng`` to
        each, or None, and rank 0's seed drives every rank's draws."""
        if mesh is not None and rng is None:
            rng = mesh.common_rng()
        engine = pk.engine
        S = pk.S
        F = engine.scalar
        p = F.modulus
        device = pk.device

        transcript, U, W, z, taus, ABC = SpartanSNARK.instance(pk, circuit, prep,
                                                               is_small, rng)
        num_vars = S.num_vars
        num_rounds_x = len(taus)
        num_rounds_y = _log2(num_vars) + 1

        td = DeviceTranscript.from_host(transcript, device)
        with span("outer_sumcheck"):
            coeffs_outer, rx_pairs, finals = SpartanSNARK.outer_sumcheck(
                F, td, ABC, taus, S.num_cons_unpadded, mesh)
            td.absorb_scalars_mont(b"claims_outer", torch.stack(finals))
            r_dev = td.squeeze_mont(b"r")
        with span("outer_sync_pull"):  # the one pull of the outer sum-check
            vals = limbs_to_ints(torch.stack([*finals, r_dev]), F, mont=True)
        claim_Az, claim_Bz, claim_Cz, r = vals
        claim_inner = (claim_Az + r * claim_Bz + r * r * claim_Cz) % p

        with span("prepare_poly_ABC"):
            # the eq(r_x) factors [r_x, 1 - r_x], as the round finishes wrote them
            abc = S.bind_and_prepare_poly_ABC_dev(
                rx_pairs.transpose(0, 1).reshape(2 * num_rounds_x, 8), r)
        with span("inner_sumcheck"):
            claim_dev = _upload_mont(engine, [claim_inner], device)[0]
            coeffs_inner, ry_pairs, eval_Z_dev = SpartanSNARK.inner_sumcheck(
                F, td, abc, z, claim_dev, num_vars, S.num_cols - num_vars, mesh)
        with span("tail_sync_pull"):  # state, coefficients, challenges: one pull
            arr = torch.cat([
                td.state.view(torch.int32).reshape(2, 8), coeffs_outer.reshape(-1, 8),
                coeffs_inner.reshape(-1, 8), ry_pairs[:, 0], eval_Z_dev[None]]).cpu().numpy()
        transcript.state = arr[:2].tobytes()
        transcript.round = td.round
        vals = limbs_to_ints(arr[2:], F, mont=True)
        n_out, n_in = 4 * num_rounds_x, 3 * num_rounds_y
        sc_proof_outer = SumcheckProof(F, [
            UniPoly(F, vals[i : i + 4]).compress() for i in range(0, n_out, 4)])
        sc_proof_inner = SumcheckProof(F, [
            UniPoly(F, vals[i : i + 3]).compress() for i in range(n_out, n_out + n_in, 3)])
        r_y = vals[n_out + n_in : n_out + n_in + num_rounds_y]
        eval_Z = vals[-1]

        # eval_W = (eval_Z - r_y[0] * eval_X) / (1 - r_y[0])   (Z = (W, 1, X))
        X = U.public_values + U.challenges
        eval_X = sparse_poly_evaluate_host(F, num_rounds_y - 1, [1] + X, r_y[1:])
        denom = (1 - r_y[0]) % p
        if denom == 0:
            raise DivisionByZeroError("division by zero in eval_W")
        eval_W = (eval_Z - r_y[0] * eval_X) * pow(denom, -1, p) % p

        blind_eval_W = engine.pcs.blind(pk.ck_s, 1, rng=rng)
        comm_eval_W = engine.pcs.commit_host(pk.ck_s, [eval_W], blind_eval_W)
        comm_W, _ = U.to_regular(engine.pcs)
        with span("pcs_prove"):
            eval_arg = engine.pcs.prove(pk.ck, pk.ck_s, transcript, comm_W, W.W,
                                        W.r_W, r_y[1:], comm_eval_W, blind_eval_W,
                                        rng=rng)
        proof = SpartanSNARKProof(
            U=U, sc_proof_outer=sc_proof_outer,
            claims_outer=(claim_Az, claim_Bz, claim_Cz),
            sc_proof_inner=sc_proof_inner, eval_W=eval_W,
            blind_eval_W=blind_eval_W, eval_arg=eval_arg)
        return proof, prep

    @staticmethod
    @torch.inference_mode()
    def verify(proof: SpartanSNARKProof, vk: SpartanVerifierKey) -> list[int]:
        """Reference verify (spartan.rs:469-578); the MLE evaluation of A, B
        and C runs on the key's device."""
        engine = vk.engine
        S = vk.S
        p = engine.scalar.modulus
        transcript = engine.transcript(b"SpartanSNARK")
        transcript.absorb_bytes(b"vk", vk.digest)
        transcript.absorb_scalars(b"public_values", proof.U.public_values)

        proof.U.validate(S, engine.pcs, transcript)
        comm_W, X = proof.U.to_regular(engine.pcs)

        num_vars = S.num_vars
        num_rounds_x = _log2(S.num_cons)
        num_rounds_y = _log2(num_vars) + 1
        taus = [transcript.squeeze(b"t") for _ in range(num_rounds_x)]

        claim_outer_final, r_x = proof.sc_proof_outer.verify(0, num_rounds_x, 3,
                                                             transcript)
        claim_Az, claim_Bz, claim_Cz = proof.claims_outer
        taus_bound_rx = eq_evaluate(engine.scalar, taus, r_x)
        expected = taus_bound_rx * (claim_Az * claim_Bz - claim_Cz) % p
        if claim_outer_final % p != expected:
            raise ProofVerifyError("invalid outer sum-check claim")

        transcript.absorb_scalars(b"claims_outer", [claim_Az, claim_Bz, claim_Cz])
        r = transcript.squeeze(b"r")
        claim_inner = (claim_Az + r * claim_Bz + r * r * claim_Cz) % p
        claim_inner_final, r_y = proof.sc_proof_inner.verify(claim_inner,
                                                             num_rounds_y, 2,
                                                             transcript)
        eval_X = sparse_poly_evaluate_host(engine.scalar, num_rounds_y - 1,
                                           [1] + X, r_y[1:])
        eval_Z = ((1 - r_y[0]) * proof.eval_W + r_y[0] * eval_X) % p
        with span("verify_evaluate_ABC"):
            eval_A, eval_B, eval_C = S.evaluate_at(r_x, r_y)
        expected_inner = (eval_A + r * eval_B + r * r * eval_C) * eval_Z % p
        if claim_inner_final % p != expected_inner:
            raise ProofVerifyError("invalid inner sum-check claim")

        comm_eval_W = engine.pcs.commit_host(vk.ck_s, [proof.eval_W],
                                             proof.blind_eval_W)
        with span("verify_pcs"):
            engine.pcs.verify(vk.vk_ee, vk.ck_s, transcript, comm_W, r_y[1:],
                              comm_eval_W, proof.eval_arg)
        return list(proof.U.public_values)
