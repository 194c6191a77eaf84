"""Deterministic binary serialization for proofs, keys and prep state.

The same bincode-like codec as the JAX package (spartan2_tpu/utils/
serde.py): little-endian u64 length prefixes, scalars as 32-byte LE,
points as 65-byte (x, y, infinity-flag).  The port writes the same bytes
and reads what the JAX package writes: keys and prep state recorded by
either load into the other.
"""

from __future__ import annotations

import struct

from ..errors import DigestError, SpartanError
from ..field.constants import FieldSpec
from ..pcs.hyrax import HyraxBlind, HyraxCommitment, HyraxEvaluationArgument, IpaProof
from ..polys.univariate import CompressedUniPoly
from ..sumcheck.verify import SumcheckProof

MAGIC = b"SP2TPU01"


class Writer:
    def __init__(self, field: FieldSpec, curve):
        self.field = field
        self.curve = curve
        self.buf = bytearray(MAGIC)

    def u64(self, v: int):
        self.buf += struct.pack("<Q", v)

    def scalar(self, v: int):
        self.buf += self.field.to_bytes(v)

    def scalars(self, vs):
        self.u64(len(vs))
        for v in vs:
            self.scalar(v)

    def point(self, pt):
        self.buf += self.curve.point_bytes(pt)

    def commitment(self, c: HyraxCommitment):
        self.u64(len(c.comm))
        for pt in c.comm:
            self.point(pt)

    def opt_commitment(self, c):
        self.buf += b"\x01" if c is not None else b"\x00"
        if c is not None:
            self.commitment(c)

    def blind(self, b: HyraxBlind):
        self.scalars(b.blind)

    def sumcheck(self, proof: SumcheckProof):
        self.u64(len(proof.compressed_polys))
        for cp in proof.compressed_polys:
            self.scalars(cp.coeffs_except_linear)

    def ipa(self, ipa: IpaProof):
        self.point(ipa.delta)
        self.point(ipa.beta)
        self.scalars(ipa.z_vec)
        self.scalar(ipa.z_delta)
        self.scalar(ipa.z_beta)

    def bytes_out(self) -> bytes:
        return bytes(self.buf)


class Reader:
    def __init__(self, field: FieldSpec, curve, data: bytes):
        if data[:8] != MAGIC:
            raise SpartanError("bad magic in serialized object")
        self.field = field
        self.curve = curve
        self.data = data
        self.pos = 8

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise SpartanError("truncated serialized object")
        self.pos += n
        return out

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def scalar(self) -> int:
        return self.field.from_bytes(self.take(32))

    def scalars(self) -> list[int]:
        return [self.scalar() for _ in range(self.u64())]

    def point(self):
        return self.curve.point_from_bytes(self.take(65))

    def commitment(self) -> HyraxCommitment:
        return HyraxCommitment([self.point() for _ in range(self.u64())])

    def opt_commitment(self):
        return self.commitment() if self.take(1) == b"\x01" else None

    def blind(self) -> HyraxBlind:
        return HyraxBlind(self.scalars())

    def sumcheck(self) -> SumcheckProof:
        n = self.u64()
        return SumcheckProof(
            self.field,
            [CompressedUniPoly(self.field, self.scalars()) for _ in range(n)],
        )

    def ipa(self) -> IpaProof:
        return IpaProof(self.point(), self.point(), self.scalars(),
                        self.scalar(), self.scalar())

    def done(self):
        if self.pos != len(self.data):
            raise SpartanError("trailing bytes in serialized object")


# ---------------------------------------------------------------------------
# proofs
# ---------------------------------------------------------------------------


def _write_split_instance(w: Writer, U):
    w.opt_commitment(U.comm_W_shared)
    w.opt_commitment(U.comm_W_precommitted)
    w.commitment(U.comm_W_rest)
    w.scalars(U.public_values)
    w.scalars(U.challenges)


def _read_split_instance(r: Reader):
    from ..r1cs.shape import SplitR1CSInstance

    return SplitR1CSInstance(
        comm_W_shared=r.opt_commitment(),
        comm_W_precommitted=r.opt_commitment(),
        comm_W_rest=r.commitment(),
        public_values=r.scalars(),
        challenges=r.scalars(),
    )


def spartan_proof_to_bytes(proof, engine) -> bytes:
    w = Writer(engine.scalar, engine.curve)
    _write_split_instance(w, proof.U)
    w.sumcheck(proof.sc_proof_outer)
    w.scalars(list(proof.claims_outer))
    w.sumcheck(proof.sc_proof_inner)
    w.scalar(proof.eval_W)
    w.blind(proof.blind_eval_W)
    w.ipa(proof.eval_arg.ipa)
    return w.bytes_out()


def spartan_proof_from_bytes(data: bytes, engine):
    from ..snark.spartan import SpartanSNARKProof

    r = Reader(engine.scalar, engine.curve, data)
    U = _read_split_instance(r)
    outer = r.sumcheck()
    claims = tuple(r.scalars())
    inner = r.sumcheck()
    eval_W = r.scalar()
    blind = r.blind()
    ipa = r.ipa()
    r.done()
    return SpartanSNARKProof(U=U, sc_proof_outer=outer, claims_outer=claims,
                             sc_proof_inner=inner, eval_W=eval_W,
                             blind_eval_W=blind,
                             eval_arg=HyraxEvaluationArgument(ipa))


def _write_relaxed_instance(w: Writer, U):
    w.commitment(U.comm_W)
    w.commitment(U.comm_E)
    w.scalar(U.u)
    w.scalars(U.X)


def _read_relaxed_instance(r: Reader):
    from ..r1cs.relaxed import RelaxedR1CSInstance

    return RelaxedR1CSInstance(comm_W=r.commitment(), comm_E=r.commitment(),
                               u=r.scalar(), X=r.scalars())


def _write_relaxed_snark(w: Writer, rp):
    w.sumcheck(rp.sc_proof_outer)
    w.scalars(list(rp.claims_outer))
    w.sumcheck(rp.sc_proof_inner)
    w.scalars(rp.v_W)
    w.scalar(rp.blind_W)
    w.scalars(rp.v_E)
    w.scalar(rp.blind_E)


def _read_relaxed_snark(r: Reader):
    from ..snark.spartan_relaxed import RelaxedR1CSSpartanProof

    return RelaxedR1CSSpartanProof(
        sc_proof_outer=r.sumcheck(), claims_outer=tuple(r.scalars()),
        sc_proof_inner=r.sumcheck(), v_W=r.scalars(), blind_W=r.scalar(),
        v_E=r.scalars(), blind_E=r.scalar())


def _write_multiround_instance(w: Writer, U):
    w.u64(len(U.comm_w_per_round))
    for c in U.comm_w_per_round:
        w.commitment(c)
    w.scalars(U.public_values)
    w.u64(len(U.challenges_per_round))
    for ch in U.challenges_per_round:
        w.scalars(ch)


def _read_multiround_instance(r: Reader):
    from ..r1cs.multiround import SplitMultiRoundR1CSInstance

    comms = [r.commitment() for _ in range(r.u64())]
    public_values = r.scalars()
    chals = [r.scalars() for _ in range(r.u64())]
    return SplitMultiRoundR1CSInstance(comm_w_per_round=comms,
                                       public_values=public_values,
                                       challenges_per_round=chals)


def spartan_zk_proof_to_bytes(proof, engine) -> bytes:
    w = Writer(engine.scalar, engine.curve)
    _write_split_instance(w, proof.U)
    _write_multiround_instance(w, proof.U_verifier)
    _write_relaxed_instance(w, proof.random_U)
    w.commitment(proof.nifs.comm_T)
    _write_relaxed_snark(w, proof.relaxed_snark)
    w.ipa(proof.eval_arg.ipa)
    return w.bytes_out()


def spartan_zk_proof_from_bytes(data: bytes, engine):
    from ..r1cs.relaxed import NovaNIFS
    from ..snark.spartan_zk import SpartanZkSNARKProof

    r = Reader(engine.scalar, engine.curve, data)
    U = _read_split_instance(r)
    U_verifier = _read_multiround_instance(r)
    random_U = _read_relaxed_instance(r)
    nifs = NovaNIFS(comm_T=r.commitment())
    relaxed = _read_relaxed_snark(r)
    ipa = r.ipa()
    r.done()
    return SpartanZkSNARKProof(U=U, U_verifier=U_verifier, random_U=random_U,
                               nifs=nifs, relaxed_snark=relaxed,
                               eval_arg=HyraxEvaluationArgument(ipa))


def neutronnova_proof_to_bytes(proof, engine) -> bytes:
    w = Writer(engine.scalar, engine.curve)
    w.opt_commitment(proof.comm_W_shared)
    w.u64(len(proof.step_instances))
    for u in proof.step_instances:
        _write_split_instance(w, u)
    _write_split_instance(w, proof.core_instance)
    _write_multiround_instance(w, proof.U_verifier)
    _write_relaxed_instance(w, proof.random_U)
    w.commitment(proof.nifs.comm_T)
    _write_relaxed_snark(w, proof.relaxed_snark)
    w.ipa(proof.eval_arg.ipa)
    return w.bytes_out()


def neutronnova_proof_from_bytes(data: bytes, engine):
    from ..r1cs.relaxed import NovaNIFS
    from ..snark.neutronnova import NeutronNovaProof

    r = Reader(engine.scalar, engine.curve, data)
    comm_shared = r.opt_commitment()
    steps = [_read_split_instance(r) for _ in range(r.u64())]
    core = _read_split_instance(r)
    U_verifier = _read_multiround_instance(r)
    random_U = _read_relaxed_instance(r)
    nifs = NovaNIFS(comm_T=r.commitment())
    relaxed = _read_relaxed_snark(r)
    ipa = r.ipa()
    r.done()
    return NeutronNovaProof(comm_W_shared=comm_shared, step_instances=steps,
                            core_instance=core, U_verifier=U_verifier,
                            random_U=random_U, nifs=nifs, relaxed_snark=relaxed,
                            eval_arg=HyraxEvaluationArgument(ipa))


# ---------------------------------------------------------------------------
# keys / prep (checkpoint & resume; reference spartan.rs:42-124 derives
# Serialize on ProverKey/VerifierKey/PrepSNARK)
# ---------------------------------------------------------------------------


def _write_sparse_matrix(w: Writer, M):
    w.u64(M.cols)
    w.u64(len(M.indptr))
    for v in M.indptr:
        w.u64(v)
    w.u64(len(M.data))
    for v in M.data:
        w.scalar(v)
    for c in M.indices:
        w.u64(c)


def _read_sparse_matrix(r: Reader):
    from ..r1cs.sparse import SparseMatrix

    cols = r.u64()
    indptr = [r.u64() for _ in range(r.u64())]
    nnz = r.u64()
    data = [r.scalar() for _ in range(nnz)]
    indices = [r.u64() for _ in range(nnz)]
    return SparseMatrix(r.field, data, indices, indptr, cols)


_SHAPE_NUMS = (
    "num_cons", "num_cons_unpadded", "num_shared", "num_shared_unpadded",
    "num_precommitted", "num_precommitted_unpadded", "num_rest",
    "num_rest_unpadded", "num_public", "num_challenges", "width",
)


def _write_shape(w: Writer, S):
    for name in _SHAPE_NUMS:
        w.u64(getattr(S, name))
    _write_sparse_matrix(w, S.A)
    _write_sparse_matrix(w, S.B)
    _write_sparse_matrix(w, S.C)


def _read_shape(r: Reader):
    """Rebuild a SplitR1CSShape in its already-padded form (the
    constructor re-pads raw inputs, so bypass it)."""
    from ..r1cs.shape import SplitR1CSShape

    S = SplitR1CSShape.__new__(SplitR1CSShape)
    S.field = r.field
    for name in _SHAPE_NUMS:
        setattr(S, name, r.u64())
    S.A = _read_sparse_matrix(r)
    S.B = _read_sparse_matrix(r)
    S.C = _read_sparse_matrix(r)
    S.dev = None
    return S


def spartan_keys_to_bytes(pk) -> bytes:
    """Serialize the prover key; the verifier key shares every field
    (generators re-derive deterministically from their labels)."""
    engine = pk.engine
    w = Writer(engine.scalar, engine.curve)
    _write_shape(w, pk.S)
    w.buf += pk.vk_digest
    return w.bytes_out()


def spartan_keys_from_bytes(data: bytes, engine, device="cuda"):
    """-> (SpartanProverKey, SpartanVerifierKey) with device state on
    ``device``; the generators re-derive from their labels."""
    from ..snark.spartan import SpartanProverKey, SpartanVerifierKey

    r = Reader(engine.scalar, engine.curve, data)
    S = _read_shape(r)
    digest = r.take(32)
    r.done()
    S.attach_device(device)
    ck, vk_ee = engine.pcs.setup(b"ck", S.num_vars, S.width, device)
    ck_s, _ = engine.pcs.setup(b"ck_s", 1, 1, device)
    pk = SpartanProverKey(engine, S, ck, ck_s, digest)
    vk = SpartanVerifierKey(engine, S, vk_ee, ck_s, digest)
    return pk, vk


def spartan_zk_keys_to_bytes(pk) -> bytes:
    """SpartanZk keys: the shape determines every derived component (the
    verifier circuit's dimensions, the generators); store shape and
    digest."""
    w = Writer(pk.engine.scalar, pk.engine.curve)
    _write_shape(w, pk.S)
    w.buf += pk.vk_digest
    return w.bytes_out()


def spartan_zk_keys_from_bytes(data: bytes, engine, device="cuda"):
    """-> (SpartanZkProverKey, SpartanZkVerifierKey) with device state on
    ``device``; raises DigestError if the rebuilt keys' digest differs."""
    from ..snark.spartan_zk import SpartanZkSNARK

    r = Reader(engine.scalar, engine.curve, data)
    S = _read_shape(r)
    digest = r.take(32)
    r.done()
    pk, vk = SpartanZkSNARK.setup_from_shape(engine, S, device)
    if pk.vk_digest != digest:
        raise DigestError("reloaded SpartanZk key digest mismatch")
    return pk, vk


def _opt_blind(w: Writer, b):
    w.buf += b"\x01" if b is not None else b"\x00"
    if b is not None:
        w.blind(b)


def _read_opt_blind(r: Reader):
    return r.blind() if r.take(1) == b"\x01" else None


def _write_precommitted_state(w: Writer, ps) -> None:
    w.scalars(ps.W)
    w.opt_commitment(ps.comm_W_shared)
    _opt_blind(w, ps.r_W_shared)
    w.opt_commitment(ps.comm_W_precommitted)
    _opt_blind(w, ps.r_W_precommitted)
    w.u64(ps.cs.num_aux)
    w.scalars(ps.cs.aux_assignment)
    w.scalars(ps.cs.input_assignment)


def _read_precommitted_state(r: Reader, engine, circuit):
    """``circuit`` re-synthesizes the shared/precommitted variable handles
    (deterministic, cheap host work); the expensive commitments come from
    the serialized state."""
    from ..frontend.constraint_system import ConstraintSystem
    from ..snark.spartan import PrecommittedState

    W = r.scalars()
    comm_s = r.opt_commitment()
    blind_s = _read_opt_blind(r)
    comm_p = r.opt_commitment()
    blind_p = _read_opt_blind(r)
    num_aux = r.u64()
    aux = r.scalars()
    inputs = r.scalars()

    cs = ConstraintSystem(engine.scalar, shape_mode=False)
    shared = circuit.shared(cs)
    precommitted = circuit.precommitted(cs, shared)
    cs.num_aux = num_aux
    cs.aux_assignment = aux
    cs.input_assignment = inputs
    return PrecommittedState(
        cs=cs, shared=shared, precommitted=precommitted, W=W,
        comm_W_shared=comm_s, r_W_shared=blind_s,
        comm_W_precommitted=comm_p, r_W_precommitted=blind_p,
    )


def spartan_prep_to_bytes(prep, engine) -> bytes:
    """Serialize a SpartanPrepSNARK: witness prefix values, partial
    commitments and blinds, and the constraint-system assignments.
    Device-side caches (limb planes, prefix mat-vec products) are
    deterministic and rebuilt on load."""
    w = Writer(engine.scalar, engine.curve)
    _write_precommitted_state(w, prep.ps)
    return w.bytes_out()


def spartan_prep_from_bytes(data: bytes, engine, pk, circuit):
    """Reload a SpartanPrepSNARK (``circuit`` gives the variable handles)."""
    from ..snark.spartan import SpartanPrepSNARK, cache_prefix

    r = Reader(engine.scalar, engine.curve, data)
    ps = _read_precommitted_state(r, engine, circuit)
    r.done()
    # rebuild the deterministic device caches (mirrors prep_prove)
    cache_prefix(pk.S, engine, ps)
    return SpartanPrepSNARK(ps=ps)


def neutronnova_keys_to_bytes(pk, num_steps: int) -> bytes:
    """NeutronNova keys: the batch size (the verifier circuit's size
    depends on it), both equalized shapes and the digest."""
    w = Writer(pk.engine.scalar, pk.engine.curve)
    w.u64(num_steps)
    _write_shape(w, pk.S_step)
    _write_shape(w, pk.S_core)
    w.buf += pk.vk_digest
    return w.bytes_out()


def neutronnova_keys_from_bytes(data: bytes, engine, device="cuda"):
    """-> (NeutronNovaProverKey, NeutronNovaVerifierKey) with device state
    on ``device``; raises DigestError if the rebuilt keys' digest differs."""
    from ..snark.neutronnova import NeutronNovaZkSNARK

    r = Reader(engine.scalar, engine.curve, data)
    num_steps = r.u64()
    S_step = _read_shape(r)
    S_core = _read_shape(r)
    digest = r.take(32)
    r.done()
    pk, vk = NeutronNovaZkSNARK.setup_from_shapes(engine, S_step, S_core, num_steps,
                                                  device)
    if pk.vk_digest != digest:
        raise DigestError("reloaded NeutronNova key digest mismatch")
    return pk, vk


def neutronnova_prep_to_bytes(prep, engine) -> bytes:
    """NeutronNovaPrep: one precommitted state per step, then the core's."""
    w = Writer(engine.scalar, engine.curve)
    w.u64(len(prep.ps_step))
    for ps in prep.ps_step:
        _write_precommitted_state(w, ps)
    _write_precommitted_state(w, prep.ps_core)
    return w.bytes_out()


def neutronnova_prep_from_bytes(data: bytes, engine, step_circuits, core_circuit):
    from ..snark.neutronnova import NeutronNovaPrep

    r = Reader(engine.scalar, engine.curve, data)
    if r.u64() != len(step_circuits):
        raise SpartanError("prep step count mismatch")
    ps_step = [_read_precommitted_state(r, engine, c) for c in step_circuits]
    ps_core = _read_precommitted_state(r, engine, core_circuit)
    r.done()
    return NeutronNovaPrep(ps_step=ps_step, ps_core=ps_core)
