"""The port's host protocol code of the ZK wrapper against the JAX
package: relaxed R1CS (multiply_vec, is_sat_relaxed, the random
instance, commit_T, the witness and instance folds), the Nova NIFS, the
relaxed Spartan SNARK with its direct openings, and the verifier
circuit's multi-round shape.  Commitments are host commitments
(commit_host) on both sides, so nothing compiles on XLA:CPU; the port's
comb commit is held against JAX in test_torch_hyrax.py."""

import numpy as np
import pytest

from spartan2_tpu.field.limbs import limbs_to_ints as jax_limbs_to_ints
from spartan2_tpu.provider.engines import get_engine as jax_get_engine
from spartan2_tpu.r1cs.multiround import SplitMultiRoundR1CSShape as JaxMRShape
from spartan2_tpu.r1cs.relaxed import NovaNIFS as JaxNIFS
from spartan2_tpu.r1cs.relaxed import R1CSInstance as JaxInstance
from spartan2_tpu.r1cs.relaxed import R1CSShape as JaxShape
from spartan2_tpu.r1cs.relaxed import R1CSWitnessHost as JaxWitness
from spartan2_tpu.r1cs.shape import SplitR1CSShape as JaxSplitShape
from spartan2_tpu.snark.spartan_relaxed import RelaxedR1CSSpartanProof as JaxRelaxed
from spartan2_tpu.snark.zk_circuits import SpartanVerifierCircuit as JaxVC
from spartan2_tpu.utils import serde as jax_serde
from spartan2_tpu_torch.errors import SpartanError
from spartan2_tpu_torch.provider.engines import get_engine
from spartan2_tpu_torch.r1cs.multiround import SplitMultiRoundR1CSShape
from spartan2_tpu_torch.r1cs.relaxed import (NovaNIFS, R1CSInstance, R1CSShape,
                                             R1CSWitnessHost)
from spartan2_tpu_torch.r1cs.shape import SplitR1CSShape
from spartan2_tpu_torch.snark.spartan_relaxed import RelaxedR1CSSpartanProof
from spartan2_tpu_torch.snark.zk_circuits import SpartanVerifierCircuit
from spartan2_tpu_torch.utils import serde
from tests.torch_golden.make_golden import jax_cubic_circuit
from tests.torch_helpers import CubicCircuit, det, rand_ints

WIDTH = 4
CUBIC_W = [2, 4, 8, 15]  # x, x^2, x^3, y of the cubic circuit


def _mats(M):
    return (list(M.data), list(M.indices), list(M.indptr), M.cols)


def _snark_bytes(mod, proof, engine):
    w = mod.Writer(engine.scalar, engine.curve)
    mod._write_relaxed_snark(w, proof)
    return w.bytes_out()


@pytest.fixture(scope="module")
def sides():
    """(engine, shape, ck) of the port and of JAX, with host commits."""
    eng, jeng = get_engine("P256HyraxEngine"), jax_get_engine("P256HyraxEngine")
    S = SplitR1CSShape.from_circuit(CubicCircuit(), eng.scalar, WIDTH)
    JS = JaxSplitShape.from_circuit(jax_cubic_circuit(), jeng.scalar, WIDTH)
    shape = R1CSShape(eng.scalar, S.num_cons, S.num_vars, 1, S.A, S.B, S.C)
    jshape = JaxShape(jeng.scalar, JS.num_cons, JS.num_vars, 1, JS.A, JS.B, JS.C)
    ck, _ = eng.pcs.setup(b"ck", S.num_vars, WIDTH, "cpu")
    jck, _ = jeng.pcs.setup(b"ck", JS.num_vars, WIDTH)
    eng.pcs.commit = eng.pcs.commit_host
    F = jeng.scalar
    jeng.pcs.commit = lambda ck_, vm, r, is_small=False: jeng.pcs.commit_host(
        ck_, jax_limbs_to_ints(np.asarray(vm), F, mont=True), r)
    yield (eng, shape, ck), (jeng, jshape, jck)
    del eng.pcs.commit, jeng.pcs.commit


def _regular(side, mod_instance, mod_witness):
    eng, shape, ck = side
    r_W = eng.pcs.blind(ck, shape.num_vars, rng=det(3))
    return (mod_instance(eng.pcs.commit_host(ck, CUBIC_W, r_W), [15]),
            mod_witness(CUBIC_W, r_W))


@pytest.fixture(scope="module")
def folded(sides):
    """Random instance, NIFS prove and verify on both sides."""
    out = []
    for (eng, shape, ck), inst, wit, nifs_cls in (
            (sides[0], R1CSInstance, R1CSWitnessHost, NovaNIFS),
            (sides[1], JaxInstance, JaxWitness, JaxNIFS)):
        U2, W2 = _regular((eng, shape, ck), inst, wit)
        U1, W1 = shape.sample_random_instance_witness(eng.pcs, ck, rng=det(4))
        t = eng.transcript(b"nifs")
        nifs, W, u, X = nifs_cls.prove(eng.pcs, ck, shape, U1, W1, U2, W2, t,
                                       rng=det(5))
        out.append(dict(eng=eng, shape=shape, ck=ck, U1=U1, W1=W1, U2=U2, nifs=nifs,
                        W=W, u=u, X=X, t=t))
    return out


def test_shape_multiply_vec_and_sat(sides):
    (eng, shape, _), (_, jshape, _) = sides
    assert [_mats(M) for M in (shape.A, shape.B, shape.C)] == [
        _mats(M) for M in (jshape.A, jshape.B, jshape.C)]
    z = rand_ints(eng.scalar.modulus, shape.num_vars + 2, 1)
    assert shape.multiply_vec(z) == jshape.multiply_vec(z)


def test_random_instance_and_nifs_match_jax(folded):
    ours, ref = folded
    for a, b in ((ours["U1"].comm_W, ref["U1"].comm_W),
                 (ours["U1"].comm_E, ref["U1"].comm_E),
                 (ours["nifs"].comm_T, ref["nifs"].comm_T)):
        assert a.comm == b.comm
    assert (ours["U1"].u, ours["U1"].X) == (ref["U1"].u, ref["U1"].X)
    assert (ours["W1"].W, ours["W1"].E) == (ref["W1"].W, ref["W1"].E)
    assert (ours["W"].W, ours["W"].E) == (ref["W"].W, ref["W"].E)
    assert ours["W"].r_W.blind == ref["W"].r_W.blind
    assert ours["W"].r_E.blind == ref["W"].r_E.blind
    assert (ours["u"], ours["X"]) == (ref["u"], ref["X"])
    assert ours["t"].state == ref["t"].state
    # the folded witness satisfies the folded relaxed instance
    eng, shape = ours["eng"], ours["shape"]
    t = eng.transcript(b"nifs")
    U = ours["nifs"].verify(eng.pcs, eng.scalar, t, ours["U1"], ours["U2"], "cpu")
    assert (U.u, U.X) == (ours["u"], ours["X"]) and t.state == ours["t"].state
    shape.is_sat_relaxed(U, ours["W"])
    jt = ref["eng"].transcript(b"nifs")
    JU = ref["nifs"].verify(ref["eng"].pcs, ref["eng"].scalar, jt, ref["U1"], ref["U2"])
    assert JU.comm_W.comm == U.comm_W.comm and JU.comm_E.comm == U.comm_E.comm
    bad = ours["W"].E[:]
    bad[0] = (bad[0] + 1) % eng.scalar.modulus
    with pytest.raises(SpartanError):
        shape.is_sat_relaxed(U, type(ours["W"])(ours["W"].W, ours["W"].r_W, bad,
                                                ours["W"].r_E))


def test_relaxed_snark_matches_jax(folded):
    ours, ref = folded
    proofs = []
    for side, cls in ((ours, RelaxedR1CSSpartanProof), (ref, JaxRelaxed)):
        t = side["eng"].transcript(b"relaxed")
        proofs.append(cls.prove(side["eng"].pcs, side["shape"], side["ck"], side["u"],
                                side["X"], side["W"], t))
    port_bytes = _snark_bytes(serde, proofs[0], ours["eng"])
    assert port_bytes == _snark_bytes(jax_serde, proofs[1], ref["eng"])

    eng = ours["eng"]
    U = ours["nifs"].verify(eng.pcs, eng.scalar, eng.transcript(b"nifs"), ours["U1"],
                            ours["U2"], "cpu")
    proofs[0].verify(eng.pcs, ours["shape"], ours["ck"], U, eng.transcript(b"relaxed"))
    # JAX's verifier accepts the port's proof, read back from its bytes
    jeng = ref["eng"]
    r = jax_serde.Reader(jeng.scalar, jeng.curve, port_bytes)
    jproof = jax_serde._read_relaxed_snark(r)
    JU = ref["nifs"].verify(jeng.pcs, jeng.scalar, jeng.transcript(b"nifs"), ref["U1"],
                            ref["U2"])
    jproof.verify(jeng.pcs, ref["shape"], ref["ck"], JU, jeng.transcript(b"relaxed"))
    proofs[0].v_W[0] = (proofs[0].v_W[0] + 1) % eng.scalar.modulus
    with pytest.raises(SpartanError):
        proofs[0].verify(eng.pcs, ours["shape"], ours["ck"], U,
                         eng.transcript(b"relaxed"))


@pytest.mark.parametrize("dims", [(2, 3, 4), (20, 20, 16)])
def test_verifier_circuit_shape_matches_jax(dims):
    """The SHA-256 1 KiB dims (20, 20, 16): 43 rounds, 688 variables in
    rows of 16, 256 constraints, 44 public inputs."""
    eng, jeng = get_engine("P256HyraxEngine"), jax_get_engine("P256HyraxEngine")
    s = SplitMultiRoundR1CSShape.from_circuit(SpartanVerifierCircuit(eng.scalar, *dims),
                                              eng.scalar)
    js = JaxMRShape.from_circuit(JaxVC(jeng.scalar, *dims), jeng.scalar)
    for name in ("num_vars_per_round", "num_challenges_per_round", "num_public",
                 "num_cons", "num_rounds", "total_vars"):
        assert getattr(s, name) == getattr(js, name)
    assert [_mats(M) for M in (s.A, s.B, s.C)] == [_mats(M) for M in (js.A, js.B, js.C)]
    if dims[0] == 20:
        reg = s.to_regular_shape()
        assert (s.num_rounds, reg.num_vars, reg.num_cons, reg.num_io) == (43, 688, 256,
                                                                         44)
