"""The port's SpartanZkSNARK as a whole (plain versions, CPU) against the
JAX package, on the cubic circuit with P256HyraxEngine, width 4 and
bench.py's deterministic blinds.

A JAX ZK prove compiles its device programs on XLA:CPU for tens of
minutes, so its keys, prep state and proof were recorded once by
tests/torch_golden/make_golden.py --zk (through JAX's default device
path); the slow test repeats that run live.
"""

import pytest

from spartan2_tpu.provider.engines import get_engine as jax_get_engine
from spartan2_tpu.r1cs.multiround import SplitMultiRoundR1CSShape as JaxMRShape
from spartan2_tpu.snark.spartan_zk import SpartanZkSNARK as JaxZk
from spartan2_tpu.snark.spartan_zk import SpartanZkVerifierKey as JaxZkVerifierKey
from spartan2_tpu.snark.zk_circuits import SpartanVerifierCircuit as JaxVC
from spartan2_tpu.utils import serde as jax_serde
from spartan2_tpu_torch.errors import SpartanError
from spartan2_tpu_torch.provider.engines import get_engine
from spartan2_tpu_torch.snark.spartan_zk import SpartanZkSNARK
from spartan2_tpu_torch.utils.serde import (
    spartan_prep_from_bytes,
    spartan_prep_to_bytes,
    spartan_zk_keys_from_bytes,
    spartan_zk_keys_to_bytes,
    spartan_zk_proof_from_bytes,
    spartan_zk_proof_to_bytes,
)
from tests.torch_golden.make_golden import OUT_ZK, jax_prove, read_golden
from tests.torch_helpers import CubicCircuit, det


@pytest.fixture(scope="module")
def golden():
    return read_golden(OUT_ZK)


@pytest.fixture(scope="module")
def port_run(golden):
    """Keys and prep loaded from the JAX bytes, then one port prove."""
    engine = get_engine("P256HyraxEngine")
    circuit = CubicCircuit()
    pk, vk = spartan_zk_keys_from_bytes(golden["keys"], engine, device="cpu")
    prep = spartan_prep_from_bytes(golden["prep"], engine, pk, circuit)
    proof, _ = SpartanZkSNARK.prove(pk, circuit, prep, rng=det(golden["prove_seed"]))
    return engine, pk, vk, proof


def jax_host_zk_verifier_key(key_bytes: bytes):
    """A JAX SpartanZk verifier key built as setup_from_shape builds it,
    but with the shape left off the device, so that evaluate_at takes its
    host walk and nothing compiles."""
    engine = jax_get_engine("P256HyraxEngine")
    r = jax_serde.Reader(engine.scalar, engine.curve, key_bytes)
    S = jax_serde._read_shape(r)
    digest = r.take(32)
    r.done()
    ck, vk_ee = engine.pcs.setup(b"ck", S.num_vars, S.width)
    vc = JaxVC(engine.scalar, S.num_cons.bit_length() - 1, S.num_vars.bit_length(),
               JaxZk.VC_COMMITMENT_WIDTH)
    vc_shape = JaxMRShape.from_circuit(vc, engine.scalar)
    vc_ck, vc_vk = engine.pcs.setup(b"ck", vc_shape.total_vars,
                                    vc_shape.commitment_width)
    return engine, JaxZkVerifierKey(engine, S, vk_ee, vc_shape,
                                    vc_shape.to_regular_shape(), vc_ck, vc_vk, digest)


def test_port_setup_and_prep_write_the_jax_bytes(golden):
    engine = get_engine("P256HyraxEngine")
    circuit = CubicCircuit()
    pk, _ = SpartanZkSNARK.setup(engine, circuit, width=golden["width"], device="cpu")
    assert spartan_zk_keys_to_bytes(pk) == golden["keys"]
    prep = SpartanZkSNARK.prep_prove(pk, circuit, rng=det(golden["prep_seed"]))
    assert spartan_prep_to_bytes(prep, engine) == golden["prep"]


def test_zk_proof_bytes_equal_jax(golden, port_run):
    engine, _, _, proof = port_run
    assert spartan_zk_proof_to_bytes(proof, engine) == golden["proof"]


def test_jax_verifier_accepts_port_zk_proof(port_run):
    engine, pk, _, proof = port_run
    jengine, jvk = jax_host_zk_verifier_key(spartan_zk_keys_to_bytes(pk))
    assert jvk.S._device is None
    jproof = jax_serde.spartan_zk_proof_from_bytes(
        spartan_zk_proof_to_bytes(proof, engine), jengine)
    assert JaxZk.verify(jproof, jvk) == [15]


def test_port_zk_verifier_accepts_and_rejects_tampered(golden, port_run):
    engine, _, vk, proof = port_run
    assert SpartanZkSNARK.verify(proof, vk) == [15]
    # the JAX proof bytes load and verify in the port too
    assert SpartanZkSNARK.verify(spartan_zk_proof_from_bytes(golden["proof"], engine),
                                 vk) == [15]
    p = engine.scalar.modulus
    blob = spartan_zk_proof_to_bytes(proof, engine)
    bad = spartan_zk_proof_from_bytes(blob, engine)
    bad.U_verifier.challenges_per_round[0][0] = (
        bad.U_verifier.challenges_per_round[0][0] + 1) % p
    with pytest.raises(SpartanError):
        SpartanZkSNARK.verify(bad, vk)
    bad = spartan_zk_proof_from_bytes(blob, engine)
    bad.U.public_values = [16]
    with pytest.raises(SpartanError):
        SpartanZkSNARK.verify(bad, vk)
    bad = spartan_zk_proof_from_bytes(blob, engine)
    bad.relaxed_snark.v_E[0] = (bad.relaxed_snark.v_E[0] + 1) % p
    with pytest.raises(SpartanError):
        SpartanZkSNARK.verify(bad, vk)
    # a verifier instance short of a round is rejected, not an IndexError
    bad = spartan_zk_proof_from_bytes(blob, engine)
    bad.U_verifier.comm_w_per_round.pop()
    with pytest.raises(SpartanError):
        SpartanZkSNARK.verify(bad, vk)


@pytest.mark.slow
def test_live_jax_zk_prove_matches_golden_and_port(golden, port_run):
    """Repeats the recording: JAX setup, prep_prove and prove now (tens of
    minutes of XLA:CPU compiles) must give the committed bytes."""
    keys, prep, proof = jax_prove(zk=True)
    assert (keys, prep, proof) == (golden["keys"], golden["prep"], golden["proof"])
    assert spartan_zk_proof_to_bytes(port_run[3], port_run[0]) == proof
