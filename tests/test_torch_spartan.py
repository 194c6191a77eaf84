"""The port's SpartanSNARK as a whole (plain versions, CPU) against the
JAX package, on the cubic circuit with P256HyraxEngine, width 4 and
bench.py's deterministic blinds.

A JAX prove compiles its device programs on XLA:CPU for tens of minutes,
so its keys, prep state and proof were recorded once by
tests/torch_golden/make_golden.py; the slow test repeats that run live.
"""

import pytest

from spartan2_tpu.provider.engines import get_engine as jax_get_engine
from spartan2_tpu.snark.spartan import SpartanSNARK as JaxSpartan
from spartan2_tpu.snark.spartan import SpartanVerifierKey as JaxVerifierKey
from spartan2_tpu.utils import serde as jax_serde
from spartan2_tpu_torch.errors import SpartanError
from spartan2_tpu_torch.provider.engines import get_engine
from spartan2_tpu_torch.snark.spartan import SpartanSNARK
from spartan2_tpu_torch.utils.serde import (
    spartan_keys_from_bytes,
    spartan_keys_to_bytes,
    spartan_prep_from_bytes,
    spartan_prep_to_bytes,
    spartan_proof_from_bytes,
    spartan_proof_to_bytes,
)
from tests.torch_golden.make_golden import jax_prove, read_golden
from tests.torch_helpers import CubicCircuit, det


@pytest.fixture(scope="module")
def golden():
    return read_golden()


@pytest.fixture(scope="module")
def port_run(golden):
    """Keys and prep loaded from the JAX bytes, then one port prove."""
    engine = get_engine("P256HyraxEngine")
    circuit = CubicCircuit()
    pk, vk = spartan_keys_from_bytes(golden["keys"], engine, device="cpu")
    prep = spartan_prep_from_bytes(golden["prep"], engine, pk, circuit)
    proof, _ = SpartanSNARK.prove(pk, circuit, prep, rng=det(golden["prove_seed"]))
    return engine, pk, vk, proof


def jax_host_verifier_key(key_bytes: bytes):
    """A JAX verifier key whose shape stays off the device, so that
    evaluate_at takes its host walk and nothing compiles."""
    engine = jax_get_engine("P256HyraxEngine")
    r = jax_serde.Reader(engine.scalar, engine.curve, key_bytes)
    S = jax_serde._read_shape(r)
    digest = r.take(32)
    r.done()
    ck, vk_ee = engine.pcs.setup(b"ck", S.num_vars, S.width)
    ck_s, _ = engine.pcs.setup(b"ck_s", 1, 1)
    return engine, JaxVerifierKey(engine, S, vk_ee, ck_s, digest)


def test_port_setup_and_prep_write_the_jax_bytes(golden):
    engine = get_engine("P256HyraxEngine")
    circuit = CubicCircuit()
    pk, _ = SpartanSNARK.setup(engine, circuit, width=golden["width"], device="cpu")
    assert spartan_keys_to_bytes(pk) == golden["keys"]
    prep = SpartanSNARK.prep_prove(pk, circuit, rng=det(golden["prep_seed"]))
    assert spartan_prep_to_bytes(prep, engine) == golden["prep"]


def test_proof_bytes_equal_jax(golden, port_run):
    engine, _, _, proof = port_run
    assert spartan_proof_to_bytes(proof, engine) == golden["proof"]


def test_jax_verifier_accepts_port_proof(port_run):
    engine, _, _, proof = port_run
    jengine, jvk = jax_host_verifier_key(spartan_keys_to_bytes(port_run[1]))
    assert jvk.S._device is None
    jproof = jax_serde.spartan_proof_from_bytes(
        spartan_proof_to_bytes(proof, engine), jengine)
    assert JaxSpartan.verify(jproof, jvk) == [15]


def test_port_verifier_accepts_and_rejects_tampered(golden, port_run):
    engine, _, vk, proof = port_run
    assert SpartanSNARK.verify(proof, vk) == [15]
    # the JAX proof bytes load and verify in the port too
    assert SpartanSNARK.verify(spartan_proof_from_bytes(golden["proof"], engine),
                               vk) == [15]
    bad = spartan_proof_from_bytes(spartan_proof_to_bytes(proof, engine), engine)
    bad.U.public_values = [16]
    with pytest.raises(SpartanError):
        SpartanSNARK.verify(bad, vk)


@pytest.mark.slow
def test_live_jax_prove_matches_golden_and_port(golden, port_run):
    """Repeats the recording: JAX setup, prep_prove and prove now (tens of
    minutes of XLA:CPU compiles) must give the committed bytes."""
    keys, prep, proof = jax_prove()
    assert (keys, prep, proof) == (golden["keys"], golden["prep"], golden["proof"])
    engine = port_run[0]
    assert spartan_proof_to_bytes(port_run[3], engine) == proof


@pytest.mark.parametrize("name", ["vesta", "bn254"])
def test_other_engines_prove_to_the_jax_bytes(name):
    """SpartanSNARK on the cubic circuit with VestaHyraxEngine and
    Bn254Engine (make_golden --vesta / --bn254): the port's setup and prep
    write the recorded JAX keys and prep, its prove from the same seeds
    writes the recorded JAX proof, and its verifier accepts it."""
    from tests.torch_golden.make_golden import ENGINE_OUT

    engine_name, path = ENGINE_OUT[name]
    gold = read_golden(path)
    engine, circuit = get_engine(engine_name), CubicCircuit()
    pk, vk = SpartanSNARK.setup(engine, circuit, width=gold["width"], device="cpu")
    assert spartan_keys_to_bytes(pk) == gold["keys"]
    prep = SpartanSNARK.prep_prove(pk, circuit, rng=det(gold["prep_seed"]))
    assert spartan_prep_to_bytes(prep, engine) == gold["prep"]
    proof, _ = SpartanSNARK.prove(pk, circuit, prep, rng=det(gold["prove_seed"]))
    assert spartan_proof_to_bytes(proof, engine) == gold["proof"]
    assert SpartanSNARK.verify(proof, vk) == [15]
