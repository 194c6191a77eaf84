"""The port's NeutronNovaZkSNARK as a whole (plain versions, CPU) against
the JAX package, P256HyraxEngine at width 4 with bench.py's deterministic
blinds, in two configurations with tests/test_neutronnova.py's core:
3 SquareStepCircuit steps (a non-empty rest segment: the batched rest
commit) and 7 PrecommittedStepCircuit steps (padded to 8; the truncated
fold and the small-value round 0).

A JAX NeutronNova prove compiles its programs on XLA:CPU for tens of
minutes, so its keys, prep state and proof were recorded once by
tests/torch_golden/make_golden.py --nn; the slow test repeats that run
live.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spartan2_tpu.provider.engines import get_engine as jax_get_engine
from spartan2_tpu.r1cs.multiround import SplitMultiRoundR1CSShape as JaxMRShape
from spartan2_tpu.snark.neutronnova import NeutronNovaVerifierKey as JaxNNVerifierKey
from spartan2_tpu.snark.neutronnova import NeutronNovaZkSNARK as JaxNN
from spartan2_tpu.snark.zk_circuits import NeutronNovaVerifierCircuit as JaxVC
from spartan2_tpu.utils import serde as jax_serde
from spartan2_tpu_torch.errors import SpartanError
from spartan2_tpu_torch.provider.engines import get_engine
from spartan2_tpu_torch.snark.neutronnova import NeutronNovaZkSNARK
from spartan2_tpu_torch.sumcheck.nifs import NIFS
from spartan2_tpu_torch.utils.serde import (
    neutronnova_keys_from_bytes,
    neutronnova_keys_to_bytes,
    neutronnova_prep_from_bytes,
    neutronnova_prep_to_bytes,
    neutronnova_proof_from_bytes,
    neutronnova_proof_to_bytes,
)
from tests.torch_golden.make_golden import NN_STEPS, nn_path, read_golden
from tests.torch_helpers import CoreCircuit, PrecommittedStepCircuit, SquareStepCircuit, det

CONFIGS = list(NN_STEPS)
ROOT = Path(__file__).resolve().parents[1]


def circuits(name):
    step = {"square": SquareStepCircuit, "precommitted": PrecommittedStepCircuit}[name]
    return [step(x) for x in NN_STEPS[name]], CoreCircuit()


@pytest.fixture(scope="module", params=CONFIGS)
def run(request):
    """Keys and prep loaded from the JAX bytes, then one port prove."""
    name = request.param
    golden = read_golden(nn_path(name))
    engine = get_engine("P256HyraxEngine")
    steps, core = circuits(name)
    pk, vk = neutronnova_keys_from_bytes(golden["keys"], engine, device="cpu")
    prep = neutronnova_prep_from_bytes(golden["prep"], engine, steps, core)
    proof, _ = NeutronNovaZkSNARK.prove(pk, steps, core, prep,
                                        rng=det(golden["prove_seed"]))
    return dict(name=name, golden=golden, engine=engine, steps=steps, core=core,
                pk=pk, vk=vk, proof=proof, prep=prep)


def public_io(name):
    return [[x * x + 3] for x in NN_STEPS[name]], [42]


def jax_host_nn_verifier_key(key_bytes: bytes):
    """A JAX NeutronNova verifier key built as setup_from_shapes builds it,
    but with the shapes left off the device, so that evaluate_at takes its
    host walk and nothing compiles."""
    engine = jax_get_engine("P256HyraxEngine")
    r = jax_serde.Reader(engine.scalar, engine.curve, key_bytes)
    num_steps = r.u64()
    S_step = jax_serde._read_shape(r)
    S_core = jax_serde._read_shape(r)
    digest = r.take(32)
    r.done()
    _, vk_ee = engine.pcs.setup(b"ck", max(S_step.num_vars, S_core.num_vars),
                                S_step.width)
    n_padded = 1 << max(num_steps - 1, 0).bit_length()
    vc = JaxVC(engine.scalar, n_padded.bit_length() - 1,
               S_step.num_cons.bit_length() - 1, S_step.num_vars.bit_length(),
               JaxNN.VC_COMMITMENT_WIDTH)
    vc_shape = JaxMRShape.from_circuit(vc, engine.scalar)
    vc_ck, vc_vk = engine.pcs.setup(b"ck", vc_shape.total_vars,
                                    vc_shape.commitment_width)
    return engine, JaxNNVerifierKey(engine, S_step, S_core, vk_ee, vc_shape,
                                    vc_shape.to_regular_shape(), vc_ck, vc_vk, digest)


def test_port_setup_and_prep_write_the_jax_bytes(run):
    """Port setup gives JAX's key bytes; port prep (on those keys) gives
    JAX's prep bytes."""
    engine, golden = run["engine"], run["golden"]
    steps, core = circuits(run["name"])
    pk, _ = NeutronNovaZkSNARK.setup(engine, steps[0], core, len(steps),
                                     width=golden["width"], device="cpu")
    assert neutronnova_keys_to_bytes(pk, len(steps)) == golden["keys"]
    prep = NeutronNovaZkSNARK.prep_prove(run["pk"], steps, core,
                                         rng=det(golden["prep_seed"]))
    assert neutronnova_prep_to_bytes(prep, engine) == golden["prep"]


def test_nn_proof_bytes_equal_jax(run):
    assert neutronnova_proof_to_bytes(run["proof"], run["engine"]) == run["golden"]["proof"]
    S = run["pk"].S_step
    if run["name"] == "precommitted":
        # the truncated fold and the small round 0 were on trial
        assert S.num_rest_unpadded == 0 < S.num_rest
        assert run["prep"].cache["small"][1] is True
    else:
        assert S.num_rest_unpadded > 0


def test_prep_cache_unchanged_and_second_proof_identical(run):
    """The NIFS rounds only read the prep cache's grid (each fold writes a
    buffer of its own): a second prove with the first one's blinds leaves
    the cache bit-identical and gives the same bytes."""
    cache = run["prep"].cache
    assert "ABC" in cache  # filled by the fixture's prove
    before = {"ABC": cache["ABC"].clone(), "small": cache["small"][0].clone()}
    proof, prep = NeutronNovaZkSNARK.prove(run["pk"], run["steps"], run["core"],
                                           run["prep"], rng=det(run["golden"]["prove_seed"]))
    assert prep.cache is cache
    assert torch.equal(cache["ABC"], before["ABC"])
    assert torch.equal(cache["small"][0], before["small"])
    engine = run["engine"]
    assert neutronnova_proof_to_bytes(proof, engine) == neutronnova_proof_to_bytes(
        run["proof"], engine) == run["golden"]["proof"]


def test_jax_verifier_accepts_port_nn_proof(run, monkeypatch):
    jengine, jvk = jax_host_nn_verifier_key(run["golden"]["keys"])
    assert jvk.S_step._device is None and jvk.S_core._device is None
    # the relaxed SNARK's direct openings reach _msm_gens with 32 scalars
    # (the verifier circuit's row width), which would build comb tables
    # on XLA:CPU; its host reference computes the same point
    monkeypatch.setattr(jengine.pcs, "_msm_gens",
                        lambda ck, sc: jengine.curve.msm(list(sc), ck.ck[: len(sc)]))
    jproof = jax_serde.neutronnova_proof_from_bytes(
        neutronnova_proof_to_bytes(run["proof"], run["engine"]), jengine)
    assert JaxNN.verify(jproof, jvk, len(run["steps"])) == public_io(run["name"])


def test_port_nn_verifier_accepts_jax_proof_and_rejects_tampered(run):
    engine, vk, n = run["engine"], run["vk"], len(run["steps"])
    jax_proof = neutronnova_proof_from_bytes(run["golden"]["proof"], engine)
    assert NeutronNovaZkSNARK.verify(jax_proof, vk, n) == public_io(run["name"])
    jax_proof.step_instances[1].public_values = [29]
    with pytest.raises(SpartanError):
        NeutronNovaZkSNARK.verify(jax_proof, vk, n)
    with pytest.raises(SpartanError):
        NeutronNovaZkSNARK.verify(run["proof"], vk, n + 1)


def test_nn_serde_round_trip(run):
    engine, golden = run["engine"], run["golden"]
    blob = neutronnova_proof_to_bytes(run["proof"], engine)
    back = neutronnova_proof_from_bytes(blob, engine)
    assert neutronnova_proof_to_bytes(back, engine) == blob
    assert NeutronNovaZkSNARK.verify(back, run["vk"], len(run["steps"])) == public_io(
        run["name"])
    assert neutronnova_keys_to_bytes(run["pk"], len(run["steps"])) == golden["keys"]
    steps, core = circuits(run["name"])
    prep = neutronnova_prep_from_bytes(golden["prep"], engine, steps, core)
    assert neutronnova_prep_to_bytes(prep, engine) == golden["prep"]
    # the CPU run ran the plain versions: no kernel was built
    assert NIFS._lib is None and NIFS.launches == 0


@pytest.mark.slow
@pytest.mark.parametrize("name", CONFIGS)
def test_live_jax_nn_prove_matches_golden(name, tmp_path):
    """Repeats the recording as it was made (make_golden.py's docstring):
    JAX setup, prep_prove and prove now, in a process of their own with
    SPARTAN2_NN_HOST=1, must give the committed bytes."""
    out = tmp_path / "nn.bin"
    code = ("import sys; from tests.torch_golden.make_golden import jax_nn_prove, "
            "write_golden; write_golden(sys.argv[2], *jax_nn_prove(sys.argv[1]))")
    env = dict(os.environ, SPARTAN2_NN_HOST="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code, name, str(out)], cwd=ROOT, env=env,
                   check=True, timeout=4 * 3600)
    assert read_golden(str(out)) == read_golden(nn_path(name))
