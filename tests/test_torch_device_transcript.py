"""The port's device transcript (kernel T's plain versions, CPU), its host
Keccak in C and from_uniform_bytes, against the JAX package:
keccak256_dev, DeviceTranscript, the host Transcript and
FieldSpec.from_uniform, byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.field.jnp_ops import FieldOps
from spartan2_tpu.field.limbs import ints_to_limbs_np as jax_limbs
from spartan2_tpu.field.limbs import limbs_to_ints as jax_ints
from spartan2_tpu.transcript.device import DeviceTranscript as JaxDeviceTranscript
from spartan2_tpu.transcript.device import keccak256_dev
from spartan2_tpu.transcript.transcript import Transcript as JaxTranscript
from spartan2_tpu_torch.field import ops
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints
from spartan2_tpu_torch.transcript.device import DeviceTranscript, keccak256_batch
from spartan2_tpu_torch.transcript.keccak import keccak256, keccak256_plain
from spartan2_tpu_torch.transcript.transcript import Transcript
from tests.torch_helpers import mont_vector

F = get_field("p256_scalar")
JF = jax_get_field("p256_scalar")


@pytest.mark.parametrize("L", [0, 135, 136, 137, 300])
def test_device_keccak_matches_jax(L):
    """135, 136, 137: one byte of padding (0x81), a full block, a block
    and one byte; a sum-check round's squeeze hashes 136 + 1 (quad) or
    168 + 1 (cubic) bytes."""
    msgs = np.random.default_rng(L).integers(0, 256, size=(2, L), dtype=np.uint8)
    got = keccak256_batch(torch.from_numpy(msgs)).numpy()
    want = np.asarray(keccak256_dev(jnp.asarray(msgs.T))).T
    assert np.array_equal(got, want)


def test_c_keccak_matches_python():
    for n in (0, 1, 135, 136, 137, 271, 272, 273, 4096):
        data = bytes((7 * i + n) & 0xFF for i in range(n))
        assert keccak256(data) == keccak256_plain(data), n


def test_from_uniform_bytes_matches_jax():
    p = F.modulus
    cases = [bytes(64), b"\xff" * 64, p.to_bytes(32, "little") * 2,
             (p - 1).to_bytes(32, "little") + bytes(32)]
    cases += [np.random.default_rng(i).bytes(64) for i in range(16)]
    got = ops.from_uniform_bytes(torch.tensor([list(c) for c in cases], dtype=torch.uint8),
                                 F)
    assert limbs_to_ints(got, F, mont=True) == [JF.from_uniform(c) for c in cases]


def test_device_transcript_matches_jax_and_host():
    """A sequence of absorbs and three squeezes on the port's
    DeviceTranscript, JAX's DeviceTranscript and JAX's host Transcript;
    then the hand-off to a host transcript and back."""
    vals, a = mont_vector(F, 5, 3)
    aj = jnp.asarray(jax_limbs(vals, JF))
    ours = DeviceTranscript(F, b"SpartanSNARK", device="cpu")
    ref = JaxDeviceTranscript(FieldOps(JF), b"SpartanSNARK")
    host = JaxTranscript(JF, b"SpartanSNARK")

    def check_state():
        assert ours.state.numpy().tobytes() == np.asarray(ref.state).tobytes() == host.state
        assert ours.round == ref.round == host.round

    for t in (ours, ref, host):
        t.absorb_bytes(b"vk", bytes(range(32)))
    ours.absorb_scalars_mont(b"vals", a)
    ref.absorb_scalars_mont(b"vals", aj)
    host.absorb_scalars(b"vals", vals)
    ours.absorb_scalar_mont(b"one", a[2])
    ref.absorb_scalar_mont(b"one", aj[:, 2])
    host.absorb_scalar(b"one", vals[2])
    for i in range(3):
        if i == 1:
            for t in (ours, ref, host):
                t.dom_sep(b"phase2")
        c = limbs_to_ints(ours.squeeze_mont(b"c"), F, mont=True)[0]
        assert c == jax_ints(ref.squeeze_mont(b"c"), JF)[0] == host.squeeze(b"c")
        check_state()

    t = Transcript(F, b"other")
    ours.to_host(t)
    assert (t.state, t.round) == (host.state, host.round)
    t.absorb_scalars(b"x", vals[:2])
    host.absorb_scalars(b"x", vals[:2])
    assert t.squeeze(b"r") == host.squeeze(b"r")
    back = DeviceTranscript.from_host(t, "cpu")
    back.absorb_bytes(b"blob", torch.arange(40, dtype=torch.uint8))
    host.absorb_bytes(b"blob", bytes(range(40)))
    assert back.squeeze_bytes(b"s").numpy().tobytes() == host.squeeze_bytes(b"s")
    assert back.round == host.round
