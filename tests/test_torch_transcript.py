"""The port's host Keccak-256 transcript against the reference KAT and the
JAX package's Transcript."""

import numpy as np

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.transcript.transcript import Transcript as JaxTranscript
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.transcript.keccak import keccak256
from spartan2_tpu_torch.transcript.transcript import Transcript


def test_keccak_kat():
    # reference src/provider/keccak.rs:155-163
    assert keccak256((0xFFFFFFFF).to_bytes(4, "little")).hex() == (
        "29045a592007d0c246ef02c2223570da9522d0cf0f73282c79a1bc8f0bb2c238")
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


def test_transcript_kat_pallas():
    """Reference src/provider/keccak.rs:146-152 known-answer vectors."""
    F = get_field("pallas_scalar")
    t = Transcript(F, b"test")
    t.absorb_scalar(b"s1", 2)
    t.absorb_scalar(b"s2", 5)
    c1 = t.squeeze(b"c1")
    assert F.to_bytes(c1).hex() == (
        "b67339da79ce5f6dc72ad23c8c3b4179f49655cadf92d47e79c3e7788f00f125")
    t.absorb_scalar(b"s3", 128)
    assert F.to_bytes(t.squeeze(b"c2")).hex() == (
        "b7f033d47b3519dd6efe320b995eaad1dc11712cb9b655d2e7006ed5f86bd321")


def test_transcript_sequence_matches_jax():
    F, JF = get_field("p256_scalar"), jax_get_field("p256_scalar")
    rng = np.random.default_rng(0)
    ours, ref = Transcript(F, b"SpartanSNARK"), JaxTranscript(JF, b"SpartanSNARK")
    for step in range(40):
        blob = rng.bytes(int(rng.integers(0, 300)))
        scal = [int.from_bytes(rng.bytes(40), "little") % F.modulus
                for _ in range(int(rng.integers(1, 5)))]
        for t in (ours, ref):
            t.absorb_bytes(b"blob", blob)
            t.absorb_scalars(b"vals", scal)
            if step % 7 == 0:
                t.dom_sep(b"sep")
        assert ours.squeeze(b"c") == ref.squeeze(b"c")
        assert ours.state == ref.state and ours.round == ref.round
