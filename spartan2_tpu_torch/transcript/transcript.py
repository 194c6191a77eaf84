"""Fiat-Shamir transcript, bit-exact with the reference Keccak256Transcript.

Reference semantics (src/provider/keccak.rs:26-105):
  * 64-byte running ``state``, u16 ``round`` counter, byte buffer.
  * new(label): state = CUS(PERSONA_TAG || label), round = 0, buffer empty,
    where CUS(input) = Keccak256(input || 0x00) || Keccak256(input || 0x01).
  * absorb(label, obj): buffer += label || obj.to_transcript_bytes()
  * dom_sep(bytes): buffer += DOM_SEP_TAG || bytes
  * squeeze(label): out = CUS(buffer || DOM_SEP_TAG || round_le2 || state ||
    label); round += 1; state = out; buffer cleared;
    challenge = Scalar::from_uniform(out).

Known-answer anchor: tests/test_transcript.py reproduces the Pallas vectors
at src/provider/keccak.rs:148-152.
"""

from __future__ import annotations

from ..field.constants import FieldSpec
from .keccak import keccak256

PERSONA_TAG = b"NoTR"
DOM_SEP_TAG = b"NoDS"


def _compute_updated_state(data: bytes) -> bytes:
    lo = keccak256(data + b"\x00")
    hi = keccak256(data + b"\x01")
    return lo + hi


class Transcript:
    """Host-side Keccak256 transcript over a given scalar field."""

    __slots__ = ("field", "round", "state", "buf")

    def __init__(self, field: FieldSpec, label: bytes):
        self.field = field
        self.round = 0
        self.state = _compute_updated_state(PERSONA_TAG + label)
        self.buf = bytearray()

    # -- absorb ----------------------------------------------------------
    def absorb_bytes(self, label: bytes, data: bytes) -> None:
        self.buf += label
        self.buf += data

    def absorb_scalar(self, label: bytes, a: int) -> None:
        """Scalars absorb as big-endian 32 bytes (traits.rs:282-286)."""
        self.absorb_bytes(label, self.field.to_transcript_bytes(a))

    def absorb_scalars(self, label: bytes, vals) -> None:
        """&[Scalar] absorbs as the concatenation (transcript.rs:35-42)."""
        data = b"".join(self.field.to_transcript_bytes(a) for a in vals)
        self.absorb_bytes(label, data)

    def dom_sep(self, data: bytes) -> None:
        self.buf += DOM_SEP_TAG
        self.buf += data

    # -- squeeze ---------------------------------------------------------
    def squeeze_bytes(self, label: bytes) -> bytes:
        inp = (
            bytes(self.buf)
            + DOM_SEP_TAG
            + self.round.to_bytes(2, "little")
            + self.state
            + label
        )
        out = _compute_updated_state(inp)
        if self.round >= 0xFFFF:
            raise OverflowError("transcript round counter overflow")
        self.round += 1
        self.state = out
        self.buf = bytearray()
        return out

    def squeeze(self, label: bytes) -> int:
        return self.field.from_uniform(self.squeeze_bytes(label))
