"""Kernel T (csrc/transcript.cu, csrc/keccak.cuh): Keccak-256 and the
Fiat-Shamir transcript on the card, with their plain versions.

The port of the JAX package's transcript/device.py (keccak256_dev :133,
compute_updated_state_dev :173, DeviceTranscript :184-257).  The state is
a (64,) uint8 tensor on the device and the round counter a host int;
absorbs collect uint8 tensors, and a squeeze hashes them into the new
state on the device.  Byte semantics are the host Transcript's
(transcript.py): labels and tags as given, scalars as canonical 32-byte
big-endian, challenges through from_uniform.  Host bytes reach the
device by asynchronous copies, so nothing here synchronizes the host.

On CUDA tensors each wrapper launches its kernel (or raises); on CPU
tensors it runs the plain version: the host Keccak (C) on the same bytes.
"""

from __future__ import annotations

import torch

from ..field import ops
from ..field.constants import FieldSpec
from ..utils.cuda import SZ, CudaKernel, I, P, check_cuda, field_words
from .keccak import keccak256
from .transcript import DOM_SEP_TAG, PERSONA_TAG, Transcript, _compute_updated_state

TRANSCRIPT = CudaKernel("transcript", {
    "sp2_keccak256": [I, I, P, P],
    "sp2_squeeze": [I, P, I, P, P, I, P, P, P],
    "sp2_fe_bytes": [SZ, P, P, I, P],
})

_U8 = torch.uint8


def host_bytes(data: bytes, device) -> torch.Tensor:
    """Bytes -> (len,) uint8 tensor on ``device``, copied without a host
    synchronization."""
    t = torch.tensor(list(data), dtype=_U8)
    return t.to(device, non_blocking=True)


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


def keccak256_batch_plain(msgs: torch.Tensor) -> torch.Tensor:
    """Plain version of ``keccak256_batch``."""
    return torch.tensor([list(keccak256(_bytes_of(m))) for m in msgs], dtype=_U8)


def keccak256_batch(msgs: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of each row of a (n, L) uint8 tensor -> (n, 32) uint8
    (keccak256_dev over a batch of equal-length messages)."""
    if msgs.dim() != 2:
        raise ValueError("keccak256_batch: messages are (n, L) uint8")
    if msgs.device.type == "cpu":
        return keccak256_batch_plain(msgs)
    check_cuda(msgs, dtype=_U8)
    out = torch.empty(msgs.shape[0], 32, dtype=_U8, device=msgs.device)
    TRANSCRIPT.call("sp2_keccak256", msgs.shape[0], msgs.shape[1], msgs.data_ptr(),
                    out.data_ptr())
    return out


def squeeze_plain(buf: torch.Tensor, round_: int, state: torch.Tensor, label: bytes,
                  spec: FieldSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``squeeze``."""
    msg = (_bytes_of(buf) + DOM_SEP_TAG + round_.to_bytes(2, "little") + _bytes_of(state)
           + label)
    new = torch.tensor(list(_compute_updated_state(msg)), dtype=_U8)
    return new, ops.from_uniform_bytes(new, spec)


def squeeze(buf: torch.Tensor, round_: int, state: torch.Tensor, label: bytes,
            spec: FieldSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """CUS(buf || DOM_SEP_TAG || round (u16 LE) || state || label) ->
    (the new (64,) state, its challenge from_uniform as (8,) Montgomery)."""
    if not 0 <= round_ < 0xFFFF:
        raise OverflowError("transcript round counter overflow")
    if state.device.type == "cpu":
        return squeeze_plain(buf, round_, state, label, spec)
    check_cuda(state, dtype=_U8)
    if buf.numel():
        check_cuda(buf, dtype=_U8)
    new = torch.empty(64, dtype=_U8, device=state.device)
    chal = torch.empty(8, dtype=torch.int32, device=state.device)
    TRANSCRIPT.call("sp2_squeeze", buf.numel(), buf.data_ptr() if buf.numel() else None,
                    round_, state.data_ptr(), label, len(label), new.data_ptr(),
                    chal.data_ptr(), field_words(spec))
    return new, chal


def fe_bytes(a: torch.Tensor, spec: FieldSpec, big_endian: bool) -> torch.Tensor:
    """(n, 8) Montgomery -> (n, 32) uint8 canonical encodings
    (field/ops.py ``to_bytes`` is the plain version)."""
    if a.device.type == "cpu":
        return ops.to_bytes(a, spec, big_endian)
    check_cuda(a)
    out = torch.empty(a.shape[0], 32, dtype=_U8, device=a.device)
    TRANSCRIPT.call("sp2_fe_bytes", a.shape[0], a.data_ptr(), out.data_ptr(),
                    int(big_endian), field_words(spec))
    return out


class DeviceTranscript:
    """The host Transcript's twin on the device: same byte semantics."""

    def __init__(self, spec: FieldSpec, label: bytes | None = None, *,
                 state: torch.Tensor | None = None, round: int = 0, device="cuda"):
        self.spec = spec
        self.round = round
        self.parts: list[torch.Tensor] = []
        if state is None:
            state = host_bytes(_compute_updated_state(PERSONA_TAG + label), device)
        self.state = state
        self.device = state.device

    @classmethod
    def from_host(cls, t: Transcript, device) -> "DeviceTranscript":
        """Continue a host transcript on the device: its state and round
        (its buffer must be empty, as after a squeeze)."""
        if t.buf:
            raise ValueError("hand-off needs an empty transcript buffer")
        return cls(t.field, state=host_bytes(t.state, device), round=t.round)

    def to_host(self, t: Transcript) -> None:
        """Hand the state and round back to a host transcript (one pull)."""
        if self.parts:
            raise ValueError("hand-off needs an empty transcript buffer")
        t.state, t.round, t.buf = _bytes_of(self.state), self.round, bytearray()

    # -- absorb ----------------------------------------------------------
    def _const(self, data: bytes) -> None:
        if data:
            self.parts.append(host_bytes(data, self.device))

    def absorb_bytes(self, label: bytes, data) -> None:
        self._const(label)
        if isinstance(data, (bytes, bytearray)):
            self._const(bytes(data))
        else:
            self.parts.append(data.reshape(-1))

    def absorb_scalar_mont(self, label: bytes, a: torch.Tensor) -> None:
        """Absorb a Montgomery (8,) element as 32 big-endian bytes."""
        self.absorb_scalars_mont(label, a.reshape(1, 8))

    def absorb_scalars_mont(self, label: bytes, a: torch.Tensor) -> None:
        """Absorb (n, 8) Montgomery elements under one label, each as 32
        big-endian canonical bytes, concatenated."""
        self.absorb_bytes(label, fe_bytes(a, self.spec, big_endian=True))

    def dom_sep(self, data: bytes) -> None:
        self._const(DOM_SEP_TAG + data)

    # -- squeeze ---------------------------------------------------------
    def _squeeze(self, label: bytes) -> torch.Tensor:
        buf = (torch.cat(self.parts) if self.parts
               else torch.empty(0, dtype=_U8, device=self.device))
        self.state, chal = squeeze(buf, self.round, self.state, label, self.spec)
        self.round += 1
        self.parts = []
        return chal

    def squeeze_bytes(self, label: bytes) -> torch.Tensor:
        self._squeeze(label)
        return self.state

    def squeeze_mont(self, label: bytes) -> torch.Tensor:
        """Squeeze a challenge as a Montgomery (8,) element."""
        return self._squeeze(label)
