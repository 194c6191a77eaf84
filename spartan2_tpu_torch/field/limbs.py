"""Conversions between canonical Python ints and the port's limb tensors.

A field element is 8 little-endian 32-bit limbs, element-major: an int32
array of shape ``(n, 8)`` (field/constants.py).  The bytes of that array
are exactly the concatenated 32-byte little-endian encodings, so every
conversion is one ``to_bytes``/``from_bytes`` per value.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import NUM_LIMBS, R, FieldSpec

NL = NUM_LIMBS


def ints_to_limbs_np(vals, spec: FieldSpec, mont: bool = False) -> np.ndarray:
    """Python ints -> (n, 8) int32 limbs, reduced mod p; Montgomery form
    (v * 2^256 mod p) when ``mont``."""
    p = spec.modulus
    if mont:
        buf = b"".join((int(v) * R % p).to_bytes(32, "little") for v in vals)
    else:
        buf = b"".join((int(v) % p).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<i4").reshape(-1, NL).copy()


def limbs_to_ints(arr, spec: FieldSpec, mont: bool = False) -> list[int]:
    """(n, 8) or (8,) limbs (numpy or torch, any device) -> canonical ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr, dtype="<i4").reshape(-1, NL))
    raw = a.tobytes()
    vals = [int.from_bytes(raw[32 * i : 32 * i + 32], "little")
            for i in range(a.shape[0])]
    p = spec.modulus
    if mont:
        return [v * spec.r_inv % p for v in vals]
    return [v % p for v in vals]


def to_device(vals, spec: FieldSpec, device, mont: bool = False,
              non_blocking: bool = False) -> torch.Tensor:
    """Python ints -> (n, 8) int32 tensor on ``device``; ``non_blocking``
    copies without synchronizing the host (the source is pageable, so the
    copy is staged before the call returns)."""
    return torch.from_numpy(ints_to_limbs_np(vals, spec, mont)).to(
        device, non_blocking=non_blocking)
