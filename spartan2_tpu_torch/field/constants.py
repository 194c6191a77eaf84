"""Prime-field constants for the port's limb layout.

Layout, chosen once for the whole port: a field element is 8 limbs of 32
bits, little-endian, stored element-major as an int32 tensor of shape
``(n, 8)`` so one CUDA thread reads 32 contiguous bytes.  Montgomery form
uses R = 2^256.  Every stored value is canonical, in [0, p).

Both P-256 moduli exceed 2^255, so a + b can carry out of limb 7; the
kernels (csrc/field.cuh) and the plain version (field/ops.py) fold that
carry into the conditional subtract.

Host values are canonical Python ints; no Montgomery-form value reaches
a transcript or a proof.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

LIMB_BITS = 32
NUM_LIMBS = 8
R_BITS = LIMB_BITS * NUM_LIMBS  # 256
R = 1 << R_BITS


@dataclass(frozen=True)
class FieldSpec:
    """Host-side constants and scalar helpers for one prime field."""

    name: str
    modulus: int

    n0: int = field(init=False)  # -p^{-1} mod 2^32 (word-wise REDC factor)
    r_mod: int = field(init=False)  # R mod p   (Montgomery ONE)
    r2_mod: int = field(init=False)  # R^2 mod p (to-Montgomery factor)
    r_inv: int = field(init=False)  # R^{-1} mod p

    def __post_init__(self):
        p = self.modulus
        assert p % 2 == 1 and p.bit_length() <= R_BITS
        object.__setattr__(self, "n0", pow(-p, -1, 1 << LIMB_BITS))
        object.__setattr__(self, "r_mod", R % p)
        object.__setattr__(self, "r2_mod", R * R % p)
        object.__setattr__(self, "r_inv", pow(R, -1, p))

    # ---- host scalar helpers (canonical integer domain) ----

    def add(self, a: int, b: int) -> int:
        s = a + b
        p = self.modulus
        return s - p if s >= p else s

    def sub(self, a: int, b: int) -> int:
        d = a - b
        return d + self.modulus if d < 0 else d

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.modulus

    def neg(self, a: int) -> int:
        return (self.modulus - a) % self.modulus

    def inv(self, a: int) -> int:
        if a % self.modulus == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(a, -1, self.modulus)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    @property
    def two_inv(self) -> int:
        return self.inv(2)

    def from_uniform(self, data: bytes) -> int:
        """64 little-endian bytes -> field element (halo2curves'
        ``from_uniform_bytes``, src/provider/traits.rs:275-280)."""
        assert len(data) == 64
        return int.from_bytes(data, "little") % self.modulus

    def to_bytes(self, a: int) -> bytes:
        """Canonical 32-byte little-endian repr (ff::PrimeField::to_repr)."""
        return int(a % self.modulus).to_bytes(32, "little")

    def from_bytes(self, data: bytes) -> int:
        v = int.from_bytes(data, "little")
        if v >= self.modulus:
            raise ValueError("non-canonical field encoding")
        return v

    def to_transcript_bytes(self, a: int) -> bytes:
        """Big-endian 32 bytes: the reference reverses to_repr before
        absorbing (src/provider/traits.rs:282-286)."""
        return int(a % self.modulus).to_bytes(32, "big")

    def to_mont(self, a: int) -> int:
        return (a * R) % self.modulus

    def from_mont(self, a_mont: int) -> int:
        return (a_mont * self.r_inv) % self.modulus


# Moduli from the curve definitions the reference binds via halo2curves.
# Pasta curves (reference: src/provider/pasta.rs:40-54).
PALLAS_Q = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
PALLAS_P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
# NIST P-256 (reference: src/provider/pt256.rs:43-49).
P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
# T256's own base field (reference: src/provider/pt256.rs:51-57).
T256_P = 0xFFFFFFFF0000000100000000000000017E72B42B30E7317793135661B1C4B117
# BN254 / bn256 G1 (reference: src/provider/bn254.rs).
BN254_R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
BN254_P = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47


@functools.lru_cache(maxsize=None)
def get_field(name: str) -> FieldSpec:
    table = {
        "pallas_scalar": PALLAS_Q,
        "pallas_base": PALLAS_P,
        "vesta_scalar": PALLAS_P,
        "vesta_base": PALLAS_Q,
        "p256_scalar": P256_N,
        "p256_base": P256_P,
        "t256_scalar": P256_P,
        "t256_base": T256_P,
        "bn254_scalar": BN254_R,
        "bn254_base": BN254_P,
    }
    return FieldSpec(name=name, modulus=table[name])
