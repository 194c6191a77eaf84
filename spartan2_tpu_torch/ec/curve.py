"""Host-side short-Weierstrass curve arithmetic over Python ints.

Counterpart of the reference's curve layer (the reference pulls
all point arithmetic from halo2curves; src/provider/traits.rs:166-353 wires
it).  The host implementation here serves:

  * setup-time generator derivation (``from_label``),
  * MSMs below 64 points (the verifier circuit's row commitments, the
    IPA) and scalar multiplications, in C (native/ec_host.c),
  * ground truth for the device EC kernel tests.

``scalar_mul`` and ``msm`` call the C library, built at first use (a
failed build raises); ``scalar_mul_plain`` and ``msm_plain`` are their
Python versions, which the tests compare with and nothing else calls.

Bulk prover-side MSMs run on the card (ec/comb.py, csrc/comb.cu), as
does the verifier's fold of 64 or more row commitments (ec/msm.py,
csrc/msm.cu).

Deviation note: the reference derives generators with SHAKE256(label) ->
32-byte seeds -> halo2curves' SSWU hash_to_curve ("from_uniform_bytes"
domain, provider/traits.rs:205-249).  halo2curves' exact map (and the T256
curve constants) are not reproducible from the reference repo alone, so
this library uses SHAKE256(label) -> seeds -> deterministic
try-and-increment.  Generators are *nothing-up-my-sleeve* in the same
sense but not bit-identical to the reference's.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass

from ..field.constants import (
    BN254_P,
    BN254_R,
    P256_N,
    P256_P,
    PALLAS_P,
    PALLAS_Q,
    FieldSpec,
    get_field,
)

# Affine points are (x, y) tuples of canonical ints; None is the identity.
Affine = tuple[int, int] | None

_EC = None
_ZERO64 = bytes(64)


def _native_ec():
    """(msm, scalar_mul) over byte buffers from the C library, built at
    first use."""
    global _EC
    if _EC is None:
        from ..native import load_ec

        _EC = load_ec()
    return _EC


@functools.lru_cache(maxsize=None)
def _native_params(curve: "CurveSpec") -> bytes:
    """The C library's 13 x u64 parameter block: p, n0 = -p^-1 mod 2^64,
    a * 2^256 mod p, 2^512 mod p, little-endian."""
    p = curve.base.modulus
    n0 = -pow(p, -1, 1 << 64) % (1 << 64)
    a_mont = curve.a % p * (1 << 256) % p
    r2 = pow(1 << 256, 2, p)
    return (p.to_bytes(32, "little") + n0.to_bytes(8, "little")
            + a_mont.to_bytes(32, "little") + r2.to_bytes(32, "little"))


def _point_bytes(pt: Affine) -> bytes:
    """x || y little-endian; the identity as 64 zero bytes."""
    if pt is None:
        return _ZERO64
    return pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little")


def _jac_from_bytes(out: bytes):
    return (int.from_bytes(out[0:32], "little"),
            int.from_bytes(out[32:64], "little"),
            int.from_bytes(out[64:96], "little"))


def tonelli_shanks(n: int, p: int) -> int | None:
    """Square root mod odd prime p, or None if n is not a QR."""
    n %= p
    if n == 0:
        return 0
    if pow(n, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(n, (p + 1) // 4, p)
    # general Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(n, q, p), pow(n, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


@dataclass(frozen=True)
class CurveSpec:
    """y^2 = x^3 + a*x + b over ``base``; group order = ``scalar`` modulus."""

    name: str
    base: FieldSpec
    scalar: FieldSpec
    a: int
    b: int
    generator: tuple[int, int]

    # ---------------- affine / jacobian host ops ----------------

    def is_on_curve(self, pt: Affine) -> bool:
        if pt is None:
            return True
        x, y = pt
        p = self.base.modulus
        return (y * y - (x * x * x + self.a * x + self.b)) % p == 0

    def jac_double(self, P):
        X, Y, Z = P
        p = self.base.modulus
        if Z == 0 or Y == 0:
            return (0, 1, 0)
        S = 4 * X * Y * Y % p
        ZZ = Z * Z % p
        M = (3 * X * X + self.a * ZZ * ZZ) % p
        X2 = (M * M - 2 * S) % p
        Y2 = (M * (S - X2) - 8 * pow(Y, 4, p)) % p
        Z2 = 2 * Y * Z % p
        return (X2, Y2, Z2)

    def jac_add(self, P, Q):
        p = self.base.modulus
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        if Z1 == 0:
            return Q
        if Z2 == 0:
            return P
        Z1Z1 = Z1 * Z1 % p
        Z2Z2 = Z2 * Z2 % p
        U1 = X1 * Z2Z2 % p
        U2 = X2 * Z1Z1 % p
        S1 = Y1 * Z2 * Z2Z2 % p
        S2 = Y2 * Z1 * Z1Z1 % p
        H = (U2 - U1) % p
        R = (S2 - S1) % p
        if H == 0:
            if R == 0:
                return self.jac_double(P)
            return (0, 1, 0)
        HH = H * H % p
        HHH = H * HH % p
        V = U1 * HH % p
        X3 = (R * R - HHH - 2 * V) % p
        Y3 = (R * (V - X3) - S1 * HHH) % p
        Z3 = Z1 * Z2 * H % p
        return (X3, Y3, Z3)

    def to_jac(self, pt: Affine):
        if pt is None:
            return (0, 1, 0)
        return (pt[0], pt[1], 1)

    def to_affine(self, P) -> Affine:
        X, Y, Z = P
        if Z == 0:
            return None
        p = self.base.modulus
        zinv = pow(Z, -1, p)
        zinv2 = zinv * zinv % p
        return (X * zinv2 % p, Y * zinv2 * zinv % p)

    def add(self, a: Affine, b: Affine) -> Affine:
        return self.to_affine(self.jac_add(self.to_jac(a), self.to_jac(b)))

    def neg(self, pt: Affine) -> Affine:
        if pt is None:
            return None
        return (pt[0], (-pt[1]) % self.base.modulus)

    def scalar_mul(self, k: int, pt: Affine) -> Affine:
        """k * pt in C (native/ec_host.c: 4-bit windows)."""
        k %= self.scalar.modulus
        out = _native_ec()[1](_native_params(self), k.to_bytes(32, "little"),
                              _point_bytes(pt))
        return self.to_affine(_jac_from_bytes(out))

    def scalar_mul_plain(self, k: int, pt: Affine) -> Affine:
        """Plain version of ``scalar_mul``: double-and-add over Python ints."""
        k %= self.scalar.modulus
        if k == 0 or pt is None:
            return None
        acc = (0, 1, 0)
        Pj = self.to_jac(pt)
        for bit in bin(k)[2:]:
            acc = self.jac_double(acc)
            if bit == "1":
                acc = self.jac_add(acc, Pj)
        return self.to_affine(acc)

    # ---------------- MSM (verifier-side scale) ----------------

    def msm(self, scalars: list[int], points: list[Affine]) -> Affine:
        """sum_i scalars[i] * points[i] by Pippenger in C (native/ec_host.c;
        reference: src/provider/msm.rs).  Serves the small host MSMs (the
        verifier circuit's row commitments, ec/msm.py msm_points below 64
        points)."""
        if len(scalars) != len(points):
            raise ValueError(f"msm: {len(scalars)} scalars for {len(points)} points")
        q = self.scalar.modulus
        sc = b"".join((s % q).to_bytes(32, "little") for s in scalars)
        pts = b"".join(_point_bytes(pt) for pt in points)
        out = _native_ec()[0](_native_params(self), sc, pts, len(scalars))
        return self.to_affine(_jac_from_bytes(out))

    def msm_plain(self, scalars: list[int], points: list[Affine]) -> Affine:
        """Plain version of ``msm``: the same Pippenger over Python ints."""
        assert len(scalars) == len(points)
        n = len(scalars)
        if n == 0:
            return None
        c = 4 if n < 128 else 8 if n < 32768 else 12
        nbits = self.scalar.modulus.bit_length()
        windows = -(-nbits // c)
        ks = [s % self.scalar.modulus for s in scalars]
        acc = (0, 1, 0)
        for w in range(windows - 1, -1, -1):
            for _ in range(c):
                acc = self.jac_double(acc)
            buckets = [(0, 1, 0)] * ((1 << c) - 1)
            for k, pt in zip(ks, points):
                d = (k >> (w * c)) & ((1 << c) - 1)
                if d and pt is not None:
                    buckets[d - 1] = self.jac_add(buckets[d - 1], self.to_jac(pt))
            run = (0, 1, 0)
            s = (0, 1, 0)
            for j in range(len(buckets) - 1, -1, -1):
                run = self.jac_add(run, buckets[j])
                s = self.jac_add(s, run)
            acc = self.jac_add(acc, s)
        return self.to_affine(acc)

    # ---------------- generator derivation ----------------

    def hash_to_curve(self, seed: bytes) -> tuple[int, int]:
        """Deterministic 32-byte seed -> curve point, try-and-increment."""
        p = self.base.modulus
        ctr = 0
        while True:
            h = hashlib.sha256(b"spartan2_tpu_h2c" + seed + ctr.to_bytes(4, "little")).digest()
            x = int.from_bytes(h, "little") % p
            rhs = (x * x * x + self.a * x + self.b) % p
            y = tonelli_shanks(rhs, p)
            if y is not None and y != 0:
                if y % 2 == 1:
                    y = p - y
                return (x, y)
            ctr += 1

    def from_label(self, label: bytes, n: int) -> list[tuple[int, int]]:
        """SHAKE256(label) -> n 32-byte seeds -> n generators.

        Mirrors the structure of the reference's from_label
        (provider/traits.rs:205-249); see module docstring for the
        hash-to-curve deviation.
        """
        xof = hashlib.shake_256(label).digest(32 * n)
        return [self.hash_to_curve(xof[32 * i : 32 * i + 32]) for i in range(n)]

    # ---------------- serialization ----------------

    def to_transcript_bytes(self, pt: Affine) -> bytes:
        """Big-endian x || y; identity encodes as zeros
        (provider/traits.rs:288-305)."""
        if pt is None:
            return bytes(64)
        return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")

    def point_bytes(self, pt: Affine) -> bytes:
        """Canonical little-endian (x, y, infinity-flag) wire encoding."""
        if pt is None:
            return bytes(64) + b"\x01"
        return pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little") + b"\x00"

    def point_from_bytes(self, data: bytes) -> Affine:
        assert len(data) == 65
        if data[64] == 1:
            return None
        pt = (int.from_bytes(data[:32], "little"), int.from_bytes(data[32:64], "little"))
        if not self.is_on_curve(pt):
            raise ValueError("point not on curve")
        return pt


# ---------------------------------------------------------------------------
# Concrete curves.  Coefficients cite the curve definitions the reference
# binds via halo2curves (src/provider/pasta.rs, pt256.rs, bn254.rs).
# The T256 curve's (a, b, base prime) are defined only inside halo2curves
# (not recoverable from the reference repo; a class-number-1 CM
# reconstruction of a curve with order == P-256's base prime does not
# exist, verified exhaustively) — so this library ships the four curves
# with public parameters.  P256HyraxEngine is the 256-bit NIST-class
# benchmark engine standing in for T256HyraxEngine.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def get_curve(name: str) -> CurveSpec:
    if name == "pallas":
        # y^2 = x^3 + 5, generator (-1, 2) (zcash pasta_curves).
        return CurveSpec(
            "pallas", get_field("pallas_base"), get_field("pallas_scalar"),
            0, 5, (PALLAS_P - 1, 2),
        )
    if name == "vesta":
        return CurveSpec(
            "vesta", get_field("vesta_base"), get_field("vesta_scalar"),
            0, 5, (PALLAS_Q - 1, 2),
        )
    if name == "p256":
        # NIST P-256 (secp256r1), SEC2 parameters.
        return CurveSpec(
            "p256", get_field("p256_base"), get_field("p256_scalar"),
            P256_P - 3,
            0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
            (
                0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
                0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
            ),
        )
    if name == "bn254":
        # bn256/alt_bn128 G1: y^2 = x^3 + 3, generator (1, 2).
        return CurveSpec(
            "bn254", get_field("bn254_base"), get_field("bn254_scalar"),
            0, 3, (1, 2),
        )
    raise KeyError(name)


_ = (BN254_P, BN254_R, P256_N)  # re-export anchors for doc cross-reference
