"""SHA-256 R1CS gadget (reference workload: benches/sha256_spartan.rs
uses bellpepper's sha256 gadget; this is an independent implementation).

Representation: a Bit is a linear combination + 0/1 value; a UInt32 is 32
Bits, LSB first.  Gate costs: XOR 1 constraint, Ch 1, Maj 2, 32-bit
modular add of k operands ~36 (32 result bits + carry bits + 1 linear
constraint).  Rotations/shifts are free (bit wiring / constant zeros).
One 512-bit compression is ~31k constraints.
"""

from __future__ import annotations

import hashlib

from ..constraint_system import LC, ONE, ConstraintSystem

# SHA-256 round constants / IV (FIPS 180-4)
K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


class Bit:
    """A boolean value as (linear combination, known value)."""

    __slots__ = ("lc", "value")

    def __init__(self, comb: LC, value: int | None):
        self.lc = comb
        self.value = value

    @classmethod
    def constant(cls, b: int) -> "Bit":
        return cls({ONE: b} if b else {}, b)

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: int | None) -> "Bit":
        """Allocate a boolean-constrained bit: x*x = x."""
        var = cs.alloc(value)
        comb = {var: 1}
        cs.enforce(comb, comb, comb)
        return cls(comb, None if cs.shape_mode else value)

    def is_const(self) -> bool:
        return all(v == ONE for v in self.lc) and len(self.lc) <= 1


def _lc_add(a: LC, b: LC, bscale: int = 1) -> LC:
    out = dict(a)
    for var, c in b.items():
        out[var] = out.get(var, 0) + c * bscale
    return out


def bit_xor(cs: ConstraintSystem, a: Bit, b: Bit) -> Bit:
    """a ^ b = a + b - 2ab; constants fold for free."""
    if a.is_const():
        if a.value == 0:
            return b
        return Bit(_lc_add({ONE: 1}, b.lc, -1), None if b.value is None else 1 - b.value)
    if b.is_const():
        return bit_xor(cs, b, a)
    val = None if cs.shape_mode else a.value ^ b.value
    var = cs.alloc(val)
    out_lc = {var: 1}
    # (2a) * b = a + b - out  (bellpepper xor shape: out is boolean by
    # construction when a, b are)
    cs.enforce(_lc_add({}, a.lc, 2), b.lc,
               _lc_add(_lc_add(a.lc, b.lc), out_lc, -1))
    return Bit(out_lc, val)


def bit_ch(cs: ConstraintSystem, a: Bit, b: Bit, c: Bit) -> Bit:
    """Ch(a,b,c) = a(b - c) + c: one constraint."""
    val = None if cs.shape_mode else ((a.value & b.value) ^ ((1 - a.value) & c.value))
    var = cs.alloc(val)
    out_lc = {var: 1}
    cs.enforce(a.lc, _lc_add(b.lc, c.lc, -1), _lc_add(out_lc, c.lc, -1))
    return Bit(out_lc, val)


def bit_maj(cs: ConstraintSystem, a: Bit, b: Bit, c: Bit) -> Bit:
    """Maj(a,b,c) = t + a(b + c - 2t), t = bc: two constraints."""
    tval = None if cs.shape_mode else b.value & c.value
    tvar = cs.alloc(tval)
    t_lc = {tvar: 1}
    cs.enforce(b.lc, c.lc, t_lc)
    val = None if cs.shape_mode else (
        (a.value & b.value) ^ (a.value & c.value) ^ (b.value & c.value)
    )
    var = cs.alloc(val)
    out_lc = {var: 1}
    cs.enforce(a.lc, _lc_add(_lc_add(b.lc, c.lc), t_lc, -2),
               _lc_add(out_lc, t_lc, -1))
    return Bit(out_lc, val)


class UInt32:
    """32 Bits, LSB first."""

    __slots__ = ("bits",)

    def __init__(self, bits: list[Bit]):
        assert len(bits) == 32
        self.bits = bits

    @classmethod
    def constant(cls, v: int) -> "UInt32":
        return cls([Bit.constant((v >> i) & 1) for i in range(32)])

    @property
    def value(self) -> int | None:
        if any(b.value is None for b in self.bits):
            return None
        return sum(bit.value << i for i, bit in enumerate(self.bits))

    def rotr(self, n: int) -> "UInt32":
        return UInt32([self.bits[(i + n) % 32] for i in range(32)])

    def shr(self, n: int) -> "UInt32":
        return UInt32(
            [self.bits[i + n] if i + n < 32 else Bit.constant(0) for i in range(32)]
        )

    def xor(self, cs: ConstraintSystem, other: "UInt32") -> "UInt32":
        return UInt32([bit_xor(cs, a, b) for a, b in zip(self.bits, other.bits)])


def uint32_addmany(cs: ConstraintSystem, terms: list[UInt32]) -> UInt32:
    """Modular 2^32 addition of k operands: one linear constraint plus
    boolean-constrained result and carry bits."""
    k = len(terms)
    assert k >= 2
    carry_bits = max(k - 1, 1).bit_length()  # total < k * 2^32 <= 2^(32+cb)
    total = None
    if not cs.shape_mode:
        total = sum(t.value for t in terms)
    out_bits = [
        Bit.alloc(cs, None if cs.shape_mode else (total >> i) & 1)
        for i in range(32 + carry_bits)
    ]
    # sum of term lcs == sum 2^i out_bits[i]
    lhs: LC = {}
    for t in terms:
        for i, b in enumerate(t.bits):
            lhs = _lc_add(lhs, b.lc, 1 << i)
    rhs: LC = {}
    for i, b in enumerate(out_bits):
        rhs = _lc_add(rhs, b.lc, 1 << i)
    cs.enforce(_lc_add(lhs, rhs, -1), {ONE: 1}, {})
    return UInt32(out_bits[:32])


def _sigma(cs: ConstraintSystem, x: UInt32, r1: int, r2: int, r3: int,
           shift: bool) -> UInt32:
    a = x.rotr(r1)
    b = x.rotr(r2)
    c = x.shr(r3) if shift else x.rotr(r3)
    return a.xor(cs, b).xor(cs, c)


def sha256_compress(cs: ConstraintSystem, state: list[UInt32],
                    block: list[UInt32]) -> list[UInt32]:
    """One compression: state (8 words) x block (16 words) -> 8 words."""
    W = list(block)
    for t in range(16, 64):
        s0 = _sigma(cs, W[t - 15], 7, 18, 3, True)
        s1 = _sigma(cs, W[t - 2], 17, 19, 10, True)
        W.append(uint32_addmany(cs, [s1, W[t - 7], s0, W[t - 16]]))

    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _sigma(cs, e, 6, 11, 25, False)
        ch = UInt32([bit_ch(cs, x, y, z) for x, y, z in
                     zip(e.bits, f.bits, g.bits)])
        T1 = uint32_addmany(cs, [h, S1, ch, UInt32.constant(K[t]), W[t]])
        S0 = _sigma(cs, a, 2, 13, 22, False)
        maj = UInt32([bit_maj(cs, x, y, z) for x, y, z in
                      zip(a.bits, b.bits, c.bits)])
        T2 = uint32_addmany(cs, [S0, maj])
        h, g, f = g, f, e
        e = uint32_addmany(cs, [d, T1])
        d, c, b = c, b, a
        a = uint32_addmany(cs, [T1, T2])

    return [uint32_addmany(cs, [s, w])
            for s, w in zip(state, [a, b, c, d, e, f, g, h])]


def sha256_pad(msg_bits_len: int) -> list[int]:
    """Padding bit values (MSB-first stream) appended after the message."""
    pad = [1]
    while (msg_bits_len + len(pad)) % 512 != 448:
        pad.append(0)
    length = msg_bits_len
    pad.extend((length >> (63 - i)) & 1 for i in range(64))
    return pad


def sha256_gadget(cs: ConstraintSystem, msg_bits: list[Bit]) -> list[Bit]:
    """Full SHA-256 over message bits (MSB-first stream, byte-aligned
    length). Returns 256 digest bits, MSB-first."""
    assert len(msg_bits) % 8 == 0
    bits = list(msg_bits)
    bits.extend(Bit.constant(b) for b in sha256_pad(len(msg_bits)))
    assert len(bits) % 512 == 0

    state = [UInt32.constant(v) for v in IV]
    for blk in range(len(bits) // 512):
        words = []
        for w in range(16):
            stream = bits[blk * 512 + w * 32 : blk * 512 + (w + 1) * 32]
            words.append(UInt32(list(reversed(stream))))  # MSB-first -> LSB
        state = sha256_compress(cs, state, words)

    out = []
    for word in state:
        out.extend(reversed(word.bits))  # back to MSB-first
    return out


class Sha256Circuit:
    """Full-hash circuit (benches/sha256_spartan.rs:36-152): allocate the
    preimage bits and the SHA-256 computation in the PRECOMMITTED phase
    (so prep_prove carries all witness work), expose the 256 digest bits
    as public IO."""

    def __init__(self, preimage: bytes):
        self.preimage = bytes(preimage)

    def public_values(self) -> list[int]:
        digest = hashlib.sha256(self.preimage).digest()
        return [(byte >> (7 - i)) & 1 for byte in digest for i in range(8)]

    def shared(self, cs):
        return []

    def precommitted(self, cs, shared):
        msg_bits = [
            Bit.alloc(cs, (byte >> (7 - i)) & 1)
            for byte in self.preimage for i in range(8)
        ]
        hash_bits = sha256_gadget(cs, msg_bits)
        if not cs.shape_mode:
            expected = self.public_values()
            got = [b.value if b.value is not None else None for b in hash_bits]
            assert got == expected, "sha256 gadget mismatch"
        for bit in hash_bits:
            inp = cs.alloc_input(bit.value)
            cs.enforce(bit.lc, {ONE: 1}, {inp: 1})
        return []

    def num_challenges(self) -> int:
        return 0

    def synthesize(self, cs, shared, precommitted, challenges) -> None:
        return None
