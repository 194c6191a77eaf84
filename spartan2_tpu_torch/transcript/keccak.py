"""Host Keccak-256 (original Keccak padding 0x01, NOT SHA3's 0x06).

Implemented from the Keccak specification (Keccak-f[1600] permutation,
rate 1088 bits / capacity 512 bits, 32-byte output).  The reference uses the
Rust `sha3::Keccak256` (src/provider/keccak.rs:16) — this module reproduces
the same function so Fiat-Shamir transcripts are bit-exact.

``keccak256`` is the C implementation (native/keccak.c, built with ``cc``
at its first call; a failed build raises).  ``keccak256_plain`` is the
same function in pure Python, kept as its plain version for the tests.
The device Keccak is csrc/keccak.cuh (transcript/device.py).
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1

# Rotation offsets r[x][y] for rho, per the Keccak reference.
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

# Round constants for iota.
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK64


def keccak_f1600(lanes: list[int]) -> list[int]:
    """Apply Keccak-f[1600] to 25 64-bit lanes, A[x][y] = lanes[x + 5*y]."""
    a = lanes
    for rnd in range(24):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        # chi: a[x,y] = b[x,y] ^ (~b[x+1,y] & b[x+2,y])
        a = [
            b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # iota
        a[0] ^= _RC[rnd]
        a = [v & _MASK64 for v in a]
    return a


_RATE = 136  # bytes (1088-bit rate for Keccak-256)


def keccak256_plain(data: bytes) -> bytes:
    """Keccak-256 digest (original padding 0x01 .. 0x80), pure Python."""
    state = [0] * 25
    # absorb
    pad_len = _RATE - (len(data) % _RATE)
    if pad_len == 1:
        padded = data + b"\x81"
    else:
        padded = data + b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    for off in range(0, len(padded), _RATE):
        block = padded[off : off + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
    # squeeze (single block suffices for 32 bytes)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


_native = None


def keccak256(data: bytes) -> bytes:
    """Keccak-256 digest, in C (native/keccak.c)."""
    global _native
    if _native is None:
        from ..native import load_keccak

        _native = load_keccak()
    return _native(data)
