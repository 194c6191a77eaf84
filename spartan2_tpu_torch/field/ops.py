"""Plain PyTorch Montgomery arithmetic on the port's limb tensors.

Inputs and outputs are int32 tensors of shape ``(..., 8)`` holding
canonical values in [0, p) (field/constants.py).  Internally every
function works on int64 tensors of sixteen 16-bit digits, so a digit
product is below 2^32 and a column of sixteen products plus the
Montgomery fold stays below 2^38: no intermediate can overflow int64.

A small batch on the CPU (up to ``_SMALL`` elements) takes Python's
integers instead: the same values, without the per-operation cost of some
seventy small tensor operations, which dominates the plain curve
arithmetic's long chains of doublings on a handful of points.

This is the plain version of the device functions in csrc/field.cuh,
which replace ``FieldOps`` of the JAX package (field/jnp_ops.py: add/sub
:126-146, mont_mul :185, to_mont/from_mont :211-228, inv/batch_inv
:243-300, from_uniform_bytes :302, the canonical byte encodings
:704/:722).  The kernels' plain versions call it; it runs on any device.
"""

from __future__ import annotations

import torch

from .constants import FieldSpec

_D = 16  # digits per element
_MASK = 0xFFFF

# Internally digits lie on the FIRST axis, (16, ...), so every digit
# operation is one contiguous vector operation over the batch.


def _digits(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (16, ...) int64 digits in [0, 2^16)."""
    u = (x.to(torch.int64) & 0xFFFFFFFF).movedim(-1, 0)
    d = torch.stack((u & _MASK, u >> 16), dim=1)  # (8, 2, ...)
    return d.reshape(_D, *x.shape[:-1])


def _limbs(d: torch.Tensor) -> torch.Tensor:
    """(16, ...) int64 digits in [0, 2^16) -> (..., 8) int32."""
    d = d.reshape(8, 2, *d.shape[1:])
    u = d[:, 0] | (d[:, 1] << 16)
    u = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
    return u.movedim(0, -1).contiguous()


def _p_digits(spec: FieldSpec, device, ndim: int) -> torch.Tensor:
    p = spec.modulus
    P = torch.tensor([(p >> (16 * i)) & _MASK for i in range(_D)],
                     dtype=torch.int64, device=device)
    return P.reshape(_D, *([1] * ndim))


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries (or borrows: >> floors) along the digit axis, in
    place; every digit but the last ends in [0, 2^16).  Each pass moves
    every digit's carry up one digit at once; a carry that ripples through
    k digits takes k passes, which is rare, so a few passes do."""
    while True:
        c = t[:-1] >> 16
        if not bool(c.any()):
            return t
        t[:-1] &= _MASK
        t[1:] += c


def _reduce_once(t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """17 carried digits holding v < 2p -> 16 digits of v mod p.  The 17th
    digit is the carry out of the top limb (p > 2^255 makes it
    reachable), and it takes part in the subtract."""
    w = t.clone()
    w[:_D] -= _p_digits(spec, t.device, t.dim() - 1)
    _carry(w)
    return torch.where(w[_D] < 0, t[:_D], w[:_D])


_SMALL = 256


def _small(a: torch.Tensor) -> bool:
    return a.device.type == "cpu" and a.numel() <= 8 * _SMALL


def _ints(a: torch.Tensor) -> list[int]:
    raw = a.contiguous().numpy().tobytes()
    return [int.from_bytes(raw[i : i + 32], "little") for i in range(0, len(raw), 32)]


def _tensor(vals, shape) -> torch.Tensor:
    if not vals:
        return torch.empty(shape, dtype=torch.int32)
    raw = bytearray(b"".join(v.to_bytes(32, "little") for v in vals))
    return torch.frombuffer(raw, dtype=torch.int32).reshape(shape)


def _small_op(a: torch.Tensor, b: torch.Tensor, fn) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return _tensor([fn(x, y) for x, y in zip(_ints(a), _ints(b))], a.shape)


def _extend(d: torch.Tensor) -> torch.Tensor:
    return torch.cat([d, torch.zeros_like(d[:1])])


def add(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    if _small(a) and _small(b):
        p = spec.modulus
        return _small_op(a, b, lambda x, y: (x + y) % p)
    t = _carry(_extend(_digits(a) + _digits(b)))
    return _limbs(_reduce_once(t, spec))


def sub(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    if _small(a) and _small(b):
        p = spec.modulus
        return _small_op(a, b, lambda x, y: (x - y) % p)
    t = _carry(_extend(_digits(a) - _digits(b)))
    plus = t[:_D] + _p_digits(spec, a.device, t.dim() - 1)
    _carry(plus)
    return _limbs(torch.where(t[_D] < 0, plus & _MASK, t[:_D]))


def _redc(t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Word-by-word Montgomery reduction of a wide value held as 33
    non-negative int64 digit rows (value below p * 2^256, magnitudes
    below 2^40), in place: -> (..., 8) canonical t * 2^-256 mod p."""
    P = _p_digits(spec, t.device, t.dim() - 1)
    n0 = (-pow(spec.modulus, -1, 1 << 16)) % (1 << 16)
    for i in range(_D):
        m = (t[i] * n0) & _MASK  # t[i] * n0 < 2^56: no overflow
        t[i : i + _D].addcmul_(P, m)
        t[i + 1] += t[i] >> 16
    return _limbs(_reduce_once(_carry(t[_D:]), spec))


def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a * b * 2^-256 mod p (word-by-word REDC over 16-bit digits)."""
    if _small(a) and _small(b):
        p, r_inv = spec.modulus, spec.r_inv
        return _small_op(a, b, lambda x, y: x * y * r_inv % p)
    a, b = torch.broadcast_tensors(a, b)
    A, B = _digits(a), _digits(b)
    t = torch.zeros(2 * _D + 1, *A.shape[1:], dtype=torch.int64, device=a.device)
    for i in range(_D):
        t[i : i + _D].addcmul_(B, A[i])
    return _redc(t, spec)


def reduce_digit_sums(d: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(16, ...) int64 digit-wise sums of up to 2^20 canonical elements
    -> (..., 8) canonical sum mod p: REDC gives S * 2^-256, and a
    Montgomery product by 2^512 mod p restores S."""
    t = torch.zeros(2 * _D + 1, *d.shape[1:], dtype=torch.int64, device=d.device)
    t[:_D] = d
    r2 = const(spec.r2_mod, spec, device=d.device, mont=False)
    return mont_mul(_redc(t, spec), r2, spec)


def digits(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (16, ...) int64 16-bit digits, for digit-wise sums
    that ``reduce_digit_sums`` brings back to the field."""
    return _digits(x)


def const(value: int, spec: FieldSpec, shape=(), device="cpu",
          mont: bool = True) -> torch.Tensor:
    """A tensor of shape ``(*shape, 8)`` filled with ``value``."""
    v = value % spec.modulus
    if mont:
        v = spec.to_mont(v)
    limbs = [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    limbs = [x - (1 << 32) if x >= 1 << 31 else x for x in limbs]
    t = torch.tensor(limbs, dtype=torch.int32, device=device)
    return t.expand(*shape, 8).contiguous()


def to_mont(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    r2 = const(spec.r2_mod, spec, device=a.device, mont=False)
    return mont_mul(a, r2, spec)


def from_mont(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    one = const(1, spec, device=a.device, mont=False)
    return mont_mul(a, one, spec)


def pow_const(a: torch.Tensor, e: int, spec: FieldSpec) -> torch.Tensor:
    """a^e for Montgomery-form ``a`` (result in Montgomery form)."""
    acc = const(1, spec, a.shape[:-1], a.device)
    for bit in bin(e)[2:]:
        acc = mont_mul(acc, acc, spec)
        if bit == "1":
            acc = mont_mul(acc, a, spec)
    return acc


def inv(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Elementwise inverse of Montgomery-form values by Fermat (0 -> 0).
    One vectorized exponentiation serves a whole batch, so this is also
    the batch inverse."""
    return pow_const(a, spec.modulus - 2, spec)


def sum_all(x: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(n, 8) -> (8,): the sum of n <= 2^20 elements mod p."""
    return reduce_digit_sums(_digits(x).sum(1), spec)


def from_uniform_bytes(data: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(..., 64) uint8, a 512-bit little-endian integer -> (..., 8) its
    Montgomery form mod p (FieldSpec.from_uniform, then to_mont).  With
    lo and hi the two 256-bit halves, lo R + hi 2^256 R = REDC(lo R^2) +
    REDC(hi R^3); REDC takes lo, hi < 2^256 unreduced, since a factor
    below p keeps the product below p R."""
    words = data.contiguous().view(torch.int32)  # little-endian limbs
    p = spec.modulus
    r2 = const(spec.r2_mod, spec, device=data.device, mont=False)
    r3 = const(spec.r2_mod * spec.to_mont(1) % p, spec, device=data.device, mont=False)
    return add(mont_mul(words[..., :8], r2, spec), mont_mul(words[..., 8:], r3, spec),
               spec)


def to_bytes(a: torch.Tensor, spec: FieldSpec, big_endian: bool = False) -> torch.Tensor:
    """(..., 8) Montgomery -> (..., 32) uint8, the canonical 32-byte
    encoding, little-endian (FieldSpec.to_bytes) or big-endian (the
    transcript's scalar encoding)."""
    le = from_mont(a, spec).contiguous().view(torch.uint8)
    return le.flip(-1) if big_endian else le
