"""Small-value integers for NeutronNova's NIFS round 0: the gate and the
plain integer arithmetic of kernel 4 (csrc/nifs.cu).

Reference: src/big_num/small_value.rs:33-222 (the i64/i128 arithmetic
that src/neutronnova_zk.rs:246-314 and :1550-1560 use), through the JAX
package's field/small_value.py.  When every Az, Bz, Cz entry of the
NIFS grid has a small signed representative, round 0's sums run as exact
integer products with one modular reduction per sum instead of a
Montgomery product per entry.

The gate is the JAX package's predicate (``to_small_planes``): an entry
v (canonical, in [0, p)) is small when v < 2^72 or p - v < 2^72, and its
representative is then v or v - p.  The gate is whole-grid: one ``ok``
flag; if any entry is outside the window, round 0 runs on the Montgomery
grid (kernel 3) instead, as in the JAX package.  2^72 is wider than the
reference's 2^62 SMALL_VALUE_MAX (small_value.rs:21-31); the sums are
exact at either width.

The port's layout is its own (the JAX package's 12-bit planes are a TPU
layout): an entry is 4 int32 words, the magnitude in words 0-2
(little-endian, below 2^72) and the sign in word 3 (1 for negative);
entries outside the window are all zeros.  The plain versions below work
on 16-bit digits in int64 and are exact.
"""

from __future__ import annotations

import torch

from . import ops
from .constants import FieldSpec

SMALL_BITS = 72
_D = 16  # bits per digit of the plain arithmetic


def _window(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) canonical limbs -> (...) bool: value below 2^72."""
    hi = (x[..., 3:] != 0).any(-1)
    w2 = x[..., 2].to(torch.int64) & 0xFFFFFFFF
    return ~hi & (w2 < (1 << (SMALL_BITS - 64)))


def to_small_plain(x: torch.Tensor, spec: FieldSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 4's conversion: (..., 8) Montgomery ->
    ((..., 4) small entries, (...) bool in-window)."""
    v = ops.from_mont(x, spec)
    ng = ops.sub(torch.zeros_like(v), v, spec)
    pos, neg = _window(v), _window(ng)
    out = torch.zeros(*x.shape[:-1], 4, dtype=torch.int32, device=x.device)
    out[..., :3] = torch.where(pos[..., None], v[..., :3],
                               torch.where(neg[..., None], ng[..., :3],
                                           torch.zeros_like(v[..., :3])))
    out[..., 3] = (~pos & neg).to(torch.int32)
    return out, pos | neg


def _signed_digits(S: torch.Tensor) -> torch.Tensor:
    """(..., 4) small entries -> (6, ...) int64 signed 16-bit digits (every
    digit carries the entry's sign)."""
    u = (S[..., :3].to(torch.int64) & 0xFFFFFFFF).movedim(-1, 0)
    d = torch.stack((u & 0xFFFF, u >> 16), 1).reshape(6, *S.shape[:-1])
    sign = 1 - 2 * S[..., 3].to(torch.int64)
    return d * sign


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product columns of two digit vectors, (Ka, ...) x (Kb, ...) ->
    (Ka + Kb - 1, ...) (the JAX package's conv_cols)."""
    t = torch.zeros(a.shape[0] + b.shape[0] - 1, *(a[0] * b[0]).shape,
                    dtype=torch.int64, device=a.device)
    for i in range(a.shape[0]):
        t[i : i + b.shape[0]] += a[i] * b
    return t


def _carry_signed(t: torch.Tensor, ncols: int) -> torch.Tensor:
    """Signed columns -> ncols columns, all but the last in [0, 2^16)
    (>> floors, so the top column keeps the sign)."""
    t = torch.cat([t, torch.zeros(ncols - t.shape[0], *t.shape[1:],
                                  dtype=t.dtype, device=t.device)])
    for i in range(ncols - 1):
        c = t[i] >> _D
        t[i] -= c << _D
        t[i + 1] += c
    return t


def _column_value(cols: list[int]) -> int:
    return sum(c << (_D * i) for i, c in enumerate(cols))


def small_round_plain(S: torch.Tensor, E: torch.Tensor, w: torch.Tensor,
                      spec: FieldSpec) -> torch.Tensor:
    """Plain version of kernel 4's round: S (3, I, n, 4) small entries of
    A, B, C; E (n, 8) and w (I / 2, 8) Montgomery.  -> (2, 8) plain
    [e0, quad] = sum_q w_q sum_k E_k (Ae Be - Ce), and the same of
    (Ao - Ae)(Bo - Be), over adjacent pairs q = (2q, 2q + 1), exactly."""
    p = spec.modulus
    A, B, C = (_signed_digits(S[j]) for j in range(3))  # (6, I, n)
    Ae, Ao, Be, Bo, Ce = A[:, 0::2], A[:, 1::2], B[:, 0::2], B[:, 1::2], C[:, 0::2]
    t0 = _conv(Ae, Be)
    t0[:6] -= Ce
    t1 = _conv(Ao - Ae, Bo - Be)
    Ed = ops.digits(ops.from_mont(E, spec))  # (16, n), canonical E
    wv = [spec.from_mont(x) for x in _ints(w)]
    out = []
    for t in (t0, t1):
        t = _carry_signed(t, 11)  # |t| < 2^147 < 2^160
        cols = _conv(t, Ed[:, None, :]).sum(-1)  # (26, pairs): sum over k
        total = sum(wq * _column_value(cols[:, q].tolist())
                    for q, wq in enumerate(wv)) % p
        out.append(total)
    return torch.stack([ops.const(v, spec, device=S.device, mont=False) for v in out])


def _ints(x: torch.Tensor) -> list[int]:
    """(n, 8) limbs -> raw 256-bit ints (no reduction, no conversion)."""
    return [sum((v & 0xFFFFFFFF) << (32 * i) for i, v in enumerate(row))
            for row in x.reshape(-1, 8).tolist()]
