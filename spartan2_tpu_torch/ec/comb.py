"""Fixed-base comb MSM over static generators: kernel 3 (csrc/comb.cu)
and its plain version.

Each row MSM sum_j v[row, j] * G_j splits every scalar into 6-bit
digits and adds one precomputed point T[w][d][j] = (d * 2^(6w)) * G_j per
window, then sums the row's columns (the reference's FixedBaseMul,
msm.rs:637-774; the JAX package's ec/comb.py).  Points are Jacobian
(..., 3, 8) int32 tensors over the base field in Montgomery form, Z = 0
for the identity.  Every addition is complete.

The plain versions follow the kernels' order of additions exactly, so a
kernel's Jacobian output equals its plain version's limb for limb.
"""

from __future__ import annotations

import torch

from ..field import ops
from ..field.limbs import limbs_to_ints, to_device
from ..utils.cuda import CudaKernel, I, P, check_cuda, field_words
from .curve import Affine, CurveSpec

COMB = CudaKernel("comb", {
    "sp2_comb_build": [I, I, P, P, P, P],
    "sp2_comb_rows": [I, I, I, I, P, P, P, P, P],
})

WINDOW_BITS = 6
DIGITS = 1 << WINDOW_BITS
_SUM_NT = 128  # threads of a block sum (csrc/curve.cuh SUM_NT)


def n_windows(nbits: int) -> int:
    return -(-nbits // WINDOW_BITS)


def curve_words(curve: CurveSpec) -> bytes:
    """Base-field words followed by a in Montgomery form (csrc/curve.cuh)."""
    F = curve.base
    return field_words(F) + F.to_mont(curve.a % F.modulus).to_bytes(32, "little")


# ---------------------------------------------------------------------------
# plain group law (same formulas and branches as csrc/curve.cuh)
# ---------------------------------------------------------------------------


def _is_zero(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(-1)


def _inf_like(P: torch.Tensor, curve: CurveSpec) -> torch.Tensor:
    one = ops.const(1, curve.base, P.shape[:-2], P.device)
    return torch.stack([one, one, torch.zeros_like(one)], -2)


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None, None], a, b)


def pt_dbl(P: torch.Tensor, curve: CurveSpec) -> torch.Tensor:
    F = curve.base
    mul, add, sub = (lambda a, b: ops.mont_mul(a, b, F),
                     lambda a, b: ops.add(a, b, F), lambda a, b: ops.sub(a, b, F))
    X, Y, Z = P.unbind(-2)
    a = ops.const(curve.a, F, device=P.device)
    XX, YY, ZZ = mul(X, X), mul(Y, Y), mul(Z, Z)
    t = mul(X, YY)
    t = add(t, t)
    S = add(t, t)
    M = add(add(add(XX, XX), XX), mul(a.expand_as(ZZ), mul(ZZ, ZZ)))
    X3 = sub(mul(M, M), add(S, S))
    y4 = mul(YY, YY)
    y4 = add(y4, y4)
    y4 = add(y4, y4)
    y4 = add(y4, y4)
    Y3 = sub(mul(M, sub(S, X3)), y4)
    yz = mul(Y, Z)
    R = torch.stack([X3, Y3, add(yz, yz)], -2)
    return _sel(_is_zero(Z) | _is_zero(Y), _inf_like(P, curve), R)


# A CPU batch of at most this many points runs the group law in Python
# integers, converted once: a batched field operation on a few points costs
# more in conversions than in arithmetic.  The same formulas and branches,
# so the same limbs (tests/test_torch_ec.py runs both paths).  The two
# paths' CPU times cross between 4096 and 8192 points a batch for an
# addition and four doublings a point; the threshold sits at the lower end.
_INT_POINTS = 4096


def _int_path(*pts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in pts) and pts[0][..., 0, 0].numel() <= _INT_POINTS


def _to_ints(P: torch.Tensor) -> list:
    raw = P.contiguous().numpy().tobytes()
    v = [int.from_bytes(raw[i : i + 32], "little") for i in range(0, len(raw), 32)]
    return [v[i : i + 3] for i in range(0, len(v), 3)]


def _from_ints(pts: list, shape) -> torch.Tensor:
    data = bytearray(b"".join(c.to_bytes(32, "little") for pt in pts for c in pt))
    return torch.frombuffer(data, dtype=torch.int32).reshape(shape)


def _int_curve(curve: CurveSpec) -> tuple:
    """(p, 2^-256 mod p, a and 1 in Montgomery form)."""
    F = curve.base
    p = F.modulus
    return p, pow(1 << 256, -1, p), F.to_mont(curve.a % p), F.to_mont(1)


def _dbl_int(X: int, Y: int, Z: int, c: tuple) -> list:
    p, ri, a, one = c
    if Z == 0 or Y == 0:
        return [one, one, 0]
    XX, YY, ZZ = X * X * ri % p, Y * Y * ri % p, Z * Z * ri % p
    S = 4 * X * YY * ri % p
    M = (3 * XX + a * (ZZ * ZZ * ri % p) * ri) % p
    X3 = (M * M * ri - 2 * S) % p
    return [X3, (M * (S - X3) * ri - 8 * (YY * YY * ri % p)) % p, 2 * Y * Z * ri % p]


def _add_int(P: list, Q: list, c: tuple) -> list:
    p, ri, _, one = c
    (X1, Y1, Z1), (X2, Y2, Z2) = P, Q
    if Z1 == 0:
        return Q
    if Z2 == 0:
        return P
    Z1Z1, Z2Z2 = Z1 * Z1 * ri % p, Z2 * Z2 * ri % p
    U1, U2 = X1 * Z2Z2 * ri % p, X2 * Z1Z1 * ri % p
    S1 = Y1 * (Z2 * Z2Z2 * ri % p) * ri % p
    S2 = Y2 * (Z1 * Z1Z1 * ri % p) * ri % p
    H, Rr = (U2 - U1) % p, (S2 - S1) % p
    if H == 0:
        return _dbl_int(X1, Y1, Z1, c) if Rr == 0 else [one, one, 0]
    HH = H * H * ri % p
    HHH, V = H * HH * ri % p, U1 * HH * ri % p
    X3 = (Rr * Rr * ri - HHH - 2 * V) % p
    return [X3, (Rr * (V - X3) * ri - S1 * HHH * ri) % p, (Z1 * Z2 * ri % p) * H * ri % p]


def pt_dbl_n(P: torch.Tensor, k: int, curve: CurveSpec) -> torch.Tensor:
    """k doublings of P (``pt_dbl`` k times, the same limbs)."""
    if not _int_path(P):
        for _ in range(k):
            P = pt_dbl(P, curve)
        return P
    c = _int_curve(curve)
    out = []
    for pt in _to_ints(P):
        for _ in range(k):
            pt = _dbl_int(*pt, c)
        out.append(pt)
    return _from_ints(out, P.shape)


def pt_add(P: torch.Tensor, Q: torch.Tensor, curve: CurveSpec) -> torch.Tensor:
    F = curve.base
    mul, add, sub = (lambda a, b: ops.mont_mul(a, b, F),
                     lambda a, b: ops.add(a, b, F), lambda a, b: ops.sub(a, b, F))
    P, Q = torch.broadcast_tensors(P, Q)
    if _int_path(P, Q):
        c = _int_curve(curve)
        return _from_ints([_add_int(a, b, c) for a, b in zip(_to_ints(P), _to_ints(Q))],
                          P.shape)
    X1, Y1, Z1 = P.unbind(-2)
    X2, Y2, Z2 = Q.unbind(-2)
    Z1Z1, Z2Z2 = mul(Z1, Z1), mul(Z2, Z2)
    U1, U2 = mul(X1, Z2Z2), mul(X2, Z1Z1)
    S1, S2 = mul(Y1, mul(Z2, Z2Z2)), mul(Y2, mul(Z1, Z1Z1))
    H, Rr = sub(U2, U1), sub(S2, S1)
    HH = mul(H, H)
    HHH = mul(H, HH)
    V = mul(U1, HH)
    X3 = sub(sub(mul(Rr, Rr), HHH), add(V, V))
    Y3 = sub(mul(Rr, sub(V, X3)), mul(S1, HHH))
    Z3 = mul(mul(Z1, Z2), H)
    out = torch.stack([X3, Y3, Z3], -2)
    h0, r0 = _is_zero(H), _is_zero(Rr)
    if bool((h0 & r0).any()):
        out = _sel(h0 & r0, pt_dbl(P, curve), out)
    out = _sel(h0 & ~r0, _inf_like(P, curve), out)
    out = _sel(_is_zero(Z2), P, out)
    return _sel(_is_zero(Z1), Q, out)


def pt_add_mixed(P: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                 curve: CurveSpec) -> torch.Tensor:
    """P + (qx, qy), the second point affine and never the identity;
    complete, with the formulas and branches of csrc/curve.cuh pt_add_mixed."""
    F = curve.base
    mul, add, sub = (lambda a, b: ops.mont_mul(a, b, F),
                     lambda a, b: ops.add(a, b, F), lambda a, b: ops.sub(a, b, F))
    X1, Y1, Z1 = P.unbind(-2)
    Z1Z1 = mul(Z1, Z1)
    U2 = mul(qx, Z1Z1)
    S2 = mul(qy, mul(Z1, Z1Z1))
    H, Rr = sub(U2, X1), sub(S2, Y1)
    HH = mul(H, H)
    HHH = mul(H, HH)
    V = mul(X1, HH)
    X3 = sub(sub(mul(Rr, Rr), HHH), add(V, V))
    Y3 = sub(mul(Rr, sub(V, X3)), mul(Y1, HHH))
    out = torch.stack([X3, Y3, mul(Z1, H)], -2)
    h0, r0 = _is_zero(H), _is_zero(Rr)
    if bool((h0 & r0).any()):
        out = _sel(h0 & r0, pt_dbl(P, curve), out)
    out = _sel(h0 & ~r0, _inf_like(P, curve), out)
    one = ops.const(1, F, qx.shape[:-1], qx.device)
    return _sel(_is_zero(Z1), torch.stack([qx, qy, one], -2), out)


def to_affine(pts: torch.Tensor, curve: CurveSpec) -> list[Affine]:
    """(n, 3, 8) Jacobian Montgomery points -> host affine points."""
    flat = limbs_to_ints(pts.reshape(-1, 8), curve.base, mont=True)
    return [curve.to_affine(tuple(flat[3 * i : 3 * i + 3]))
            for i in range(len(flat) // 3)]


# ---------------------------------------------------------------------------
# comb_build
# ---------------------------------------------------------------------------


def comb_build_plain(gx: torch.Tensor, gy: torch.Tensor, n_win: int,
                     curve: CurveSpec) -> torch.Tensor:
    """Plain version of ``comb_build``, in its order: each window's base by
    six doublings of the one before, then T[d] = T[d - 1] + B_w."""
    one = ops.const(1, curve.base, gx.shape[:-1], gx.device)
    B = torch.stack([gx, gy, one], -2)  # (C, 3, 8)
    bases = [B]
    for _ in range(1, n_win):
        B = pt_dbl_n(B, WINDOW_BITS, curve)
        bases.append(B)
    B = torch.stack(bases)  # (n_win, C, 3, 8)
    rows = [_inf_like(B, curve), B]
    acc = B
    for _ in range(2, DIGITS):
        acc = pt_add(acc, B, curve)
        rows.append(acc)
    return torch.stack(rows, 1).contiguous()  # (n_win, 64, C, 3, 8)


def comb_build(gx: torch.Tensor, gy: torch.Tensor, n_win: int,
               curve: CurveSpec) -> torch.Tensor:
    """Tables T[w][d][j] = (d * 2^(6w)) * G_j as (n_win, 64, C, 3, 8) from
    (C, 8) Montgomery affine generator coordinates."""
    if gx.device.type == "cpu":
        return comb_build_plain(gx, gy, n_win, curve)
    check_cuda(gx, gy)
    C = gx.shape[0]
    if gx.shape != (C, 8) or gy.shape != (C, 8):
        raise ValueError("comb_build: generator coordinates must be (C, 8)")
    table = torch.empty(n_win, DIGITS, C, 3, 8, dtype=torch.int32,
                        device=gx.device)
    COMB.call("sp2_comb_build", n_win, C, gx.data_ptr(), gy.data_ptr(),
              table.data_ptr(), curve_words(curve))
    return table


# ---------------------------------------------------------------------------
# comb_rows
# ---------------------------------------------------------------------------


def scalar_digits(scal: torch.Tensor, n_win: int,
                  bits: int = WINDOW_BITS) -> torch.Tensor:
    """(..., 8) canonical scalars -> (n_win, ...) digits of ``bits`` bits,
    lowest window first."""
    u = scal.to(torch.int64) & 0xFFFFFFFF
    out = []
    for w in range(n_win):
        bit = bits * w
        limb, sh = bit // 32, bit % 32
        v = u[..., limb]
        if limb + 1 < 8:
            v = v | (u[..., limb + 1] << 32)
        out.append((v >> sh) & ((1 << bits) - 1))
    return torch.stack(out)


def row_sum_plain(pts: torch.Tensor, curve: CurveSpec) -> torch.Tensor:
    """(R, C, 3, 8) -> (R, 3, 8) row sums in the order of the kernels'
    block sum (csrc/curve.cuh block_pt_sum): thread t adds columns t,
    t + 128, ... in order, then a halving tree over the 128 threads.
    With C < 128 the threads past the next power of two of C hold the
    identity, and an addition of the identity returns the other operand
    unchanged, so the tree starts at that width: the same limbs."""
    R, C = pts.shape[:2]
    nt = min(_SUM_NT, 1 << max(C - 1, 0).bit_length())
    k = -(-C // nt)
    if k * nt > C:
        pad = _inf_like(torch.empty(R, k * nt - C, 3, 8, device=pts.device), curve)
        pts = torch.cat([pts, pad], 1)
    pts = pts.reshape(R, k, nt, 3, 8)
    part = pts[:, 0]  # the identity plus a point is that point, limb for limb
    for i in range(1, k):
        part = pt_add(part, pts[:, i], curve)
    s = nt // 2
    while s:
        part = torch.cat([pt_add(part[:, :s], part[:, s : 2 * s], curve),
                          part[:, s:]], 1)
        s //= 2
    return part[:, 0].contiguous()


# Tables of at most this many windows (scalars below 2^66: the witness
# commits) hold mostly zero digits, which cost a branch where a tree level
# costs a complete addition: their threads take at least _SPARSE_CHAIN points.
_SPARSE_WINDOWS = 11
_SPARSE_CHAIN = 32


def comb_chain(C: int, n_win: int) -> int:
    """Points a thread of the comb kernel's first pass adds before the
    block tree (csrc/comb.cu): enough that a row of n_win * C points makes
    at most 128 block partials, and at least 32 on short-scalar tables.  A
    function of (C, n_win) alone, never of the row count."""
    k = -(-n_win * C // (_SUM_NT * _SUM_NT))
    return max(k, _SPARSE_CHAIN) if n_win <= _SPARSE_WINDOWS else k


def comb_parts(C: int, n_win: int) -> int:
    """Block partials of a row of n_win * C comb points (csrc/comb.cu)."""
    return -(-n_win * C // (_SUM_NT * comb_chain(C, n_win)))


def comb_points(scalars: torch.Tensor, table: torch.Tensor,
                curve: CurveSpec) -> torch.Tensor:
    """(R, C, 8) scalars -> (R, n_win * C, 3, 8): point w * C + j of row r
    is T[w][d_{r,j,w}][j], the identity where the digit is 0."""
    R, C = scalars.shape[:2]
    n_win = table.shape[0]
    d = scalar_digits(scalars, n_win)  # (n_win, R, C)
    w = torch.arange(n_win, device=scalars.device)[:, None, None]
    col = torch.arange(C, device=scalars.device)
    pts = table[w, d, col]  # (n_win, R, C, 3, 8)
    pts = _sel(d == 0, _inf_like(pts, curve), pts)
    return pts.transpose(0, 1).reshape(R, n_win * C, 3, 8)


# comb points a chunk of rows of the plain version holds, on the CPU and on
# a card (where each batched addition costs a fixed ~0.1 s of launches)
_PLAIN_POINTS = {"cpu": 1 << 18, "cuda": 1 << 23}


def comb_rows_plain(scalars: torch.Tensor, table: torch.Tensor,
                    curve: CurveSpec) -> torch.Tensor:
    """Plain version of ``comb_rows``, in the kernel's order: a row's
    points in blocks of 128 k (the identity past the row's end), each
    block summed as ``row_sum_plain`` sums a row of 128 k columns, then
    the row's partials the same way; with one partial, that partial.  Rows
    go in chunks, which changes nothing: each row's sum is its own."""
    R, C = scalars.shape[:2]
    n_win = table.shape[0]
    n, parts = n_win * C, comb_parts(C, n_win)
    span = _SUM_NT * comb_chain(C, n_win)
    step = max(1, _PLAIN_POINTS[scalars.device.type] // n)
    out = []
    for sc in scalars.split(step):
        pts = comb_points(sc, table, curve)
        if parts == 1:
            out.append(row_sum_plain(pts, curve))
            continue
        r = sc.shape[0]
        if parts * span > n:
            tail = _inf_like(torch.empty(r, parts * span - n, 3, 8, device=sc.device),
                             curve)
            pts = torch.cat([pts, tail], 1)
        part = row_sum_plain(pts.reshape(r * parts, span, 3, 8), curve)
        out.append(row_sum_plain(part.reshape(r, parts, 3, 8), curve))
    return torch.cat(out) if out else torch.empty(0, 3, 8, dtype=torch.int32,
                                                  device=scalars.device)


def comb_rows(scalars: torch.Tensor, table: torch.Tensor,
              curve: CurveSpec) -> torch.Tensor:
    """(R, C, 8) canonical scalars -> (R, 3, 8) Jacobian row sums
    sum_j scalars[r, j] * G_j (scalars below 2^(6 n_win))."""
    if scalars.device.type == "cpu":
        return comb_rows_plain(scalars, table, curve)
    check_cuda(scalars, table)
    R, C = scalars.shape[:2]
    if (scalars.shape != (R, C, 8) or table.dim() != 5
            or table.shape[1:] != (DIGITS, C, 3, 8)):
        raise ValueError("comb_rows: scalars (R, C, 8) and a (n_win, 64, C, 3, 8) table")
    n_win = table.shape[0]
    parts = comb_parts(C, n_win)
    scratch = torch.empty(R * parts if parts > 1 else 0, 3, 8, dtype=torch.int32,
                          device=scalars.device)
    out = torch.empty(R, 3, 8, dtype=torch.int32, device=scalars.device)
    if R:
        COMB.call("sp2_comb_rows", R, C, n_win, comb_chain(C, n_win), scalars.data_ptr(),
                  table.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                  curve_words(curve))
    return out


class FixedBaseComb:
    """Comb tables over one static generator vector, on one device."""

    def __init__(self, curve: CurveSpec, gens: list, nbits: int, device):
        self.curve = curve
        self.C = len(gens)
        self.n_win = n_windows(nbits)
        gx = to_device([g[0] for g in gens], curve.base, device, mont=True)
        gy = to_device([g[1] for g in gens], curve.base, device, mont=True)
        self.table = comb_build(gx, gy, self.n_win, curve)

    def rows_msm(self, scalars: torch.Tensor) -> torch.Tensor:
        """(R, C, 8) canonical scalars -> (R, 3, 8) Jacobian row sums."""
        return comb_rows(scalars, self.table, self.curve)

