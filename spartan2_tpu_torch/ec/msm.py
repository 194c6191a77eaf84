"""Windowed MSMs over runtime points: kernels 5 and C (csrc/msm.cu) and
their plain version; and the masked sum, the per-lane double-and-add and
the host-scalar multiple of affine points (csrc/msm.cu's other entries)
with theirs.

sum_i s_i * Q_i for points known only at run time, such as the row
commitments a Hyrax verifier folds (kernel 5: the JAX package's
DeviceCurve.msm, ec/device.py:398, reached through HyraxPCS._msm_auto),
and R such sums at once, one per row of I points (kernel C:
DeviceCurve.msm_rows, ec/device.py:424, which HyraxPCS.fold_commitments
uses to fold commitments row by row).  One launch an entry call: each
point's 16 multiples in four dependent steps (``msm_table_plain``); per
4-bit window the row's picked multiples summed by an adjacent-pair tree
over the points (across blocks for rows of more than GP points,
``msm_layout``); then an adjacent-pair ladder over the windows, P_j =
P_2j + 2^(4 2^l) P_2j+1, whose doublings a quad of lanes shares.  Its
longest chain: 255 doublings (a 256-bit scalar of a runtime point needs
them in sequence, the latency floor) and 7 + log2 I additions; its work,
microseconds at the card's multiply rate, is not what bounds it.  The
points may come from a proof, so every addition is complete.

The plain version follows the kernel's order of additions exactly, so
the kernel's Jacobian output equals it limb for limb; the block split of
a row does not change that order (an identity addend returns the other
point unchanged).

``msm_binary``, ``msm_points_per_lane`` and ``scalar_mul_host_base`` are
the JAX package's DeviceCurve functions of the same names (ec/device.py
:445, :468, :474).  They take affine Montgomery coordinates qx, qy of
shape (n, 8), never the identity, as JAX takes Qx, Qy, and return
Jacobian Montgomery points.  No prove path calls them.
"""

from __future__ import annotations

import torch

from ..errors import InvalidCommitmentLengthError
from ..field import ops
from ..field.limbs import to_device
from ..utils.cuda import CudaKernel, I, P, check_cuda
from .comb import (_inf_like, _sel, curve_words, pt_add, pt_add_mixed, pt_dbl, pt_dbl_n,
                   row_sum_plain, scalar_digits, to_affine)
from .curve import Affine, CurveSpec

MSM = CudaKernel("msm", {"sp2_msm": [I, I, I, P, P, P, P, P, P],
                         "sp2_msm_rows": [I, I, I, I, P, P, P, P, P, P],
                         "sp2_msm_binary": [I, P, P, P, P, P, P],
                         "sp2_msm_per_lane": [I, I, P, P, P, P, P],
                         "sp2_scalar_mul_base": [I, I, P, P, P, P, P]})

MSM_WINDOW_BITS = 4
FULL_BITS = 256
# Below this many points the host Pippenger serves, as in the JAX
# package's _msm_auto (pcs/hyrax.py:674).
MSM_MIN_POINTS = 64
BIN_LANES = 256  # lanes a block of msm_binary sums (csrc/msm.cu)
MSM_THREADS = 256  # threads of a block of the windowed MSM at most (csrc/msm.cu MSM_NT)
MSM_GROUP_MAX = 8  # points of a row a block takes at most (csrc/msm.cu)


def msm_windows(nbits: int) -> int:
    return max(1, -(-nbits // MSM_WINDOW_BITS))


def _log2_ceil(n: int) -> int:
    return (n - 1).bit_length()


def msm_layout(npts: int, n_win: int) -> tuple[int, int, int]:
    """(log2 GP, ng, levels) of csrc/msm.cu's kernel for rows of ``npts``
    points: a block takes GP points (a power of two, at most
    MSM_GROUP_MAX, and NW * GP <= MSM_THREADS for NW = 2^ceil(log2
    n_win) windows), a row ng blocks, joined by a tree of ``levels``."""
    gp = min(1 << _log2_ceil(npts), MSM_GROUP_MAX, MSM_THREADS >> _log2_ceil(n_win))
    ng = -(-npts // gp)
    return gp.bit_length() - 1, ng, _log2_ceil(ng)


def _pad(pts: torch.Tensor, dim: int, size: int, curve: CurveSpec) -> torch.Tensor:
    """``pts`` (..., 3, 8) padded with the identity along ``dim`` to ``size``."""
    extra = size - pts.shape[dim]
    if extra == 0:
        return pts
    shape = list(pts.shape)
    shape[dim] = extra
    return torch.cat([pts, _inf_like(torch.empty(shape, device=pts.device), curve)], dim)


def msm_table_plain(points: torch.Tensor, curve: CurveSpec) -> torch.Tensor:
    """(..., 3, 8) -> (16, ..., 3, 8) multiples d Q, d < 16, in the
    kernel's four steps: 2Q = dbl Q; 3Q = 2Q + Q, 4Q = dbl 2Q; 5Q..7Q = 4Q
    + (Q..3Q), 8Q = dbl 4Q; 9Q..15Q = 8Q + (Q..7Q)."""
    t = [_inf_like(points, curve), points, pt_dbl(points, curve)]
    t += [pt_add(t[2], t[1], curve), pt_dbl(t[2], curve)]
    t += list(pt_add(t[4], torch.stack(t[1:4]), curve).unbind(0)) + [pt_dbl(t[4], curve)]
    t += list(pt_add(t[8], torch.stack(t[1:8]), curve).unbind(0))
    return torch.stack(t)


def msm_rows_plain(scalars: torch.Tensor, points: torch.Tensor, curve: CurveSpec,
                   nbits: int = FULL_BITS) -> torch.Tensor:
    """Plain version of ``msm_rows``, in the kernel's order: each point's
    table (``msm_table_plain``); per row and window the picked multiples
    (the identity for a zero digit) summed by the adjacent-pair tree over
    the row's points padded with the identity to a power of two; then the
    windows, padded to a power of two, joined by the adjacent-pair ladder
    P_j = P_2j + 2^(4 2^l) P_2j+1 at level l."""
    R, n = points.shape[:2]
    n_win = msm_windows(nbits)
    table = msm_table_plain(points, curve)  # (16, R, n, 3, 8)
    d = scalar_digits(scalars, n_win, MSM_WINDOW_BITS)  # (n_win, R, n)
    r_idx = torch.arange(R, device=points.device)[:, None]
    i_idx = torch.arange(n, device=points.device)
    picked = table[d, r_idx, i_idx]  # (n_win, R, n, 3, 8); table[0] is the identity
    picked = _pad(picked, 2, 1 << _log2_ceil(n), curve)
    while picked.shape[2] > 1:
        picked = pt_add(picked[:, :, 0::2], picked[:, :, 1::2], curve)
    acc = _pad(picked[:, :, 0], 0, 1 << _log2_ceil(n_win), curve)  # (NW, R, 3, 8)
    shift = MSM_WINDOW_BITS
    while acc.shape[0] > 1:
        acc = pt_add(acc[0::2], pt_dbl_n(acc[1::2], shift, curve), curve)
        shift *= 2
    return acc[0]


def _launch(entry: str, scalars: torch.Tensor, points: torch.Tensor,
            curve: CurveSpec, nbits: int) -> torch.Tensor:
    check_cuda(scalars, points)
    R, n = points.shape[:2]
    if n == 0 or scalars.shape != (R, n, 8) or points.shape != (R, n, 3, 8):
        raise ValueError("msm_rows: scalars (R, I, 8) and points (R, I, 3, 8), I > 0")
    if not 0 <= nbits <= FULL_BITS:
        raise ValueError("msm_rows: 0 <= nbits <= 256")
    dev = points.device
    n_win = msm_windows(nbits)
    lg, ng, levels = msm_layout(n, n_win)
    part = torch.empty(R * ng << _log2_ceil(n_win), 3, 8, dtype=torch.int32, device=dev)
    counters = torch.zeros(max(1, R * levels * ng), dtype=torch.int32, device=dev)
    out = torch.empty(R, 3, 8, dtype=torch.int32, device=dev)
    args = (n_win, lg, scalars.data_ptr(), points.data_ptr(), part.data_ptr(),
            counters.data_ptr(), out.data_ptr(), curve_words(curve))
    if entry == "sp2_msm":
        MSM.call(entry, n, *args)
    else:
        MSM.call(entry, R, n, *args)
    return out


def msm_rows(scalars: torch.Tensor, points: torch.Tensor, curve: CurveSpec,
             nbits: int = FULL_BITS) -> torch.Tensor:
    """Kernel C: (R, I, 8) canonical scalars below 2^nbits and (R, I, 3, 8)
    Jacobian Montgomery points -> (R, 3, 8) Jacobian row sums
    sum_i scalars[r, i] * points[r, i]."""
    if points.device.type == "cpu":
        return msm_rows_plain(scalars, points, curve, nbits)
    return _launch("sp2_msm_rows", scalars, points, curve, nbits)


def msm_plain(scalars: torch.Tensor, points: torch.Tensor, curve: CurveSpec,
              nbits: int = FULL_BITS) -> torch.Tensor:
    """Plain version of ``msm``."""
    return msm_rows_plain(scalars[None], points[None], curve, nbits)[0]


def msm(scalars: torch.Tensor, points: torch.Tensor, curve: CurveSpec,
        nbits: int = FULL_BITS) -> torch.Tensor:
    """Kernel 5: (n, 8) canonical scalars below 2^nbits and (n, 3, 8)
    Jacobian Montgomery points -> (3, 8) Jacobian sum_i scalars[i] *
    points[i]."""
    if points.device.type == "cpu":
        return msm_plain(scalars, points, curve, nbits)
    return _launch("sp2_msm", scalars[None], points[None], curve, nbits)[0]


def to_jacobian(points: list[Affine], curve: CurveSpec, device) -> torch.Tensor:
    """Affine points (None for the identity) -> (n, 3, 8) Jacobian
    Montgomery tensor with Z = 1 (Z = 0 for the identity)."""
    F = curve.base
    xs = [pt[0] if pt else 1 for pt in points]
    ys = [pt[1] if pt else 1 for pt in points]
    zs = [1 if pt else 0 for pt in points]
    return torch.stack([to_device(v, F, device, mont=True) for v in (xs, ys, zs)], 1)


def msm_points(scalars: list[int], points: list[Affine], curve: CurveSpec,
               device) -> Affine:
    """sum_i scalars[i] * points[i] over runtime points: the host
    Pippenger below MSM_MIN_POINTS points, else kernel 5 on ``device``
    with no more windows than the largest scalar needs."""
    if len(scalars) != len(points):
        raise InvalidCommitmentLengthError(
            f"msm: {len(scalars)} scalars for {len(points)} points")
    if len(scalars) < MSM_MIN_POINTS:
        return curve.msm(scalars, points)
    q = curve.scalar.modulus
    scalars = [s % q for s in scalars]
    sc = to_device(scalars, curve.scalar, device)
    jac = msm(sc, to_jacobian(points, curve, device), curve,
              max(scalars).bit_length())
    return to_affine(jac.reshape(1, 3, 8), curve)[0]


# ---------------------------------------------------------------------------
# msm_binary, msm_points_per_lane, scalar_mul_host_base
# ---------------------------------------------------------------------------


def _check_affine(qx: torch.Tensor, qy: torch.Tensor) -> int:
    n = qx.shape[0]
    if n < 1 or qx.shape != (n, 8) or qy.shape != (n, 8):
        raise ValueError("points: qx and qy of shape (n, 8), n > 0")
    return n


def _affine_jac(qx: torch.Tensor, qy: torch.Tensor, curve: CurveSpec) -> torch.Tensor:
    one = ops.const(1, curve.base, qx.shape[:-1], qx.device)
    return torch.stack([qx, qy, one], -2)


def msm_binary_plain(bits: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                     curve: CurveSpec) -> torch.Tensor:
    """Plain version of ``msm_binary``: the selected points padded with the
    identity to blocks of BIN_LANES, each block's sum, then the blocks'."""
    n = _check_affine(qx, qy)
    lanes = _affine_jac(qx, qy, curve)
    lanes = _sel(bits == 1, lanes, _inf_like(lanes, curve))
    blocks = -(-n // BIN_LANES)
    pad = _inf_like(torch.empty(blocks * BIN_LANES - n, 3, 8, device=qx.device), curve)
    lanes = torch.cat([lanes, pad]).reshape(blocks, BIN_LANES, 3, 8)
    return row_sum_plain(row_sum_plain(lanes, curve)[None], curve)[0]


def msm_binary(bits: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
               curve: CurveSpec) -> torch.Tensor:
    """sum_i [bits[i] == 1] (qx[i], qy[i]) -> (3, 8) Jacobian (JAX
    DeviceCurve.msm_binary): bits (n,) int32, a masked tree sum of
    complete additions, the identity when no bit is set."""
    if qx.device.type == "cpu":
        return msm_binary_plain(bits, qx, qy, curve)
    n = _check_affine(qx, qy)
    check_cuda(bits, qx, qy)
    if bits.shape != (n,):
        raise ValueError("msm_binary: bits (n,) for n points")
    partial = torch.empty(-(-n // BIN_LANES), 3, 8, dtype=torch.int32, device=qx.device)
    out = torch.empty(3, 8, dtype=torch.int32, device=qx.device)
    MSM.call("sp2_msm_binary", n, bits.data_ptr(), qx.data_ptr(), qy.data_ptr(),
             partial.data_ptr(), out.data_ptr(), curve_words(curve))
    return out


def msm_points_per_lane_plain(scalars: torch.Tensor, qx: torch.Tensor,
                              qy: torch.Tensor, curve: CurveSpec,
                              nbits: int = FULL_BITS) -> torch.Tensor:
    """Plain version of ``msm_points_per_lane``."""
    _check_affine(qx, qy)
    u = scalars.to(torch.int64) & 0xFFFFFFFF
    acc = _inf_like(_affine_jac(qx, qy, curve), curve)
    for b in range(nbits - 1, -1, -1):
        acc = pt_dbl(acc, curve)
        bit = ((u[:, b // 32] >> (b % 32)) & 1) == 1
        acc = _sel(bit, pt_add_mixed(acc, qx, qy, curve), acc)
    return acc


def msm_points_per_lane(scalars: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                        curve: CurveSpec, nbits: int = FULL_BITS) -> torch.Tensor:
    """s_i (qx[i], qy[i]) in each lane -> (n, 3, 8) Jacobian, no reduction
    (JAX DeviceCurve.msm_points_per_lane): scalars (n, 8) canonical below
    2^nbits, a left-to-right double-and-add over nbits <= 256 bits with a
    complete mixed addition, one thread per lane."""
    if not 0 <= nbits <= FULL_BITS:
        raise ValueError("msm_points_per_lane: 0 <= nbits <= 256")
    if qx.device.type == "cpu":
        return msm_points_per_lane_plain(scalars, qx, qy, curve, nbits)
    n = _check_affine(qx, qy)
    check_cuda(scalars, qx, qy)
    if scalars.shape != (n, 8):
        raise ValueError("msm_points_per_lane: scalars (n, 8) for n points")
    out = torch.empty(n, 3, 8, dtype=torch.int32, device=qx.device)
    MSM.call("sp2_msm_per_lane", n, nbits, scalars.data_ptr(), qx.data_ptr(),
             qy.data_ptr(), out.data_ptr(), curve_words(curve))
    return out


def scalar_mul_host_base_plain(k: int, qx: torch.Tensor, qy: torch.Tensor,
                               curve: CurveSpec) -> torch.Tensor:
    """Plain version of ``scalar_mul_host_base``: ``msm_points_per_lane_plain``
    with k in every lane, over the bit length of k."""
    k %= curve.scalar.modulus
    scalars = to_device([k], curve.scalar, qx.device).expand(qx.shape[0], 8)
    return msm_points_per_lane_plain(scalars, qx, qy, curve, k.bit_length())


def scalar_mul_host_base(k: int, qx: torch.Tensor, qy: torch.Tensor,
                         curve: CurveSpec) -> torch.Tensor:
    """k (qx[i], qy[i]) for one host scalar k (reduced mod q) -> (n, 3, 8)
    Jacobian (JAX DeviceCurve.scalar_mul_host_base): the per-lane
    double-and-add of ``msm_points_per_lane`` with k passed by value to
    every lane (entry sp2_scalar_mul_base) over the bit length of k."""
    if qx.device.type == "cpu":
        return scalar_mul_host_base_plain(k, qx, qy, curve)
    n = _check_affine(qx, qy)
    check_cuda(qx, qy)
    k %= curve.scalar.modulus
    out = torch.empty(n, 3, 8, dtype=torch.int32, device=qx.device)
    MSM.call("sp2_scalar_mul_base", n, k.bit_length(), k.to_bytes(32, "little"),
             qx.data_ptr(), qy.data_ptr(), out.data_ptr(), curve_words(curve))
    return out
