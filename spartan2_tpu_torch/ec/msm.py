"""Windowed MSM over runtime points: kernel 5 (csrc/msm.cu) and its
plain version.

sum_i s_i * Q_i for points known only at run time, such as the row
commitments a Hyrax verifier folds (the JAX package's DeviceCurve.msm,
ec/device.py:398, reached through HyraxPCS._msm_auto).  Each point gets
a table of its 16 multiples, each 4-bit window sums one table entry per
point, and a Horner ladder of 4 doublings per window joins the window
sums.  The points may come from a proof, so every addition is complete.

The plain version follows the kernel's order of additions exactly, so
the kernel's Jacobian output equals it limb for limb.
"""

from __future__ import annotations

import torch

from ..errors import InvalidCommitmentLengthError
from ..field.limbs import to_device
from ..utils.cuda import CudaKernel, I, P, check_cuda
from .comb import (_inf_like, curve_words, pt_add, pt_dbl, row_sum_plain,
                   scalar_digits, to_affine)
from .curve import Affine, CurveSpec

MSM = CudaKernel("msm", {"sp2_msm": [I, I, P, P, P, P, P, P]})

MSM_WINDOW_BITS = 4
MSM_DIGITS = 1 << MSM_WINDOW_BITS
FULL_BITS = 256
# Below this many points the host Pippenger serves, as in the JAX
# package's _msm_auto (pcs/hyrax.py:674).
MSM_MIN_POINTS = 64


def msm_windows(nbits: int) -> int:
    return max(1, -(-nbits // MSM_WINDOW_BITS))


def msm_plain(scalars: torch.Tensor, points: torch.Tensor, curve: CurveSpec,
              nbits: int = FULL_BITS) -> torch.Tensor:
    """Plain version of ``msm``."""
    n, n_win = points.shape[0], msm_windows(nbits)
    rows = [_inf_like(points, curve), points]
    acc = points
    for _ in range(2, MSM_DIGITS):
        acc = pt_add(acc, points, curve)
        rows.append(acc)
    table = torch.stack(rows)  # (16, n, 3, 8)
    d = scalar_digits(scalars, n_win, MSM_WINDOW_BITS)  # (n_win, n)
    sums = row_sum_plain(table[d, torch.arange(n, device=points.device)], curve)
    acc = _inf_like(sums[0], curve)
    for k in range(n_win - 1, -1, -1):
        for _ in range(MSM_WINDOW_BITS):
            acc = pt_dbl(acc, curve)
        acc = pt_add(acc, sums[k], curve)
    return acc


def msm(scalars: torch.Tensor, points: torch.Tensor, curve: CurveSpec,
        nbits: int = FULL_BITS) -> torch.Tensor:
    """(n, 8) canonical scalars below 2^nbits and (n, 3, 8) Jacobian
    Montgomery points -> (3, 8) Jacobian sum_i scalars[i] * points[i]."""
    if points.device.type == "cpu":
        return msm_plain(scalars, points, curve, nbits)
    check_cuda(scalars, points)
    n = points.shape[0]
    if n == 0 or scalars.shape != (n, 8) or points.shape != (n, 3, 8):
        raise ValueError("msm: scalars (n, 8) and points (n, 3, 8), n > 0")
    dev = points.device
    table = torch.empty(MSM_DIGITS, n, 3, 8, dtype=torch.int32, device=dev)
    n_win = msm_windows(nbits)
    sums = torch.empty(n_win, 3, 8, dtype=torch.int32, device=dev)
    out = torch.empty(3, 8, dtype=torch.int32, device=dev)
    MSM.call("sp2_msm", n, n_win, scalars.data_ptr(), points.data_ptr(),
             table.data_ptr(), sums.data_ptr(), out.data_ptr(), curve_words(curve))
    return out


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
