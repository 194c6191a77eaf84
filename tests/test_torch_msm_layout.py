"""The order of additions of the redesigned windowed MSM (csrc/msm.cu,
kernels C and 5) on its plain version (CPU): a reference that repeats the
kernel's blocks point by point equals ``msm_rows_plain`` limb for limb, an
order rolled by one does not, and the sums equal the JAX package's host
MSM.  Nothing here compiles on XLA:CPU."""

import re

import pytest
import torch

from spartan2_tpu.ec.curve import get_curve as jax_get_curve
from spartan2_tpu_torch.ec.comb import _inf_like, pt_add, pt_dbl, scalar_digits, to_affine
from spartan2_tpu_torch.ec.curve import get_curve
from spartan2_tpu_torch.ec.msm import (
    MSM_GROUP_MAX, MSM_THREADS, MSM_WINDOW_BITS, msm_layout, msm_rows, msm_rows_plain,
    msm_windows, to_jacobian)
from spartan2_tpu_torch.field.limbs import to_device
from spartan2_tpu_torch.utils.cuda import CSRC
from tests.torch_helpers import rand_ints

CURVE = get_curve("p256")
JCURVE = jax_get_curve("p256")


def _inputs(R: int, I: int, nbits: int, seed: int):
    q = CURVE.scalar.modulus
    pts = [JCURVE.scalar_mul(k, CURVE.generator) for k in rand_ints(q, R * I, seed)]
    sc = [v % (1 << nbits) for v in rand_ints(q, R * I, seed + 1)]
    return sc, pts


def _table(Q: torch.Tensor) -> list:
    """One point's multiples in the kernel's four steps."""
    T = [None, Q, pt_dbl(Q, CURVE)]
    T += [pt_add(T[2], T[1], CURVE), pt_dbl(T[2], CURVE)]
    T += [pt_add(T[4], T[c], CURVE) for c in (1, 2, 3)] + [pt_dbl(T[4], CURVE)]
    T += [pt_add(T[8], T[c], CURVE) for c in range(1, 8)]
    return T


def _kernel_order(sc: torch.Tensor, pts: torch.Tensor, nbits: int,
                  roll: int = 0) -> torch.Tensor:
    """csrc/msm.cu's order, one row and one point at a time: blocks of GP
    points (msm_layout); a block's leaves (window k, point j), the adjacent
    pairs over its points; the blocks' adjacent pairs level by level (a
    block without a sibling passes up); the windows' ladder P_j = P_2j +
    2^(4 2^l) P_2j+1.  ``roll`` rolls each row's points first."""
    R, I = pts.shape[:2]
    n_win = msm_windows(nbits)
    lg, ng, levels = msm_layout(I, n_win)
    GP, NW = 1 << lg, 1 << (n_win - 1).bit_length()
    inf = _inf_like(pts[0, :1], CURVE)
    d = scalar_digits(sc, n_win, MSM_WINDOW_BITS)  # (n_win, R, I)
    out = []
    for r in range(R):
        order = [(i + roll) % I for i in range(I)]
        tables = [_table(pts[r, i : i + 1]) for i in order]
        blocks = []
        for g in range(ng):
            sums = []
            for k in range(NW):
                leaves = []
                for j in range(GP):
                    i = g * GP + j
                    dig = int(d[k, r, order[i]]) if k < n_win and i < I else 0
                    leaves.append(tables[i][dig] if dig else inf)
                while len(leaves) > 1:
                    leaves = [pt_add(leaves[2 * a], leaves[2 * a + 1], CURVE)
                              for a in range(len(leaves) // 2)]
                sums.append(leaves[0])
            blocks.append(sums)
        for _ in range(levels):
            blocks = [[pt_add(a, b, CURVE) for a, b in zip(blocks[2 * m], blocks[2 * m + 1])]
                      if 2 * m + 1 < len(blocks) else blocks[2 * m]
                      for m in range((len(blocks) + 1) // 2)]
        P = blocks[0]
        shift = MSM_WINDOW_BITS
        while len(P) > 1:
            nxt = []
            for j in range(len(P) // 2):
                hi = P[2 * j + 1]
                for _ in range(shift):
                    hi = pt_dbl(hi, CURVE)
                nxt.append(pt_add(P[2 * j], hi, CURVE))
            P, shift = nxt, 2 * shift
        out.append(P[0][0])
    return torch.stack(out)


def test_layout_constants_match_the_cuda_source():
    src = (CSRC / "msm.cu").read_text()
    assert int(re.search(r"constexpr int MSM_NT = (\d+);", src).group(1)) == MSM_THREADS
    assert int(re.search(r"constexpr int MSM_GROUP_MAX = (\d+);", src).group(1)) \
        == MSM_GROUP_MAX
    # the main paths' shapes: 4 points a block at 64 windows, one block a
    # row of 2, four (two tree levels) a row of 16, 64 for kernel 5's 256
    assert msm_layout(2, 64) == (1, 1, 0)
    assert msm_layout(16, 64) == (2, 4, 2)
    assert msm_layout(256, 64) == (2, 64, 6)
    assert msm_layout(5, 10) == (3, 1, 0)
    assert msm_layout(9, 64) == (2, 3, 2)


@pytest.mark.parametrize("R,I,nbits", [(3, 5, 40), (2, 2, 256), (1, 9, 256)])
def test_plain_follows_the_kernel_order(R, I, nbits):
    """At (1, 9) three blocks of 4 points: the third has no sibling at the
    first level and passes up."""
    sc, pts = _inputs(R, I, nbits, 40 + R + I)
    sc_t = to_device(sc, CURVE.scalar, "cpu").reshape(R, I, 8)
    jac = to_jacobian(pts, CURVE, "cpu").reshape(R, I, 3, 8)
    got = msm_rows_plain(sc_t, jac, CURVE, nbits)
    assert torch.equal(got, _kernel_order(sc_t, jac, nbits))
    assert not torch.equal(got, _kernel_order(sc_t, jac, nbits, roll=1))
    assert to_affine(got, CURVE) == [JCURVE.msm(sc[r * I : (r + 1) * I],
                                                pts[r * I : (r + 1) * I]) for r in range(R)]


def test_row_alone_equals_row_in_batch():
    """A row's limbs do not depend on the rows beside it."""
    sc, pts = _inputs(4, 3, 64, 60)
    sc_t = to_device(sc, CURVE.scalar, "cpu").reshape(4, 3, 8)
    jac = to_jacobian(pts, CURVE, "cpu").reshape(4, 3, 3, 8)
    batch = msm_rows(sc_t, jac, CURVE, 64)
    for r in (0, 3):
        assert torch.equal(batch[r], msm_rows(sc_t[r : r + 1], jac[r : r + 1], CURVE, 64)[0])
