"""The port's comb MSM and runtime-point MSM (kernels 3 and 5 through
their plain versions, CPU) against the JAX package's host curve
arithmetic."""

import pytest
import torch

from spartan2_tpu.ec.curve import get_curve as jax_get_curve
from spartan2_tpu_torch.ec import comb
from spartan2_tpu_torch.ec.comb import (
    FixedBaseComb, comb_build, comb_rows, pt_add, pt_dbl, pt_dbl_n, to_affine)
from spartan2_tpu_torch.ec.curve import get_curve
from spartan2_tpu_torch.ec.msm import MSM_MIN_POINTS, msm, msm_points, to_jacobian
from spartan2_tpu_torch.field.limbs import to_device
from tests.torch_helpers import rand_ints

CURVE = get_curve("p256")
JCURVE = jax_get_curve("p256")


def _jac(points):
    return to_jacobian(points, CURVE, "cpu")


def _runtime_points(n, nbits, seed):
    """n points k_i * G and scalars below 2^nbits; for n > 3 also an
    identity point, a zero scalar and two equal terms."""
    q = CURVE.scalar.modulus
    pts = [JCURVE.scalar_mul(k, CURVE.generator) for k in rand_ints(q, n, seed)]
    scal = rand_ints(min(q, 1 << nbits), n, seed + 1)
    if n > 3:
        pts[1], scal[2] = None, 0
        pts[3], scal[3] = pts[0], scal[0]
    return scal, pts


def test_generators_match_jax():
    assert CURVE.from_label(b"ck", 9) == JCURVE.from_label(b"ck", 9)


def test_group_law_edge_cases():
    G = CURVE.generator
    G2 = JCURVE.add(G, G)
    negG = JCURVE.neg(G)
    P = _jac([G, G, G, None, G, None])
    Q = _jac([G2, G, negG, G, None, None])
    got = to_affine(pt_add(P, Q, CURVE), CURVE)
    assert got == [JCURVE.add(a, b) for a, b in
                   zip([G, G, G, None, G, None], [G2, G, negG, G, None, None])]
    assert to_affine(pt_dbl(_jac([G2, None]), CURVE), CURVE) == [JCURVE.add(G2, G2),
                                                                 None]


@pytest.mark.parametrize("name", ["p256", "pallas"])
def test_group_law_int_and_tensor_paths_agree(name, monkeypatch):
    """The plain group law's two CPU paths (Python integers up to
    _INT_POINTS points a batch, batched tensors above) give the same limbs
    on the edge cases: identity on either side, doubling, inverse."""
    curve, jcurve = get_curve(name), jax_get_curve(name)
    G = curve.generator
    G2, G3, negG = jcurve.add(G, G), jcurve.scalar_mul(3, G), jcurve.neg(G)
    P = to_jacobian([G, G, G, None, G, None, G3, G2], curve, "cpu")
    Q = to_jacobian([G2, G, negG, G, None, None, G3, negG], curve, "cpu")
    got = {}
    for path, limit in (("int", comb._INT_POINTS), ("tensor", 0)):
        monkeypatch.setattr(comb, "_INT_POINTS", limit)
        got[path] = (pt_add(P, Q, curve), pt_dbl_n(P, 3, curve))
    assert all(torch.equal(a, b) for a, b in zip(got["int"], got["tensor"]))
    assert to_affine(got["int"][0], curve) == [
        jcurve.add(a, b) for a, b in zip([G, G, G, None, G, None, G3, G2],
                                         [G2, G, negG, G, None, None, G3, negG])]


@pytest.mark.parametrize("width,nbits", [(4, 64), (16, 64), (4, 256)])
def test_comb_rows_match_jax_msm(width, nbits):
    gens = CURVE.from_label(b"test_comb", width)
    comb = FixedBaseComb(CURVE, gens, nbits, "cpu")
    assert comb.table.shape == (comb.n_win, 64, width, 3, 8)
    bound = 1 << 64 if nbits == 64 else CURVE.scalar.modulus
    rows = [rand_ints(bound, width, 20 + i) for i in range(3)]
    rows[1] = [0] * width
    rows[2][0] = rows[2][1] = 7  # equal digits in one row
    sc = to_device([v for row in rows for v in row], CURVE.scalar,
                   "cpu").reshape(3, width, 8)
    got = to_affine(comb.rows_msm(sc), CURVE)
    assert got == [JCURVE.msm(row, gens) for row in rows]


def test_comb_table_entries():
    gens = CURVE.from_label(b"tab", 2)
    gx = to_device([g[0] for g in gens], CURVE.base, "cpu", mont=True)
    gy = to_device([g[1] for g in gens], CURVE.base, "cpu", mont=True)
    table = comb_build(gx, gy, 3, CURVE)
    for w, d in ((0, 0), (0, 1), (1, 5), (2, 63)):
        got = to_affine(table[w, d], CURVE)
        assert got == [JCURVE.scalar_mul(d << (6 * w), g) for g in gens]
    # a row through comb_rows equals the table's own entry for one digit
    sc = to_device([5 << 6, 0], CURVE.scalar, "cpu").reshape(1, 2, 8)
    assert to_affine(comb_rows(sc, table, CURVE), CURVE) == [
        JCURVE.scalar_mul(5 << 6, gens[0])]


@pytest.mark.parametrize("n,nbits", [(3, 64), (70, 256)])
def test_msm_matches_jax_msm(n, nbits):
    scal, pts = _runtime_points(n, nbits, 40 + n)
    got = msm(to_device(scal, CURVE.scalar, "cpu"), _jac(pts), CURVE, nbits)
    assert got.shape == (3, 8)
    assert to_affine(got.reshape(1, 3, 8), CURVE) == [JCURVE.msm(scal, pts)]


@pytest.mark.parametrize("n", [5, MSM_MIN_POINTS])
def test_msm_points_matches_jax_msm(n):
    scal, pts = _runtime_points(n, 30, 60 + n)
    assert msm_points(scal, pts, CURVE, "cpu") == JCURVE.msm(scal, pts)
