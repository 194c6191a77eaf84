"""Kernel C, the row-batched MSM over runtime points (its plain version,
CPU), and the port's HyraxPCS.fold_commitments, against the JAX
package's host fold (HyraxPCS.fold_commitments below its 64-point device
threshold) and its host Pippenger (CurveSpec.msm) per row."""

import pytest

from spartan2_tpu.ec.curve import get_curve as jax_get_curve
from spartan2_tpu.pcs.hyrax import HyraxCommitment as JaxCommitment
from spartan2_tpu.provider.engines import get_engine as jax_get_engine
from spartan2_tpu_torch.ec.comb import to_affine
from spartan2_tpu_torch.ec.curve import get_curve
from spartan2_tpu_torch.ec.msm import msm_plain, msm_rows, to_jacobian
from spartan2_tpu_torch.errors import SpartanError
from spartan2_tpu_torch.field.limbs import to_device
from spartan2_tpu_torch.pcs.hyrax import HyraxCommitment
from spartan2_tpu_torch.provider.engines import get_engine
from tests.torch_helpers import rand_ints

CURVE = get_curve("p256")
JCURVE = jax_get_curve("p256")


def _points(n, seed):
    q = CURVE.scalar.modulus
    return [JCURVE.scalar_mul(k, CURVE.generator) for k in rand_ints(q, n, seed)]


def _fold_inputs(rows, seed):
    """Two commitments of ``rows`` rows and the NIFS weights [1, r]."""
    pts = _points(2 * rows, seed)
    r = rand_ints(CURVE.scalar.modulus, 1, seed + 1)[0]
    return pts[:rows], pts[rows:], [1, r]


def test_msm_rows_matches_jax_fold_below_threshold():
    """R = 31 rows of I = 2 points: 62 points, so JAX folds on the host."""
    c1, c2, w = _fold_inputs(31, 1)
    # an identity row point and a repeated pair (equal partial sums)
    c1[4] = None
    c2[7] = c1[7]
    jeng = jax_get_engine("P256HyraxEngine")
    ref = jeng.pcs.fold_commitments([JaxCommitment(c1), JaxCommitment(c2)], w).comm
    sc = to_device(w, CURVE.scalar, "cpu").expand(31, 2, 8).contiguous()
    pts = to_jacobian([pt for row in zip(c1, c2) for pt in row], CURVE, "cpu")
    got = to_affine(msm_rows(sc, pts.reshape(31, 2, 3, 8), CURVE), CURVE)
    assert got == ref
    assert got == [JCURVE.msm(w, [a, b]) for a, b in zip(c1, c2)]


def test_msm_rows_per_row_scalars_and_one_row():
    R, n = 3, 5
    pts = _points(R * n, 11)
    scal = rand_ints(1 << 40, R * n, 12)
    scal[3] = 0
    sc = to_device(scal, CURVE.scalar, "cpu").reshape(R, n, 8)
    jac = to_jacobian(pts, CURVE, "cpu").reshape(R, n, 3, 8)
    got = msm_rows(sc, jac, CURVE, 40)
    assert to_affine(got, CURVE) == [
        JCURVE.msm(scal[r * n : (r + 1) * n], pts[r * n : (r + 1) * n])
        for r in range(R)]
    # kernel 5 is kernel C's one-row case, limb for limb
    assert (msm_plain(sc[1], jac[1], CURVE, 40) == got[1]).all()


@pytest.mark.parametrize("rows", [16, 43])
def test_port_fold_commitments(rows):
    """43 rows x 2 = 86 points take kernel C (the verifier-circuit W fold
    at SHA-256 1 KiB); 16 x 2 = 32 the host fold (its E fold)."""
    c1, c2, w = _fold_inputs(rows, 20 + rows)
    pcs = get_engine("P256HyraxEngine").pcs
    got = pcs.fold_commitments([HyraxCommitment(c1), HyraxCommitment(c2)], w, "cpu")
    assert got.comm == [JCURVE.msm(w, [a, b]) for a, b in zip(c1, c2)]


def test_port_fold_commitments_rejects_unequal_rows():
    c1, c2, w = _fold_inputs(3, 30)
    pcs = get_engine("P256HyraxEngine").pcs
    with pytest.raises(SpartanError):
        pcs.fold_commitments([HyraxCommitment(c1), HyraxCommitment(c2[:2])], w, "cpu")


@pytest.mark.parametrize("R,I,nbits", [(5, 16, 256), (6, 2, 40)])
def test_msm_rows_edge_rows_match_jax_msm(R, I, nbits):
    """Kernel C's plain version on the rows chip_smoke also sends the card:
    all-zero scalars, q - 1 (cut to nbits), a point repeated with its
    scalar (a doubling in the window sums), a point beside its negation
    (their identity), a point at infinity; against JAX's CurveSpec.msm."""
    q = CURVE.scalar.modulus
    bound = 1 << nbits
    sc = [v % bound for v in rand_ints(q, R * I, 70 + I)]
    pts = _points(R * I, 71 + I)
    sc[0:I] = [0] * I
    sc[I : 2 * I] = [(q - 1) % bound] * I
    pts[2 * I + 1], sc[2 * I + 1] = pts[2 * I], sc[2 * I]
    x, y = pts[3 * I]
    pts[3 * I + 1], sc[3 * I + 1] = (x, (-y) % CURVE.base.modulus), sc[3 * I]
    pts[4 * I] = None
    sc_t = to_device(sc, CURVE.scalar, "cpu").reshape(R, I, 8)
    jac = to_jacobian(pts, CURVE, "cpu").reshape(R, I, 3, 8)
    got = to_affine(msm_rows(sc_t, jac, CURVE, nbits), CURVE)
    assert got == [JCURVE.msm(sc[r * I : (r + 1) * I], pts[r * I : (r + 1) * I])
                   for r in range(R)]
    assert got[0] is None and got[3] == JCURVE.msm(sc[3 * I + 2 : 4 * I],
                                                   pts[3 * I + 2 : 4 * I])
