"""The port's last four device functions through their plain versions (CPU):
``msm_binary``, ``msm_points_per_lane`` (nbits 256 and 64) and
``scalar_mul_host_base`` (ec/msm.py) and ``mle_evaluate_device``
(polys/multilinear.py), against the JAX package's device functions of
the same names as recorded in tests/torch_golden/curve_device.json
(``make_golden --curve``), and against the JAX package's host curve and
MLE evaluation live.  Nothing here compiles on XLA:CPU; the tolerance is
0 (points compare affine, field elements canonical)."""

import json

import numpy as np
import pytest
import torch

import spartan2_tpu_torch.ec.msm as msm_mod
from spartan2_tpu.ec.curve import get_curve as jax_get_curve
from spartan2_tpu.polys.multilinear import mle_evaluate_host as jax_mle_evaluate_host
from spartan2_tpu_torch.ec.comb import to_affine
from spartan2_tpu_torch.ec.curve import get_curve
from spartan2_tpu_torch.ec.msm import (msm_binary, msm_binary_plain,
                                       msm_points_per_lane, scalar_mul_host_base)
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.polys.multilinear import (bind_top_device, mle_evaluate_device,
                                                  mle_evaluate_host)
from tests.torch_golden.make_golden import CURVE_NAMES, CURVE_OUT


@pytest.fixture(scope="module")
def golden():
    with open(CURVE_OUT) as f:
        return json.load(f)


def _aff(v):
    return None if v is None else (int(v[0], 16), int(v[1], 16))


def _coords(curve, pts):
    return (to_device([p[0] for p in pts], curve.base, "cpu", mont=True),
            to_device([p[1] for p in pts], curve.base, "cpu", mont=True))


def _case(golden, name):
    rec = golden[name]
    curve, jc = get_curve(name), jax_get_curve(name)
    pts = [_aff(p) for p in rec["points"]]
    return rec, curve, jc, pts


def test_golden_covers_both_curves(golden):
    assert sorted(golden) == sorted(CURVE_NAMES)
    for rec in golden.values():
        assert [len(b["bits"]) for b in rec["binary"]] == [8, 5, 5]
        assert [p["nbits"] for p in rec["per_lane"]] == [264, 64]


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_msm_binary_matches_jax(golden, name):
    rec, curve, jc, pts = _case(golden, name)
    for entry in rec["binary"]:
        bits = entry["bits"]
        qx, qy = _coords(curve, pts[: len(bits)])
        got = to_affine(msm_binary(torch.tensor(bits, dtype=torch.int32), qx, qy,
                                   curve)[None], curve)[0]
        assert got == _aff(entry["out"])
        assert got == jc.msm(bits, pts[: len(bits)])
    assert rec["binary"][2]["out"] is None  # no bit set: the identity


@pytest.mark.parametrize("idx", [0, 1], ids=["nbits264", "nbits64"])
@pytest.mark.parametrize("name", CURVE_NAMES)
def test_msm_points_per_lane_matches_jax(golden, name, idx):
    rec, curve, jc, pts = _case(golden, name)
    entry = rec["per_lane"][idx]
    scal = [int(s, 16) for s in entry["scalars"]]
    qx, qy = _coords(curve, pts)
    # JAX's 264 bits cover its 22 x 12-bit limbs; canonical scalars stop at 256
    nbits = min(entry["nbits"], 256)
    got = to_affine(msm_points_per_lane(to_device(scal, curve.scalar, "cpu"), qx, qy,
                                        curve, nbits), curve)
    assert got == [_aff(p) for p in entry["out"]]
    assert got == [jc.scalar_mul(s, p) for s, p in zip(scal, pts)]


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_scalar_mul_host_base_matches_jax(golden, name):
    rec, curve, jc, pts = _case(golden, name)
    n = 5
    qx, qy = _coords(curve, pts[:n])
    ks = [int(e["k"], 16) for e in rec["host_base"]]
    assert ks[:3] == [0, 1, curve.scalar.modulus - 1]
    for k, entry in zip(ks, rec["host_base"]):
        got = to_affine(scalar_mul_host_base(k, qx, qy, curve), curve)
        assert got == [_aff(p) for p in entry["out"]]
        assert got == [jc.scalar_mul(k, p) for p in pts[:n]]


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_mle_evaluate_device_matches_jax(golden, name):
    rec, curve, _, _ = _case(golden, name)
    F = curve.scalar
    table = [int(v, 16) for v in rec["mle"]["table"]]
    r = [int(v, 16) for v in rec["mle"]["r"]]
    T = to_device(table, F, "cpu", mont=True)
    R = to_device(r, F, "cpu", mont=True)
    got = limbs_to_ints(mle_evaluate_device(T, R, F), F, mont=True)[0]
    assert got == int(rec["mle"]["out"], 16)
    assert got == int(rec["mle"]["host"], 16) == mle_evaluate_host(F, table, r)
    assert got == jax_mle_evaluate_host(F, table, r)
    half = limbs_to_ints(bind_top_device(T, R[0], F), F, mont=True)
    p = F.modulus
    assert half == [(table[j] + r[0] * (table[4 + j] - table[j])) % p for j in range(4)]


def _multiples(jc, n: int, seed: int):
    rng = np.random.default_rng(seed)
    q = jc.scalar.modulus
    return [jc.scalar_mul(int.from_bytes(rng.bytes(40), "little") % q, jc.generator)
            for _ in range(n)]


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_msm_binary_complete_over_two_blocks(name):
    """300 lanes (two blocks of 256, padded with the identity): a point
    selected twice doubles in the tree, P and -P cancel."""
    curve, jc = get_curve(name), jax_get_curve(name)
    pts = _multiples(jc, 300, 5)
    pts[260] = pts[3]
    pts[7] = jc.neg(pts[8])
    bits = [int(b) for b in np.random.default_rng(6).integers(0, 2, 300)]
    bits[3] = bits[260] = bits[7] = bits[8] = 1
    qx, qy = _coords(curve, pts)
    got = msm_binary(torch.tensor(bits, dtype=torch.int32), qx, qy, curve)
    assert to_affine(got[None], curve)[0] == jc.msm(bits, pts)
    zero = msm_binary_plain(torch.zeros(300, dtype=torch.int32), qx, qy, curve)
    assert to_affine(zero[None], curve)[0] is None


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_per_lane_exceptional_lanes(name):
    """Scalars of 256 bits that are not reduced reach the mixed addition's
    exceptional cases: q (the last addition meets -Q: the identity) and
    q + 2 (it meets Q: a doubling)."""
    curve, jc = get_curve(name), jax_get_curve(name)
    q = curve.scalar.modulus
    pts = _multiples(jc, 4, 9)
    scal = [q, q + 2, 0, 1]
    qx, qy = _coords(curve, pts)
    sc = torch.from_numpy(np.frombuffer(b"".join(s.to_bytes(32, "little") for s in scal),
                                        dtype="<i4").reshape(4, 8).copy())
    got = to_affine(msm_points_per_lane(sc, qx, qy, curve), curve)
    assert got == [None, jc.scalar_mul(2, pts[1]), None, pts[3]]


def test_shapes_are_checked():
    curve = get_curve("p256")
    qx, qy = _coords(curve, [curve.generator])
    with pytest.raises(ValueError):
        msm_binary(torch.zeros(0, dtype=torch.int32), qx[:0], qy[:0], curve)
    with pytest.raises(ValueError):
        msm_points_per_lane(torch.zeros(1, 8, dtype=torch.int32), qx, qy, curve, 264)
    with pytest.raises(ValueError):
        mle_evaluate_device(torch.zeros(4, 8, dtype=torch.int32),
                            torch.zeros(1, 8, dtype=torch.int32), curve.scalar)


@pytest.mark.parametrize("fn", ["msm_binary", "msm_points_per_lane"])
def test_kernel_inputs_checked_on_one_device(fn, monkeypatch):
    """The bits or scalars on another device than the points are refused
    before a launch: every input of the entry goes through one check.  The
    points lie on the meta device, which takes the kernel's branch here,
    and the check is check_cuda's device rule without its CUDA type."""
    def one_device(*tensors, dtype=torch.int32):
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs must lie on one CUDA device")

    monkeypatch.setattr(msm_mod, "check_cuda", one_device)
    curve = get_curve("p256")
    qx = torch.zeros(4, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        if fn == "msm_binary":
            msm_binary(torch.zeros(4, dtype=torch.int32), qx, qx, curve)
        else:
            msm_points_per_lane(torch.zeros(4, 8, dtype=torch.int32), qx, qx, curve)
