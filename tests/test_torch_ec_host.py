"""The port's host curve module in C (native/ec_host.c through
ec/curve.py's ``msm`` and ``scalar_mul``) against its Python versions
(``msm_plain``, ``scalar_mul_plain``) and against the JAX package's host
CurveSpec, on P-256, Pallas, Vesta and BN254.  Nothing here compiles on
XLA:CPU: JAX's CurveSpec is host code."""

import numpy as np
import pytest

from spartan2_tpu.ec import curve as jax_curve_mod
from spartan2_tpu_torch import native
from spartan2_tpu_torch.ec import curve as curve_mod
from spartan2_tpu_torch.ec.curve import get_curve

CURVES = ("p256", "pallas", "vesta", "bn254")


def _ints(bound: int, n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(n)]


def _inputs(name: str, n: int, seed: int):
    """n scalars and points (multiples of the generator, by the JAX
    package's host curve).  With n > 4: scalars 0, 1 and q - 1, an
    identity point, a repeated point with a repeated scalar (its bucket
    doubles), and P beside -P with equal scalars (they cancel)."""
    jc = jax_curve_mod.get_curve(name)
    q = jc.scalar.modulus
    pts = [jc.scalar_mul(k, jc.generator) for k in _ints(q, n, seed)]
    sc = _ints(q, n, seed + 1)
    if n > 4:
        sc[0], sc[1], sc[2] = 0, 1, q - 1
        pts[3] = None
        pts[4], sc[4] = pts[1], sc[1]
    if n > 6:
        pts[6], sc[6] = jc.neg(pts[5]), sc[5]
    return sc, pts


@pytest.mark.parametrize("n", [0, 1, 2, 17, 64, 2048])
@pytest.mark.parametrize("name", CURVES)
def test_msm_c_equals_plain_and_jax(name, n):
    c, jc = get_curve(name), jax_curve_mod.get_curve(name)
    sc, pts = _inputs(name, n, 10 + n)
    got = c.msm(sc, pts)
    assert got == c.msm_plain(sc, pts)
    assert got == jc.msm(sc, pts)
    assert c.is_on_curve(got)
    if n == 0:
        assert got is None


@pytest.mark.parametrize("name", CURVES)
def test_msm_edge_sums(name):
    """P + (-P) is the identity; P + P (one bucket twice) is 2P; identity
    points and zero scalars add nothing."""
    c, jc = get_curve(name), jax_curve_mod.get_curve(name)
    q = c.scalar.modulus
    P = jc.scalar_mul(_ints(q, 1, 3)[0], jc.generator)
    cases = [([5, 5], [P, jc.neg(P)], None),
             ([7, 7], [P, P], jc.scalar_mul(14, P)),
             ([1, 9, 0], [P, None, P], P),
             ([q - 1, 1], [P, P], None),
             ([0, 0], [P, P], None)]
    for sc, pts, want in cases:
        assert c.msm(sc, pts) == want
        assert c.msm_plain(sc, pts) == want
        assert jc.msm(sc, pts) == want


@pytest.mark.parametrize("name", CURVES)
def test_scalar_mul_c_equals_plain_and_jax(name):
    c, jc = get_curve(name), jax_curve_mod.get_curve(name)
    q = c.scalar.modulus
    pts = [c.generator, jc.scalar_mul(_ints(q, 1, 5)[0], jc.generator), None]
    ks = [0, 1, 2, q - 1, q, q + 1, -1, *_ints(q, 3, 6)]
    for pt in pts:
        for k in ks:
            got = c.scalar_mul(k, pt)
            assert got == c.scalar_mul_plain(k, pt)
            assert got == jc.scalar_mul(k, pt)
    assert c.scalar_mul(q - 1, c.generator) == c.neg(c.generator)


@pytest.mark.parametrize("name", CURVES)
def test_parameter_block_matches_jax(name):
    assert (curve_mod._native_params(get_curve(name))
            == jax_curve_mod._native_params(jax_curve_mod.get_curve(name)))


def test_missing_compiler_raises_without_fallback(monkeypatch, tmp_path):
    """A failed build of the C library raises; msm and scalar_mul do not
    fall back to their Python versions."""
    monkeypatch.setattr(native, "CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(curve_mod, "_EC", None)
    c = get_curve("p256")
    with pytest.raises(RuntimeError, match="no-such-cc failed for ec_host.c"):
        c.msm([3], [c.generator])
    with pytest.raises(RuntimeError, match="failed for ec_host.c"):
        c.scalar_mul(3, c.generator)
    assert curve_mod._EC is None
    assert not list((tmp_path / "native").glob("*.so"))


def test_failing_compiler_raises_its_message(monkeypatch, tmp_path):
    cc = tmp_path / "bad-cc"
    cc.write_text("#!/bin/sh\necho 'bad-cc: refused to build' >&2\nexit 1\n")
    cc.chmod(0o755)
    monkeypatch.setattr(native, "CC", str(cc))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(RuntimeError, match="refused to build"):
        native.load_ec()
    assert not list((tmp_path / "native").glob("*.so"))
