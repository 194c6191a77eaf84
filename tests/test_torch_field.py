"""The port's field arithmetic (plain PyTorch, CPU) against the JAX
package's FieldOps and Python ints.  Outputs are integers mod p, so every
comparison is exact."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.field.jnp_ops import FieldOps
from spartan2_tpu.field.limbs import ints_to_limbs_np as jax_to_limbs
from spartan2_tpu.field.limbs import limbs_to_ints as jax_to_ints
from spartan2_tpu_torch.field import ops
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import ints_to_limbs_np, limbs_to_ints
from tests.torch_helpers import rand_ints

# every modulus the engines use: P-256's exceed 2^255 (the carry out of
# limb 7 is reachable), Pallas's and BN254's lie below it.  The JAX
# FieldOps comparisons run on the P-256 fields only, whose programs the
# suite has compiled already; the others are held against Python ints.
FIELDS = ["p256_scalar", "p256_base", "pallas_scalar", "pallas_base", "bn254_scalar",
          "bn254_base"]
JAX_FIELDS = {"p256_scalar", "p256_base"}


def values(p: int, n: int, seed: int) -> list[int]:
    """Edge values (0, 1, p-1 and values near 2^256 that carry out of limb
    7 when added) followed by random ones."""
    edge = [0, 1, 2, p - 1, p - 2, (1 << 255) % p, ((1 << 256) - 1) % p,
            p // 2, p // 2 + 1, p - (1 << 224)]
    return edge + rand_ints(p, n, seed)


@pytest.fixture(scope="module", params=FIELDS)
def fields(request):
    return get_field(request.param), jax_get_field(request.param)


def _t(vals, spec, mont=False):
    return torch.from_numpy(ints_to_limbs_np(vals, spec, mont=mont))


def test_constants_and_layout(fields):
    spec, _ = fields
    p = spec.modulus
    # the carry out of limb 7 is reachable exactly for the P-256 moduli
    assert (p > 1 << 255) == (spec.name in JAX_FIELDS)
    assert (spec.n0 * p + 1) % (1 << 32) == 0
    assert spec.r_mod == (1 << 256) % p and spec.r2_mod == (1 << 512) % p
    vals = values(p, 8, 0)
    arr = ints_to_limbs_np(vals, spec)
    assert arr.shape == (len(vals), 8) and arr.dtype == np.int32
    # bytes <-> limbs: the element-major array IS the 32-byte LE encodings
    assert arr.tobytes() == b"".join(spec.to_bytes(v) for v in vals)
    assert limbs_to_ints(arr, spec) == vals
    assert limbs_to_ints(ints_to_limbs_np(vals, spec, mont=True), spec,
                         mont=True) == vals


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_against_jax(fields, op):
    spec, jspec = fields
    p = spec.modulus
    xs = values(p, 20, 1)
    ys = list(reversed(values(p, 20, 2)))
    got = limbs_to_ints(getattr(ops, op)(_t(xs, spec, True), _t(ys, spec, True),
                                         spec), spec, mont=True)
    expect = {"add": [(x + y) % p for x, y in zip(xs, ys)],
              "sub": [(x - y) % p for x, y in zip(xs, ys)],
              "mont_mul": [x * y % p for x, y in zip(xs, ys)]}[op]
    assert got == expect
    if spec.name in JAX_FIELDS:
        jops = FieldOps(jspec)
        ja = jnp.asarray(jax_to_limbs(xs, jspec, mont=True))
        jb = jnp.asarray(jax_to_limbs(ys, jspec, mont=True))
        assert jax_to_ints(np.asarray(getattr(jops, op)(ja, jb)), jspec, mont=True) == got


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_limb_path_equals_integer_path(fields, op):
    """A CPU batch above ops._SMALL elements takes the 16-bit digit limb
    arithmetic, a smaller one Python's integers: the same values."""
    spec, _ = fields
    p = spec.modulus
    n = ops._SMALL + 44
    xs, ys = values(p, n, 6), list(reversed(values(p, n, 7)))
    a, b = _t(xs, spec, True), _t(ys, spec, True)
    big = getattr(ops, op)(a, b, spec)
    small = torch.cat([getattr(ops, op)(a[i : i + 50], b[i : i + 50], spec)
                       for i in range(0, a.shape[0], 50)])
    assert torch.equal(big, small)
    expect = {"add": [(x + y) % p for x, y in zip(xs, ys)],
              "sub": [(x - y) % p for x, y in zip(xs, ys)],
              "mont_mul": [x * y % p for x, y in zip(xs, ys)]}[op]
    assert limbs_to_ints(big, spec, mont=True) == expect


def test_mont_conversions_against_jax(fields):
    spec, jspec = fields
    xs = values(spec.modulus, 20, 3)
    m = ops.to_mont(_t(xs, spec), spec)
    assert limbs_to_ints(m, spec) == [spec.to_mont(x) for x in xs]
    assert limbs_to_ints(ops.from_mont(m, spec), spec) == xs
    if spec.name not in JAX_FIELDS:
        return
    jops = FieldOps(jspec)
    jm = jops.to_mont(jnp.asarray(jax_to_limbs(xs, jspec, mont=False)))
    assert jax_to_ints(np.asarray(jops.from_mont(jm)), jspec, mont=False) == xs


def test_inverse_against_jax(fields):
    spec, jspec = fields
    p = spec.modulus
    xs = [1, 2, p - 1, p - 2, (1 << 255) % p] + values(p, 6, 4)[10:]
    got = limbs_to_ints(ops.inv(_t(xs, spec, True), spec), spec, mont=True)
    assert got == [pow(x, -1, p) for x in xs]
    if spec.name in JAX_FIELDS:
        jops = FieldOps(jspec)
        want = jax_to_ints(np.asarray(jops.inv(jnp.asarray(
            jax_to_limbs(xs, jspec, mont=True)))), jspec, mont=True)
        assert got == want


def test_sums_and_carry_out_of_limb_7(fields):
    spec, _ = fields
    p = spec.modulus
    # every pair sums past 2^256
    xs = [p - 1, p - 2, (1 << 256) - 1 - p + (1 << 200)] * 5
    ys = [p - 1, (1 << 255), p - 3] * 5
    got = limbs_to_ints(ops.add(_t(xs, spec), _t(ys, spec), spec), spec)
    assert got == [(x + y) % p for x, y in zip(xs, ys)]
    big = values(p, 300, 5)
    s = ops.sum_all(_t(big, spec), spec)
    assert limbs_to_ints(s, spec) == [sum(big) % p]
    # and through the digit limb path, a batch above ops._SMALL
    n = ops._SMALL + 10
    xs, ys = values(p, n, 8), values(p, n, 9)
    got = limbs_to_ints(ops.add(_t(xs, spec), _t(ys, spec), spec), spec)
    assert got == [(x + y) % p for x, y in zip(xs, ys)]


def test_field_words_match_the_cuda_header():
    """The words field_words packs are what csrc/field.cuh unpacks: every
    reader after them (curve_from_words' a) starts at FIELD_WORDS."""
    import re
    from pathlib import Path

    from spartan2_tpu_torch.ec.comb import curve_words
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.utils.cuda import CSRC, field_words

    n = int(re.search(r"constexpr int FIELD_WORDS = (\d+);",
                      (CSRC / "field.cuh").read_text()).group(1))
    curve = get_engine("P256HyraxEngine").curve
    assert len(field_words(curve.base)) == 4 * n
    assert len(curve_words(curve)) == 4 * n + 32
    assert "w + FIELD_WORDS" in (CSRC / "curve.cuh").read_text()
