"""The port's host helpers against the JAX package's: the debug
constraint system (frontend/test_shape_cs.py ``TestShapeCS``), the host
satisfiability check (``SplitR1CSShape.is_sat_host``) and the host MLE
evaluation (``mle_evaluate_host``).  All host code: nothing compiles on
XLA:CPU."""

import numpy as np
import pytest

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.frontend import constraint_system as jax_csm
from spartan2_tpu.frontend import test_shape_cs as jax_tscs
from spartan2_tpu.frontend.gadgets.sha256 import Sha256Circuit as JaxSha256Circuit
from spartan2_tpu.polys.multilinear import mle_evaluate_host as jax_mle_evaluate_host
from spartan2_tpu.r1cs.shape import SplitR1CSShape as JaxShape
from spartan2_tpu_torch.errors import UnSatError
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.frontend import constraint_system as csm
from spartan2_tpu_torch.frontend import test_shape_cs as tscs
from spartan2_tpu_torch.frontend.constraint_system import ConstraintSystem
from spartan2_tpu_torch.frontend.gadgets.sha256 import Sha256Circuit
from spartan2_tpu_torch.polys.multilinear import mle_evaluate_host
from spartan2_tpu_torch.r1cs.shape import SplitR1CSShape
from tests.torch_helpers import CubicCircuit

F = get_field("pallas_scalar")
PORT = (tscs.TestShapeCS, csm.ONE, csm.lc, F)
JAX = (jax_tscs.TestShapeCS, jax_csm.ONE, jax_csm.lc, jax_get_field("pallas_scalar"))


def _named_circuit(pkg):
    """tests/test_frontend_debug.py's first circuit: namespaces, an input,
    and coefficients -1, 4 and 1."""
    TestShapeCS, ONE, lc, field = pkg
    cs = TestShapeCS(field)
    x = cs.alloc(name="x")
    with cs.namespace("sq"):
        xsq = cs.alloc(name="x_sq")
        cs.enforce(lc((1, x)), lc((1, x)), lc((1, xsq)), name="square")
    y = cs.alloc_input(name="y")
    cs.enforce(lc((1, xsq), (4, x), (field.modulus - 1, ONE)), lc((1, ONE)),
               lc((1, y)), name="out")
    return cs


def _mul_circuit(pkg):
    """tests/test_frontend_debug.py's second circuit: two aux values, one
    constraint, default names."""
    TestShapeCS, _, lc, field = pkg
    cs = TestShapeCS(field)
    a = cs.alloc(name="a")
    b = cs.alloc(name="b")
    cs.enforce(lc((1, a)), lc((1, b)), lc((1, a)), name="mul")
    cs.alloc()
    with cs.namespace("outer"), cs.namespace("inner"):
        cs.enforce(lc((3, a), (1 << 5, b), (1, a)), lc((1, b)), lc(), name="nested")
    return cs


@pytest.mark.parametrize("build", [_named_circuit, _mul_circuit])
def test_test_shape_cs_matches_jax(build):
    got, want = build(PORT), build(JAX)
    assert got.pretty_print() == want.pretty_print()
    assert got.pretty_print_list() == want.pretty_print_list()
    assert (got.num_constraints(), got.num_aux, got.num_inputs) == (
        want.num_constraints(), want.num_aux, want.num_inputs)
    assert (got.input_names, got.aux_names, got.constraint_names) == (
        want.input_names, want.aux_names, want.constraint_names)


def test_test_shape_cs_reference_format():
    cs = _named_circuit(PORT)
    assert cs.pretty_print_list() == ["INPUT y", "AUX x", "AUX sq/x_sq", "sq/square", "out"]
    printed = cs.pretty_print()
    assert "sq/square: (`Ax`) * (`Ax`) = (`Asq/x_sq`)" in printed
    assert "out: (- `IONE` + 2^2 . `Ax` + `Asq/x_sq`) * (`IONE`) = (`Iy`)" in printed
    nested = _mul_circuit(PORT).pretty_print()
    assert "outer/inner/nested: (2^2 . `Aa` + 2^5 . `Ab`) * (`Ab`) = (0)" in nested


def _check_sat(S, jax_S, z, ok: bool):
    if ok:
        S.is_sat_host(z)
        jax_S.is_sat_host(z)
        return
    with pytest.raises(UnSatError):
        S.is_sat_host(z)
    with pytest.raises(Exception, match="unsatisfied"):
        jax_S.is_sat_host(z)


def test_is_sat_host_cubic():
    from tests.torch_golden.make_golden import jax_cubic_circuit

    S = SplitR1CSShape.from_circuit(CubicCircuit(), F, width=4)
    jax_S = JaxShape.from_circuit(jax_cubic_circuit(), JAX[3], width=4)
    z = [2, 4, 8, 15, 1, 15]  # (W, 1, X): witness (2, 4, 8, 15), public 15
    _check_sat(S, jax_S, z, True)
    for i, v in ((0, 3), (3, 16), (5, 14)):
        bad = list(z)
        bad[i] = v
        _check_sat(S, jax_S, bad, False)


def test_is_sat_host_sha256():
    msg = b"spartan2"
    S = SplitR1CSShape.from_circuit(Sha256Circuit(msg), F, width=512)
    jax_S = JaxShape.from_circuit(JaxSha256Circuit(msg), JAX[3], width=512)
    assert (S.num_cons_unpadded, S.num_vars) == (jax_S.num_cons_unpadded, jax_S.num_vars)
    cs = ConstraintSystem(F, shape_mode=False)
    Sha256Circuit(msg).precommitted(cs, [])
    W = list(cs.aux_assignment)
    W += [0] * (S.num_vars - len(W))
    z = W + [1] + cs.input_assignment[1:]
    _check_sat(S, jax_S, z, True)
    bad = list(z)
    bad[len(cs.aux_assignment) // 2] ^= 1  # a bit of the compression
    _check_sat(S, jax_S, bad, False)
    bad = list(z)
    bad[S.num_vars + 1] ^= 1  # a public digest bit
    _check_sat(S, jax_S, bad, False)


@pytest.mark.parametrize("m", [0, 1, 4, 9])
@pytest.mark.parametrize("name", ["p256_scalar", "pallas_scalar", "bn254_scalar"])
def test_mle_evaluate_host_matches_jax(name, m):
    field = get_field(name)
    rng = np.random.default_rng(40 + m)
    draw = [int.from_bytes(rng.bytes(40), "little") % field.modulus
            for _ in range((1 << m) + m)]
    evals, r = draw[: 1 << m], draw[1 << m :]
    got = mle_evaluate_host(field, evals, r)
    assert got == jax_mle_evaluate_host(jax_get_field(name), evals, r)
    if m == 0:
        assert got == evals[0]
