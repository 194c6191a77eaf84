"""The port's R1CS shape and SpMV (kernel 1's plain version, CPU) against
the JAX package's host implementations, on the cubic circuit and on a
one-block SHA-256 shape.  Exact equality throughout."""

import pytest
import torch

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.frontend.gadgets.sha256 import Sha256Circuit as JaxSha256
from spartan2_tpu.polys.eq import eq_evals_host as jax_eq_evals
from spartan2_tpu.r1cs.shape import SplitR1CSShape as JaxShape
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.frontend.gadgets.sha256 import Sha256Circuit
from spartan2_tpu_torch.r1cs.shape import SplitR1CSShape
from spartan2_tpu_torch.r1cs.sparse import spmv
from tests.torch_golden.make_golden import jax_cubic_circuit
from tests.torch_helpers import CubicCircuit, rand_ints

F = get_field("p256_scalar")
JF = jax_get_field("p256_scalar")


@pytest.fixture(scope="module", params=["cubic", "sha256_1block"])
def shapes(request):
    if request.param == "cubic":
        ours = SplitR1CSShape.from_circuit(CubicCircuit(), F, width=4)
        ref = JaxShape.from_circuit(jax_cubic_circuit(), JF, width=4)
    else:
        ours = SplitR1CSShape.from_circuit(Sha256Circuit(bytes(55)), F, width=2048)
        ref = JaxShape.from_circuit(JaxSha256(bytes(55)), JF, width=2048)
    ours.attach_device("cpu")
    return ours, ref


def test_shape_matches_jax(shapes):
    ours, ref = shapes
    assert ours.sizes() == ref.sizes()
    for a, b in ((ours.A, ref.A), (ours.B, ref.B), (ours.C, ref.C)):
        assert a.digest_bytes() == b.digest_bytes()


def test_multiply_vec_matches_jax(shapes):
    ours, ref = shapes
    z = rand_ints(F.modulus, ours.num_cols, 1)
    got = ours.multiply_vec(to_device(z, F, "cpu", mont=True))
    for k, M in enumerate((ref.A, ref.B, ref.C)):
        assert limbs_to_ints(got[k], F, mont=True) == M.multiply_vec_host(z)


def test_incremental_prefix_path_matches_jax(shapes):
    ours, ref = shapes
    lo = ours.num_shared + ours.num_precommitted
    z = rand_ints(F.modulus, ours.num_cols, 2)
    zt = to_device(z, F, "cpu", mont=True)
    if 0 < lo < ours.num_cols:
        cached = ours.multiply_vec_precommitted(zt[:lo].contiguous())
        got = ours.multiply_vec_incremental(zt, cached)
    else:  # no prefix segment: the prefix path is a zero cache
        pre = torch.zeros(3, ours.num_cons, 8, dtype=torch.int32)
        got = spmv([ours.dev[n] for n in "ABC"], zt, F, prefix=pre)
    for k, M in enumerate((ref.A, ref.B, ref.C)):
        assert limbs_to_ints(got[k], F, mont=True) == M.multiply_vec_host(z)


def test_poly_abc_combine_matches_jax(shapes):
    ours, ref = shapes
    p = F.modulus
    m = ours.num_cons.bit_length() - 1
    r_x = rand_ints(p, m, 3)
    r = rand_ints(p, 1, 4)[0]
    got = limbs_to_ints(ours.bind_and_prepare_poly_ABC(r_x, r), F, mont=True)
    eq = jax_eq_evals(JF, r_x)
    want = [0] * ref.num_cols
    for scale, M in ((1, ref.A), (r, ref.B), (r * r, ref.C)):
        for row, col, v in M.iter_entries():
            want[col] = (want[col] + scale * v * eq[row]) % p
    assert got == want


def test_evaluate_at_matches_jax_host_walk(shapes):
    ours, ref = shapes
    p = F.modulus
    m_x = ours.num_cons.bit_length() - 1
    m_y = ours.num_vars.bit_length()
    r_x, r_y = rand_ints(p, m_x, 5), rand_ints(p, m_y, 6)
    assert ref._device is None  # the JAX shape takes its host walk
    assert ours.evaluate_at(r_x, r_y) == ref.evaluate_at(r_x, r_y)
