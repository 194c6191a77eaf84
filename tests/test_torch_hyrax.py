"""The port's Hyrax PCS (kernels 3 and 4 through their plain versions,
CPU) against the JAX package: commitments, the row bind, and a port
evaluation argument checked by JAX's HyraxPCS.verify."""

import pytest

from spartan2_tpu.errors import InvalidPCSError
from spartan2_tpu.pcs.hyrax import HyraxBlind as JaxBlind
from spartan2_tpu.pcs.hyrax import HyraxCommitment as JaxCommitment
from spartan2_tpu.pcs.hyrax import HyraxEvaluationArgument as JaxArg
from spartan2_tpu.pcs.hyrax import IpaProof as JaxIpa
from spartan2_tpu.polys.eq import eq_evals_host
from spartan2_tpu.provider.engines import get_engine as jax_get_engine
from spartan2_tpu.transcript.transcript import Transcript as JaxTranscript
from spartan2_tpu_torch.errors import InvalidPCSError as PortInvalidPCSError
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.pcs.hyrax import hyrax_bind
from spartan2_tpu_torch.provider.engines import get_engine
from spartan2_tpu_torch.transcript.transcript import Transcript
from tests.torch_helpers import det, rand_ints

WIDTH = 8


@pytest.fixture(scope="module")
def pcs():
    eng, jeng = get_engine("P256HyraxEngine"), jax_get_engine("P256HyraxEngine")
    ck, _ = eng.pcs.setup(b"ck", 4 * WIDTH, WIDTH, "cpu")
    jck, _ = jeng.pcs.setup(b"ck", 4 * WIDTH, WIDTH)
    ck_s, _ = eng.pcs.setup(b"ck_s", 1, 1, "cpu")
    jck_s, _ = jeng.pcs.setup(b"ck_s", 1, 1)
    return eng, jeng, ck, jck, ck_s, jck_s


@pytest.mark.parametrize("small", [True, False])
def test_commit_matches_jax(pcs, small):
    eng, jeng, ck, jck, _, _ = pcs
    p = eng.scalar.modulus
    v = rand_ints(1 << 64 if small else p, 3 * WIDTH - 3, 1)
    blind = eng.pcs.blind(ck, len(v), rng=det(7))
    got = eng.pcs.commit(ck, v, blind, is_small=small)
    want = jeng.pcs.commit_host(jck, v, JaxBlind(blind.blind))
    assert got.comm == want.comm and len(got.comm) == 3


def test_commit_zeros_matches_jax(pcs):
    eng, jeng, ck, jck, _, _ = pcs
    blind = eng.pcs.blind(ck, 2 * WIDTH, rng=det(8))
    got = eng.pcs.commit_zeros(ck, 2 * WIDTH, blind)
    assert got.comm == [jeng.curve.scalar_mul(b, jck.h) for b in blind.blind]


@pytest.mark.parametrize("entries", ["random", "p-1"])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_bind_matches_jax_direct_opening(pcs, rows, entries):
    """Kernel 4's plain version (the port's row bind) against JAX's host
    direct opening, v = L * poly-as-matrix, at 1-8 rows of WIDTH."""
    eng, jeng, _, jck, _, _ = pcs
    F = eng.scalar
    p = F.modulus
    poly = (rand_ints(p, rows * WIDTH, 2) if entries == "random"
            else [p - 1] * (rows * WIDTH))
    nr = rows.bit_length() - 1  # row variables, then 3 column variables
    point = rand_ints(p, nr + 3, 3)
    L = eq_evals_host(jeng.scalar, point[:nr])
    got = hyrax_bind(to_device(L, F, "cpu", mont=True),
                     to_device(poly, F, "cpu", mont=True).reshape(rows, WIDTH, 8), F)
    v, _ = jeng.pcs.prove_direct(jck, poly, JaxBlind([0] * rows), point)
    assert limbs_to_ints(got, F) == v


@pytest.mark.parametrize("rows", [1, 4])
def test_port_prove_verifies_under_jax(pcs, rows):
    eng, jeng, ck, jck, ck_s, jck_s = pcs
    F = eng.scalar
    p = F.modulus
    n = rows * WIDTH
    poly = rand_ints(p, n, 4)
    point = rand_ints(p, n.bit_length() - 1, 5)
    blind = eng.pcs.blind(ck, n, rng=det(9))
    comm = eng.pcs.commit(ck, poly, blind)
    value = sum(a * b for a, b in zip(poly, eq_evals_host(jeng.scalar, point))) % p
    b_eval = eng.pcs.blind(ck_s, 1, rng=det(10))
    c_eval = eng.pcs.commit_host(ck_s, [value], b_eval)
    arg = eng.pcs.prove(ck, ck_s, Transcript(F, b"pcs"), comm,
                        to_device(poly, F, "cpu", mont=True), blind, point,
                        c_eval, b_eval, rng=det(11))
    ipa = arg.ipa
    jarg = JaxArg(JaxIpa(ipa.delta, ipa.beta, ipa.z_vec, ipa.z_delta, ipa.z_beta))
    jeng.pcs.verify(jck, jck_s, JaxTranscript(jeng.scalar, b"pcs"),
                    JaxCommitment(comm.comm), point, JaxCommitment(c_eval.comm), jarg)
    eng.pcs.verify(ck, ck_s, Transcript(F, b"pcs"), comm, point, c_eval, arg)
    bad = list(point)
    bad[0] = (bad[0] + 1) % p
    with pytest.raises(InvalidPCSError):
        jeng.pcs.verify(jck, jck_s, JaxTranscript(jeng.scalar, b"pcs"),
                        JaxCommitment(comm.comm), bad, JaxCommitment(c_eval.comm),
                        jarg)


def test_port_verify_folds_rows_on_msm(pcs):
    """64 rows: the verifier folds the row commitments with the
    runtime-point MSM (kernel 5's plain version here)."""
    eng, jeng, ck, _, ck_s, _ = pcs
    F = eng.scalar
    p = F.modulus
    n = 64 * WIDTH
    poly = rand_ints(p, n, 12)
    point = rand_ints(p, n.bit_length() - 1, 13)
    blind = eng.pcs.blind(ck, n, rng=det(14))
    comm = eng.pcs.commit(ck, poly, blind)
    value = sum(a * b for a, b in zip(poly, eq_evals_host(jeng.scalar, point))) % p
    b_eval = eng.pcs.blind(ck_s, 1, rng=det(15))
    c_eval = eng.pcs.commit_host(ck_s, [value], b_eval)
    arg = eng.pcs.prove(ck, ck_s, Transcript(F, b"pcs"), comm,
                        to_device(poly, F, "cpu", mont=True), blind, point,
                        c_eval, b_eval, rng=det(16))
    eng.pcs.verify(ck, ck_s, Transcript(F, b"pcs"), comm, point, c_eval, arg)
    bad = list(point)
    bad[-1] = (bad[-1] + 1) % p
    with pytest.raises(PortInvalidPCSError):
        eng.pcs.verify(ck, ck_s, Transcript(F, b"pcs"), comm, bad, c_eval, arg)
