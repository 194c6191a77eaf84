"""Kernels A and B (their plain versions, CPU) against the JAX package's
host sum-check provers: the ZK cubic and quad drivers, batched over K
instances, and the structured inner round 0.  Every comparison is exact,
and nothing compiles on XLA:CPU (the references are host functions)."""

import pytest
import torch

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.polys.eq import eq_evals_host, eq_evaluate
from spartan2_tpu.sumcheck.host import prove_cubic_with_three_inputs
from spartan2_tpu.sumcheck.host import prove_quad as jax_prove_quad
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.sumcheck.device import (eq_factors, eq_table, inner0_bind,
                                                inner0_evals)
from spartan2_tpu_torch.sumcheck.zk_device import (inner_round0, prove_zk_cubic,
                                                   prove_zk_quad)
from tests.torch_helpers import rand_ints

F = get_field("p256_scalar")
JF = jax_get_field("p256_scalar")


def _up(rows):
    """K lists of ints -> (K, n, 8) Montgomery tensor."""
    return torch.stack([to_device(v, F, "cpu", mont=True) for v in rows])


class Challenges:
    """Fixed challenges; records the round polynomials it is shown."""

    def __init__(self, rs):
        self.rs, self.seen = rs, []

    def port(self, i, unis):
        self.seen.append([u.coeffs for u in unis])
        return self.rs[i]

    def jax(self, i, poly):
        self.seen.append([poly.coeffs])
        return self.rs[i]


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("m", [6, 8])
@pytest.mark.parametrize("taus_kind", ["random", "with_0_and_1"])
def test_zk_cubic_matches_jax_host(K, m, taus_kind):
    p, n = F.modulus, 1 << m
    taus = rand_ints(p, m, 20 + m)
    if taus_kind == "with_0_and_1":
        taus[0], taus[-1] = 0, 1
    eq = eq_evals_host(JF, taus)
    inst, claims = [], []
    for k in range(K):
        A, B = rand_ints(p, n, 30 + k), rand_ints(p, n, 40 + k)
        C = rand_ints(p, n, 50 + k) if k else [a * b % p for a, b in zip(A, B)]
        inst.append((A, B, C))
        claims.append(sum(e * (a * b - c) for e, a, b, c in zip(eq, A, B, C)) % p)
    rs = rand_ints(p, m, 60 + m)

    ch = Challenges(rs)
    E = eq_table(eq_factors(taus, F, "cpu"), F)
    polys = tuple(_up([inst[k][j] for k in range(K)]) for j in range(3))
    r_ours, finals, e_final = prove_zk_cubic(F, claims, E, polys, ch.port)
    assert r_ours == rs
    assert e_final == eq_evaluate(JF, taus, rs)
    for k in range(K):
        ref = Challenges(rs)
        _, r_ref, fin_ref = prove_cubic_with_three_inputs(
            JF, claims[k], taus, *inst[k], challenge_fn=ref.jax)
        assert r_ref == rs
        assert [s[k] for s in ch.seen] == [s[0] for s in ref.seen]
        assert list(finals[k]) == fin_ref


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("m", [6, 8])
def test_zk_quad_matches_jax_host(K, m):
    p, n = F.modulus, 1 << m
    extra = 5  # rows past the sum-check's width: never read, never written
    rows_A = [rand_ints(p, n + extra, 70 + k) for k in range(K)]
    rows_Z = [rand_ints(p, n + extra, 80 + k) for k in range(K)]
    claims = [sum(a * z for a, z in zip(A[:n], Z[:n])) % p
              for A, Z in zip(rows_A, rows_Z)]
    rs = rand_ints(p, m, 90 + m)
    A, Z = _up(rows_A), _up(rows_Z)
    tail = torch.cat([A[:, n:], Z[:, n:]]).clone()
    ch = Challenges(rs)
    r_ours, finals = prove_zk_quad(F, claims, (A, Z), m, ch.port)
    assert r_ours == rs
    assert torch.equal(torch.cat([A[:, n:], Z[:, n:]]), tail)
    for k in range(K):
        ref = Challenges(rs)
        _, _, fin_ref = jax_prove_quad(JF, claims[k], m, rows_A[k][:n],
                                       rows_Z[k][:n], challenge_fn=ref.jax)
        assert [s[k] for s in ch.seen] == [s[0] for s in ref.seen]
        assert list(finals[k]) == fin_ref


def _host_round0(abc, z, nv, ne, r0):
    """spartan_zk.py:252-276 of the JAX package (its host branch)."""
    p = F.modulus
    eval0 = sum(abc[j] * z[j] for j in range(nv)) % p
    corr_low = sum(abc[j] * z[j] for j in range(ne)) % p
    corr_cross = sum((abc[nv + j] - abc[j]) * (z[nv + j] - z[j])
                     for j in range(ne)) % p
    t_inf = (eval0 - corr_low + corr_cross) % p
    a, x = list(abc), list(z)
    for j in range(ne):
        a[j] = (a[j] + r0 * (a[nv + j] - a[j])) % p
        x[j] = (x[j] + r0 * (x[nv + j] - x[j])) % p
    for j in range(ne, nv):
        a[j] = a[j] * (1 - r0) % p
        x[j] = x[j] * (1 - r0) % p
    return (eval0, t_inf), a[:nv], x[:nv]


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("nv,ne", [(16, 1), (16, 5), (64, 33), (8, 8)])
def test_inner_round0_matches_host_formula(K, nv, ne):
    p = F.modulus
    abc = [rand_ints(p, nv + ne, 100 + k) for k in range(K)]
    z = [rand_ints(p, nv + ne, 110 + k) for k in range(K)]
    r0 = rand_ints(p, 1, nv + ne)[0]
    A, Z = _up(abc), _up(z)
    got = inner0_evals(A, Z, nv, ne, F)
    inner0_bind(A, Z, r0, nv, ne, F)
    for k in range(K):
        ev, a_ref, z_ref = _host_round0(abc[k], z[k], nv, ne, r0)
        assert got[k] == ev
        assert limbs_to_ints(A[k, :nv], F, mont=True) == a_ref
        assert limbs_to_ints(Z[k, :nv], F, mont=True) == z_ref
        # the tail past num_vars is left as it was
        assert limbs_to_ints(A[k, nv:], F, mont=True) == abc[k][nv:]


@pytest.mark.parametrize("ne", [1, 3])
def test_structured_inner_sumcheck_equals_padded_quad(ne):
    """Round 0 on kernel B over num_cols, then the quad rounds, gives the
    JAX host quad sum-check's messages over the zero-padded 2 num_vars
    domain (the non-ZK inner sum-check's domain)."""
    p, m = F.modulus, 4
    nv = 1 << m
    abc, z = rand_ints(p, nv + ne, 120 + ne), rand_ints(p, nv + ne, 130 + ne)
    pad = nv - ne
    claim = sum(a * x for a, x in zip(abc, z)) % p
    rs = rand_ints(p, m + 1, 140)
    ref = Challenges(rs)
    _, r_ref, fin_ref = jax_prove_quad(JF, claim, m + 1, abc + [0] * pad,
                                       z + [0] * pad, challenge_fn=ref.jax)
    A, Z = _up([abc]), _up([z])
    ch = Challenges(rs)
    r0, _, claims = inner_round0(F, [claim], A, Z, nv, ne,
                                 lambda unis: ch.port(0, unis))
    r_rest, finals = prove_zk_quad(F, claims, (A, Z), m,
                                   lambda i, unis: ch.port(i + 1, unis))
    assert [r0] + r_rest == r_ref
    assert ch.seen == ref.seen
    assert list(finals[0]) == fin_ref
