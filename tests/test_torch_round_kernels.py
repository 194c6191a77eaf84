"""Kernel A's bind-first round and kernel F's layouts, on the CPU.

The bind-first round (sumcheck/device.py ``round_sums_bind``,
``round_sums`` given a challenge slot) against Python integers: the
vectors bound with r, then the round's sums.  The ZK drivers that run on
it against the JAX package's host sum-checks on Pallas, K = 3 with a
shared eq included.  The constants that the Python side mirrors from
csrc/sumcheck.cu, csrc/round_finish.cu and csrc/keccak.cuh, read from the
sources; the warp-wide Keccak-f[1600]'s lane maps emulated lane by lane
against the host permutation; and kernel A's one reduction of an
unreduced sum (field.cuh ``acc_reduce``) in Python integers at the
accumulator's extremes.  No CPU test runs the kernels: chip_smoke.py
holds them against these plain versions on the card.
"""

import re

import pytest
import torch

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.polys.eq import eq_evals_host
from spartan2_tpu.sumcheck.host import prove_cubic_with_three_inputs
from spartan2_tpu.sumcheck.host import prove_quad as jax_prove_quad
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.sumcheck import device, prove
from spartan2_tpu_torch.sumcheck.device import (CUBIC, QUAD, eq_factors, eq_table,
                                                round_sums, round_sums_bind)
from spartan2_tpu_torch.sumcheck.zk_device import prove_zk_cubic, prove_zk_quad
from spartan2_tpu_torch.utils.cuda import CSRC
from tests.torch_helpers import rand_ints

FIELDS = ["p256_scalar", "pallas_scalar"]


def _up(spec, rows):
    return to_device(rows, spec, "cpu", mont=True)


def _ints(spec, t):
    return limbs_to_ints(t.reshape(-1, 8), spec, mont=True)


def _bind(p, v, n, r):
    """The first n entries of v bound with r: v_j + r (v_{n/2 + j} - v_j)."""
    h = n // 2
    return [(v[j] + r * (v[h + j] - v[j])) % p for j in range(h)]


def _sums(p, mode, n, vecs):
    """The round's sums over the first n entries, in Python integers."""
    h = n // 2
    if mode == QUAD:
        a, b = vecs
        return [sum(a[j] * b[j] for j in range(h)) % p,
                sum((a[h + j] - a[j]) * (b[h + j] - b[j]) for j in range(h)) % p]
    out = []
    for x in (0, 2, 3):
        vals = [[(v[j] + x * (v[h + j] - v[j])) % p for j in range(h)] for v in vecs]
        e, a, b, c = vals
        out.append(sum(e[j] * (a[j] * b[j] - c[j]) for j in range(h)) % p)
    return out


def _edge(p, n, seed):
    """n entries: random, with zeros and p - 1 among them."""
    v = rand_ints(p, n, seed)
    v[0], v[1], v[n // 2], v[-1] = 0, p - 1, p - 1, 0
    return v


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("mode,K", [(CUBIC, 1), (CUBIC, 3), (QUAD, 1), (QUAD, 2)])
@pytest.mark.parametrize("r_kind", ["zero", "one", "random"])
def test_bind_first_round_equals_bind_then_evaluate(field, mode, K, r_kind):
    """round_sums_bind over vectors that carry 2n rows: the bound vectors
    and the round's sums of every instance, as binding first and then
    evaluating (Python integers); the eq vector is shared by the K
    instances, bound in place for K = 1 and into a second buffer for
    K > 1 (its own rows then left as they were).  Rows past 2n are never
    touched."""
    spec = get_field(field)
    p, n, extra = spec.modulus, 16, 3
    r = {"zero": 0, "one": 1, "random": rand_ints(p, 1, 7)[0]}[r_kind]
    npoly = 3 if mode == CUBIC else 2
    polys = [[_edge(p, 2 * n + extra, 10 * k + j) for k in range(K)] for j in range(npoly)]
    vecs = [torch.stack([_up(spec, rows) for rows in poly]) for poly in polys]
    if mode == CUBIC:
        eq = _edge(p, 2 * n + extra, 99)
        vecs = [_up(spec, eq)] + vecs
    before = [v.clone() for v in vecs]
    eq_out = torch.zeros(n, 8, dtype=torch.int32) if mode == CUBIC and K > 1 else None
    got = round_sums_bind(mode, n, vecs, r, spec, eq_out=eq_out)
    assert got.shape == (K, 2 if mode == QUAD else 3, 8)
    for k in range(K):
        inst = [poly[k] for poly in polys]
        if mode == CUBIC:
            inst = [eq] + inst
        bound = [_bind(p, v, 2 * n, r) for v in inst]
        assert _ints(spec, got[k]) == _sums(p, mode, n, bound)
        for v, b in zip(vecs[1:] if mode == CUBIC else vecs, bound[1:] if mode == CUBIC
                        else bound):
            assert _ints(spec, v[k, :n]) == b
    if mode == CUBIC:
        bound_eq = vecs[0][:n] if eq_out is None else eq_out
        assert _ints(spec, bound_eq) == _bind(p, eq, 2 * n, r)
        if eq_out is not None:
            assert torch.equal(vecs[0], before[0])
    for v, b in zip(vecs, before):
        assert torch.equal(v[..., n:2 * n, :], b[..., n:2 * n, :])
        assert torch.equal(v[..., 2 * n:, :], b[..., 2 * n:, :])


@pytest.mark.parametrize("mode", [CUBIC, QUAD])
def test_round_sums_with_a_challenge_slot(mode):
    """The enqueued provers' form: r read from the round finish's slot
    [r, 1 - r] (Montgomery), one instance -> (1, sums, 8)."""
    spec = get_field("pallas_scalar")
    p, n = spec.modulus, 8
    r = rand_ints(p, 1, 3)[0]
    rows = [_edge(p, 2 * n, 20 + j) for j in range(4 if mode == CUBIC else 2)]
    vecs = [_up(spec, v) for v in rows]
    slot = _up(spec, [r, (1 - r) % p])
    got = round_sums(mode, n, vecs, spec, slot)
    bound = [_bind(p, v, 2 * n, r) for v in rows]
    assert _ints(spec, got[0]) == _sums(p, mode, n, bound)
    assert [_ints(spec, v[:n]) for v in vecs] == bound
    # without a slot: the round over n rows as they are
    assert _ints(spec, round_sums(mode, n, vecs, spec)[0]) == _sums(p, mode, n, bound)


class Challenges:
    def __init__(self, rs):
        self.rs, self.seen = rs, []

    def port(self, i, unis):
        self.seen.append([u.coeffs for u in unis])
        return self.rs[i]

    def jax(self, i, poly):
        self.seen.append([poly.coeffs])
        return self.rs[i]


def test_zk_cubic_k3_shared_eq_pallas_matches_jax_host():
    """A whole ZK cubic sum-check through the bind-first driver, K = 3
    instances over one shared eq table on Pallas (taus 0 and 1 among
    them): each instance's round polynomials and finals equal the JAX
    package's host prover's, and so does the eq table's final value."""
    spec, jf = get_field("pallas_scalar"), jax_get_field("pallas_scalar")
    p, m, K = spec.modulus, 5, 3
    n = 1 << m
    taus = rand_ints(p, m, 1)
    taus[0], taus[2] = 0, 1
    eq = eq_evals_host(jf, taus)
    inst, claims = [], []
    for k in range(K):
        A, B, C = (_edge(p, n, 30 + 3 * k + j) for j in range(3))
        inst.append((A, B, C))
        claims.append(sum(e * (a * b - c) for e, a, b, c in zip(eq, A, B, C)) % p)
    rs = rand_ints(p, m, 2)
    rs[1] = 0
    ch = Challenges(rs)
    E = eq_table(eq_factors(taus, spec, "cpu"), spec)
    polys = tuple(torch.stack([_up(spec, inst[k][j]) for k in range(K)]) for j in range(3))
    r_ours, finals, e_final = prove_zk_cubic(spec, claims, E, polys, ch.port)
    assert r_ours == rs
    for k in range(K):
        ref = Challenges(rs)
        _, _, fin_ref = prove_cubic_with_three_inputs(jf, claims[k], taus, *inst[k],
                                                      challenge_fn=ref.jax)
        assert [s[k] for s in ch.seen] == [s[0] for s in ref.seen]
        assert list(finals[k]) == fin_ref
    want_e = eq
    for r in rs:
        want_e = _bind(p, want_e, len(want_e), r)
    assert e_final == want_e[0]


def test_zk_quad_pallas_matches_jax_host():
    """A whole ZK quad sum-check through the bind-first driver on Pallas,
    K = 2, equal to the JAX package's host prove_quad per instance."""
    spec, jf = get_field("pallas_scalar"), jax_get_field("pallas_scalar")
    p, m, K = spec.modulus, 6, 2
    n = 1 << m
    rows_A = [_edge(p, n, 50 + k) for k in range(K)]
    rows_Z = [_edge(p, n, 60 + k) for k in range(K)]
    claims = [sum(a * z for a, z in zip(A, Z)) % p for A, Z in zip(rows_A, rows_Z)]
    rs = rand_ints(p, m, 4)
    rs[-1] = 1
    ch = Challenges(rs)
    A = torch.stack([_up(spec, v) for v in rows_A])
    Z = torch.stack([_up(spec, v) for v in rows_Z])
    r_ours, finals = prove_zk_quad(spec, claims, (A, Z), m, ch.port)
    assert r_ours == rs
    for k in range(K):
        ref = Challenges(rs)
        _, _, fin_ref = jax_prove_quad(jf, claims[k], m, rows_A[k], rows_Z[k],
                                       challenge_fn=ref.jax)
        assert [s[k] for s in ch.seen] == [s[0] for s in ref.seen]
        assert list(finals[k]) == fin_ref


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_kernel_a_and_f_constants_match_the_cuda_sources():
    """What device.py and prove.py mirror of csrc/sumcheck.cu and
    csrc/round_finish.cu: the block size, kernel A's modes and its grid
    (which the wrapper sizes the scratch for), F's modes, its
    ctx layout (the state at word 16) and its message's two Keccak blocks."""
    sc = (CSRC / "sumcheck.cu").read_text()
    assert _const(sc, "NT") == device._NT
    assert _const(sc, "ROUND_MAX_BLOCKS") == device._ROUND_MAX_BLOCKS
    assert device._nblocks(1) == 1 and device._nblocks(1 << 14) == 64
    assert device._nblocks(1 << 18) == device._ROUND_MAX_BLOCKS
    assert [_const(sc, f"MODE_{m}") for m in ("CUBIC", "QUAD", "DOT")] == [
        device.CUBIC, device.QUAD, device.DOT]
    rf = (CSRC / "round_finish.cu").read_text()
    assert [_const(rf, m) for m in ("GRUEN", "CUBIC_EVALS", "QUAD", "INNER0")] == [
        prove.GRUEN, prove.CUBIC_EVALS, prove.QUAD_EVALS, prove.INNER0]
    assert "ctx + 16" in rf  # rows claim, P, then the 64-byte state (prove._open)
    kc = (CSRC / "keccak.cuh").read_text()
    rate = _const(kc, "KECCAK_RATE")
    suffix = 4 + 2 + 64  # DOM_SEP_TAG, round, state (transcript.py _squeeze)
    assert "constexpr int SQUEEZE_SUFFIX = 4 + 2 + 64;" in kc
    longest = 1 + 32 * (max(prove._NCOEFFS.values()) - 1) + suffix + 1
    assert rate < longest + 1 <= 2 * rate  # two blocks, MSG_LANES = 2 rate / 8
    assert "MSG_LANES = 2 * KECCAK_RATE_LANES" in rf


def test_warp_keccak_lane_maps_equal_the_host_permutation():
    """keccak.cuh's warp-wide Keccak-f[1600], emulated lane by lane with the
    source's rho table and its shuffle sources (theta's columns, pi's
    source lane (x + 3 y) % 5 + 5 x, chi's row neighbours), idle lanes
    25-31 included: equal to transcript/keccak.py's permutation."""
    import random

    from spartan2_tpu_torch.transcript.keccak import _RC, _rotl, keccak_f1600

    kc = (CSRC / "keccak.cuh").read_text()
    body = re.search(r"KECCAK_RHO\[32\] = \{([^}]*)\}", kc).group(1)
    rho = [int(v) for v in body.replace("\n", " ").split(",")]
    assert len(rho) == 32
    assert "const int pi = l < 25 ? (x + 3 * y) % 5 + 5 * x : l - 25;" in kc
    mask = (1 << 64) - 1
    xs = [lane % 5 for lane in range(32)]
    ys = [(lane // 5) % 5 for lane in range(32)]
    pi = [(x + 3 * y) % 5 + 5 * x if lane < 25 else lane - 25
          for lane, x, y in zip(range(32), xs, ys)]
    for seed in range(3):
        st = [random.Random(seed).getrandbits(64) for _ in range(25)]
        a = st + [0] * 7
        for rnd in range(24):
            c = [a[lane] for lane in range(32)]
            for j in range(1, 5):
                c = [c[lane] ^ a[xs[lane] + 5 * ((ys[lane] + j) % 5)] for lane in range(32)]
            a = [a[lane] ^ c[(xs[lane] + 4) % 5] ^ _rotl(c[(xs[lane] + 1) % 5], 1)
                 for lane in range(32)]
            rot = [_rotl(a[lane], rho[lane]) for lane in range(32)]
            b = [rot[pi[lane]] for lane in range(32)]
            a = [b[lane] ^ (~b[(xs[lane] + 1) % 5 + 5 * ys[lane]] & mask
                            & b[(xs[lane] + 2) % 5 + 5 * ys[lane]]) for lane in range(32)]
            a[0] ^= _RC[rnd]
        assert a[:25] == keccak_f1600(list(st))


@pytest.mark.parametrize("field", ["p256_scalar", "pallas_scalar", "bn254_scalar",
                                   "t256_base"])
def test_acc_reduce_in_python_integers(field):
    """field.cuh's acc_reduce, step by step in Python integers: eight
    reduction rows on an accumulator below 2^544 leave T < 2^289, h = T >>
    256 < 2^33, l = T mod 2^256 needs at most 7 subtractions of p, and h R
    (fe_mul_cc(h, R^2)) + l mod p is the Montgomery sum acc R^-1 mod p; at
    zero, at a few products and at the accumulator's largest value."""
    spec = get_field(field)
    p, R = spec.modulus, 1 << 256
    r_inv = pow(R, -1, p)
    n0 = spec.n0
    prods = [x * y for x, y in zip(rand_ints(p, 5, 1), rand_ints(p, 5, 2))]
    for acc in (0, sum(prods), (p - 1) ** 2 * 3, (1 << 544) - 1):
        t = acc
        for i in range(8):
            m = ((t >> (32 * i)) & 0xFFFFFFFF) * n0 & 0xFFFFFFFF
            t += m * p << (32 * i)
        assert t % R == 0 and t < 1 << 545
        T = t >> 256
        h, l = T >> 256, T % R
        assert T < 1 << 289 and h < 1 << 33
        subs = 0
        while l >= p:
            l -= p
            subs += 1
        assert subs <= 7
        assert (h * R * R * r_inv % p + l) % p == acc * r_inv % p
