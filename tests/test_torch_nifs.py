"""NeutronNova's kernels (their plain versions, CPU) against the JAX
package's host functions: the power table (kernel 1), the batched SpMV
(kernel 2), the NIFS rounds and folds (kernel 3) and the small-value
round 0 (kernel 4).  Every comparison is exact, and nothing compiles on
XLA:CPU (the references are host functions)."""

import random

import pytest
import torch

from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.polys.eq import pow_evaluate as jax_pow_evaluate
from spartan2_tpu.polys.eq import pow_split_evals_host
from spartan2_tpu.r1cs.shape import SplitR1CSShape as JaxShape
from spartan2_tpu.r1cs.sparse import SparseMatrix as JaxSparse
from spartan2_tpu.snark.neutronnova import nifs_finish_round, nifs_update_state
from spartan2_tpu.snark.neutronnova import suffix_weight as jax_suffix_weight
from spartan2_tpu.snark.neutronnova import weights_from_r as jax_weights_from_r
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.polys.eq import pow_evaluate, pow_generators
from spartan2_tpu_torch.r1cs.shape import SplitR1CSShape
from spartan2_tpu_torch.r1cs.sparse import DeviceCSR, SparseMatrix, spmv_batched
from spartan2_tpu_torch.snark.neutronnova import weights_from_r
from spartan2_tpu_torch.sumcheck.device import pow_table
from spartan2_tpu_torch.sumcheck.nifs import (nifs_fold, nifs_round, run_nifs,
                                              small_round, suffix_weight, to_small,
                                              weighted_fold)
from tests.torch_helpers import (CoreCircuit, PrecommittedStepCircuit,
                                 SquareStepCircuit, rand_ints)

F = get_field("p256_scalar")
JF = jax_get_field("p256_scalar")
P = F.modulus


def _up(vals):
    return to_device(vals, F, "cpu", mont=True)


def _grid(rows):
    """I lists of n ints -> (I, n, 8) Montgomery."""
    return torch.stack([_up(r) for r in rows])


def _ints(t):
    return limbs_to_ints(t.reshape(-1, 8), F, mont=True)


# ---------------------------------------------------------------------------
# kernel 1: the power table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ell", [1, 5, 8])
@pytest.mark.parametrize("tau", [0, 1, 7, None])
def test_pow_table_equals_split_evals(ell, tau):
    tau = rand_ints(P, 1, ell)[0] if tau is None else tau
    L, R = 1 << -(-ell // 2), 1 << (ell // 2)
    left, right = pow_split_evals_host(JF, tau, ell, L, R)
    want = [left[k % L] * right[k // L] % P for k in range(L * R)]
    got = _ints(pow_table(_up(pow_generators(F, tau, ell)), F))
    assert got == want == [pow(tau, k, P) for k in range(1 << ell)]
    r = rand_ints(P, ell, 3 + ell)
    assert pow_evaluate(F, tau, r) == jax_pow_evaluate(JF, tau, r)


# ---------------------------------------------------------------------------
# kernel 2: the batched SpMV, and equalize
# ---------------------------------------------------------------------------


def test_spmv_batched_matches_jax_host():
    rows, cols, I = 48, 40, 4
    rnd = random.Random(5)
    mats = []
    for m in range(3):
        entries = {(r, rnd.randrange(cols)): rnd.randrange(P) for r in range(rows)
                   for _ in range(rnd.randrange(4))}
        # a skewed column, as the ONE column of an R1CS transposes to
        entries.update({(r, cols - 1): (m + 2) for r in range(0, rows, 2)})
        entries.update({(r, c): rnd.randrange(P) for r in range(3) for c in range(cols)})
        mats.append([(r, c, v) for (r, c), v in sorted(entries.items())])
    port = [SparseMatrix.from_coo(F, e, rows, cols) for e in mats]
    jax = [JaxSparse.from_coo(JF, e, rows, cols) for e in mats]
    zs = [rand_ints(P, cols, 70 + i) for i in range(I)]
    got = spmv_batched([DeviceCSR.build(M, "cpu") for M in port], _grid(zs), F)
    assert got.shape == (3, I, rows, 8)
    for y, M in enumerate(jax):
        for i, z in enumerate(zs):
            assert _ints(got[y, i]) == M.multiply_vec_host(z)


@pytest.mark.parametrize("kind", ["square", "precommitted"])
def test_equalize_matches_jax(kind):
    from tests.test_neutronnova import CoreCircuit as JaxCore
    from tests.test_neutronnova import PrecommittedStepCircuit as JaxPre
    from tests.test_neutronnova import SquareStepCircuit as JaxSquare

    step, jstep = ((SquareStepCircuit(3), JaxSquare(3)) if kind == "square"
                   else (PrecommittedStepCircuit(3), JaxPre(3)))
    S = [SplitR1CSShape.from_circuit(c, F, 4) for c in (step, CoreCircuit())]
    J = [JaxShape.from_circuit(c, JF, 4) for c in (jstep, JaxCore())]
    SplitR1CSShape.equalize(*S)
    JaxShape.equalize(*J)
    for s, j in zip(S, J):
        assert s.sizes() == j.sizes() and (s.num_vars, s.num_cols) == (j.num_vars,
                                                                      j.num_cols)
        for a, b in ((s.A, j.A), (s.B, j.B), (s.C, j.C)):
            assert (a.data, a.indices, a.indptr, a.cols) == (b.data, b.indices,
                                                              b.indptr, b.cols)


# ---------------------------------------------------------------------------
# kernel 3: NIFS rounds and folds
# ---------------------------------------------------------------------------


def _host_fold(layers, r):
    half = len(layers) // 2
    return [[(e + r * (o - e)) % P for e, o in zip(layers[2 * i], layers[2 * i + 1])]
            for i in range(half)]


def _host_sums(A, B, C, E, w):
    """JAX's host NIFS loop (neutronnova.py:233-248) for one round."""
    e0 = quad = 0
    for q, wq in enumerate(w):
        Ae, Ao, Be, Bo, Ce = A[2 * q], A[2 * q + 1], B[2 * q], B[2 * q + 1], C[2 * q]
        se0 = sum(E[k] * (Ae[k] * Be[k] - Ce[k]) for k in range(len(E))) % P
        squad = sum(E[k] * (Ao[k] - Ae[k]) * (Bo[k] - Be[k]) for k in range(len(E))) % P
        e0, quad = (e0 + wq * se0) % P, (quad + wq * squad) % P
    return e0, quad


@pytest.mark.parametrize("I", [2, 4, 8, 16])
@pytest.mark.parametrize("bind_first", [False, True])
def test_nifs_round_matches_jax_host_loop(I, bind_first):
    """A round over I instances; with bind_first the grid holds 2I
    instances that the round first folds into I, in a buffer of its own."""
    n = 16
    G = 2 * I if bind_first else I
    A, B, C = ([rand_ints(P, n, 100 * j + i) for i in range(G)] for j in range(1, 4))
    E = rand_ints(P, n, 9)
    r = rand_ints(P, 1, 10)[0]
    ell_b = G.bit_length() - 1
    rhos = rand_ints(P, ell_b, 11)
    t = 1 if bind_first else 0
    hA, hB, hC = (_host_fold(X, r) for X in (A, B, C)) if bind_first else (A, B, C)
    pairs = len(hA) // 2
    w = [jax_suffix_weight(JF, t, ell_b, q, rhos) for q in range(pairs)]
    assert w == [suffix_weight(F, t, ell_b, q, rhos) for q in range(pairs)]
    gA, gB, gC = _grid(A), _grid(B), _grid(C)
    out = torch.empty(3, I, n, 8, dtype=torch.int32) if bind_first else None
    got = nifs_round(gA, gB, gC, _up(E), _up(w), r, bind_first, F, out)
    assert tuple(got) == _host_sums(hA, hB, hC, E, w)
    if bind_first:  # the fold landed in the output buffer
        assert [[_ints(x[i]) for i in range(I)] for x in out] == [hA, hB, hC]
    # the input grid is only read
    assert [[_ints(x[i]) for i in range(G)] for x in (gA, gB, gC)] == [A, B, C]


def test_nifs_fold_refuses_in_place_and_missing_output():
    """A fold's output shares no byte with its input grid."""
    g = [_grid([rand_ints(P, 4, 40 + 3 * j + i) for i in range(4)]) for j in range(3)]
    with pytest.raises(ValueError, match="output"):
        nifs_round(*g, _up([1] * 4), _up([1]), 5, True, F)
    with pytest.raises(ValueError, match="overlaps"):
        nifs_round(*g, _up([1] * 4), _up([1]), 5, True, F, [x[:2] for x in g])
    with pytest.raises(ValueError, match="overlaps"):
        nifs_fold(*g, 5, F, [g[0][2:], g[1][2:], g[2][2:]])


def test_run_nifs_and_folds_match_jax_host():
    """The whole driver against JAX's host rounds (neutronnova.py:225-270):
    round polynomials, challenges, final layers, then the witness fold."""
    I, n = 8, 8
    A, B, C = ([rand_ints(P, n, 200 * j + i) for i in range(I)] for j in range(1, 4))
    E = rand_ints(P, n, 3)
    rhos = rand_ints(P, 3, 4)

    def challenge(t, coeffs):
        return (sum(coeffs) * 7919 + t + 1) % P

    # JAX host reference
    state, polys, r_bs = {"T_cur": 0, "acc_eq": 1}, [], []
    hA, hB, hC = A, B, C
    for t in range(3):
        w = [jax_suffix_weight(JF, t, 3, q, rhos) for q in range(len(hA) // 2)]
        coeffs = nifs_finish_round(JF, state, rhos[t], *_host_sums(hA, hB, hC, E, w))
        polys.append(coeffs)
        r_bs.append(challenge(t, coeffs))
        nifs_update_state(JF, state, coeffs, rhos[t], r_bs[-1])
        hA, hB, hC = (_host_fold(X, r_bs[-1]) for X in (hA, hB, hC))

    port_state, port_polys = {"T_cur": 0, "acc_eq": 1}, []

    def round_cb(t, e0, quad):
        coeffs = nifs_finish_round(JF, port_state, rhos[t], e0, quad)
        port_polys.append(coeffs)
        r_b = challenge(t, coeffs)
        nifs_update_state(JF, port_state, coeffs, rhos[t], r_b)
        return r_b

    grid = [_grid(X) for X in (A, B, C)]
    got_r, (Az, Bz, Cz) = run_nifs(F, *grid, _up(E), rhos, round_cb)
    assert (got_r, port_polys) == (r_bs, polys)
    assert [_ints(Az), _ints(Bz), _ints(Cz)] == [hA[0], hB[0], hC[0]]
    # the rounds only read the grid (the prep cache's on the main path)
    assert [[_ints(x[i]) for i in range(I)] for x in grid] == [A, B, C]

    weights = jax_weights_from_r(JF, r_bs, I)
    assert weights_from_r(F, r_bs, I) == weights
    W = [rand_ints(P, 12, 300 + i) for i in range(I)]
    want = [sum(wi * Wi[j] for wi, Wi in zip(weights, W)) % P for j in range(12)]
    assert _ints(weighted_fold(_grid(W), _up(weights), F)) == want
    # the rows as separate tensors, as the prove passes them
    assert _ints(weighted_fold([_up(x) for x in W], _up(weights), F)) == want
    # the final fold alone, I = 2 -> 1, into its own buffer
    g = [_grid(X[:2]) for X in (A, B, C)]
    out = torch.empty(3, 1, n, 8, dtype=torch.int32)
    nifs_fold(*g, r_bs[0], F, out)
    assert [_ints(x[0]) for x in out] == [_host_fold(X[:2], r_bs[0])[0] for X in (A, B, C)]
    assert [[_ints(x[i]) for i in range(2)] for x in g] == [X[:2] for X in (A, B, C)]


def test_run_nifs_one_instance_returns_copies():
    """With one instance there is no round: run_nifs hands back copies of
    the grid's rows, which the outer sum-check then binds in place."""
    n = 8
    rows = [rand_ints(P, n, 500 + j) for j in range(3)]
    grid = [_grid([x]) for x in rows]
    r_bs, folded = run_nifs(F, *grid, _up(rand_ints(P, n, 7)), [], None)
    assert r_bs == []
    for x, g, want in zip(folded, grid, rows):
        assert _ints(x) == want
        assert x.data_ptr() != g.data_ptr()
        x.zero_()
        assert _ints(g[0]) == want


# ---------------------------------------------------------------------------
# kernel 4: the small-value round 0
# ---------------------------------------------------------------------------


def _small_grid(rnd, I, n, lo_bits, hi_bits):
    """I rows of n field elements whose signed values have magnitudes in
    [2^lo_bits, 2^hi_bits)."""
    rows = []
    for _ in range(I):
        row = []
        for _ in range(n):
            v = rnd.randrange(1 << lo_bits, 1 << hi_bits) if lo_bits else rnd.randrange(
                1 << hi_bits)
            row.append((-v if rnd.randrange(2) else v) % P)
        rows.append(row)
    return rows


def small_values(S) -> list[int]:
    """(..., 4) small entries -> signed ints."""
    out = []
    for row in S.reshape(-1, 4).tolist():
        m = sum((w & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row[:3]))
        out.append(-m if row[3] else m)
    return out


def _jax_gate(v: int) -> bool:
    """to_small_planes' predicate (field/small_value.py:66-89 of the JAX
    package), in Python: v < 2^72 or p - v < 2^72."""
    return v < (1 << 72) or P - v < (1 << 72)


@pytest.mark.parametrize("window", ["below_2^62", "2^62_to_2^72", "one_large"])
def test_small_round0_matches_montgomery_and_jax(window):
    I, n = 4, 32
    rnd = random.Random(17)
    lo, hi = (0, 62) if window == "below_2^62" else (62, 72)
    A, B, C = (_small_grid(rnd, I, n, lo, hi) for _ in range(3))
    if window == "one_large":
        B[2][5] = (1 << 72) + 3  # just outside the window
    E = rand_ints(P, n, 21)
    rhos = rand_ints(P, 2, 22)
    w = [jax_suffix_weight(JF, 0, 2, q, rhos) for q in range(I // 2)]
    gA, gB, gC = _grid(A), _grid(B), _grid(C)
    S, ok = to_small(gA, gB, gC, F)
    flat = [v for X in (A, B, C) for row in X for v in row]
    assert ok == all(_jax_gate(v) for v in flat) == (window != "one_large")
    reps = small_values(S)
    assert reps == [(v if v < (1 << 72) else v - P) if _jax_gate(v) else 0 for v in flat]
    mont = nifs_round(gA, gB, gC, _up(E), _up(w), 0, False, F)
    assert tuple(mont) == _host_sums(A, B, C, E, w)
    if ok:
        assert small_round(S, _up(E), _up(w), F) == mont
