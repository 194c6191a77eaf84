"""The comb table build's schedule (csrc/comb.cu sp2_comb_build), on the CPU.

The build is two launches: a quad of lanes a generator chains the window
bases B_w = 2^(6w) G_j by six doublings a window and writes each at
T[w][1][j] (lane c < 3 its coordinate c); then a thread a (w, j),
window-major, reads B_w there and writes T[w][d][j] = T[w][d-1][j] + B_w
for d = 2 .. 63 and the identity at d = 0.  No CPU test runs the kernels,
so their maps are replayed here thread by thread with the plain group law
and field (ec/comb.py): every (w, d, j) entry written exactly once, every
base written before it is read, and the table equal to ``comb_build_plain``
limb for limb and, in affine form, to the JAX package's host
``scalar_mul(d << 6w, G_j)``.  chip_smoke.py holds the kernels against the
plain version on the card.
"""

import re
from collections import Counter

import pytest
import torch

from spartan2_tpu.ec import curve as jax_curve_mod
from spartan2_tpu_torch.ec import comb
from spartan2_tpu_torch.ec.comb import (DIGITS, WINDOW_BITS, comb_build_plain, pt_add,
                                        pt_dbl_n, to_affine)
from spartan2_tpu_torch.ec.curve import get_curve
from spartan2_tpu_torch.field import ops
from spartan2_tpu_torch.field.limbs import to_device
from spartan2_tpu_torch.utils.cuda import CSRC

CU = (CSRC / "comb.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = ([^;]+);", CU).group(1).replace(
        "1 << WIN", str(1 << WINDOW_BITS)))


def test_build_constants_match_comb_cu():
    assert _const("WIN") == WINDOW_BITS
    assert _const("DIGITS") == DIGITS
    assert _const("BUILD_NT") % 4 == 0  # whole quads in a block
    # the launches the entry makes: 4 lanes a generator, then a thread a (w, j)
    assert "lanes = 4 * (size_t)ncols, n = (size_t)n_win * ncols" in CU


def _gens(curve, C: int, seed: int):
    jc = jax_curve_mod.get_curve(curve.name)
    pts = [jc.scalar_mul(seed + 7 * i + 1, jc.generator) for i in range(C)]
    gx = to_device([g[0] for g in pts], curve.base, "cpu", mont=True)
    gy = to_device([g[1] for g in pts], curve.base, "cpu", mont=True)
    return pts, gx, gy


def _emulate_build(gx: torch.Tensor, gy: torch.Tensor, n_win: int, curve):
    """The two launches of sp2_comb_build, thread by thread -> (table,
    writes of each point or coordinate)."""
    C, nt = gx.shape[0], _const("BUILD_NT")
    table = torch.full((n_win, DIGITS, C, 3, 8), -1, dtype=torch.int32)
    writes = Counter()
    # launch 1: ceil(4 C / nt) blocks; lane t of quad t >> 2 (generator j).
    # The lanes of a quad hold the same point (pt_dbl_quad_n), so the chain
    # is computed once a quad here.
    one = ops.const(1, curve.base, (C,), "cpu")
    B = torch.stack([gx, gy, one], -2)
    bases = [B]
    for _ in range(1, n_win):
        B = pt_dbl_n(B, WINDOW_BITS, curve)
        bases.append(B)
    for t in range(-(-4 * C // nt) * nt):
        j, c = t >> 2, t & 3
        if j >= C or c == 3:
            continue
        for w in range(n_win):
            table[w, 1, j, c] = bases[w][j, c]
            writes[(w, 1, j, c)] += 1
    # launch 2: ceil(n_win C / nt) blocks; thread t = w C + j
    n = n_win * C
    reads = []
    for t in range(-(-n // nt) * nt):
        if t >= n:
            continue
        w, j = divmod(t, C)
        assert all(writes[(w, 1, j, c)] == 1 for c in range(3)), "base read before written"
        reads.append((w, j))
        table[w, 0, j] = torch.stack([one[0], one[0], torch.zeros_like(one[0])])
        writes[(w, 0, j)] += 1
    # the threads' chains, their additions batched (each thread's own points)
    B = torch.stack([table[w, 1, j] for w, j in reads])
    acc = B
    for d in range(2, DIGITS):
        acc = pt_add(acc, B, curve)
        for i, (w, j) in enumerate(reads):
            table[w, d, j] = acc[i]
            writes[(w, d, j)] += 1
    return table, writes


@pytest.mark.parametrize("name,C,n_win", [("p256", 3, 5), ("pallas", 3, 5), ("p256", 1, 43)])
def test_two_launch_build_equals_plain_and_host_scalar_mul(name, C, n_win):
    curve = get_curve(name)
    pts, gx, gy = _gens(curve, C, seed=len(name) + n_win)
    table, writes = _emulate_build(gx, gy, n_win, curve)
    want = {(w, d, j): 1 for w in range(n_win) for d in range(DIGITS) for j in range(C)
            if d != 1}
    want.update({(w, 1, j, c): 1 for w in range(n_win) for j in range(C) for c in range(3)})
    assert dict(writes) == want  # every entry exactly once
    assert torch.equal(table, comb_build_plain(gx, gy, n_win, curve))
    if C > 1:
        jc = jax_curve_mod.get_curve(name)
        got = to_affine(table.reshape(-1, 3, 8), curve)
        for i, pt in enumerate(got):
            w, d, j = i // (DIGITS * C), i // C % DIGITS, i % C
            assert pt == jc.scalar_mul(d << (WINDOW_BITS * w), pts[j]), (w, d, j)


def test_fewer_windows_are_the_first_windows():
    """A table of fewer windows over the same generators is the first
    windows of a longer one, limb for limb (chip_smoke.py holds the 11-window
    table against the 43-window plain table's first 11 windows)."""
    curve = get_curve("p256")
    _, gx, gy = _gens(curve, 2, seed=3)
    assert torch.equal(comb_build_plain(gx, gy, 2, curve),
                       comb_build_plain(gx, gy, 5, curve)[:2])


def test_cpu_wrapper_is_the_plain_version():
    curve = get_curve("pallas")
    _, gx, gy = _gens(curve, 2, seed=5)
    assert torch.equal(comb.comb_build(gx, gy, 3, curve), comb_build_plain(gx, gy, 3, curve))
