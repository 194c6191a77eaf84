"""NIFS kernels 3 and 4 (csrc/nifs.cu) emulated in Python on the CPU: the
round's (pair, column, block) map over the real buffers of a run of the
round loop (run_nifs), its weighted last-block finish, and kernel 4's signed
448-bit sums.  No test here runs a kernel (there is no CUDA here); each
repeats the kernel's index arithmetic and checks what the kernel relies on:
no launch reads a byte that a block of the same launch writes, the folds
never write the prep cache's grid, and the finish's sums equal
sum_q w_q S_q."""

import random
import re
from pathlib import Path

import pytest
import torch

from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import to_device
from spartan2_tpu_torch.sumcheck import nifs
from tests.torch_helpers import rand_ints

F = get_field("p256_scalar")
P = F.modulus
R_INV = pow(1 << 256, -1, P)
CU = (Path(nifs.__file__).resolve().parents[1] / "csrc" / "nifs.cu").read_text()
FIN = (Path(nifs.__file__).resolve().parents[1] / "csrc" / "finish.cuh").read_text()
NT = nifs._NT
ELEM = 32  # bytes a field element


def _const(name: str, src: str = CU) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_layout_constants_match_nifs_cu():
    assert (_const("NT"), _const("NIFS_MAX_BLOCKS"), _const("WF_MAX_ROWS")) == (
        nifs._NT, nifs._NIFS_MAX_BLOCKS, nifs._WF_MAX_ROWS)
    assert "finish_weighted_sums<2, NT>" in CU and "reduce_pairs" not in CU
    # the prove's shapes (16 instances of 2^15 constraints): rounds 0-3 and
    # the small round; every grid within one wave of two blocks an SM
    n = 1 << 15
    assert [nifs._nifs_blocks(p, n) for p in (8, 4, 2, 1)] == [32, 64, 128, 128]
    assert all(p * nifs._nifs_blocks(p, n) <= 264 for p in (1, 2, 4, 8, 16, 64, 132))
    assert nifs._nifs_blocks(1000, n) == 1 and nifs._nifs_blocks(1, 100) == 1  # a block a pair


def _round_launch(n: int, pairs: int, bind: bool, ins, outs):
    """The byte addresses each block (bx, q) of a round launch reads and
    writes (nifs_round_kernel): thread x of block bx takes columns k = bx NT
    + x + j gridDim.x NT; with bind it reads rows 4q .. 4q + 3 of each input
    grid and writes rows 2q, 2q + 1 of each output grid, else it reads rows
    2q, 2q + 1 -> ({block: reads}, {block: writes}, {(q, k): times taken})."""
    nb = nifs._nifs_blocks(pairs, n)
    reads, writes, taken = {}, {}, {}
    for q in range(pairs):
        for bx in range(nb):
            rd, wr = set(), set()
            for x in range(NT):
                for k in range(bx * NT + x, n, nb * NT):
                    taken[(q, k)] = taken.get((q, k), 0) + 1
                    for g in range(3):
                        if bind:
                            rd.update(ins[g] + ((4 * q + j) * n + k) * ELEM for j in range(4))
                            wr.update(outs[g] + ((2 * q + s) * n + k) * ELEM for s in range(2))
                        else:
                            rd.update(ins[g] + ((2 * q + j) * n + k) * ELEM for j in range(2))
            reads[(bx, q)], writes[(bx, q)] = rd, wr
    return reads, writes, taken


def _fold_launch(n: int, rows_out: int, ins, outs):
    """fold_kernel: block (bx, g, i) writes row i of output grid g and reads
    rows 2i, 2i + 1 of input grid g, a thread a column."""
    reads, writes = {}, {}
    for g in range(3):
        for i in range(rows_out):
            reads[(g, i)] = {ins[g] + ((2 * i + j) * n + k) * ELEM
                             for j in range(2) for k in range(n)}
            writes[(g, i)] = {outs[g] + (i * n + k) * ELEM for k in range(n)}
    return reads, writes


def _races(reads: dict, writes: dict) -> list:
    """(writer, reader) block pairs of one launch where a block reads a byte
    another block writes."""
    return [(a, b) for a, wa in writes.items() for b, rb in reads.items()
            if a != b and wa & rb]


def test_round_map_out_of_place_has_no_race_and_in_place_would():
    """Over the blocks of one bind-first round (16 -> 8 instances, 4 pairs,
    n = 1024: 4 blocks a pair), each (pair, column) is taken once; written
    to a buffer of its own no block reads what another writes, while the
    same map folding in place would race (the block of pair 1 writes rows
    2, 3, which pair 0's blocks read)."""
    n, I = 1024, 16
    grid = [0x1000000 * (g + 1) for g in range(3)]
    buf = [0x9000000 * (g + 1) for g in range(3)]
    reads, writes, taken = _round_launch(n, I // 4, True, grid, buf)
    assert set(taken.values()) == {1} and len(taken) == (I // 4) * n
    assert _races(reads, writes) == []
    reads, writes, _ = _round_launch(n, I // 4, True, grid, grid)
    races = _races(reads, writes)
    assert races and any(a[1] != b[1] for a, b in races)


def test_run_nifs_buffers_never_alias_the_grid(monkeypatch):
    """run_nifs's real buffers over a run of 16 instances (ell_b = 4:
    round 0, rounds 1-3 into two buffers in turn, the final fold into a
    third): in every launch no block reads a byte a block writes, and no
    launch writes a byte of the grid (the prep cache's)."""
    n, I = 512, 16
    A, B, C = (torch.stack([to_device(rand_ints(P, n, 1000 * j + i), F, "cpu", mont=True)
                            for i in range(I)]) for j in range(1, 4))
    cache = torch.stack([A, B, C])
    before = cache.clone()
    span = (cache.data_ptr(), cache.data_ptr() + cache.numel() * 4)
    launches = []
    real_round, real_fold = nifs.nifs_round, nifs.nifs_fold

    def rec_round(A, B, C, E, w, r, bind_first, spec, out=None, ticket=None):
        ins = [x.data_ptr() for x in (A, B, C)]
        outs = [x.data_ptr() for x in out] if bind_first else None
        pairs = (A.shape[0] // 2 if bind_first else A.shape[0]) // 2
        launches.append(("round", _round_launch(n, pairs, bind_first, ins, outs)[:2]))
        return real_round(A, B, C, E, w, r, bind_first, spec, out, ticket)

    def rec_fold(A, B, C, r, spec, out):
        ins, outs = [x.data_ptr() for x in (A, B, C)], [x.data_ptr() for x in out]
        launches.append(("fold", _fold_launch(n, A.shape[0] // 2, ins, outs)))
        return real_fold(A, B, C, r, spec, out)

    monkeypatch.setattr(nifs, "nifs_round", rec_round)
    monkeypatch.setattr(nifs, "nifs_fold", rec_fold)
    small, ok = nifs.to_small(*cache, F)
    rnd = random.Random(3)
    r_bs, folded = nifs.run_nifs(F, *cache, to_device(rand_ints(P, n, 5), F, "cpu",
                                                      mont=True),
                                 rand_ints(P, 4, 6), lambda t, e0, q: rnd.randrange(P),
                                 small if ok else None)
    assert [k for k, _ in launches] == ["round"] * (3 if ok else 4) + ["fold"]
    for _, (reads, writes) in launches:
        assert _races(reads, writes) == []
        assert not any(span[0] <= a < span[1] for wr in writes.values() for a in wr)
    assert torch.equal(cache, before)
    assert all(not (span[0] <= x.data_ptr() < span[1]) for x in folded)


def _emulate_finish(partial, w, K: int, nb: int, NS: int = 2, nt: int = NT):
    """finish_weighted_sums: warp j keeps sum t = j mod NS of the instances
    k = j / NS, j / NS + WPS, ...; each pair's blocks added by the warp's
    lanes, weighted by w_k (a Montgomery product); the warps' sums added."""
    warps = nt // 32
    assert warps % NS == 0
    wps = warps // NS
    ws = []
    for j in range(warps):
        t, acc = j % NS, 0
        for k in range(j // NS, K, wps):
            s = sum(partial[k][b][t] for b in range(nb)) % P
            acc = (acc + w[k] * s * R_INV) % P
        ws.append(acc)
    return [sum(ws[j] for j in range(t, warps, NS)) % P for t in range(NS)]


@pytest.mark.parametrize("K,nb", [(1, 128), (2, 128), (4, 64), (8, 32), (16, 16),
                                  (300, 1)])
def test_weighted_finish_equals_weighted_pair_sums(K, nb):
    rnd = random.Random(K * 1000 + nb)
    partial = [[[rnd.randrange(P) for _ in range(2)] for _ in range(nb)] for _ in range(K)]
    w = [rnd.randrange(P) for _ in range(K)]
    want = [sum(w[k] * sum(partial[k][b][t] for b in range(nb)) for k in range(K))
            * R_INV % P for t in range(2)]
    assert _emulate_finish(partial, w, K, nb) == want
    assert "static_assert((NT / 32) % NS == 0" in FIN


def test_round_kernel_emulated_equals_host_sums():
    """The whole bind-first round in Python integers through the kernel's
    map: each block's sums over its columns, then the weighted finish,
    against JAX's host loop (test_torch_nifs's _host_sums)."""
    from tests.test_torch_nifs import _host_fold, _host_sums

    n, I = 512, 8
    rows = [[rand_ints(P, n, 50 * g + i) for i in range(I)] for g in range(3)]
    E, r = rand_ints(P, n, 90), rand_ints(P, 1, 91)[0]
    pairs = I // 4
    w = rand_ints(P, pairs, 92)
    nb = nifs._nifs_blocks(pairs, n)
    fA, fB, fC = (_host_fold(X, r) for X in rows)
    partial = [[[0, 0] for _ in range(nb)] for _ in range(pairs)]
    for q in range(pairs):
        for bx in range(nb):
            for x in range(NT):
                for k in range(bx * NT + x, n, nb * NT):
                    bind = [[(X[4 * q + 2 * s][k] + r * (X[4 * q + 2 * s + 1][k]
                                                         - X[4 * q + 2 * s][k])) % P
                             for s in range(2)] for X in rows]
                    (ae, ao), (be, bo), (ce, _) = bind
                    s0 = E[k] * (ae * be - ce)
                    s1 = E[k] * (ao - ae) * (bo - be)
                    partial[q][bx][0] = (partial[q][bx][0] + s0) % P
                    partial[q][bx][1] = (partial[q][bx][1] + s1) % P
    # Montgomery weights: the finish's product w_mont s R^-1 = w s
    got = _emulate_finish(partial, [x * (1 << 256) % P for x in w], pairs, nb)
    assert tuple(got) == _host_sums(fA, fB, fC, E, w)


# ---------------------------------------------------------------------------
# kernel 4: the signed 448-bit sums
# ---------------------------------------------------------------------------

WACC = _const("WACC")
MASK32 = (1 << 32) - 1


def _acc_mul_add(acc: list[int], t: int, e: int) -> None:
    """acc_mul_add word by word: |t| e in 13 words, each complemented when t
    < 0, added to the 14 words with t's sign as the carry in."""
    prod = abs(t) * e
    assert prod < 1 << (13 * 32)
    mask = MASK32 if t < 0 else 0
    c = 1 if t < 0 else 0
    for i in range(WACC):
        word = (prod >> (32 * i)) & MASK32 if i < 13 else 0
        s = acc[i] + (word ^ mask) + c
        acc[i], c = s & MASK32, s >> 32


def _redc_signed(acc: list[int]) -> int:
    """redc_signed: the sign from the top bit, the magnitude reduced once
    (REDC, a 2^-256), the sign put back."""
    v = sum(x << (32 * i) for i, x in enumerate(acc))
    neg = v >> (32 * WACC - 1)
    mag = (1 << (32 * WACC)) - v if neg else v
    assert mag < P << 256  # redc_wide's range
    m = mag * R_INV % P
    return (P - m) % P if neg else m


@pytest.mark.parametrize("case", ["mixed", "positive", "negative", "cancel", "extreme"])
def test_small_round_signed_sums_equal_the_integer_sums(case):
    """A thread's signed sums as kernel 4 keeps them equal sum t_k E_k R^-1
    mod p (the plain value of the sum; E carries R); t within the kernel's
    bound |t| < 2^147, E below p."""
    rnd = random.Random(case)
    top = (1 << 147) - 1
    if case == "extreme":
        ts = [top, -top, -top, -top, top]
        es = [P - 1] * 5
    else:
        ts = [rnd.randrange(-top, top + 1) for _ in range(64)]
        if case == "positive":
            ts = [abs(x) for x in ts]
        elif case == "negative":
            ts = [-abs(x) for x in ts]
        es = [rnd.randrange(P) for _ in ts]
        if case == "cancel":
            ts, es = ts + [-x for x in ts], es + es
    acc = [0] * WACC
    for t, e in zip(ts, es):
        _acc_mul_add(acc, t, e)
    want = sum(t * e for t, e in zip(ts, es))
    assert sum(x << (32 * i) for i, x in enumerate(acc)) == want % (1 << (32 * WACC))
    assert _redc_signed(acc) == want * R_INV % P
    if case == "cancel":
        assert acc == [0] * WACC


def test_small_round_signed_sum_bound():
    """The two's-complement sum holds any thread's terms: at most 2^32 of
    them, each below 2^147 p in magnitude, stays below 2^447."""
    assert (1 << 32) * ((1 << 147) - 1) * (P - 1) < 1 << (32 * WACC - 1)
