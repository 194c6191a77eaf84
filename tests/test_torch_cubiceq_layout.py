"""Kernel G's and kernel 4's layouts, on the CPU.

Kernel G (csrc/cubiceq.cu) splits a two-level Gruen round into left rows,
cut into sub-rows: a segment of threads adds ER[lo] f over one sub-row's
pairs unreduced, reduces once and multiplies by EL[hi] once, and the
blocks' sums are finished in the launch.  No CPU test runs the kernel, so
its thread map is emulated here loop for loop in Python integers (grid,
sub-rows, tiles, segments, the shard stride) and held against the plain
version: every local pair taken exactly once, every pair of a sub-row
under its left row's EL entry, the sums equal.  The grid rules and refusals the wrappers mirror from the
CUDA sources (G's grid and ticket, kernel 4's slices and shape limits)
are read from the sources.  chip_smoke.py holds the kernels against
their plain versions on the card.
"""

import inspect
import random
import re

import pytest
import torch

from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.pcs import hyrax
from spartan2_tpu_torch.sumcheck import device
from spartan2_tpu_torch.sumcheck.device import cubiceq_evals, cubiceq_evals_plain
from spartan2_tpu_torch.utils.cuda import CSRC


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _emulate_g(half, hi_len, rlog, lw, shard, zc, fb, vals, max_blocks, p):
    """Kernel G's loops over Python integers (values, not Montgomery), on
    a grid of at most max_blocks blocks (device._G_MAX_BLOCKS, which the
    caller sets to it, and _G_WAVE to half of it): -> ([t0, tinf, tm1],
    how often each local pair was taken)."""
    NT = device._NT
    A, B, C, EL, ER = vals
    two = EL is not None
    nblocks = max(1, min(device._g_shape(half, rlog, lw, two)[2], max_blocks))
    taken = [0] * half
    mask = (1 << rlog) - 1

    def f_terms(i):
        live = i < hi_len
        a0, b0, c0 = A[i], B[i], C[i]
        a1, b1, c1 = ((A[half + i], B[half + i], C[half + i]) if live else (0, 0, 0))
        return [0 if zc else a0 * b0 - c0, (a1 - a0) * (b1 - b0),
                (2 * a0 - a1) * (2 * b0 - b1) - (2 * c0 - c1) if fb else 0]

    sums = [0, 0, 0]
    for blk in range(nblocks):
        if two:
            lr, seg, ntiles = device._g_shape(half, rlog, lw, True)
            per_tile = NT // seg
            for tile in range(blk, ntiles, nblocks):
                for s in range(per_tile):  # the tile's segments
                    q = tile * per_tile + s  # the sub-row
                    inner = [0, 0, 0]  # the segment's unreduced sums
                    for lane in range(seg):
                        for k in range(lane, lr, seg):
                            i = q * lr + k
                            if i >= half:
                                break
                            g = shard + (i << lw)
                            assert g >> rlog == (shard + ((q * lr) << lw)) >> rlog
                            taken[i] += 1
                            for t, v in enumerate(f_terms(i)):
                                inner[t] += ER[g & mask] * v
                    i0 = q * lr
                    el = EL[(shard + (i0 << lw)) >> rlog] if i0 < half else 0
                    for t in range(3):  # one reduction a sub-row and sum, one EL product
                        sums[t] += (inner[t] % p) * el
        else:
            acc = [0, 0, 0]
            for tid in range(NT):
                for i in range(blk * NT + tid, half, nblocks * NT):
                    taken[i] += 1
                    for t, v in enumerate(f_terms(i)):
                        acc[t] += ER[shard + (i << lw)] * v
            for t in range(3):
                sums[t] += acc[t] % p
    return [s % p for s in sums], taken


# (half, hi_len, rlog, lw, shard, two-level, zero_check, fallback, max_blocks):
# rows of >= NT pairs (the main path's shapes, cut: 2 rows of 1024 in
# sub-rows of NT, one sub-row a row on 3 blocks, 16 rows of 1024, 2 of 512
# at lw = 1, 256 of 512 on a grid below its tiles, 4 rows of 1024 in
# sub-rows of 512 as in round 2), rows of 32..NT, below 32, a ragged last
# row, lw > rlog, one-level, grids below the tiles
CASES = [
    (2048, 1500, 10, 0, 0, True, True, False, 264),
    (2048, 2048, 10, 0, 0, True, False, True, 3),
    (1 << 14, 5000, 10, 0, 0, True, False, False, 264),
    (1024, 700, 10, 1, 1, True, False, True, 264),
    (1 << 17, 40000, 9, 0, 0, True, True, False, 100),
    (512, 0, 6, 0, 0, True, False, False, 264),
    (512, 200, 7, 1, 1, True, True, True, 2),
    (96, 96, 3, 0, 0, True, False, True, 264),
    (40, 17, 4, 0, 0, True, True, False, 264),
    (256, 100, 6, 2, 3, True, False, False, 264),
    (64, 64, 1, 2, 1, True, False, True, 264),
    (600, 300, 0, 1, 1, False, False, True, 2),
    (300, 0, 0, 0, 0, False, True, False, 264),
    (0, 0, 5, 0, 0, True, False, False, 264),
    (4096, 3000, 10, 0, 0, True, False, True, 16),
]


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_kernel_g_thread_map_equals_the_plain_sums(case, monkeypatch):
    half, hi_len, rlog, lw, shard, two, zc, fb, max_blocks = case
    monkeypatch.setattr(device, "_G_MAX_BLOCKS", max_blocks)
    monkeypatch.setattr(device, "_G_WAVE", max(1, max_blocks // 2))
    spec = get_field("p256_scalar")
    p = spec.modulus
    rnd = random.Random(half * 31 + rlog * 7 + lw)
    rows = max(1, 2 * half)
    A, B, C = ([rnd.randrange(p) for _ in range(rows)] for _ in range(3))
    glob = half << lw
    if two:
        ER = [rnd.randrange(p) for _ in range(1 << rlog)]
        EL = [rnd.randrange(p) for _ in range(max(1, -(-glob >> rlog)))]
    else:
        ER, EL = [rnd.randrange(p) for _ in range(max(1, glob))], None
    got, taken = _emulate_g(half, hi_len, rlog, lw, shard, zc, fb, (A, B, C, EL, ER),
                            max_blocks, p)
    assert taken == [1] * half

    def up(v):
        return to_device(v, spec, "cpu", mont=True)

    want = cubiceq_evals_plain(up(A), up(B), up(C), half, hi_len,
                               None if EL is None else up(EL), up(ER), rlog, zc, fb,
                               spec, shard, lw)
    assert limbs_to_ints(want[0], spec, mont=True) == got


def test_kernel_g_grid_and_refusals_match_the_cuda_source():
    """What device.py mirrors of csrc/cubiceq.cu: the block size, the map
    (sub-rows capped so that the tiles fit G_WAVE; a tile a block up
    to G_MAX_BLOCKS; the partial sums are sized by the grid and the C side
    refuses another), the least segment, the one-row output with its
    ticket, and the shape limits it refuses."""
    src = (CSRC / "cubiceq.cu").read_text()
    assert _const(src, "NT") == device._NT
    assert _const(src, "G_MAX_BLOCKS") == device._G_MAX_BLOCKS
    assert _const(src, "G_MIN_SEG") == device._G_MIN_SEG
    assert "nblocks != g_blocks(half, rlog, lw, EL != nullptr)" in src
    assert _const(src, "G_WAVE") == device._G_WAVE
    assert "size_t cap = NT;" in src and "while (cap * G_WAVE < half) cap <<= 1;" in src
    assert "s.lr = row < cap ? row : cap;" in src
    assert "out == nullptr || ticket == nullptr" in src
    assert "half >> 32" in src and "rlog > 40" in src and "lw > 20" in src
    # the main path: 2^20 rows, rlog 10: round 0's 512 left rows of 1024
    # pairs (264 blocks), round 1's 256, round 2's 128; round 3's in
    # sub-rows of 512, round 4's and later in sub-rows of NT (a pair a
    # thread), round 8's 2 rows on 8 blocks; the one-level tail, NT pairs
    # a tile
    assert device._g_shape(1 << 19, 10, 0, True) == (1024, 256, 512)
    assert device._g_blocks(1 << 19, 10, 0, True) == device._G_MAX_BLOCKS
    assert device._g_shape(1 << 18, 10, 0, True) == (1024, 256, 256)
    assert device._g_shape(1 << 17, 10, 0, True) == (1024, 256, 128)
    assert device._g_shape(1 << 16, 10, 0, True) == (512, 256, 128)
    assert device._g_shape(1 << 15, 10, 0, True) == (256, 256, 128)
    assert device._g_blocks(1 << 11, 10, 0, True) == 8
    assert device._g_blocks(1 << 10, 0, 0, False) == 4
    assert device._g_blocks(1, 0, 0, False) == 1 and device._g_blocks(0, 3, 0, True) == 1
    # rows of 64 pairs: four a tile; rows of 4: eight a tile (a warp each)
    assert device._g_shape(1 << 10, 6, 0, True) == (64, 64, 4)
    assert device._g_shape(1 << 10, 2, 0, True) == (4, 32, 32)
    assert device._g_shape(1 << 10, 8, 2, True) == (64, 64, 4)  # the shard stride


def test_kernel_g_wrapper_refuses_a_shard_outside_its_mesh():
    """shard < 2^lw, which the C side also refuses, is checked before the
    plain version runs."""
    spec = get_field("p256_scalar")
    v = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        cubiceq_evals(v, v, v, 2, 0, None, v, 0, False, False, spec, shard=2, lw=1)


def test_one_finish_for_kernels_a_b_and_g():
    """The last block's ticket finish lives in csrc/finish.cuh alone, and
    kernels A, B (sumcheck.cu) and G (cubiceq.cu) use it."""
    defs = [f.name for f in CSRC.iterdir()
            if "void finish_sums(" in f.read_text()]
    assert defs == ["finish.cuh"]
    for name in ("sumcheck.cu", "cubiceq.cu"):
        src = (CSRC / name).read_text()
        assert '#include "finish.cuh"' in src and "finish_sums<" in src


def test_kernel_4_slices_and_shapes_match_the_cuda_source():
    """csrc/hyrax_bind.cu picks its own row slices (a block within 1024
    threads) and refuses empty shapes; hyrax.py's wrapper refuses them
    too, and shapes past the C side's int, before a launch."""
    src = (CSRC / "hyrax_bind.cu").read_text()
    assert "if (rows < 1 || ncols < 1) return (int)cudaErrorInvalidValue;" in src
    assert "const dim3 block(HB_COLS, hb_slices(rows));" in src
    assert _const(src, "HB_COLS") * _const(src, "HB_MAX_SLICES") <= 1024
    assert "1 <= R <= _INT_MAX and 1 <= C <= _INT_MAX" in inspect.getsource(hyrax.hyrax_bind)
    assert hyrax._INT_MAX == (1 << 31) - 1
