"""Kernel B's sums' layout (csrc/sumcheck.cu inner0_evals_kernel), on the CPU.

The grid's first blocks take the extra columns j < num_extra, a column a
thread (corr_low and corr_cross, and their part of eval0); the other
blocks take columns num_extra .. num_vars - 1 for eval0 alone, in chunks
of B_NT * B_U columns, a thread loading its B_U columns of a chunk before
their products.  No CPU test runs the kernel, so its thread map and
partial rows are replayed here in Python integers: every column summed
exactly once, and the finished sums equal to ``inner0_evals_plain`` and to
a host-integer evaluation of the JAX package's ``ZkInnerRound0._evals``
formula (spartan2_tpu/sumcheck/zk_device.py:257-282).  The grid rule the
wrapper mirrors is read from the source.  chip_smoke.py holds the kernel
against its plain version on the card.
"""

import random
import re
from collections import Counter

import pytest
import torch

from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.sumcheck import device
from spartan2_tpu_torch.sumcheck.device import inner0_evals, inner0_evals_plain, inner0_sums
from spartan2_tpu_torch.utils.cuda import CSRC

CU = (CSRC / "sumcheck.cu").read_text()
SPEC = get_field("p256_scalar")


def _const(name: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([^;]+);", CU).group(1)
    return eval(expr, {}, {"B_BLOCKS_PER_SM": _const("B_BLOCKS_PER_SM")}
                if "B_BLOCKS_PER_SM" in expr else {})


def test_grid_constants_match_sumcheck_cu():
    assert _const("B_NT") == device._B_NT
    assert _const("B_U") == device._B_U
    assert _const("INNER0_MAX_EXTRA") == device._INNER0_MAX_EXTRA
    assert _const("INNER0_MAX_BLOCKS") == device._INNER0_MAX_BLOCKS


@pytest.mark.parametrize("nv,ne", [(1 << 19, 257), (1 << 19, 1), (1 << 19, 1 << 19),
                                   (1 << 12, 300), (1, 1)])
def test_grid_mirror(nv, ne):
    nmain, nextra = device._inner0_blocks(nv, ne)
    assert 1 <= nextra <= device._INNER0_MAX_EXTRA
    assert nmain + nextra <= device._INNER0_MAX_BLOCKS
    chunk = device._B_NT * device._B_U
    assert nmain == min(-(-(nv - ne) // chunk), device._INNER0_MAX_BLOCKS - nextra)


def _emulate_b(a: list, x: list, nv: int, ne: int, p: int, max_blocks: int):
    """inner0_evals_kernel's loops over one instance's canonical values on a
    grid of at most max_blocks blocks -> ((eval0, corr_low, corr_cross),
    times each column fed eval0, times each extra column fed corr_*)."""
    nt, U = _const("B_NT"), _const("B_U")
    chunk = nt * U
    nextra = min(-(-ne // nt), _const("INNER0_MAX_EXTRA"))
    nmain = min(-(-(nv - ne) // chunk), max_blocks - nextra)
    e0_taken, extra_taken = Counter(), Counter()
    rows = []
    for blk in range(nmain + nextra):
        if blk < nextra:
            low = cross = 0
            for t in range(nt):
                for j in range(blk * nt + t, ne, nextra * nt):
                    low += a[j] * x[j]
                    cross += (a[nv + j] - a[j]) % p * ((x[nv + j] - x[j]) % p)
                    e0_taken[j] += 1
                    extra_taken[j] += 1
            rows.append((low, low, cross))
            continue
        e0 = 0
        for t in range(nt):
            for j0 in range(ne + (blk - nextra) * chunk + t, nv, nmain * chunk):
                for j in range(j0, min(j0 + U * nt, nv), nt):  # the thread's B_U loads
                    e0 += a[j] * x[j]
                    e0_taken[j] += 1
        rows.append((e0, 0, 0))
    sums = tuple(sum(r[i] for r in rows) % p for i in range(3))  # finish_sums
    return sums, e0_taken, extra_taken


def _cols(n: int, seed: int, p: int) -> list:
    rnd = random.Random(seed)
    edge = [0, 1, p - 1]
    return [edge[i % 3] if i % 5 == 0 else rnd.randrange(p) for i in range(n)]


@pytest.mark.parametrize("nv,ne,K,max_blocks", [
    (1 << 12, 257, 1, 4),      # the main path's extra columns, several chunks a block
    (1 << 12, 1, 1, 264),      # one extra column, a ragged last chunk
    (1 << 10, 1 << 10, 1, 12),  # every column extra: no main block
    (1 << 11, 300, 2, 8),      # K = 2
    (40000, 40000, 1, 264),    # the extra blocks capped: several columns a thread
])
def test_emulated_kernel_b_equals_plain_and_host_formula(nv, ne, K, max_blocks):
    p = SPEC.modulus
    cols = nv + ne
    A = [_cols(cols, 10 * k + 1, p) for k in range(K)]
    Z = [_cols(cols, 10 * k + 2, p) for k in range(K)]
    abc = torch.stack([to_device(v, SPEC, "cpu", mont=True) for v in A])
    z = torch.stack([to_device(v, SPEC, "cpu", mont=True) for v in Z])
    plain = inner0_evals_plain(abc, z, nv, ne, SPEC)
    pairs = inner0_evals(abc, z, nv, ne, SPEC)
    for k in range(K):
        sums, e0_taken, extra_taken = _emulate_b(A[k], Z[k], nv, ne, p, max_blocks)
        assert e0_taken == Counter(range(nv))  # every column once for eval0
        assert extra_taken == Counter(range(ne))  # every extra column once
        assert list(sums) == limbs_to_ints(plain[k], SPEC, mont=True)
        # ZkInnerRound0._evals: eval0 = sum_{j<nv} a z, t_inf = eval0 -
        # corr_low + corr_cross, on the host in integers
        a, x = A[k], Z[k]
        eval0 = sum(a[j] * x[j] for j in range(nv)) % p
        low = sum(a[j] * x[j] for j in range(ne)) % p
        cross = sum((a[nv + j] - a[j]) * (x[nv + j] - x[j]) for j in range(ne)) % p
        assert sums == (eval0, low, cross)
        assert pairs[k] == (eval0, (eval0 - low + cross) % p)


def test_inner0_sums_on_the_cpu_is_the_plain_version():
    p = SPEC.modulus
    nv, ne = 64, 5
    abc = to_device(_cols(nv + ne, 3, p), SPEC, "cpu", mont=True)
    z = to_device(_cols(nv + ne, 4, p), SPEC, "cpu", mont=True)
    assert torch.equal(inner0_sums(abc, z, nv, ne, SPEC),
                       inner0_evals_plain(abc, z, nv, ne, SPEC))
