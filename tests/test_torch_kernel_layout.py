"""The layouts the redesigned kernels 1 and 3 read, on their plain
versions (CPU): the SpMV row classes (csrc/spmv.cu) and the comb's order
of additions (csrc/comb.cu), against the JAX package's host functions
where there is one.  Nothing here compiles on XLA:CPU."""

import re

import numpy as np
import pytest
import torch

from spartan2_tpu.ec.curve import get_curve as jax_get_curve
from spartan2_tpu.field.constants import get_field as jax_get_field
from spartan2_tpu.r1cs.shape import SplitR1CSShape as JaxShape
from spartan2_tpu_torch.ec.comb import (
    _SUM_NT, FixedBaseComb, _inf_like, comb_chain, comb_parts, comb_rows, comb_rows_plain,
    pt_add, scalar_digits, to_affine)
from spartan2_tpu_torch.ec.curve import get_curve
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.frontend.gadgets.sha256 import Sha256Circuit
from spartan2_tpu_torch.pcs.hyrax import HyraxCommitmentKey
from spartan2_tpu_torch.r1cs.shape import SplitR1CSShape
from spartan2_tpu_torch.r1cs.sparse import (
    SHORT_ROW_MAX, WARP_ROW_MAX, DeviceCSR, RowClasses, SparseMatrix, mont_values, spmv,
    spmv_batched, spmv_combine)
from spartan2_tpu_torch.utils.cuda import CSRC
from tests.torch_golden.make_golden import jax_cubic_circuit
from tests.torch_helpers import CubicCircuit, rand_ints

F = get_field("p256_scalar")
JF = jax_get_field("p256_scalar")
CURVE = get_curve("p256")
JCURVE = jax_get_curve("p256")


# ---------------------------------------------------------------------------
# kernel 1: row classes
# ---------------------------------------------------------------------------


def _check_partition(classes: RowClasses, lengths: np.ndarray) -> None:
    """Every row is short, a warp row or a block row, exactly once, by its
    length; each part of the list ascends."""
    rows = classes.long_rows.numpy()
    assert classes.long_rows.dtype == torch.int32
    warp, block = rows[: classes.n_warp], rows[classes.n_warp :]
    assert classes.n_block == len(block)
    assert np.all(np.diff(warp) > 0) and np.all(np.diff(block) > 0)
    assert not set(warp) & set(block)
    want_warp = np.flatnonzero((lengths > SHORT_ROW_MAX) & (lengths <= WARP_ROW_MAX))
    want_block = np.flatnonzero(lengths > WARP_ROW_MAX)
    assert np.array_equal(warp, want_warp) and np.array_equal(block, want_block)
    short = np.setdiff1d(np.arange(len(lengths)), rows)
    assert len(short) + len(rows) == len(lengths)
    assert np.all(lengths[short] <= SHORT_ROW_MAX)


def test_row_class_bounds_match_the_cuda_source():
    src = (CSRC / "spmv.cu").read_text()
    assert int(re.search(r"constexpr int SHORT_ROW_MAX = (\d+);", src).group(1)) \
        == SHORT_ROW_MAX
    assert f"WARP_ROW_MAX = {WARP_ROW_MAX}" in src
    assert int(re.search(r"constexpr int SUM_NT = (\d+);",
                         (CSRC / "curve.cuh").read_text()).group(1)) == _SUM_NT


@pytest.fixture(scope="module", params=["cubic", "sha256_1block"])
def shape(request):
    if request.param == "cubic":
        S = SplitR1CSShape.from_circuit(CubicCircuit(), F, width=4)
    else:
        S = SplitR1CSShape.from_circuit(Sha256Circuit(bytes(55)), F, width=2048)
    S.attach_device("cpu")
    return S


def test_row_classes_partition_the_shape_matrices(shape):
    mats = {k: v for k, v in shape.dev.items() if isinstance(v, DeviceCSR)}
    assert {"A", "B", "C", "At", "Bt", "Ct"} <= set(mats)
    for m in mats.values():
        _check_partition(m.classes, np.diff(m.indptr.numpy()))
    # the combine mode's class is the largest of the three transposes' rows
    joint = np.maximum.reduce([np.diff(shape.dev[n + "t"].indptr.numpy())
                               for n in "ABC"])
    _check_partition(shape.dev["t_classes"], joint)


def test_sha256_classes_have_warp_and_block_rows():
    """One SHA-256 block: A's packing rows are warp rows; the column of the
    constant ONE (column num_vars), as a transposed row, is B's longest and
    a block row of the combine mode."""
    S = SplitR1CSShape.from_circuit(Sha256Circuit(bytes(55)), F, width=2048)
    S.attach_device("cpu")
    assert S.dev["A"].classes.n_warp > 0
    lengths = np.diff(S.dev["Bt"].indptr.numpy())
    assert int(np.argmax(lengths)) == S.num_vars and lengths.max() > WARP_ROW_MAX
    joint = S.dev["t_classes"]
    assert joint.long_rows.tolist()[joint.n_warp :] == [S.num_vars]


def _skewed(seed: int):
    """A matrix with rows of every class: empty rows, rows of exactly
    SHORT_ROW_MAX and SHORT_ROW_MAX + 1, WARP_ROW_MAX and WARP_ROW_MAX + 1
    entries, and one row of 1500 (more than 1024) entries -> SparseMatrix."""
    rng = np.random.default_rng(seed)
    rows, cols = 300, 2000
    lengths = rng.integers(0, 4, rows)
    lengths[::7] = 0
    fixed = {3: SHORT_ROW_MAX, 4: SHORT_ROW_MAX + 1, 10: 40, 11: WARP_ROW_MAX,
             12: WARP_ROW_MAX + 1, 20: 1500, 299: SHORT_ROW_MAX + 1}
    for r, n in fixed.items():
        lengths[r] = n
    entries = []
    for r, n in enumerate(lengths):
        for c in rng.choice(cols, int(n), replace=False):
            entries.append((r, int(c), int(rng.integers(0, 1 << 62)) * 977))
    return SparseMatrix.from_coo(F, entries, rows, cols), lengths


def test_row_classes_of_a_skewed_matrix():
    M, lengths = _skewed(1)
    classes = DeviceCSR.build(M, "cpu").classes
    _check_partition(classes, lengths)
    assert classes.long_rows.tolist() == [4, 10, 11, 299, 12, 20]
    assert classes.n_warp == 4 and classes.n_block == 2
    # transposed: the columns become rows of about 1 to 4 entries
    T = DeviceCSR.build(M, "cpu", transpose_rows=M.cols)
    _check_partition(T.classes, np.bincount(M.indices, minlength=M.cols))
    # the joint class of three matrices is the largest
    mats = [DeviceCSR.build(_skewed(s)[0], "cpu") for s in (1, 2, 3)]
    _check_partition(RowClasses.joint(mats),
                     np.maximum.reduce([_skewed(s)[1] for s in (1, 2, 3)]))


def test_spmv_plain_on_a_skewed_matrix_matches_host():
    """The plain versions (which the kernel must equal exactly) on a matrix
    with rows of every class, against Python integers."""
    Ms = [_skewed(s)[0] for s in (1, 2, 3)]
    mats = [DeviceCSR.build(M, "cpu") for M in Ms]
    p = F.modulus
    z = rand_ints(p, Ms[0].cols, 7)
    zt = to_device(z, F, "cpu", mont=True)
    got = spmv(mats, zt, F)
    for k, M in enumerate(Ms):
        assert limbs_to_ints(got[k], F, mont=True) == M.multiply_vec_host(z)
    zs = [rand_ints(p, Ms[0].cols, 8 + i) for i in range(3)]
    got = spmv_batched(mats, torch.stack([to_device(v, F, "cpu", mont=True)
                                          for v in zs]), F)
    for k, M in enumerate(Ms):
        for i, v in enumerate(zs):
            assert limbs_to_ints(got[k, i], F, mont=True) == M.multiply_vec_host(v)
    r = rand_ints(p, 1, 9)[0]
    got = limbs_to_ints(spmv_combine(mats, zt, r, F, RowClasses.joint(mats)), F,
                        mont=True)
    a, b, c = (M.multiply_vec_host(z) for M in Ms)
    assert got == [(x + r * (y + r * w)) % p for x, y, w in zip(a, b, c)]


def test_shape_matrices_keep_the_jax_values():
    """The classes sit beside the CSR and change none of it: the device
    copy still holds the JAX shape's entries (cubic circuit)."""
    ours = SplitR1CSShape.from_circuit(CubicCircuit(), F, width=4)
    ref = JaxShape.from_circuit(jax_cubic_circuit(), JF, width=4)
    ours.attach_device("cpu")
    for n, M in (("A", ref.A), ("B", ref.B), ("C", ref.C)):
        d = ours.dev[n]
        assert d.indptr.tolist() == list(M.indptr)
        assert d.indices.tolist() == list(M.indices)
        assert np.array_equal(d.vals.numpy(), mont_values(getattr(ours, n)))


# ---------------------------------------------------------------------------
# kernel 3: the comb's order
# ---------------------------------------------------------------------------


def _tree(pts: torch.Tensor) -> torch.Tensor:
    """block_pt_sum over 128 points, written out level by level."""
    assert pts.shape[0] == _SUM_NT
    s = _SUM_NT // 2
    while s:
        pts = torch.cat([pt_add(pts[:s], pts[s : 2 * s], CURVE), pts[s:]])
        s //= 2
    return pts[0]


def _kernel_order(sc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """csrc/comb.cu's order, one row at a time: points p = w C + j, blocks
    of 128 k padded with the identity; thread t of a block adds its points
    t, t + 128, ... in order and the tree sums the threads; then the same
    over the row's partials (at most 128, one point a thread)."""
    R, C = sc.shape[:2]
    n_win = table.shape[0]
    k = comb_chain(C, n_win)
    d = scalar_digits(sc, n_win)
    inf = _inf_like(torch.empty(_SUM_NT, 3, 8), CURVE)
    out = []
    for r in range(R):
        pts = [inf[0] if d[w, r, j] == 0 else table[w, d[w, r, j], j]
               for w in range(n_win) for j in range(C)]
        parts = -(-len(pts) // (_SUM_NT * k))
        assert parts <= _SUM_NT
        pts = torch.stack(pts + [inf[0]] * (parts * _SUM_NT * k - len(pts)))
        partial = []
        for b in range(parts):
            acc = inf
            for i in range(k):
                lo = (b * k + i) * _SUM_NT
                acc = pt_add(acc, pts[lo : lo + _SUM_NT], CURVE)
            partial.append(_tree(acc))
        if parts == 1:
            out.append(partial[0])
            continue
        out.append(_tree(torch.cat([torch.stack(partial), inf[parts:]])))
    return torch.stack(out)


def _h_key():
    return HyraxCommitmentKey(CURVE, b"layout", 4, "cpu")


def _special_scalars(n: int, seed: int) -> list[int]:
    """q - 1, 0, 1, values whose digits are zero in whole windows (a single
    window set; the low and the high half cleared), then random scalars."""
    q = CURVE.scalar.modulus
    vals = rand_ints(q, max(n, 8), seed)
    special = [q - 1, 0, 1, 5 << 6 * 20, vals[0] >> 128 << 128,
               vals[1] & ((1 << 96) - 1), (63 << 6 * 42) % q, 0]
    return (special + vals[8:])[:n]


@pytest.mark.parametrize("R", [1, 3, 16])
def test_comb_rows_h_table_match_jax(R):
    """C = 1, the blind generator h's table (every blinding and
    rerandomize): rows against the JAX package's host scalar products."""
    ck = _h_key()
    comb = ck.comb_h()
    assert comb.C == 1 and comb_parts(1, comb.n_win) == 1
    vals = _special_scalars(R, 30 + R)
    sc = to_device(vals, CURVE.scalar, "cpu").reshape(R, 1, 8)
    got = comb.rows_msm(sc)
    assert to_affine(got, CURVE) == [JCURVE.scalar_mul(v, ck.h) for v in vals]
    assert torch.equal(got, _kernel_order(sc, comb.table))


@pytest.mark.parametrize("width,nbits,R", [(4, 256, 1), (4, 256, 3), (64, 64, 16)])
def test_comb_rows_special_rows_match_jax_msm(width, nbits, R):
    gens = CURVE.from_label(b"layout", width)
    comb = FixedBaseComb(CURVE, gens, nbits, "cpu")
    bound = 1 << nbits if nbits < 256 else CURVE.scalar.modulus
    rows = []
    for i in range(R):
        row = [v % bound for v in _special_scalars(width, 50 + i)]
        rows.append(row[i % width :] + row[: i % width])
    rows[-1] = [0] * width
    sc = to_device([v for row in rows for v in row], CURVE.scalar,
                   "cpu").reshape(R, width, 8)
    got = comb.rows_msm(sc)
    assert to_affine(got, CURVE) == [JCURVE.msm(row, gens) for row in rows]
    if width == 4:  # two block partials a row: both passes
        assert comb_parts(width, comb.n_win) == 2
        assert torch.equal(got, _kernel_order(sc, comb.table))


def test_comb_rows_chain_of_points_follows_the_kernel_order():
    """Each thread of the first pass adds k > 1 points before the tree: on
    a short-scalar table (11 windows) at least 32, here one row of 1490
    columns (5 partials), over a table whose columns alternate two
    generators (a real table of 1490 would take a minute to build here;
    equal points also reach the doubling case of the additions)."""
    gens = CURVE.from_label(b"layout", 2)
    table = FixedBaseComb(CURVE, gens, 64, "cpu").table.repeat(1, 1, 745, 1, 1)
    n_win = table.shape[0]
    assert comb_chain(1490, n_win) == 32 and comb_parts(1490, n_win) == 5
    vals = [v % (1 << 64) for v in rand_ints(CURVE.scalar.modulus, 1490, 80)]
    vals[:100] = [0] * 100
    vals[200:210] = [vals[210]] * 10
    sc = to_device(vals, CURVE.scalar, "cpu").reshape(1, 1490, 8)
    got = comb_rows(sc, table, CURVE)
    assert torch.equal(got, _kernel_order(sc, table))
    assert to_affine(got, CURVE) == [JCURVE.msm(vals, [gens[j % 2] for j in range(1490)])]


def test_comb_rows_full_width_chain_keeps_128_partials():
    """Past 128^2 points a row of a full-scalar table (43 windows) takes k
    = ceil(N / 128^2) points a thread: one row of 382 columns, k = 2 and
    65 partials, in the kernel's order and equal to JAX's MSM."""
    gens = CURVE.from_label(b"layout", 2)
    table = FixedBaseComb(CURVE, gens, 256, "cpu").table.repeat(1, 1, 191, 1, 1)
    n_win = table.shape[0]
    assert comb_chain(382, n_win) == 2 and comb_parts(382, n_win) == 65
    vals = rand_ints(CURVE.scalar.modulus, 382, 81)
    vals[:40] = [0] * 40
    vals[100] = CURVE.scalar.modulus - 1
    sc = to_device(vals, CURVE.scalar, "cpu").reshape(1, 382, 8)
    got = comb_rows(sc, table, CURVE)
    assert torch.equal(got, _kernel_order(sc, table))
    assert to_affine(got, CURVE) == [JCURVE.msm(vals, [gens[j % 2] for j in range(382)])]


def test_comb_chain_depends_on_columns_and_windows_only():
    """The main path's tables: the witness's 11 windows at width 2048 take
    32 points a thread (6 partials a row), [LZ, d_vec]'s 43 take 6 (115),
    the blinds' h table one (a single block)."""
    assert (comb_chain(2048, 11), comb_parts(2048, 11)) == (32, 6)
    assert (comb_chain(2048, 43), comb_parts(2048, 43)) == (6, 115)
    assert (comb_chain(1, 43), comb_parts(1, 43)) == (1, 1)
    assert all(comb_parts(C, w) <= _SUM_NT for C in (1, 64, 1490, 2048, 1 << 16)
               for w in (1, 11, 12, 43))


def test_comb_row_alone_equals_row_in_batch():
    """A row's Jacobian limbs do not depend on the rows beside it: the order
    is a function of (C, n_win) only, as a mesh rank's shard needs."""
    gens = CURVE.from_label(b"layout", 2)
    comb = FixedBaseComb(CURVE, gens, 64, "cpu")
    table = comb.table.repeat(1, 1, 256, 1, 1)
    vals = [v % (1 << 64) for v in rand_ints(CURVE.scalar.modulus, 6 * 512, 70)]
    sc = to_device(vals, CURVE.scalar, "cpu").reshape(6, 512, 8)
    assert comb_parts(512, comb.n_win) == 2
    batch = comb_rows(sc, table, CURVE)
    for r in (0, 3, 5):
        assert torch.equal(batch[r], comb_rows(sc[r : r + 1], table, CURVE)[0])
    assert torch.equal(batch[2:5], comb_rows_plain(sc[2:5], table, CURVE))
