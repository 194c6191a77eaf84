"""Kernel 2 (csrc/sumcheck.cu): the eq and power tables, sum-check round
evaluations and binds batched over K instances (kernel A), and the
structured inner round 0 (kernel B); kernel G (csrc/cubiceq.cu): the sums
of a Gruen eq-split round; with their plain versions.

Vectors are (n, 8) int32 Montgomery tensors, or (K, n, 8) for K
instances.  On CUDA tensors each
wrapper launches the kernel (or raises); on CPU tensors it runs the plain
PyTorch version.  Kernel A's round is one launch: its sums finished on
the card by the last block to arrive, and, in the ``*_bind`` entries and
``round_sums`` given a challenge slot, the previous round's bind folded
in (the JAX steps' ``bind_first``).  ``round_evals*`` and
``inner0_evals`` return canonical Python ints (the host-challenge
drivers squeeze from them); ``round_sums``, ``inner0_sums`` and
``cubiceq_evals`` leave their sums on the device, (rows, sums, 8)
Montgomery (one row an instance), for the round finish
(sumcheck/prove.py ``round_finish``), and ``bind_dev``/
``inner0_bind_dev`` read the challenge from the device slot [r, 1 - r]
the finish wrote.
"""

from __future__ import annotations

import struct

import torch

from ..field import ops
from ..field.constants import FieldSpec
from ..field.limbs import limbs_to_ints, to_device
from ..utils.cuda import SZ, CudaKernel, I, P, check_cuda, fe_words, field_words

SUMCHECK = CudaKernel("sumcheck", {
    "sp2_eq_table": [I, P, P, P],
    "sp2_eq_tables": [I, P, P, P, P],
    "sp2_pow_table": [I, P, P, P],
    "sp2_round_evals": [I, SZ, I, SZ, P, P, P, P, P, I, P, P, P],
    "sp2_round_bind_evals": [I, SZ, I, SZ, P, P, P, P, P, P, P, P, I, P, P, P],
    "sp2_bind": [SZ, I, SZ, I, I, P, P, P, P, P, P],
    "sp2_inner0_evals": [SZ, SZ, I, SZ, P, P, P, I, P, P, P],
    "sp2_inner0_bind": [SZ, SZ, I, SZ, P, P, P, P, P],
    "sp2_bind_dev": [SZ, I, P, P, P, P, P, P],
    "sp2_inner0_bind_dev": [SZ, SZ, I, P, P, P, P, P, P],
})
CUBICEQ = CudaKernel("cubiceq", {
    "sp2_cubiceq_evals": [SZ, SZ, I, I, I, SZ, I, P, P, P, P, P, P, I, P, P, P],
})

CUBIC, QUAD, DOT = 0, 1, 2
_NSUMS = {CUBIC: 3, QUAD: 2, DOT: 1}
_NT = 256
# kernel G's grid (csrc/cubiceq.cu g_blocks): a tile a block, at most
# G_MAX_BLOCKS blocks; a segment of at least G_MIN_SEG threads a sub-row
_G_MAX_BLOCKS = 264
_G_WAVE = 132
_G_MIN_SEG = 32
# kernel A's grid (csrc/sumcheck.cu round_blocks): a pair a thread,
# at most ROUND_MAX_BLOCKS blocks
_ROUND_MAX_BLOCKS = 264
# kernel B's sums (csrc/sumcheck.cu inner0_blocks): blocks of _B_NT threads,
# the extra columns a column a thread in at most _INNER0_MAX_EXTRA blocks,
# the rest in chunks of _B_NT * _B_U columns in the blocks left of
# _INNER0_MAX_BLOCKS
_B_NT = 256
_B_U = 4
_INNER0_MAX_EXTRA = 132
_INNER0_MAX_BLOCKS = 132 * 2


def _check_vecs(vecs: list, n: int) -> None:
    """Contiguous int32 CUDA vectors (rows, 8) or (K, rows, 8) with at
    least n rows."""
    check_cuda(*vecs)
    if any(v.dim() not in (2, 3) or v.shape[-1] != 8 or v.shape[-2] < n
           for v in vecs):
        raise ValueError(f"vectors must be (>= {n}, 8) or (K, >= {n}, 8)")


def _instances(vecs: list) -> tuple[int, int]:
    """(K, stride) of the batched (K, rows, 8) vectors; K = 1 when none is
    batched.  Every batched vector must have the same shape."""
    batched = {tuple(v.shape) for v in vecs if v.dim() == 3}
    if len(batched) > 1:
        raise ValueError("batched vectors must have one shape (K, rows, 8)")
    if not batched:
        return 1, 0
    K, rows, _ = batched.pop()
    return K, rows


def _g_shape(half: int, rlog: int, lw: int, two_level: bool) -> tuple:
    """Kernel G's map, as csrc/cubiceq.cu's g_shape -> (pairs a sub-row,
    threads a segment, tiles).  One-level: NT pairs a tile.  Two-level: a
    left row of 2^max(0, rlog - lw) local pairs, cut into sub-rows of at
    most the least power of two >= NT whose tiles fit _G_WAVE blocks (a
    block an SM); a segment of a sub-row's pairs clamped to [_G_MIN_SEG, NT]
    threads, NT / seg sub-rows a tile."""
    if not two_level:
        return 0, _NT, -(-half // _NT)
    cap = _NT
    while cap * _G_WAVE < half:
        cap <<= 1
    lr = min(1 << max(0, rlog - lw), cap)
    seg = min(_NT, max(_G_MIN_SEG, lr))
    return lr, seg, -(-(-(-half // lr)) // (_NT // seg))


def _g_blocks(half: int, rlog: int, lw: int, two_level: bool) -> int:
    """Kernel G's grid, as csrc/cubiceq.cu's g_blocks, which refuses
    another: a tile a block, at most _G_MAX_BLOCKS."""
    return max(1, min(_g_shape(half, rlog, lw, two_level)[2], _G_MAX_BLOCKS))


def _nblocks(work: int) -> int:
    """Kernel A's grid, as csrc/sumcheck.cu's round_blocks, which
    refuses another."""
    return max(1, min(-(-work // _NT), _ROUND_MAX_BLOCKS))


def _inner0_blocks(num_vars: int, num_extra: int) -> tuple[int, int]:
    """Kernel B's sums' grid (main blocks, extra blocks), as csrc/sumcheck.cu's
    inner0_blocks, which refuses another."""
    nextra = min(-(-num_extra // _B_NT), _INNER0_MAX_EXTRA)
    nmain = min(-(-(num_vars - num_extra) // (_B_NT * _B_U)), _INNER0_MAX_BLOCKS - nextra)
    return nmain, nextra


def new_ticket(device) -> torch.Tensor | None:
    """Kernel A's, B's and G's arrival counter on a CUDA device: zero, and zero
    again after each launch (its last block resets it), so one serves a
    whole sum-check; None on the CPU, where the plain versions need none."""
    if torch.device(device).type != "cuda":
        return None
    return torch.zeros(4, dtype=torch.int32, device=device)


def _pull(out: torch.Tensor, spec: FieldSpec, K: int) -> list[list[int]]:
    vals = limbs_to_ints(out, spec, mont=True)
    k = len(vals) // K
    return [vals[i * k : (i + 1) * k] for i in range(K)]


# ---------------------------------------------------------------------------
# eq table
# ---------------------------------------------------------------------------


def eq_factors(r: list[int], spec: FieldSpec, device) -> torch.Tensor:
    """(2m, 8) Montgomery factors [r_0 .. r_{m-1}, 1 - r_0 .. 1 - r_{m-1}]."""
    p = spec.modulus
    return to_device(list(r) + [(1 - x) % p for x in r], spec, device, mont=True)


def eq_table_plain(factors: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``eq_table`` (doubling, r_0 drives the top bit)."""
    m = factors.shape[0] // 2
    evals = ops.const(1, spec, (1,), factors.device)
    for j in range(m - 1, -1, -1):
        lo = ops.mont_mul(evals, factors[m + j].expand_as(evals), spec)
        hi = ops.mont_mul(evals, factors[j].expand_as(evals), spec)
        evals = torch.cat([lo, hi])
    return evals


def eq_table(factors: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(2^m, 8) Montgomery eq(r, i) for all i, index bit order MSB-first
    (polys/eq.py:79-94 of the JAX package); ``factors`` from eq_factors.
    On the card one product an element (csrc/sumcheck.cu): a block owns a
    prefix of the top m - 10 bits and multiplies the prefix's product into
    two doubling tables of the next 5 and the last 5 bits."""
    if factors.device.type == "cpu":
        return eq_table_plain(factors, spec)
    m = factors.shape[0] // 2
    check_cuda(factors)
    if factors.shape != (2 * m, 8):
        raise ValueError("eq_table: factors must be (2m, 8)")
    out = torch.empty(1 << m, 8, dtype=torch.int32, device=factors.device)
    SUMCHECK.call("sp2_eq_table", m, factors.data_ptr(), out.data_ptr(),
                  field_words(spec))
    return out


EQ_MAX_TABLES = 64  # tables of one sp2_eq_tables launch (csrc/sumcheck.cu)


def eq_tables_plain(factors: torch.Tensor, ms: list[int],
                    spec: FieldSpec) -> list[torch.Tensor]:
    """Plain version of ``eq_tables``: ``eq_table_plain`` of each table."""
    at = [0]
    for m in ms:
        at.append(at[-1] + 2 * m)
    return [eq_table_plain(factors[at[k] : at[k + 1]], spec) for k in range(len(ms))]


def eq_tables(factors: torch.Tensor, ms: list[int], spec: FieldSpec) -> list[torch.Tensor]:
    """The eq tables of at most 64 factor lists in one launch: ``factors``
    holds eq_factors of each list back to back (2 m_k rows each) ->
    [(2^m_k, 8)], views of one buffer on the card.  Its caller, the outer
    sum-check's plan, sends one table a round (at most 40)."""
    if len(ms) > EQ_MAX_TABLES:
        raise ValueError(f"eq_tables: at most {EQ_MAX_TABLES} tables, got {len(ms)}")
    if factors.device.type == "cpu":
        return eq_tables_plain(factors, ms, spec)
    check_cuda(factors)
    if not ms or min(ms) < 0 or factors.shape != (2 * sum(ms), 8):
        raise ValueError("eq_tables: factors must be (2 sum(ms), 8)")
    sizes = [1 << m for m in ms]
    out = torch.empty(sum(sizes), 8, dtype=torch.int32, device=factors.device)
    SUMCHECK.call("sp2_eq_tables", len(ms), struct.pack(f"<{len(ms)}i", *ms),
                  factors.data_ptr(), out.data_ptr(), field_words(spec))
    return list(out.split(sizes))


def pow_table_plain(gens: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``pow_table`` (doubling, g_0 drives the top bit)."""
    evals = ops.const(1, spec, (1,), gens.device)
    for j in range(gens.shape[0] - 1, -1, -1):
        evals = torch.cat([evals, ops.mont_mul(evals, gens[j].expand_as(evals), spec)])
    return evals


def pow_table(gens: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(2^m, 8) Montgomery power table [t^k] from the (m, 8) Montgomery
    powers g_j = t^(2^(m-1-j)) (polys/eq.py ``pow_generators``); entry
    k's bit m-1-j selects g_j (polys/eq.py:97-113 of the JAX package)."""
    if gens.device.type == "cpu":
        return pow_table_plain(gens, spec)
    m = gens.shape[0]
    check_cuda(gens)
    if gens.shape != (m, 8) or m > 40:
        raise ValueError("pow_table: gens must be (m, 8), m <= 40")
    out = torch.empty(1 << m, 8, dtype=torch.int32, device=gens.device)
    SUMCHECK.call("sp2_pow_table", m, gens.data_ptr(), out.data_ptr(),
                  field_words(spec))
    return out


# ---------------------------------------------------------------------------
# round evaluations
# ---------------------------------------------------------------------------


def round_evals_plain(mode: int, n: int, vecs: list, spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``round_evals`` for one instance: (k, 8)
    Montgomery sums."""
    if mode == DOT:
        A, B = vecs
        return ops.sum_all(ops.mont_mul(A[:n], B[:n], spec), spec)[None]
    half = n // 2
    if mode == QUAD:
        A, B = vecs
        a0, a1, b0, b1 = A[:half], A[half:n], B[:half], B[half:n]
        t0 = ops.mont_mul(a0, b0, spec)
        tinf = ops.mont_mul(ops.sub(a1, a0, spec), ops.sub(b1, b0, spec), spec)
        return torch.stack([ops.sum_all(t0, spec), ops.sum_all(tinf, spec)])
    lo = [v[:half] for v in vecs]
    d = [ops.sub(v[half:n], l, spec) for v, l in zip(vecs, lo)]
    sums = []
    cur = lo
    for x in (0, 2, 3):
        if x == 2:
            cur = [ops.add(l, ops.add(dd, dd, spec), spec) for l, dd in zip(lo, d)]
        elif x == 3:
            cur = [ops.add(c, dd, spec) for c, dd in zip(cur, d)]
        e, a, b, c = cur
        f = ops.mont_mul(e, ops.sub(ops.mont_mul(a, b, spec), c, spec), spec)
        sums.append(ops.sum_all(f, spec))
    return torch.stack(sums)


def round_evals_batched_plain(mode: int, n: int, vecs: list,
                              spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``round_evals_batched``: (K, k, 8) Montgomery sums."""
    K, _ = _instances(vecs)
    return torch.stack([
        round_evals_plain(mode, n, [v[k] if v.dim() == 3 else v for v in vecs],
                          spec) for k in range(K)])


def _round_launch(mode: int, n: int, vecs: list, spec: FieldSpec, r=None, r_slot=None,
                  ticket=None, eq_out=None) -> torch.Tensor:
    """Launch kernel A over the round's n rows -> its sums (K, sums, 8);
    given r (canonical) or r_slot (device [r, ...]) the vectors carry 2n
    rows, bound first in place (the eq vector into ``eq_out`` if given)."""
    K, stride = _instances(vecs)
    bound = r is not None or r_slot is not None
    _check_vecs(vecs, 2 * n if bound else n)
    if eq_out is not None:
        _check_vecs([eq_out], n)
    if bound and mode == CUBIC and K > 1 and eq_out is None:
        raise ValueError("the shared eq of K > 1 instances is bound into eq_out")
    ns = _NSUMS[mode]
    work = n if mode == DOT else n // 2
    nblocks = _nblocks(work)
    dev = vecs[0].device
    partial = torch.empty(K * nblocks, ns, 8, dtype=torch.int32, device=dev)
    out = torch.empty(K, ns, 8, dtype=torch.int32, device=dev)
    if ticket is None:
        ticket = new_ticket(dev)
    ptr = [v.data_ptr() for v in vecs]
    eq, A, B, C = ptr if mode == CUBIC else [None, ptr[0], ptr[1], None]
    head = (mode, work, K, stride, eq, A, B, C)
    tail = (partial.data_ptr(), nblocks, out.data_ptr(), ticket.data_ptr(),
            field_words(spec))
    if not bound:
        SUMCHECK.call("sp2_round_evals", *head, *tail)
    else:
        eo = None if eq_out is None else eq_out.data_ptr()
        if r_slot is not None:
            check_cuda(r_slot)
            rw, rd = None, r_slot.data_ptr()
        else:
            rw, rd = fe_words(spec.to_mont(r)), None
        SUMCHECK.call("sp2_round_bind_evals", mode, work, K, stride, eq, eo, A, B, C, rw, rd,
                      *tail)
    return out


def _check_round_vecs(mode: int, vecs: list) -> int:
    if len(vecs) != (4 if mode == CUBIC else 2):
        raise ValueError(f"round_evals: wrong number of vectors for mode {mode}")
    K, _ = _instances(vecs)
    polys = vecs[1:] if mode == CUBIC else vecs
    if K > 1 and any(v.dim() != 3 for v in polys):
        raise ValueError("round_evals: with K > 1 every polynomial is (K, rows, 8)")
    if mode == CUBIC and vecs[0].dim() != 2:
        raise ValueError("round_evals: the eq vector is shared, (rows, 8)")
    return K


def round_evals_batched(mode: int, n: int, vecs: list,
                        spec: FieldSpec) -> list[list[int]]:
    """Kernel A: the round sums of K instances at once, as canonical ints
    per instance.  ``vecs`` are CUBIC (eq, A, B, C), QUAD (A, B) or DOT
    (A, B); A, B, C are (K, rows, 8) tensors (instance k's vector is
    row block k) or (rows, 8) for K = 1; the eq vector is (rows, 8) and
    shared by every instance.  Per instance:
    CUBIC -> [s(0), s(2), s(3)] of
        s(X) = sum_j eq(X) (A(X) B(X) - C(X)) over the n/2 pairs;
    QUAD -> [sum A_lo B_lo, sum (A_hi - A_lo)(B_hi - B_lo)];
    DOT -> [sum A B] over the first n entries."""
    return _pull(round_sums_batched(mode, n, vecs, spec), spec,
                 _check_round_vecs(mode, vecs))


def round_sums_batched(mode: int, n: int, vecs: list, spec: FieldSpec,
                       ticket=None) -> torch.Tensor:
    """``round_evals_batched`` left on the device: (K, sums, 8) Montgomery."""
    _check_round_vecs(mode, vecs)
    if vecs[0].device.type == "cpu":
        return round_evals_batched_plain(mode, n, vecs, spec)
    return _round_launch(mode, n, vecs, spec, ticket=ticket)


def round_sums_bind_plain(mode: int, n: int, vecs: list, rr: torch.Tensor,
                          spec: FieldSpec, eq_out=None) -> torch.Tensor:
    """Plain version of the bind-first round: ``bind_mont_plain`` of the
    first 2n rows, then ``round_evals_batched_plain`` over n; given
    ``eq_out`` the eq vector (vecs[0]) is left as it was and its bound rows
    go there."""
    if eq_out is not None:
        vecs = [vecs[0][: 2 * n].clone()] + list(vecs[1:])
    bind_mont_plain(vecs, 2 * n, rr, spec)
    if eq_out is not None:
        eq_out[:n] = vecs[0][:n]
    return round_evals_batched_plain(mode, n, vecs, spec)


def round_sums_bind(mode: int, n: int, vecs: list, r: int, spec: FieldSpec,
                    ticket=None, eq_out=None) -> torch.Tensor:
    """Kernel A's round over n rows with the previous round's bind folded
    in: ``vecs`` (CUBIC or QUAD, as ``round_evals_batched``) still carry
    that round's variable over their first 2n rows; each is bound with r
    (canonical) in place to n rows and the round's sums are taken from the
    bound values, in one launch -> (K, sums, 8) Montgomery on the device.
    The eq vector shared by K > 1 instances is read unbound by every
    instance, so its bound rows go to ``eq_out`` (another (>= n, 8)
    buffer; needed then) and vecs[0] is left as it was."""
    _check_round_vecs(mode, vecs)
    if mode == DOT:
        raise ValueError("round_sums_bind: CUBIC or QUAD")
    if vecs[0].device.type == "cpu":
        return round_sums_bind_plain(mode, n, vecs, ops.const(r, spec, device="cpu"), spec,
                                     eq_out)
    return _round_launch(mode, n, vecs, spec, r=r, ticket=ticket, eq_out=eq_out)


def round_sums(mode: int, n: int, vecs: list, spec: FieldSpec, r_slot=None,
               ticket=None) -> torch.Tensor:
    """Kernel A's sums of one instance (``round_evals``' CUBIC or QUAD)
    over n rows, left on the device as (1, sums, 8); given ``r_slot``
    (the round finish's [r, 1 - r] of the previous round) the vectors
    carry 2n rows and are bound with that r first, in the same launch."""
    if _check_round_vecs(mode, vecs) != 1 or mode == DOT:
        raise ValueError("round_sums: one instance, CUBIC or QUAD")
    if vecs[0].device.type == "cpu":
        if r_slot is None:
            return round_evals_plain(mode, n, vecs, spec)[None]
        return round_sums_bind_plain(mode, n, vecs, r_slot[0], spec)
    return _round_launch(mode, n, vecs, spec, r_slot=r_slot, ticket=ticket)


def round_evals(mode: int, n: int, vecs: list, spec: FieldSpec) -> list[int]:
    """``round_evals_batched`` of one instance: its list of sums."""
    return round_evals_batched(mode, n, vecs, spec)[0]


# ---------------------------------------------------------------------------
# bind
# ---------------------------------------------------------------------------


def bind_mont_plain(vecs: list, n: int, rr: torch.Tensor, spec: FieldSpec) -> None:
    """``bind_plain`` with r an (8,) Montgomery tensor on the vectors' device."""
    half = n // 2
    for v in vecs:
        lo, hi = v[..., :half, :], v[..., half:n, :]
        v[..., :half, :] = ops.add(lo, ops.mont_mul(rr, ops.sub(hi, lo, spec), spec),
                                   spec)


def bind_plain(vecs: list, n: int, r: int, spec: FieldSpec) -> None:
    """Plain version of ``bind`` (in place)."""
    bind_mont_plain(vecs, n, ops.const(r, spec, device=vecs[0].device), spec)


def bind(vecs: list, n: int, r: int, spec: FieldSpec) -> None:
    """x[j] <- x[j] + r (x[n/2 + j] - x[j]) for j < n/2, in place in up to
    four vectors (bind_poly_var_top; r canonical).  A (K, rows, 8) vector
    is bound in each of its K instances, a (rows, 8) vector once."""
    if vecs[0].device.type == "cpu":
        bind_plain(vecs, n, r, spec)
        return
    if not 1 <= len(vecs) <= 4:
        raise ValueError("bind: 1 to 4 vectors")
    _check_vecs(vecs, n)
    K, stride = _instances(vecs)
    shared = sum(1 << i for i, v in enumerate(vecs) if v.dim() == 2)
    ptrs = [v.data_ptr() for v in vecs] + [None] * (4 - len(vecs))
    SUMCHECK.call("sp2_bind", n // 2, K, stride, len(vecs), shared, *ptrs,
                  fe_words(spec.to_mont(r)), field_words(spec))


def _check_slot(vecs: list, r_slot: torch.Tensor) -> list:
    if not 1 <= len(vecs) <= 4 or any(v.dim() != 2 for v in vecs):
        raise ValueError("device-r binds take 1 to 4 (rows, 8) vectors")
    check_cuda(*vecs, r_slot)
    return [v.data_ptr() for v in vecs] + [None] * (4 - len(vecs))


def bind_dev(vecs: list, n: int, r_slot: torch.Tensor, spec: FieldSpec) -> None:
    """``bind`` of (rows, 8) vectors with r read on the device from
    ``r_slot`` = [r, 1 - r] (Montgomery), as the round finish wrote it;
    only r is read, so a (1, 8) slot [r] serves as well."""
    if vecs[0].device.type == "cpu":
        bind_mont_plain(vecs, n, r_slot[0], spec)
        return
    if r_slot.dim() != 2 or r_slot.shape[0] < 1 or r_slot.shape[1] != 8:
        raise ValueError("bind_dev: r in row 0 of a (rows, 8) slot")
    ptrs = _check_slot(vecs, r_slot)
    _check_vecs(vecs, n)
    SUMCHECK.call("sp2_bind_dev", n // 2, len(vecs), *ptrs, r_slot.data_ptr(),
                  field_words(spec))


# ---------------------------------------------------------------------------
# kernel B: the structured inner round 0
# ---------------------------------------------------------------------------


def _batch(v: torch.Tensor) -> torch.Tensor:
    return v if v.dim() == 3 else v[None]


def inner0_evals_plain(abc: torch.Tensor, z: torch.Tensor, num_vars: int,
                       num_extra: int, spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``inner0_evals``: (K, 3, 8) Montgomery sums
    (eval0, corr_low, corr_cross)."""
    out = []
    for a, x in zip(_batch(abc), _batch(z)):
        nv, ne = num_vars, num_extra
        da = ops.sub(a[nv : nv + ne], a[:ne], spec)
        dz = ops.sub(x[nv : nv + ne], x[:ne], spec)
        out.append(torch.stack([
            ops.sum_all(ops.mont_mul(a[:nv], x[:nv], spec), spec),
            ops.sum_all(ops.mont_mul(a[:ne], x[:ne], spec), spec),
            ops.sum_all(ops.mont_mul(da, dz, spec), spec)]))
    return torch.stack(out)


def inner0_evals(abc: torch.Tensor, z: torch.Tensor, num_vars: int,
                 num_extra: int, spec: FieldSpec, ticket=None) -> list[tuple[int, int]]:
    """Kernel B's evaluations: per instance (eval0, t_inf) of round 0 of
    sum_x abc(x) z(x) over the virtual 2 num_vars domain, from abc and z
    at width num_cols = num_vars + num_extra ((rows, 8) or (K, rows, 8),
    rows >= num_cols; both are zero past num_cols):
    eval0 = sum_{j < num_vars} abc_j z_j, and
    t_inf = eval0 - sum_{j < num_extra} abc_j z_j
            + sum_{j < num_extra} (abc_{nv+j} - abc_j)(z_{nv+j} - z_j)
    (zk_device.py ZkInnerRound0._evals of the JAX package).  ``ticket``
    (``new_ticket``) may serve the whole inner sum-check."""
    if not 0 < num_extra <= num_vars:
        raise ValueError("inner0: need 0 < num_extra <= num_vars")
    K, stride = _instances([abc, z])
    if abc.device.type == "cpu":
        sums = _pull(inner0_evals_plain(abc, z, num_vars, num_extra, spec), spec, K)
    else:
        sums_dev = _inner0_launch(abc, z, num_vars, num_extra, spec, ticket)
        sums = _pull(sums_dev, spec, K)
    p = spec.modulus
    return [(e0, (e0 - low + cross) % p) for e0, low, cross in sums]


def _inner0_bind_mont_plain(vecs: list, rr: torch.Tensor, om: torch.Tensor,
                            num_vars: int, num_extra: int, spec: FieldSpec) -> None:
    nv, ne = num_vars, num_extra
    for v in vecs:
        lo, hi = v[..., :ne, :], v[..., nv : nv + ne, :]
        v[..., :ne, :] = ops.add(lo, ops.mont_mul(rr, ops.sub(hi, lo, spec), spec),
                                 spec)
        v[..., ne:nv, :] = ops.mont_mul(om, v[..., ne:nv, :], spec)


def inner0_bind_plain(abc: torch.Tensor, z: torch.Tensor, r: int, num_vars: int,
                      num_extra: int, spec: FieldSpec) -> None:
    """Plain version of ``inner0_bind`` (in place)."""
    dev = abc.device
    _inner0_bind_mont_plain([abc, z], ops.const(r, spec, device=dev),
                            ops.const(1 - r, spec, device=dev), num_vars, num_extra, spec)


def inner0_bind(abc: torch.Tensor, z: torch.Tensor, r: int, num_vars: int,
                num_extra: int, spec: FieldSpec) -> None:
    """Kernel B's bind of round 0's challenge r, in place into the first
    num_vars entries of abc and z: x_j + r (x_{nv+j} - x_j) for j <
    num_extra, (1 - r) x_j for the rest (ZkInnerRound0._bind)."""
    if not 0 < num_extra <= num_vars:
        raise ValueError("inner0: need 0 < num_extra <= num_vars")
    if abc.device.type == "cpu":
        inner0_bind_plain(abc, z, r, num_vars, num_extra, spec)
        return
    _check_vecs([abc, z], num_vars + num_extra)
    if abc.shape != z.shape:
        raise ValueError("inner0: abc and z must have one shape")
    K, stride = _instances([abc, z])
    SUMCHECK.call("sp2_inner0_bind", num_vars, num_extra, K, stride,
                  abc.data_ptr(), z.data_ptr(), fe_words(spec.to_mont(r)),
                  fe_words(spec.to_mont((1 - r) % spec.modulus)), field_words(spec))


def inner0_bind_dev(vecs: list, r_slot: torch.Tensor, num_vars: int, num_extra: int,
                    spec: FieldSpec) -> None:
    """``inner0_bind`` of up to four (rows, 8) vectors, r and 1 - r read
    on the device from ``r_slot``.  With num_vars = n/2 and num_extra the
    live entries of the upper half it is also the bind of the peeled outer
    round 0 (the zero tail's rows scaled by 1 - r)."""
    if not 0 <= num_extra <= num_vars:
        raise ValueError("inner0_bind_dev: need 0 <= num_extra <= num_vars")
    if vecs[0].device.type == "cpu":
        _inner0_bind_mont_plain(vecs, r_slot[0], r_slot[1], num_vars, num_extra, spec)
        return
    if r_slot.shape != (2, 8):
        raise ValueError("the challenge slot is (2, 8): r, 1 - r")
    ptrs = _check_slot(vecs, r_slot)
    _check_vecs(vecs, num_vars + num_extra)
    SUMCHECK.call("sp2_inner0_bind_dev", num_vars, num_extra, len(vecs), *ptrs,
                  r_slot.data_ptr(), field_words(spec))


def _inner0_launch(abc: torch.Tensor, z: torch.Tensor, num_vars: int, num_extra: int,
                   spec: FieldSpec, ticket=None) -> torch.Tensor:
    """Launch kernel B's sums -> (K, 3, 8) Montgomery on the device; a new
    ticket unless one is given."""
    _check_vecs([abc, z], num_vars + num_extra)
    if abc.shape != z.shape:
        raise ValueError("inner0: abc and z must have one shape")
    K, stride = _instances([abc, z])
    nblocks = sum(_inner0_blocks(num_vars, num_extra))
    dev = abc.device
    partial = torch.empty(K * nblocks, 3, 8, dtype=torch.int32, device=dev)
    out = torch.empty(K, 3, 8, dtype=torch.int32, device=dev)
    if ticket is None:
        ticket = new_ticket(dev)
    SUMCHECK.call("sp2_inner0_evals", num_vars, num_extra, K, stride, abc.data_ptr(),
                  z.data_ptr(), partial.data_ptr(), nblocks, out.data_ptr(),
                  ticket.data_ptr(), field_words(spec))
    return out


def inner0_sums(abc: torch.Tensor, z: torch.Tensor, num_vars: int, num_extra: int,
                spec: FieldSpec, ticket=None) -> torch.Tensor:
    """Kernel B's sums (eval0, corr_low, corr_cross) of one instance, left
    on the device as (1, 3, 8) Montgomery; ``ticket`` as in ``inner0_evals``."""
    if not 0 < num_extra <= num_vars or abc.dim() != 2:
        raise ValueError("inner0_sums: one instance, 0 < num_extra <= num_vars")
    if abc.device.type == "cpu":
        return inner0_evals_plain(abc, z, num_vars, num_extra, spec)
    return _inner0_launch(abc, z, num_vars, num_extra, spec, ticket)


# ---------------------------------------------------------------------------
# kernel G: the sums of a Gruen eq-split round
# ---------------------------------------------------------------------------


def cubiceq_evals_plain(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, half: int,
                        hi_len: int, EL, ER: torch.Tensor, rlog: int, zero_check: bool,
                        fallback: bool, spec: FieldSpec, shard: int = 0,
                        lw: int = 0) -> torch.Tensor:
    """Plain version of ``cubiceq_evals``: (1, 3, 8) Montgomery sums."""
    g = shard + (torch.arange(half, device=A.device) << lw)
    w = ER[g] if EL is None else ops.mont_mul(EL[g >> rlog], ER[g & ((1 << rlog) - 1)],
                                              spec)

    def halves(v):
        hi = torch.zeros_like(v[:half])
        hi[:hi_len] = v[half : half + hi_len]
        return v[:half], hi

    (a0, a1), (b0, b1), (c0, c1) = halves(A), halves(B), halves(C)
    zero = torch.zeros(8, dtype=torch.int32, device=A.device)

    def wsum(f):
        return ops.sum_all(ops.mont_mul(w, f, spec), spec)

    tinf = wsum(ops.mont_mul(ops.sub(a1, a0, spec), ops.sub(b1, b0, spec), spec))
    t0 = zero if zero_check else wsum(ops.sub(ops.mont_mul(a0, b0, spec), c0, spec))
    tm1 = zero
    if fallback:
        am, bm, cm = (ops.sub(ops.add(x0, x0, spec), x1, spec)
                      for x0, x1 in ((a0, a1), (b0, b1), (c0, c1)))
        tm1 = wsum(ops.sub(ops.mont_mul(am, bm, spec), cm, spec))
    return torch.stack([t0, tinf, tm1])[None]


def cubiceq_evals(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, half: int,
                  hi_len: int, EL, ER: torch.Tensor, rlog: int, zero_check: bool,
                  fallback: bool, spec: FieldSpec, shard: int = 0, lw: int = 0,
                  ticket: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel G: the sums of one Gruen round over the low half [0, half)
    of A, B, C ((rows, 8) Montgomery), the high half read below hi_len and
    zero past it, against w_g = EL[g >> rlog] ER[g mod 2^rlog] (EL a
    tensor) or ER[g] (EL None) -> (1, 3, 8) sums of t0 (zero with
    zero_check), tinf and, with fallback, t(-1) (csrc/cubiceq.cu: per left
    row an unreduced inner sum over ER, reduced once and multiplied by EL
    once; the blocks' sums finished in the launch by the last block).  Local pair i is
    global pair g = shard + (i << lw): rank ``shard`` of 2^lw holding the
    rows shard + 2^lw i (half and hi_len local); shard = lw = 0
    unsharded.  ``ticket`` (``new_ticket``) may serve a whole sum-check;
    without it the launch takes its own."""
    if not 0 <= shard < 1 << lw:
        raise ValueError("cubiceq_evals: need 0 <= shard < 2^lw")
    if A.device.type == "cpu":
        return cubiceq_evals_plain(A, B, C, half, hi_len, EL, ER, rlog, zero_check,
                                   fallback, spec, shard, lw)
    if not 0 <= hi_len <= half < 1 << 32:
        raise ValueError("cubiceq_evals: need 0 <= hi_len <= half < 2^32")
    if not (0 <= rlog <= 40 and lw <= 20):
        raise ValueError("cubiceq_evals: need 0 <= rlog <= 40 and lw <= 20")
    tables = [ER] if EL is None else [EL, ER]
    _check_vecs([A, B, C], half + hi_len)
    check_cuda(A, *tables)
    glob = half << lw  # the global pairs the weights cover
    if ER.shape[0] < (glob if EL is None else 1 << rlog) or (
            EL is not None and EL.shape[0] << rlog < glob):
        raise ValueError("cubiceq_evals: weight tables too short")
    nblocks = _g_blocks(half, rlog, lw, EL is not None)
    dev = A.device
    partial = torch.empty(nblocks, 3, 8, dtype=torch.int32, device=dev)
    out = torch.empty(1, 3, 8, dtype=torch.int32, device=dev)
    if ticket is None:
        ticket = new_ticket(dev)
    CUBICEQ.call("sp2_cubiceq_evals", half, hi_len, rlog, int(zero_check), int(fallback),
                 shard, lw, None if EL is None else EL.data_ptr(), ER.data_ptr(),
                 A.data_ptr(), B.data_ptr(), C.data_ptr(), partial.data_ptr(), nblocks,
                 out.data_ptr(), ticket.data_ptr(), field_words(spec))
    return out
