"""Kernel 2 (csrc/sumcheck.cu): the eq table, sum-check round
evaluations and binds, with their plain versions.

Vectors are (n, 8) int32 Montgomery tensors.  On CUDA tensors each
wrapper launches the kernel (or raises); on CPU tensors it runs the plain
PyTorch version.  Round evaluations come back as canonical Python ints
(the host squeezes the round challenge from them).
"""

from __future__ import annotations

import torch

from ..field import ops
from ..field.constants import FieldSpec
from ..field.limbs import limbs_to_ints, to_device
from ..utils.cuda import SZ, CudaKernel, I, P, check_cuda, fe_words, field_words

SUMCHECK = CudaKernel("sumcheck", {
    "sp2_eq_table": [I, P, P, P],
    "sp2_round_evals": [I, SZ, P, P, P, P, P, I, P, P],
    "sp2_bind": [SZ, I, P, P, P, P, P, P],
})

CUBIC, QUAD, DOT = 0, 1, 2
_NT = 256
_MAX_BLOCKS = 1024


def _check_vecs(vecs: list, n: int, count: int) -> None:
    """``count`` contiguous int32 CUDA vectors of at least n (n, 8) rows."""
    if len(vecs) != count:
        raise ValueError(f"expected {count} vectors, got {len(vecs)}")
    check_cuda(*vecs)
    if any(v.dim() != 2 or v.shape[1] != 8 or v.shape[0] < n for v in vecs):
        raise ValueError(f"vectors must be (>= {n}, 8)")


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
    (polys/eq.py:79-94 of the JAX package); ``factors`` from eq_factors."""
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


# ---------------------------------------------------------------------------
# round evaluations
# ---------------------------------------------------------------------------


def round_evals_plain(mode: int, n: int, vecs: list, spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``round_evals``: (k, 8) Montgomery sums."""
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


def round_evals(mode: int, n: int, vecs: list, spec: FieldSpec) -> list[int]:
    """Sums over the first ``n`` entries of the vectors, as canonical ints:
    CUBIC (eq, A, B, C) -> [s(0), s(2), s(3)] of
        s(X) = sum_j eq(X) (A(X) B(X) - C(X)) over the n/2 pairs;
    QUAD (A, B) -> [sum A_lo B_lo, sum (A_hi - A_lo)(B_hi - B_lo)];
    DOT (A, B) -> [sum A B]."""
    dev = vecs[0].device
    if dev.type == "cpu":
        return limbs_to_ints(round_evals_plain(mode, n, vecs, spec), spec,
                             mont=True)
    _check_vecs(vecs, n, 4 if mode == CUBIC else 2)
    k = {CUBIC: 3, QUAD: 2, DOT: 1}[mode]
    work = n if mode == DOT else n // 2
    nblocks = max(1, min(-(-work // _NT), _MAX_BLOCKS))
    partial = torch.empty(nblocks * k, 8, dtype=torch.int32, device=dev)
    out = torch.empty(k, 8, dtype=torch.int32, device=dev)
    ptr = [v.data_ptr() for v in vecs]
    eq, A, B, C = ptr if mode == CUBIC else [None, ptr[0], ptr[1], None]
    SUMCHECK.call("sp2_round_evals", mode, work, eq, A, B, C,
                  partial.data_ptr(), nblocks, out.data_ptr(), field_words(spec))
    return limbs_to_ints(out, spec, mont=True)


# ---------------------------------------------------------------------------
# bind
# ---------------------------------------------------------------------------


def bind_plain(vecs: list, n: int, r: int, spec: FieldSpec) -> None:
    """Plain version of ``bind`` (in place)."""
    half = n // 2
    rr = ops.const(r, spec, device=vecs[0].device)
    for v in vecs:
        lo, hi = v[:half], v[half:n]
        v[:half] = ops.add(lo, ops.mont_mul(rr, ops.sub(hi, lo, spec), spec), spec)


def bind(vecs: list, n: int, r: int, spec: FieldSpec) -> None:
    """x[j] <- x[j] + r (x[n/2 + j] - x[j]) for j < n/2, in place in up to
    four vectors (bind_poly_var_top; r canonical)."""
    if vecs[0].device.type == "cpu":
        bind_plain(vecs, n, r, spec)
        return
    if not 1 <= len(vecs) <= 4:
        raise ValueError("bind: 1 to 4 vectors")
    _check_vecs(vecs, n, len(vecs))
    ptrs = [v.data_ptr() for v in vecs] + [None] * (4 - len(vecs))
    SUMCHECK.call("sp2_bind", n // 2, len(vecs), *ptrs,
                  fe_words(spec.to_mont(r)), field_words(spec))
