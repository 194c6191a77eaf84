"""Multilinear polynomials: host evaluation over Python ints, and the
evaluation of a table on the device.

Reference: src/polys/multilinear.rs.  The dense MLE over the boolean
hypercube is stored index-major with variable 0 as the TOP bit (bind
order = top variable first, multilinear.rs:95-164).  Device binds are
kernel 2 (sumcheck/device.py ``bind``; ``bind_dev``, entry sp2_bind_dev of
csrc/sumcheck.cu, with r read from the device), which computes the JAX
package's ``bind_top_device`` a' = lo + r (hi - lo) exactly.  Device
tables are (2^m, 8) int32 Montgomery tensors.  The host functions, which
every SNARK and verifier imports, need neither torch nor the kernels: the
device functions import kernel 2 when they are called.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..field.constants import FieldSpec

if TYPE_CHECKING:
    import torch


def mle_evaluate_host(field: FieldSpec, evals: list[int], r: list[int]) -> int:
    """Evaluate the MLE with evaluation table ``evals`` at point ``r``.

    len(evals) == 2^len(r); r[0] binds the top (most significant) index bit.
    """
    p = field.modulus
    cur = [v % p for v in evals]
    for ri in r:
        half = len(cur) // 2
        cur = [(cur[j] + ri * (cur[half + j] - cur[j])) % p for j in range(half)]
    return cur[0]


def sparse_poly_evaluate_host(
    field: FieldSpec, num_vars: int, entries: list[int], r: list[int]
) -> int:
    """SparsePolynomial::evaluate (multilinear.rs:179-208): the MLE whose
    first ``len(entries)`` hypercube evaluations are ``entries`` and the
    rest are zero, evaluated at ``r`` (len(r) == num_vars).

    Used for the public-IO polynomial (1, X) padded with zeros.
    """
    assert len(r) == num_vars
    p = field.modulus
    acc = 0
    for i, v in enumerate(entries):
        if v % p == 0:
            continue
        # chi_i(r) = prod_j (r_j if bit_j(i) else 1 - r_j); bit 0 = top.
        chi = 1
        for j in range(num_vars):
            bit = (i >> (num_vars - 1 - j)) & 1
            chi = chi * (r[j] if bit else (1 - r[j]) % p) % p
        acc = (acc + v * chi) % p
    return acc


def bind_top_device(arr: torch.Tensor, r: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """bind_poly_var_top: (n, 8) -> (n/2, 8), a' = lo + r (hi - lo), with r
    (8,) Montgomery on ``arr``'s device: kernel 2's device-r bind on a copy
    (the JAX package's bind_top_device, polys/multilinear.py:73)."""
    from ..sumcheck.device import bind_dev

    out = arr.clone()
    bind_dev([out], arr.shape[0], r.reshape(1, 8), spec)
    return out[: arr.shape[0] // 2]


def _check_table(table: torch.Tensor, r: torch.Tensor) -> int:
    m = r.shape[0]
    if r.shape != (m, 8) or table.shape != (1 << m, 8):
        raise ValueError("mle_evaluate_device: table (2^m, 8) and r (m, 8)")
    return m


def mle_evaluate_device_plain(table: torch.Tensor, r: torch.Tensor,
                              spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``mle_evaluate_device``."""
    from ..sumcheck.device import bind_mont_plain

    m = _check_table(table, r)
    cur = table.clone()
    for j in range(m):
        bind_mont_plain([cur], 1 << (m - j), r[j], spec)
    return cur[0]


def mle_evaluate_device(table: torch.Tensor, r: torch.Tensor,
                        spec: FieldSpec) -> torch.Tensor:
    """The MLE of a (2^m, 8) table at the point r, (m, 8), both Montgomery
    on one device -> (8,) Montgomery (the JAX package's
    mle_evaluate_device, polys/multilinear.py:81): m top binds of a copy
    in place, launches of kernel 2's sp2_bind_dev with r_j read on the
    device, and no pull in between."""
    from ..sumcheck.device import bind_dev

    if table.device.type == "cpu":
        return mle_evaluate_device_plain(table, r, spec)
    m = _check_table(table, r)
    cur = table.clone()
    for j in range(m):
        bind_dev([cur], 1 << (m - j), r[j : j + 1], spec)
    return cur[0]
