"""Multilinear polynomials: host evaluation over Python ints.

Reference: src/polys/multilinear.rs.  The dense MLE over the boolean
hypercube is stored index-major with variable 0 as the TOP bit (bind
order = top variable first, multilinear.rs:95-164).  Device binds are
kernel 2 (sumcheck/device.py ``bind``).
"""

from __future__ import annotations

from ..field.constants import FieldSpec


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
