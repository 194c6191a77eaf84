"""Equality and power polynomials: host evaluators over Python ints.

Reference: src/polys/eq.rs and src/polys/power.rs.  The device eq and
power tables are entries of kernel 2 (sumcheck/device.py ``eq_table``
and ``pow_table``, csrc/sumcheck.cu).
"""

from __future__ import annotations

from ..field.constants import FieldSpec


def eq_evaluate(field: FieldSpec, r: list[int], rx: list[int]) -> int:
    p = field.modulus
    acc = 1
    for a, b in zip(r, rx):
        acc = acc * (a * b + (1 - a) * (1 - b)) % p
    return acc


def eq_evals_host(field: FieldSpec, r: list[int]) -> list[int]:
    """All 2^len(r) evaluations, index bit order: r[0] is the TOP bit."""
    p = field.modulus
    evals = [1]
    for ri in reversed(r):
        hi = [v * ri % p for v in evals]
        lo = [(v - h) % p for v, h in zip(evals, hi)]
        evals = lo + hi
    return evals


def pow_generators(field: FieldSpec, t: int, ell: int) -> list[int]:
    """The ell powers g_j = t^(2^(ell-1-j)) the power table is built from
    (g_0 drives the most significant index bit)."""
    return [pow(t, 1 << (ell - 1 - j), field.modulus) for j in range(ell)]


def pow_evaluate(field: FieldSpec, t: int, r: list[int]) -> int:
    """The MLE of [t^k for k < 2^ell] at r (PowPolynomial::evaluate,
    power.rs:34-50); r[0] binds the top index bit, so coordinate i
    carries t^(2^(ell-1-i))."""
    p = field.modulus
    acc = 1
    for g, ri in zip(pow_generators(field, t, len(r)), r):
        acc = acc * (1 + (g - 1) * ri) % p
    return acc
