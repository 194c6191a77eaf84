"""Equality polynomial: host evaluators over Python ints.

Reference: src/polys/eq.rs.  The device eq table is kernel 2
(sumcheck/device.py ``eq_table``, csrc/sumcheck.cu).
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
