"""Univariate round polynomials (host side, canonical Python ints).

Mirrors the reference's UniPoly / CompressedUniPoly
(src/polys/univariate.rs): coefficients stored low-to-high; the compressed
form omits the linear coefficient, which verifiers reconstruct from the
round claim (eval(0) + eval(1) == claim).

Transcript encoding: the compressed coefficient list, each as the 32-byte
little-endian canonical repr (univariate.rs:182-190 — note: NOT reversed,
unlike plain scalar absorbs).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field.constants import FieldSpec


@dataclass
class UniPoly:
    field: FieldSpec
    coeffs: list[int]  # low-to-high

    @classmethod
    def from_evals(cls, field: FieldSpec, evals: list[int]) -> "UniPoly":
        n = len(evals)
        if n == 3:
            return cls.from_evals_deg2(field, evals)
        if n == 4:
            return cls.from_evals_deg3(field, evals)
        # general: solve Vandermonde (x = 0..n-1) by Gaussian elimination
        p = field.modulus
        mat = [[pow(x, j, p) for j in range(n)] + [evals[x] % p] for x in range(n)]
        for col in range(n):
            piv = next(r for r in range(col, n) if mat[r][col] % p != 0)
            mat[col], mat[piv] = mat[piv], mat[col]
            inv = pow(mat[col][col], -1, p)
            mat[col] = [v * inv % p for v in mat[col]]
            for r in range(n):
                if r != col and mat[r][col]:
                    f = mat[r][col]
                    mat[r] = [(v - f * w) % p for v, w in zip(mat[r], mat[col])]
        return cls(field, [mat[r][n] for r in range(n)])

    @classmethod
    def from_evals_deg2(cls, field: FieldSpec, evals) -> "UniPoly":
        p = field.modulus
        e0, e1, e2 = (e % p for e in evals[:3])
        c = e0
        a = (e0 - 2 * e1 + e2) * field.two_inv % p
        b = (e1 - c - a) % p
        return cls(field, [c, b, a])

    @classmethod
    def from_evals_deg3(cls, field: FieldSpec, evals) -> "UniPoly":
        p = field.modulus
        e0, e1, e2, e3 = (e % p for e in evals[:4])
        d = e0
        six_inv = pow(6, -1, p)
        a = (e3 - 3 * e2 + 3 * e1 - e0) * six_inv % p
        b = ((e2 - 2 * e1 + e0) * field.two_inv - 3 * a) % p
        c = (e1 - d - b - a) % p
        return cls(field, [d, c, b, a])

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def eval_at_zero(self) -> int:
        return self.coeffs[0]

    def eval_at_one(self) -> int:
        return sum(self.coeffs) % self.field.modulus

    def evaluate(self, r: int) -> int:
        p = self.field.modulus
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * r + c) % p
        return acc

    def compress(self) -> "CompressedUniPoly":
        return CompressedUniPoly(self.field, [self.coeffs[0]] + self.coeffs[2:])

    def to_transcript_bytes(self) -> bytes:
        comp = self.compress()
        return b"".join(self.field.to_bytes(c) for c in comp.coeffs_except_linear)


@dataclass
class CompressedUniPoly:
    field: FieldSpec
    coeffs_except_linear: list[int]

    def decompress(self, hint: int) -> UniPoly:
        p = self.field.modulus
        linear = (hint - 2 * self.coeffs_except_linear[0]) % p
        for c in self.coeffs_except_linear[1:]:
            linear = (linear - c) % p
        coeffs = [self.coeffs_except_linear[0], linear] + self.coeffs_except_linear[1:]
        return UniPoly(self.field, coeffs)
