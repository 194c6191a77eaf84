"""TestShapeCS: a debug constraint system with namespaces and
constraint pretty-printing.

Reference: src/bellpepper/test_shape_cs.rs.  A superset of the
shape-mode ConstraintSystem that records names for inputs, aux
variables, and constraints (slash-joined namespace paths), and renders
them in the reference's format:

    INPUT io
    AUX ns/x
    ns/mul: (`Ans/x`) * (`Ans/x`) = (`Ans/x_sq`)

Coefficient rendering matches test_shape_cs.rs:157-199: -1 prints as a
leading minus, powers of two as ``2^i .``, everything else as the
canonical integer.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

from ..field.constants import FieldSpec
from .constraint_system import LC, ConstraintSystem, Variable


class TestShapeCS(ConstraintSystem):
    """Shape-mode constraint system with naming (test_shape_cs.rs:56-)."""

    def __init__(self, field: FieldSpec):
        super().__init__(field, shape_mode=True)
        self.input_names: list[str] = ["ONE"]
        self.aux_names: list[str] = []
        self.constraint_names: list[str] = []
        self._namespace: list[str] = []

    # -- namespaces ------------------------------------------------------
    @contextmanager
    def namespace(self, name: str):
        """with cs.namespace("round0"): ... (bellpepper Namespace)."""
        self._namespace.append(name)
        try:
            yield self
        finally:
            self._namespace.pop()

    def _path(self, name: str) -> str:
        return "/".join(self._namespace + [name])

    # -- named allocation ------------------------------------------------
    def alloc(self, value=None, name: str = "v") -> Variable:
        self.aux_names.append(self._path(name))
        return super().alloc(value)

    def alloc_input(self, value=None, name: str = "io") -> Variable:
        self.input_names.append(self._path(name))
        return super().alloc_input(value)

    def enforce(self, a: LC, b: LC, c: LC, name: str = "constraint") -> None:
        self.constraint_names.append(self._path(name))
        super().enforce(a, b, c)

    # -- introspection (test_shape_cs.rs:108-121) ------------------------
    def num_constraints(self) -> int:
        return len(self.constraints)

    # -- pretty printing (test_shape_cs.rs:123-213) ----------------------
    def pretty_print_list(self) -> list[str]:
        out = [f"INPUT {n}" for n in self.input_names[1:]]
        out += [f"AUX {n}" for n in self.aux_names]
        out += list(self.constraint_names)
        return out

    def pretty_print(self) -> str:
        lines = [f"INPUT {n}" for n in self.input_names[1:]]
        for (a, b, c), name in zip(self.constraints, self.constraint_names):
            lines.append(
                f"{name}: {self._pp_lc(a)} * {self._pp_lc(b)} = {self._pp_lc(c)}"
            )
        return "\n".join(lines) + ("\n" if lines else "")

    def _var_label(self, var: Variable) -> str:
        kind, idx = var
        if kind == "one":
            return f"`I{self.input_names[0]}`"
        if kind == "input":
            return f"`I{self.input_names[idx]}`"
        return f"`A{self.aux_names[idx]}`"

    def _pp_lc(self, comb: LC) -> str:
        p = self.field.modulus
        # merge duplicate variables, drop zero coefficients, order
        # inputs before aux (proc_lc, test_shape_cs.rs:74-99)
        merged: dict[Variable, int] = {}
        for var, coeff in comb.items():
            merged[var] = (merged.get(var, 0) + coeff) % p
        order = {"one": 0, "input": 1, "aux": 2}
        items = sorted(
            ((v, c) for v, c in merged.items() if c != 0),
            key=lambda vc: (order[vc[0][0]], vc[0][1]),
        )
        if not items:
            return "(0)"
        parts: list[str] = []
        first = True
        for var, coeff in items:
            if coeff == p - 1:
                head = " - " if first else " - "
            else:
                head = "" if first else " + "
            body = ""
            if coeff not in (1, p - 1):
                pw = None
                v = coeff
                if v and v & (v - 1) == 0:
                    pw = v.bit_length() - 1
                body = f"2^{pw} . " if pw is not None else f"{coeff} . "
            parts.append(head + body + self._var_label(var))
            first = False
        return "(" + "".join(parts).strip() + ")"
