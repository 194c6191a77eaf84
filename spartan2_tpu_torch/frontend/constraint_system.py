"""R1CS circuit frontend: constraint synthesis + witness generation.

Python-idiomatic equivalent of the reference's bellpepper frontend
(src/bellpepper/shape_cs.rs ShapeCS, solver.rs SatisfyingAssignment, and
traits/circuit.rs SpartanCircuit).  One ConstraintSystem class serves
both modes:

  * shape mode: records (A, B, C) linear-combination triples, counts
    variables; witness values are not stored (ShapeCS).
  * witness mode: records assignments; ``enforce`` is a no-op
    (SatisfyingAssignment).

Variables are ("one", 0) | ("aux", i) | ("input", i); input 0 is the
constant ONE, inputs beyond it are public IO in order (challenges first
— see traits/circuit.rs:44-47).  Linear combinations are {var: coeff}
dicts over canonical field ints.
"""

from __future__ import annotations

from typing import Callable, Optional, Protocol

from ..errors import SynthesisError
from ..field.constants import FieldSpec

Variable = tuple[str, int]
ONE: Variable = ("one", 0)

LC = dict  # Variable -> int coefficient


def lc(*terms) -> LC:
    """Build a linear combination from (coeff, var) pairs."""
    out: LC = {}
    for coeff, var in terms:
        out[var] = out.get(var, 0) + coeff
    return out


class ConstraintSystem:
    """Dual-mode constraint system (shape / witness)."""

    def __init__(self, field: FieldSpec, shape_mode: bool):
        self.field = field
        self.shape_mode = shape_mode
        self.num_aux = 0
        self.aux_assignment: list[int] = []
        self.input_assignment: list[int] = [1]  # input 0 = ONE
        self.constraints: list[tuple[LC, LC, LC]] = []
        self._inputs_shape = 0  # inputs beyond ONE, shape mode only

    # -- allocation ------------------------------------------------------
    def alloc(self, value: Optional[int | Callable[[], int]] = None) -> Variable:
        idx = self.num_aux
        self.num_aux += 1
        if not self.shape_mode:
            v = value() if callable(value) else value
            if v is None:
                raise SynthesisError("witness mode requires a value for alloc")
            self.aux_assignment.append(v % self.field.modulus)
        return ("aux", idx)

    def alloc_input(self, value: Optional[int | Callable[[], int]] = None) -> Variable:
        idx = len(self.input_assignment) if not self.shape_mode else self._num_inputs_shape()
        if self.shape_mode:
            self._inputs_shape += 1
        else:
            v = value() if callable(value) else value
            if v is None:
                raise SynthesisError(
                    "witness mode requires a value for alloc_input")
            self.input_assignment.append(v % self.field.modulus)
        return ("input", idx)

    def _num_inputs_shape(self) -> int:
        return 1 + self._inputs_shape

    @property
    def num_inputs(self) -> int:
        return self._num_inputs_shape() if self.shape_mode else len(self.input_assignment)

    # -- constraints -----------------------------------------------------
    def enforce(self, a: LC, b: LC, c: LC) -> None:
        """Add the constraint <a, z> * <b, z> = <c, z>."""
        if self.shape_mode:
            self.constraints.append((dict(a), dict(b), dict(c)))

    # -- witness lookup ---------------------------------------------------
    def value_of(self, var: Variable) -> int:
        kind, idx = var
        if kind == "one":
            return 1
        if kind == "aux":
            return self.aux_assignment[idx]
        return self.input_assignment[idx]

    def eval_lc(self, comb: LC) -> int:
        p = self.field.modulus
        return sum(coeff * self.value_of(var) for var, coeff in comb.items()) % p


class Num:
    """An allocated field element (bellpepper AllocatedNum analogue)."""

    __slots__ = ("var", "value")

    def __init__(self, var: Variable, value: Optional[int]):
        self.var = var
        self.value = value

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: Optional[int | Callable[[], int]]) -> "Num":
        v = value() if callable(value) else value
        var = cs.alloc(v)
        return cls(var, None if cs.shape_mode else v % cs.field.modulus)

    def inputize(self, cs: ConstraintSystem) -> None:
        """Expose this value as public IO: allocate an input and constrain
        equality (AllocatedNum::inputize)."""
        inp = cs.alloc_input(self.value)
        cs.enforce(lc((1, self.var)), lc((1, ONE)), lc((1, inp)))

    def mul(self, cs: ConstraintSystem, other: "Num") -> "Num":
        p = cs.field.modulus
        out = Num.alloc(
            cs,
            None if cs.shape_mode else (self.value * other.value) % p,
        )
        cs.enforce(lc((1, self.var)), lc((1, other.var)), lc((1, out.var)))
        return out

    def square(self, cs: ConstraintSystem) -> "Num":
        return self.mul(cs, self)


class SpartanCircuitAPI(Protocol):
    """SpartanCircuit (reference traits/circuit.rs:19-53): the 5-phase
    commit-then-challenge circuit interface."""

    def public_values(self) -> list[int]: ...

    def shared(self, cs: ConstraintSystem) -> list[Num]: ...

    def precommitted(self, cs: ConstraintSystem, shared: list[Num]) -> list[Num]: ...

    def num_challenges(self) -> int: ...

    def synthesize(self, cs: ConstraintSystem, shared: list[Num],
                   precommitted: list[Num],
                   challenges: Optional[list[int]]) -> None: ...
