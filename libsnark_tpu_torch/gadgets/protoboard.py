"""Protoboard: the circuit-authoring surface (gadgetlib1 equivalent).

Parity with reference gadgetlib1/protoboard.hpp:27-84 and
pb_variable.hpp:24-118: a protoboard owns the variable allocator, the
value assignment, and the growing constraint system; variables /
variable arrays / linear combinations are lightweight handles. Index 0
is the constant 1 (never allocated).

Authoring is host-side; `get_constraint_system()` gives the port's
R1CSConstraintSystem, which the port's proof systems take directly.
"""
from __future__ import annotations

from typing import List, Optional

from ..relations.r1cs import R1CSConstraintSystem
from ..relations.variable import Variable, LinearCombination, ONE


class PBVariable(Variable):
    """A protoboard variable handle; allocate before use."""

    __slots__ = ()

    def __init__(self, index: int = -1):
        super().__init__(index)

    def allocate(self, pb: "Protoboard", annotation: str = ""):
        self.index = pb._allocate(annotation)
        return self


class PBVariableArray(list):
    """List of PBVariables with bulk allocation and bit helpers
    (pb_variable_array, pb_variable.hpp:44-99)."""

    def allocate(self, pb: "Protoboard", n: int, annotation: str = ""):
        del self[:]
        for i in range(n):
            v = PBVariable()
            v.allocate(pb, f"{annotation}_{i}")
            self.append(v)
        return self

    def fill_with_bits_of_int(self, pb: "Protoboard", value: int):
        for i, v in enumerate(self):
            pb.setval(v, (value >> i) & 1)

    def fill_with_bits(self, pb: "Protoboard", bits):
        assert len(bits) == len(self)
        for v, b in zip(self, bits):
            pb.setval(v, 1 if b else 0)

    def get_int_from_bits(self, pb: "Protoboard") -> int:
        out = 0
        for i, v in enumerate(self):
            out |= (pb.val(v) & 1) << i
        return out

    def values(self, pb: "Protoboard") -> list:
        return [pb.val(v) for v in self]


class PBLinearCombination(LinearCombination):
    """A linear combination with a cached evaluated value
    (pb_linear_combination, pb_variable.hpp:101-118)."""

    __slots__ = ("is_variable",)

    def __init__(self, init=None):
        super().__init__(init)
        self.is_variable = isinstance(init, Variable)

    def assign(self, pb: "Protoboard", lc):
        lc = LinearCombination._coerce(lc)
        self.terms = list(lc.terms)
        self.is_variable = False

    def evaluate(self, pb: "Protoboard"):
        return super().evaluate(pb.full_assignment(), pb.p)


class Protoboard:
    """Variable allocator + value store + constraint accumulator."""

    def __init__(self, p: int):
        self.p = p
        self._values: List[int] = [1]          # index 0 = constant 1
        self._annotations: List[str] = ["ONE"]
        self.constraints: List[tuple] = []      # (a, b, c, annotation)
        self._num_inputs = 0

    # -- allocation ---------------------------------------------------------
    def _allocate(self, annotation: str = "") -> int:
        self._values.append(0)
        self._annotations.append(annotation)
        return len(self._values) - 1

    @property
    def num_variables(self):
        return len(self._values) - 1

    def set_input_sizes(self, n: int):
        """First n allocated variables are the primary input."""
        self._num_inputs = n

    @property
    def num_inputs(self):
        return self._num_inputs

    # -- values ------------------------------------------------------------
    def val(self, v) -> int:
        if isinstance(v, PBLinearCombination):
            return v.evaluate(self)
        return self._values[v.index]

    def setval(self, v, x: int):
        if isinstance(v, PBLinearCombination):
            raise TypeError("cannot assign to a linear combination; "
                            "use .assign() + evaluate")
        self._values[v.index] = int(x) % self.p

    def lc_val(self, lc) -> int:
        lc = LinearCombination._coerce(lc)
        return lc.evaluate(self._values, self.p)

    def full_assignment(self) -> list:
        return self._values

    def primary_input(self) -> list:
        return self._values[1: 1 + self._num_inputs]

    def auxiliary_input(self) -> list:
        return self._values[1 + self._num_inputs:]

    # -- constraints ----------------------------------------------------------
    def add_r1cs_constraint(self, a, b, c, annotation: str = ""):
        self.constraints.append(
            (LinearCombination._coerce(a), LinearCombination._coerce(b),
             LinearCombination._coerce(c), annotation))

    @property
    def num_constraints(self):
        return len(self.constraints)

    def is_satisfied(self) -> bool:
        p = self.p
        vals = self._values
        for a, b, c, _ in self.constraints:
            if (a.evaluate(vals, p) * b.evaluate(vals, p)
                    - c.evaluate(vals, p)) % p != 0:
                return False
        return True

    def first_unsatisfied(self) -> Optional[str]:
        p = self.p
        vals = self._values
        for i, (a, b, c, ann) in enumerate(self.constraints):
            if (a.evaluate(vals, p) * b.evaluate(vals, p)
                    - c.evaluate(vals, p)) % p != 0:
                return f"constraint {i}: {ann}"
        return None

    def get_constraint_system(self) -> R1CSConstraintSystem:
        cs = R1CSConstraintSystem(
            self.p, primary_input_size=self._num_inputs,
            auxiliary_input_size=self.num_variables - self._num_inputs)
        for a, b, c, ann in self.constraints:
            cs.add_constraint(a, b, c, ann)
        return cs


class ConstraintProfiler:
    """Constraint-count profiling (reference gadgetlib1/
    constraint_profiling.hpp:33-46 PROFILE_CONSTRAINTS /
    PRINT_CONSTRAINT_PROFILING): scoped tallies of constraints added
    per annotated block.

        prof = ConstraintProfiler(pb)
        with prof.scope("sha256"):
            gadget.generate_r1cs_constraints()
        prof.print_profiling()
    """

    def __init__(self, pb: "Protoboard"):
        self.pb = pb
        self.entries = []            # (depth, name, count)
        self._stack = []

    class _Scope:
        def __init__(self, prof, name):
            self.prof, self.name = prof, name

        def __enter__(self):
            self.start = self.prof.pb.num_constraints
            self.prof._stack.append(self.name)
            return self

        def __exit__(self, *exc):
            count = self.prof.pb.num_constraints - self.start
            depth = len(self.prof._stack)
            self.prof._stack.pop()
            self.prof.entries.append((depth, self.name, count))
            return False

    def scope(self, name: str):
        return self._Scope(self, name)

    def print_profiling(self, out=None):
        import sys
        out = out or sys.stdout
        for depth, name, count in self.entries:
            out.write(f"{'  ' * depth}* {name}: {count} constraints\n")


class Gadget:
    """Base gadget: (protoboard, annotation prefix); subclasses define
    generate_r1cs_constraints() and generate_r1cs_witness()
    (gadget.hpp:16-24, pattern basic_gadgets.hpp:53-57)."""

    def __init__(self, pb: Protoboard, annotation_prefix: str = ""):
        self.pb = pb
        self.annotation_prefix = annotation_prefix

    def annot(self, suffix: str) -> str:
        return f"{self.annotation_prefix}.{suffix}"

    def generate_r1cs_constraints(self):
        raise NotImplementedError

    def generate_r1cs_witness(self):
        raise NotImplementedError
