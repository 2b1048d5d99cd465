"""Unitary-square constraint systems (reference relations/.../uscs/uscs.hpp).

A USCS constraint is a single linear combination C with the semantics
C(x) in {-1, 1} -- i.e. C(x)^2 = 1 (uscs.hpp:41,78; satisfaction check
uscs.tcc:74-104). Used by the DFGK14 proof system via the USCS->SSP
reduction.
"""
from __future__ import annotations

from typing import List

from .variable import LinearCombination


class USCSConstraintSystem:
    """USCS over the prime field of order p; constraints are LCs."""

    def __init__(self, p: int, primary_input_size: int = 0,
                 auxiliary_input_size: int = 0):
        self.p = p
        self.primary_input_size = primary_input_size
        self.auxiliary_input_size = auxiliary_input_size
        self.constraints: List[LinearCombination] = []

    @property
    def num_inputs(self):
        return self.primary_input_size

    @property
    def num_variables(self):
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_constraints(self):
        return len(self.constraints)

    def add_constraint(self, c, annotation: str = ""):
        self.constraints.append(LinearCombination._coerce(c))

    def is_valid(self) -> bool:
        nv = self.num_variables
        return all(c.is_valid(nv) for c in self.constraints)

    def is_satisfied(self, primary: list, auxiliary: list) -> bool:
        p = self.p
        full = [1] + [v % p for v in primary] + [v % p for v in auxiliary]
        for c in self.constraints:
            v = c.evaluate(full, p)
            if v * v % p != 1:
                return False
        return True
