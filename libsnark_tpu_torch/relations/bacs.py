"""Bilinear arithmetic circuits (reference relations/.../bacs/bacs.hpp).

A BACS gate is ``lhs * rhs = output`` where lhs/rhs are linear
combinations and output is a fresh wire variable (bacs.hpp:54-58).
Gates marked ``is_circuit_output`` must evaluate to zero for the circuit
to be satisfied (bacs.tcc:200-215). Variable index 0 is the constant 1
and is not counted in num_wires.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .variable import LinearCombination, Variable


@dataclasses.dataclass
class BACSGate:
    lhs: LinearCombination
    rhs: LinearCombination
    output: Variable
    is_circuit_output: bool = False

    def evaluate(self, wires: list, p: int) -> int:
        """wires: full vector [1, inputs..., gate outputs so far]."""
        return self.lhs.evaluate(wires, p) * self.rhs.evaluate(wires, p) % p


class BACSCircuit:
    """Arithmetic circuit of bilinear gates over the field of order p."""

    def __init__(self, p: int, primary_input_size: int = 0,
                 auxiliary_input_size: int = 0):
        self.p = p
        self.primary_input_size = primary_input_size
        self.auxiliary_input_size = auxiliary_input_size
        self.gates: List[BACSGate] = []

    @property
    def num_inputs(self):
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_gates(self):
        return len(self.gates)

    @property
    def num_wires(self):
        return self.num_inputs + self.num_gates

    def add_gate(self, lhs, rhs, output: Variable,
                 is_circuit_output: bool = False):
        self.gates.append(BACSGate(LinearCombination._coerce(lhs),
                                   LinearCombination._coerce(rhs),
                                   output, is_circuit_output))

    def is_valid(self) -> bool:
        """Gate i's output must be the fresh wire num_inputs + i + 1, and
        its inputs must reference earlier wires (bacs.tcc:107-130)."""
        for i, g in enumerate(self.gates):
            out_idx = self.num_inputs + i + 1
            if g.output.index != out_idx:
                return False
            if not (g.lhs.is_valid(out_idx - 1) and g.rhs.is_valid(out_idx - 1)):
                return False
        return True

    def get_all_wires(self, primary: list, auxiliary: list) -> list:
        """Full wire values (excluding the constant 1 at index 0)."""
        p = self.p
        full = [1] + [v % p for v in primary] + [v % p for v in auxiliary]
        for g in self.gates:
            full.append(g.evaluate(full, p))
        return full[1:]

    def get_all_outputs(self, primary: list, auxiliary: list) -> list:
        wires = self.get_all_wires(primary, auxiliary)
        return [wires[g.output.index - 1] for g in self.gates
                if g.is_circuit_output]

    def is_satisfied(self, primary: list, auxiliary: list) -> bool:
        return all(v == 0 for v in self.get_all_outputs(primary, auxiliary))
