"""Two-input boolean circuits (reference relations/.../tbcs/tbcs.hpp).

A TBCS gate applies one of the 16 two-bit truth tables to two wires; the
opcode IS the truth table: OPCODE(g) = (g(0,0), g(0,1), g(1,0), g(1,1))
read MSB-first (tbcs.hpp:40-74; evaluate tbcs.cpp:24-38). Wire 0 is the
constant TRUE. Satisfied iff every circuit-output gate evaluates to 0.
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import List


class TBCSGateType(IntEnum):
    CONSTANT_0 = 0
    AND = 1
    X_AND_NOT_Y = 2
    X = 3
    NOT_X_AND_Y = 4
    Y = 5
    XOR = 6
    OR = 7
    NOR = 8
    EQUIVALENCE = 9
    NOT_Y = 10
    IF_Y_THEN_X = 11
    NOT_X = 12
    IF_X_THEN_Y = 13
    NAND = 14
    CONSTANT_1 = 15


@dataclasses.dataclass
class TBCSGate:
    left_wire: int
    right_wire: int
    type: TBCSGateType
    output: int
    is_circuit_output: bool = False

    def evaluate(self, wires: list) -> bool:
        """wires: assignment WITHOUT the constant; wire 0 means TRUE."""
        X = True if self.left_wire == 0 else bool(wires[self.left_wire - 1])
        Y = True if self.right_wire == 0 else bool(wires[self.right_wire - 1])
        pos = 3 - ((2 if X else 0) + (1 if Y else 0))
        return bool(int(self.type) & (1 << pos))


class TBCSCircuit:
    def __init__(self, primary_input_size: int = 0,
                 auxiliary_input_size: int = 0):
        self.primary_input_size = primary_input_size
        self.auxiliary_input_size = auxiliary_input_size
        self.gates: List[TBCSGate] = []

    @property
    def num_inputs(self):
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_gates(self):
        return len(self.gates)

    @property
    def num_wires(self):
        return self.num_inputs + self.num_gates

    def add_gate(self, gate: TBCSGate):
        self.gates.append(gate)

    def is_valid(self) -> bool:
        for i, g in enumerate(self.gates):
            out_idx = self.num_inputs + i + 1
            if g.output != out_idx:
                return False
            if g.left_wire >= out_idx or g.right_wire >= out_idx:
                return False
        return True

    def get_all_wires(self, primary: list, auxiliary: list) -> list:
        wires = [bool(v) for v in primary] + [bool(v) for v in auxiliary]
        for g in self.gates:
            wires.append(g.evaluate(wires))
        return wires

    def get_all_outputs(self, primary: list, auxiliary: list) -> list:
        wires = self.get_all_wires(primary, auxiliary)
        return [wires[g.output - 1] for g in self.gates if g.is_circuit_output]

    def is_satisfied(self, primary: list, auxiliary: list) -> bool:
        return not any(self.get_all_outputs(primary, auxiliary))
