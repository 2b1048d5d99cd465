"""TBCS -> USCS reduction (reference reductions/tbcs_to_uscs/tbcs_to_uscs.tcc).

Each two-bit gate type maps to one 4-term linear combination
cx*x + cy*y + cz*z + c1 whose value is forced into {-1, 1}
(tcc:53-136); plus booleanity constraints 2*w - 1 for every wire and
w + 1 for circuit outputs (tcc:138-155). The coefficient table below
matches the reference's generated constants (tbcs_reduction.txt /
get_tbcs_reduction.py).
"""
from __future__ import annotations

from ..relations.uscs import USCSConstraintSystem
from ..relations.variable import Variable, LinearCombination
from ..relations.tbcs import TBCSGateType


# type -> (cx, cy, cz, c1)
_GATE_LC = {
    TBCSGateType.CONSTANT_0:   (0, 0, 1, 1),
    TBCSGateType.AND:          (-2, -2, 4, 1),
    TBCSGateType.X_AND_NOT_Y:  (-2, 2, 4, -1),
    TBCSGateType.X:            (-1, 0, 1, 1),
    TBCSGateType.NOT_X_AND_Y:  (2, -2, 4, -1),
    TBCSGateType.Y:            (0, 1, 1, -1),
    TBCSGateType.XOR:          (1, 1, 1, -1),
    TBCSGateType.OR:           (-2, -2, 4, -1),
    TBCSGateType.NOR:          (2, 2, 4, -3),
    TBCSGateType.EQUIVALENCE:  (1, 1, 1, -2),
    TBCSGateType.NOT_Y:        (0, -1, 1, 0),
    TBCSGateType.IF_Y_THEN_X:  (-2, 2, 4, -3),
    TBCSGateType.NOT_X:        (-1, 0, 1, 0),
    TBCSGateType.IF_X_THEN_Y:  (2, -2, 4, -3),
    TBCSGateType.NAND:         (2, 2, 4, -5),
    TBCSGateType.CONSTANT_1:   (0, 0, 1, 0),
}


def tbcs_to_uscs_instance_map(circuit, p: int) -> USCSConstraintSystem:
    assert circuit.is_valid()
    cs = USCSConstraintSystem(
        p,
        primary_input_size=circuit.primary_input_size,
        auxiliary_input_size=circuit.auxiliary_input_size + circuit.num_gates)
    for g in circuit.gates:
        cx, cy, cz, c1 = _GATE_LC[TBCSGateType(g.type)]
        lc = (cx * Variable(g.left_wire) + cy * Variable(g.right_wire)
              + cz * Variable(g.output) + c1)
        cs.add_constraint(lc)
    # reference iterates wires 0..num_wires-1 (including the constant wire
    # 0, whose constraint 2*1-1 is trivially satisfied) -- keep its exact
    # constraint count (tcc:138-146)
    for i in range(circuit.num_wires):
        cs.add_constraint(2 * Variable(i) - 1)
    for g in circuit.gates:
        if g.is_circuit_output:
            cs.add_constraint(Variable(g.output) + 1)
    return cs


def tbcs_to_uscs_witness_map(circuit, primary: list, auxiliary: list) -> list:
    """All wire values as 0/1 field elements."""
    return [1 if w else 0
            for w in circuit.get_all_wires(primary, auxiliary)]
