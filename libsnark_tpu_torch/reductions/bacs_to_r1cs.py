"""BACS -> R1CS reduction (reference reductions/bacs_to_r1cs/bacs_to_r1cs.tcc).

One constraint lhs * rhs = output per gate, plus 1 * output = 0 for each
circuit-output gate (tcc:24-66). Witness map = circuit wire evaluation.
"""
from __future__ import annotations

from ..relations.r1cs import R1CSConstraintSystem
from ..relations.variable import LinearCombination


def bacs_to_r1cs_instance_map(circuit) -> R1CSConstraintSystem:
    assert circuit.is_valid()
    cs = R1CSConstraintSystem(
        circuit.p,
        primary_input_size=circuit.primary_input_size,
        auxiliary_input_size=circuit.auxiliary_input_size + circuit.num_gates)
    for g in circuit.gates:
        cs.add_constraint(g.lhs, g.rhs, LinearCombination(g.output))
    for g in circuit.gates:
        if g.is_circuit_output:
            cs.add_constraint(1, LinearCombination(g.output), 0)
    return cs


def bacs_to_r1cs_witness_map(circuit, primary: list, auxiliary: list) -> list:
    """Returns the FULL r1cs variable assignment (primary + auxiliary +
    gate wires), without the leading constant."""
    return circuit.get_all_wires(primary, auxiliary)
