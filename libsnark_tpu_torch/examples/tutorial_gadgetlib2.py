"""gadgetlib2 tutorial (reference gadgetlib2/examples/tutorial.cpp, read
top-down): protoboard usage, writing a gadget, composing gadgets, and the
integration path gadgetlib2 circuit -> R1CS -> ppzkSNARK, whose last step
proves and verifies the circuit with BCTV14 (r1cs_ppzksnark) over
alt_bn128 on the device.

usage: python -m libsnark_tpu_torch.examples.tutorial_gadgetlib2
           [--device cuda|cpu]
"""
import sys

from ..gadgetlib2 import (
    ANDGadget, GL2Gadget, GL2Protoboard, GL2Variable, GL2VariableArray,
    get_constraint_system_from_gadgetlib2,
    get_variable_assignment_from_gadgetlib2)
from ..ops import cuda_lib
from ..profiles._common import ALT_BN128_R as P, check, split_device


def example_protoboard_usage():
    """tutorial.cpp TEST(Examples, ProtoboardUsage): raw constraints."""
    pb = GL2Protoboard.create(P)
    inp = GL2VariableArray(3, "input")
    output = GL2Variable("output")
    # Constraint 1: input[0] * (5 + input[2]) == output
    pb.add_rank1_constraint(inp[0], 5 + inp[2], output, "c1")
    # Constraint 2 (unary form): input[1] - output == 0
    pb.add_rank1_constraint(1, inp[1] - output, 0, "c2")

    for v in list(inp) + [output]:
        pb.setval(v, 42)
    check(not pb.is_satisfied(), "42s satisfy the board")

    pb.setval(inp[0], 1)
    pb.setval(inp[1], 42)
    pb.setval(output, 42)
    pb.setval(inp[2], 37)          # 1 * (5 + 37) == 42
    check(pb.is_satisfied(), "the assignment does not satisfy the board")
    print("protoboard usage: OK")


class NANDGadget(GL2Gadget):
    """tutorial.cpp NAND_Gadget: an ANDGadget and one negation constraint,
    the canonical gadget that uses a sub-gadget."""

    def __init__(self, pb, inputs, output):
        super().__init__(pb)
        self.inputs = inputs
        self.output = output
        self.and_result = GL2Variable("and_result")
        self.and_gadget = ANDGadget(pb, inputs, self.and_result)

    def generateConstraints(self):
        self.and_gadget.generateConstraints()
        # output == 1 - and_result
        self.pb.add_rank1_constraint(
            1, 1 - self.and_result, self.output, "not")

    def generateWitness(self):
        self.and_gadget.generateWitness()
        self.pb.setval(self.output,
                       (1 - self.pb.val(self.and_result)) % self.pb.p)


def example_nand_gadget():
    pb = GL2Protoboard.create(P)
    inputs = GL2VariableArray(4, "inputs")
    output = GL2Variable("output")
    g = NANDGadget(pb, list(inputs), output)
    g.generateConstraints()
    for v in inputs:
        pb.setval(v, 1)
    g.generateWitness()
    check(pb.val(output) == 0 and pb.is_satisfied(), "NAND(1, 1, 1, 1)")
    pb.setval(inputs[2], 0)
    g.generateWitness()
    check(pb.val(output) == 1 and pb.is_satisfied(), "NAND(1, 1, 0, 1)")
    # tampering with the witness must break satisfiability
    pb.setval(output, 0)
    check(not pb.is_satisfied(), "a tampered witness satisfies the board")
    print("NAND gadget: OK")


def example_integration_to_snark(device):
    """tutorial.cpp's final stage (simple_example.hpp +
    run_r1cs_ppzksnark): gadgetlib2 circuit -> R1CS -> BCTV14 generator,
    prover and verifier on ``device``."""
    from .. import get_curve
    from ..proof_systems.bctv14 import BCTV14
    pb = GL2Protoboard.create(P)
    inputs = GL2VariableArray(2, "in")
    output = GL2Variable("out")
    pb.set_public(list(inputs) + [output])
    g = NANDGadget(pb, list(inputs), output)
    g.generateConstraints()
    pb.setval(inputs[0], 1)
    pb.setval(inputs[1], 0)
    g.generateWitness()
    check(pb.is_satisfied(), "the NAND board is not satisfied")

    cs, ordered = get_constraint_system_from_gadgetlib2(pb)
    full = get_variable_assignment_from_gadgetlib2(pb, ordered)
    k = cs.primary_input_size
    primary, aux = full[:k], full[k:]
    check(cs.is_satisfied(primary, aux), "the R1CS is not satisfied")
    print(f"integration: R1CS with {cs.num_constraints} constraints, "
          f"{cs.num_variables} variables; satisfied = True")
    ps = BCTV14(get_curve("alt_bn128"), device=device)
    kp = ps.generator(cs, seed=1)
    proof = ps.prover(kp.pk, primary, aux, seed=2)
    check(ps.verifier_strong_IC(kp.vk, primary, proof),
          "r1cs_ppzksnark: the proof was rejected")
    print(f"r1cs_ppzksnark on {device.type}: OK")


def main(argv=None) -> int:
    device, _ = split_device(argv)
    dev = cuda_lib.resolve_device(device)
    example_protoboard_usage()
    example_nand_gadget()
    example_integration_to_snark(dev)
    print("tutorial complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
