"""FOORAM CPU checker gadget (reference gadgetlib1/gadgets/
cpu_checkers/fooram/ -- the toy checker exercising the universal-machine
plumbing). One step: acc' = (acc + mem[pc]) mod 2^w ; pc' = acc'."""
from __future__ import annotations

from .protoboard import Gadget, PBVariable, PBVariableArray
from .basic import PackingGadget, pb_packing_sum
from ..relations.variable import LinearCombination


class FooRAMCPUChecker(Gadget):
    def __init__(self, pb, w: int, acc_before, pc_before, mem_value,
                 acc_after, pc_after, annotation_prefix="fooram"):
        super().__init__(pb, annotation_prefix)
        self.w = w
        self.acc_before, self.pc_before = acc_before, pc_before
        self.mem_value = mem_value
        self.acc_after, self.pc_after = acc_after, pc_after
        self.sum_bits = PBVariableArray().allocate(
            pb, w + 1, self.annot("sum_bits"))
        self.unpack = PackingGadget(
            pb, self.sum_bits,
            LinearCombination(acc_before) + mem_value,
            self.annot("unpack"))

    def generate_r1cs_constraints(self):
        self.unpack.generate_r1cs_constraints(True)
        low = pb_packing_sum(self.sum_bits[: self.w])
        self.pb.add_r1cs_constraint(1, low, self.acc_after,
                                    self.annot("acc"))
        self.pb.add_r1cs_constraint(
            1, LinearCombination(self.acc_after), self.pc_after,
            self.annot("pc"))

    def generate_r1cs_witness(self):
        pb, w = self.pb, self.w
        s = pb.val(self.acc_before) + pb.val(self.mem_value)
        self.unpack.generate_r1cs_witness_from_packed()
        pb.setval(self.acc_after, s & ((1 << w) - 1))
        pb.setval(self.pc_after, s & ((1 << w) - 1))
