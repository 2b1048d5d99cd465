"""Basic gadgets (reference gadgetlib1/gadgets/basic_gadgets.{hpp,tcc}).

packing/multipacking, field/bit-vector copy, dual variables,
disjunction/conjunction, comparison, inner product, loose multiplexing --
the same constraint shapes as basic_gadgets.hpp:36-380.
"""
from __future__ import annotations

from typing import List

from .protoboard import (
    Protoboard, Gadget, PBVariable, PBVariableArray, PBLinearCombination)
from ..relations.variable import LinearCombination, Variable, ONE


def generate_boolean_r1cs_constraint(pb: Protoboard, lc, annotation=""):
    """lc * (1 - lc) = 0 (basic_gadgets.tcc:17-27)."""
    lc = LinearCombination._coerce(lc)
    pb.add_r1cs_constraint(lc, 1 - lc, 0, annotation or "booleanity")


def generate_r1cs_equals_const_constraint(pb: Protoboard, lc, c: int,
                                          annotation=""):
    pb.add_r1cs_constraint(1, lc, c, annotation or "constness")


def pb_packing_sum(bits) -> LinearCombination:
    out = LinearCombination()
    for i, b in enumerate(bits):
        out = out + LinearCombination._coerce(b) * (1 << i)
    return out


def pb_sum(lcs) -> LinearCombination:
    out = LinearCombination()
    for x in lcs:
        out = out + LinearCombination._coerce(x)
    return out


def field_capacity(p: int) -> int:
    """Bits that always fit: floor(log2(p)) (libff FieldT::capacity())."""
    return p.bit_length() - 1


class PackingGadget(Gadget):
    """packed = sum bits[i] * 2^i, optional booleanity
    (basic_gadgets.tcc:41-76)."""

    def __init__(self, pb, bits, packed, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.bits = list(bits)
        self.packed = packed

    def generate_r1cs_constraints(self, enforce_bitness: bool = True):
        self.pb.add_r1cs_constraint(
            1, pb_packing_sum(self.bits), self.packed,
            self.annot("packing"))
        if enforce_bitness:
            for i, b in enumerate(self.bits):
                generate_boolean_r1cs_constraint(
                    self.pb, b, self.annot(f"bitness_{i}"))

    def generate_r1cs_witness_from_packed(self):
        v = self.pb.lc_val(self.packed)
        assert v.bit_length() <= len(self.bits), "packed value too wide"
        for i, b in enumerate(self.bits):
            self.pb.setval(b, (v >> i) & 1)

    def generate_r1cs_witness_from_bits(self):
        v = 0
        for i, b in enumerate(self.bits):
            v += self.pb.lc_val(b) << i
        self.pb.setval(self.packed, v % self.pb.p)


class MultipackingGadget(Gadget):
    """Chunked packing (basic_gadgets.tcc:78-127)."""

    def __init__(self, pb, bits, packed_vars, chunk_size,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.bits = list(bits)
        self.packed_vars = list(packed_vars)
        self.chunk_size = chunk_size
        n = len(self.bits)
        self.num_chunks = -(-n // chunk_size)
        assert len(self.packed_vars) == self.num_chunks
        self.packers = [
            PackingGadget(pb, self.bits[i * chunk_size:
                                        min((i + 1) * chunk_size, n)],
                          self.packed_vars[i], self.annot(f"packer_{i}"))
            for i in range(self.num_chunks)]

    def generate_r1cs_constraints(self, enforce_bitness: bool = True):
        for g in self.packers:
            g.generate_r1cs_constraints(enforce_bitness)

    def generate_r1cs_witness_from_packed(self):
        for g in self.packers:
            g.generate_r1cs_witness_from_packed()

    def generate_r1cs_witness_from_bits(self):
        for g in self.packers:
            g.generate_r1cs_witness_from_bits()


def multipacking_num_chunks(p: int, num_bits: int) -> int:
    return -(-num_bits // field_capacity(p))


class FieldVectorCopyGadget(Gadget):
    """target[i] = source[i] when do_copy = 1 (tcc:134-170)."""

    def __init__(self, pb, source, target, do_copy, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        assert len(source) == len(target)
        self.source, self.target, self.do_copy = source, target, do_copy

    def generate_r1cs_constraints(self):
        for i in range(len(self.source)):
            self.pb.add_r1cs_constraint(
                self.do_copy,
                LinearCombination(self.source[i]) - self.target[i], 0,
                self.annot(f"copy_{i}"))

    def generate_r1cs_witness(self):
        if self.pb.lc_val(self.do_copy) != 0:
            for s, t in zip(self.source, self.target):
                self.pb.setval(t, self.pb.val(s))


class BitVectorCopyGadget(Gadget):
    """Packed bit-vector copy (tcc:172-240)."""

    def __init__(self, pb, source_bits, target_bits, do_copy, chunk_size,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        assert len(source_bits) == len(target_bits)
        self.source_bits, self.target_bits = source_bits, target_bits
        self.do_copy = do_copy
        num_chunks = -(-len(source_bits) // chunk_size)
        self.packed_source = PBVariableArray().allocate(
            pb, num_chunks, self.annot("packed_source"))
        self.packed_target = PBVariableArray().allocate(
            pb, num_chunks, self.annot("packed_target"))
        self.pack_source = MultipackingGadget(
            pb, source_bits, self.packed_source, chunk_size,
            self.annot("pack_source"))
        self.pack_target = MultipackingGadget(
            pb, target_bits, self.packed_target, chunk_size,
            self.annot("pack_target"))
        self.copier = FieldVectorCopyGadget(
            pb, self.packed_source, self.packed_target, do_copy,
            self.annot("copier"))

    def generate_r1cs_constraints(self, enforce_source_bitness=False,
                                  enforce_target_bitness=False):
        self.pack_source.generate_r1cs_constraints(enforce_source_bitness)
        self.pack_target.generate_r1cs_constraints(enforce_target_bitness)
        self.copier.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        if self.pb.lc_val(self.do_copy) == 1:
            for s, t in zip(self.source_bits, self.target_bits):
                self.pb.setval(t, self.pb.val(s))
        self.pack_source.generate_r1cs_witness_from_bits()
        self.pack_target.generate_r1cs_witness_from_bits()


class DualVariableGadget(Gadget):
    """A value held both packed and in bits (basic_gadgets.hpp:121-151)."""

    def __init__(self, pb, width: int, annotation_prefix="",
                 packed=None, bits=None):
        super().__init__(pb, annotation_prefix)
        if packed is None:
            packed = PBVariable().allocate(pb, self.annot("packed"))
        if bits is None:
            bits = PBVariableArray().allocate(pb, width, self.annot("bits"))
        self.packed = packed
        self.bits = bits
        self.consistency_check = PackingGadget(
            pb, bits, packed, self.annot("consistency"))

    def generate_r1cs_constraints(self, enforce_bitness: bool = True):
        self.consistency_check.generate_r1cs_constraints(enforce_bitness)

    def generate_r1cs_witness_from_packed(self):
        self.consistency_check.generate_r1cs_witness_from_packed()

    def generate_r1cs_witness_from_bits(self):
        self.consistency_check.generate_r1cs_witness_from_bits()


class DisjunctionGadget(Gadget):
    """output = OR(inputs) (tcc:246-287)."""

    def __init__(self, pb, inputs, output, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.inputs = list(inputs)
        self.output = output
        self.inv = PBVariable().allocate(pb, self.annot("inv"))

    def generate_r1cs_constraints(self):
        s = pb_sum(self.inputs)
        self.pb.add_r1cs_constraint(self.inv, s, self.output,
                                    self.annot("inv*sum=output"))
        self.pb.add_r1cs_constraint(1 - LinearCombination(self.output), s, 0,
                                    self.annot("(1-output)*sum=0"))

    def generate_r1cs_witness(self):
        p = self.pb.p
        s = sum(self.pb.lc_val(x) for x in self.inputs) % p
        if s == 0:
            self.pb.setval(self.inv, 0)
            self.pb.setval(self.output, 0)
        else:
            self.pb.setval(self.inv, pow(s, -1, p))
            self.pb.setval(self.output, 1)


class ConjunctionGadget(Gadget):
    """output = AND(inputs) (tcc:289-349)."""

    def __init__(self, pb, inputs, output, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.inputs = list(inputs)
        self.output = output
        self.inv = PBVariable().allocate(pb, self.annot("inv"))

    def generate_r1cs_constraints(self):
        n = len(self.inputs)
        n_minus_sum = LinearCombination(n) - pb_sum(self.inputs)
        self.pb.add_r1cs_constraint(
            self.inv, n_minus_sum, 1 - LinearCombination(self.output),
            self.annot("inv*(n-sum)=(1-output)"))
        self.pb.add_r1cs_constraint(
            self.output, n_minus_sum, 0, self.annot("output*(n-sum)=0"))

    def generate_r1cs_witness(self):
        p = self.pb.p
        s = (len(self.inputs)
             - sum(self.pb.lc_val(x) for x in self.inputs)) % p
        if s == 0:
            self.pb.setval(self.inv, 0)
            self.pb.setval(self.output, 1)
        else:
            self.pb.setval(self.inv, pow(s, -1, p))
            self.pb.setval(self.output, 0)


class ComparisonGadget(Gadget):
    """less / less_or_eq for n-bit A, B via 2^n + B - A unpacking
    (tcc:351-414)."""

    def __init__(self, pb, n: int, A, B, less, less_or_eq,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.n = n
        self.A, self.B = A, B
        self.less, self.less_or_eq = less, less_or_eq
        self.alpha = PBVariableArray().allocate(pb, n, self.annot("alpha"))
        self.alpha.append(less_or_eq)   # alpha[n] == less_or_eq
        self.alpha_packed = PBVariable().allocate(
            pb, self.annot("alpha_packed"))
        self.not_all_zeros = PBVariable().allocate(
            pb, self.annot("not_all_zeros"))
        self.pack_alpha = PackingGadget(
            pb, self.alpha, self.alpha_packed, self.annot("pack_alpha"))
        self.all_zeros_test = DisjunctionGadget(
            pb, self.alpha[:n], self.not_all_zeros,
            self.annot("all_zeros_test"))

    def generate_r1cs_constraints(self):
        generate_boolean_r1cs_constraint(
            self.pb, self.not_all_zeros, self.annot("not_all_zeros"))
        self.pack_alpha.generate_r1cs_constraints(True)
        self.pb.add_r1cs_constraint(
            1,
            LinearCombination(1 << self.n)
            + LinearCombination._coerce(self.B)
            - LinearCombination._coerce(self.A),
            self.alpha_packed, self.annot("main"))
        self.all_zeros_test.generate_r1cs_constraints()
        self.pb.add_r1cs_constraint(
            self.less_or_eq, self.not_all_zeros, self.less,
            self.annot("less"))

    def generate_r1cs_witness(self):
        p = self.pb.p
        av = self.pb.lc_val(self.A)
        bv = self.pb.lc_val(self.B)
        self.pb.setval(self.alpha_packed, ((1 << self.n) + bv - av) % p)
        self.pack_alpha.generate_r1cs_witness_from_packed()
        self.all_zeros_test.generate_r1cs_witness()
        self.pb.setval(
            self.less,
            self.pb.val(self.less_or_eq) * self.pb.val(self.not_all_zeros))


class InnerProductGadget(Gadget):
    """result = <A, B> via running sums (tcc:416-428)."""

    def __init__(self, pb, A, B, result, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        assert len(A) == len(B)
        self.A, self.B = list(A), list(B)
        self.result = result
        self.S = PBVariableArray().allocate(pb, len(A) - 1, self.annot("S"))

    def generate_r1cs_constraints(self):
        n = len(self.A)
        for i in range(n):
            c = (LinearCombination(self.result) if i == n - 1
                 else LinearCombination(self.S[i]))
            if i > 0:
                c = c - self.S[i - 1]
            self.pb.add_r1cs_constraint(self.A[i], self.B[i], c,
                                        self.annot(f"S_{i}"))

    def generate_r1cs_witness(self):
        p = self.pb.p
        total = 0
        n = len(self.A)
        for i in range(n):
            total = (total
                     + self.pb.lc_val(self.A[i])
                     * self.pb.lc_val(self.B[i])) % p
            self.pb.setval(self.result if i == n - 1 else self.S[i], total)


class LooseMultiplexingGadget(Gadget):
    """result = arr[index] with a success flag; out-of-range yields
    success_flag = 0 (tcc:430-487)."""

    def __init__(self, pb, arr, index, result, success_flag,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.arr = list(arr)
        self.index, self.result, self.success_flag = index, result, success_flag
        self.alpha = PBVariableArray().allocate(
            pb, len(arr), self.annot("alpha"))
        self.compute_result = InnerProductGadget(
            pb, self.alpha, self.arr, result, self.annot("compute_result"))

    def generate_r1cs_constraints(self):
        for i in range(len(self.arr)):
            self.pb.add_r1cs_constraint(
                self.alpha[i], LinearCombination(self.index) - i, 0,
                self.annot(f"alpha_{i}"))
        self.pb.add_r1cs_constraint(
            1, pb_sum(self.alpha), self.success_flag, self.annot("main"))
        generate_boolean_r1cs_constraint(
            self.pb, self.success_flag, self.annot("success_flag"))
        self.compute_result.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        idx = self.pb.val(self.index)
        if idx >= len(self.arr):
            for a in self.alpha:
                self.pb.setval(a, 0)
            self.pb.setval(self.success_flag, 0)
        else:
            for i, a in enumerate(self.alpha):
                self.pb.setval(a, 1 if i == idx else 0)
            self.pb.setval(self.success_flag, 1)
        self.compute_result.generate_r1cs_witness()
