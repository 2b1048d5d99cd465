"""Knapsack (subset-sum) CRH gadgets (reference gadgetlib1/gadgets/
hashes/knapsack/knapsack_gadget.{hpp,tcc}).

H(x) = M * x over the field, where x is the input bit vector and M is a
d x |x| matrix of pseudorandom field coefficients derived from a fixed
seed (the reference samples them with a SHA512-based PRG; here a
SHA256-based expander -- same security rationale, different constant
stream). Field-out: d linear constraints. Bit-out: field-out + unpack
each output to field-size bits.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

from ..protoboard import Gadget, PBVariable, PBVariableArray
from ..basic import PackingGadget, pb_sum
from ...relations.variable import LinearCombination

knapsack_dimension = 1   # reference knapsack_gadget.hpp: dimension = 1


_coeff_cache: Dict[tuple, List[int]] = {}


def knapsack_coefficients(p: int, n: int, dimension: int = 1) -> List[int]:
    """Deterministic pseudorandom coefficients (row-major, d*n)."""
    key = (p, n, dimension)
    if key not in _coeff_cache:
        out = []
        nbytes = (p.bit_length() + 7) // 8 + 16
        for i in range(dimension * n):
            buf = b""
            ctr = 0
            while len(buf) < nbytes:
                buf += hashlib.sha256(
                    b"libsnark_tpu.knapsack" + i.to_bytes(8, "big")
                    + ctr.to_bytes(4, "big")).digest()
                ctr += 1
            out.append(int.from_bytes(buf[:nbytes], "big") % p)
        _coeff_cache[key] = out
    return _coeff_cache[key]


def knapsack_crh_field_eval(p: int, bits: list, dimension: int = 1) -> list:
    coeffs = knapsack_coefficients(p, len(bits), dimension)
    n = len(bits)
    return [sum(coeffs[j * n + i] for i, b in enumerate(bits) if b) % p
            for j in range(dimension)]


class KnapsackCRHFieldOutGadget(Gadget):
    """outputs[j] = <M_j, input_bits> (knapsack_gadget.tcc field-out)."""

    def __init__(self, pb, input_bits, outputs, dimension: int = 1,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.input_bits = list(input_bits)
        self.outputs = list(outputs)
        self.dimension = dimension
        assert len(self.outputs) == dimension
        self.coeffs = knapsack_coefficients(pb.p, len(self.input_bits),
                                            dimension)

    def _row_lc(self, j):
        n = len(self.input_bits)
        lc = LinearCombination()
        for i, b in enumerate(self.input_bits):
            lc = lc + LinearCombination._coerce(b) * self.coeffs[j * n + i]
        return lc

    def generate_r1cs_constraints(self):
        for j in range(self.dimension):
            self.pb.add_r1cs_constraint(1, self._row_lc(j), self.outputs[j],
                                        self.annot(f"row_{j}"))

    def generate_r1cs_witness(self):
        for j in range(self.dimension):
            self.pb.setval(self.outputs[j],
                           self.pb.lc_val(self._row_lc(j)))


class KnapsackCRHBitOutGadget(Gadget):
    """Field-out + unpack each output to |p|-1... full field bits
    (knapsack_gadget.tcc bit-out: digest = dimension * field bits)."""

    def __init__(self, pb, input_bits, output_bits, dimension: int = 1,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.field_bits = pb.p.bit_length()
        assert len(output_bits) == dimension * self.field_bits
        self.output_bits = list(output_bits)
        self.outputs = PBVariableArray().allocate(
            pb, dimension, self.annot("field_out"))
        self.field_gadget = KnapsackCRHFieldOutGadget(
            pb, input_bits, self.outputs, dimension, self.annot("crh"))
        # output_bits are MSB-first per field element (digest convention)
        self.unpackers = []
        for j in range(dimension):
            chunk = list(reversed(
                self.output_bits[j * self.field_bits:
                                 (j + 1) * self.field_bits]))
            self.unpackers.append(PackingGadget(
                pb, chunk, self.outputs[j], self.annot(f"unpack_{j}")))

    def generate_r1cs_constraints(self, enforce_bitness: bool = True):
        self.field_gadget.generate_r1cs_constraints()
        for g in self.unpackers:
            g.generate_r1cs_constraints(enforce_bitness)

    def generate_r1cs_witness(self):
        self.field_gadget.generate_r1cs_witness()
        for g in self.unpackers:
            g.generate_r1cs_witness_from_packed()

    @staticmethod
    def get_digest_len(p: int, dimension: int = 1):
        return dimension * p.bit_length()


def knapsack_crh_bit_eval(p: int, bits: list, dimension: int = 1) -> list:
    """Host oracle matching KnapsackCRHBitOutGadget output convention."""
    field_bits = p.bit_length()
    vals = knapsack_crh_field_eval(p, bits, dimension)
    out = []
    for v in vals:
        out.extend((v >> (field_bits - 1 - i)) & 1
                   for i in range(field_bits))
    return out


class KnapsackTwoToOneHashGadget(Gadget):
    """Two-to-one CRH over digest bit variables with the SHA-gadget call
    signature, so it drops into the Merkle check-read/update gadgets as
    `hash_gadget_cls` (the reference's HashT template role;
    knapsack_gadget.hpp's two_to_one usage in merkle tests). Digest size
    is dimension * |p| bits.
    """

    def __init__(self, pb, left, right, output, annotation_prefix="",
                 dimension: int = knapsack_dimension):
        super().__init__(pb, annotation_prefix)
        self.inner = KnapsackCRHBitOutGadget(
            pb, list(left.bits) + list(right.bits), list(output.bits),
            dimension, self.annot("knap"))

    def generate_r1cs_constraints(self, ensure_output_bitness: bool = True):
        self.inner.generate_r1cs_constraints(ensure_output_bitness)

    def generate_r1cs_witness(self):
        self.inner.generate_r1cs_witness()

    @staticmethod
    def hash_fn(p: int, dimension: int = knapsack_dimension):
        """Host two-to-one callable for common.merkle_tree.MerkleTree."""
        def h(l, r):
            return knapsack_crh_bit_eval(p, list(l) + list(r), dimension)
        return h
