"""Set commitment gadget (reference gadgetlib1/gadgets/set_commitment/).

Checks that element_bits is a member of the committed set: hash the
element to a leaf digest, then authenticate the leaf under the
commitment root via a Merkle check-read over the membership proof.
"""
from __future__ import annotations

from .protoboard import Gadget, PBVariable, PBVariableArray
from .hashes.sha256_gadget import (
    DigestVariable, SHA256CompressionGadget, sha256_default_IV_bits)
from .merkle_tree_gadgets import (
    MerkleAuthenticationPathVariable, MerkleTreeCheckReadGadget)
from ..relations.variable import LinearCombination


class SHA256SingleBlockHashGadget(Gadget):
    """digest = compress(IV, pad(input_bits to 512)) -- the host
    accumulator's element hash (set_commitment.tcc HashT::get_hash)."""

    def __init__(self, pb, input_bits, output: DigestVariable,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        assert len(input_bits) <= 512
        iv = [LinearCombination(v) for v in sha256_default_IV_bits()]
        block = list(input_bits) + [LinearCombination(0)] * (512 - len(input_bits))
        self.f = SHA256CompressionGadget(pb, iv, block, output,
                                         self.annot("f"))

    def generate_r1cs_constraints(self):
        self.f.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        self.f.generate_r1cs_witness()


def sha256_element_hash_bits(value_bits: list) -> list:
    """Host oracle for SHA256SingleBlockHashGadget."""
    from .hashes.sha256_host import (sha256_compress, SHA256_H,
                                     bits_to_words, words_to_bits)
    padded = list(value_bits) + [0] * (512 - len(value_bits))
    return words_to_bits(sha256_compress(SHA256_H, bits_to_words(padded)))


class SetCommitmentGadget(Gadget):
    """element in committed set (set_commitment_gadget.hpp:36)."""

    def __init__(self, pb, max_entries: int, element_bits, root_digest,
                 check_successful, annotation_prefix="",
                 element_hash_cls=SHA256SingleBlockHashGadget):
        super().__init__(pb, annotation_prefix)
        self.tree_depth = max(1, (max_entries - 1).bit_length())
        self.element_bits = list(element_bits)
        self.root_digest = root_digest
        self.check_successful = check_successful
        self.element_block = DigestVariable(
            pb, 256, self.annot("element_digest"))
        self.hash_element = element_hash_cls(
            pb, element_bits, self.element_block, self.annot("hash_elt"))
        self.address_bits = PBVariableArray().allocate(
            pb, self.tree_depth, self.annot("address"))
        self.path = MerkleAuthenticationPathVariable(
            pb, self.tree_depth, self.annot("path"))
        self.check_membership = MerkleTreeCheckReadGadget(
            pb, self.tree_depth, self.address_bits, self.element_block,
            root_digest, self.path, check_successful,
            self.annot("check_membership"))

    def generate_r1cs_constraints(self):
        self.hash_element.generate_r1cs_constraints()
        self.path.generate_r1cs_constraints()
        self.check_membership.generate_r1cs_constraints()

    def generate_r1cs_witness(self, membership_proof):
        self.hash_element.generate_r1cs_witness()
        self.address_bits.fill_with_bits_of_int(
            self.pb, membership_proof.address)
        self.path.generate_r1cs_witness(membership_proof.address,
                                        membership_proof.merkle_path)
        self.check_membership.generate_r1cs_witness()

    @staticmethod
    def root_size_in_bits():
        return 256
