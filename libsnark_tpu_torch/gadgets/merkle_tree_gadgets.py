"""Merkle tree gadgets (reference gadgetlib1/gadgets/merkle_tree/).

merkle_authentication_path_variable, digest_selector
(digest_selector_gadget.tcc:32-65), check-read
(merkle_tree_check_read_gadget.tcc) and check-update
(merkle_tree_check_update_gadget.tcc). Path ordering: path[0] is one
layer below the root; address_bits[0] is the LSB (leaf layer).
"""
from __future__ import annotations

from typing import List

from .protoboard import Gadget, PBVariable, PBVariableArray
from .basic import BitVectorCopyGadget, field_capacity
from .hashes.sha256_gadget import DigestVariable, SHA256TwoToOneHashGadget
from ..relations.variable import LinearCombination


class MerkleAuthenticationPathVariable:
    """Per-level (left, right) digest variables; the witness places the
    path sibling on the side opposite the address bit
    (merkle_authentication_path_variable.tcc:45-57)."""

    def __init__(self, pb, tree_depth: int, annotation="",
                 digest_size: int = 256):
        self.pb = pb
        self.tree_depth = tree_depth
        self.left_digests = [DigestVariable(pb, digest_size,
                                            f"{annotation}_L{i}")
                             for i in range(tree_depth)]
        self.right_digests = [DigestVariable(pb, digest_size,
                                             f"{annotation}_R{i}")
                              for i in range(tree_depth)]

    def generate_r1cs_constraints(self):
        for l, r in zip(self.left_digests, self.right_digests):
            l.generate_r1cs_constraints()
            r.generate_r1cs_constraints()

    def generate_r1cs_witness(self, address: int, path: List[list]):
        assert len(path) == self.tree_depth
        for i in range(self.tree_depth):
            if address & (1 << (self.tree_depth - 1 - i)):
                self.left_digests[i].generate_r1cs_witness(path[i])
            else:
                self.right_digests[i].generate_r1cs_witness(path[i])


class DigestSelectorGadget(Gadget):
    """Propagate `input` into left or right slot by is_right."""

    def __init__(self, pb, input_digest, is_right, left, right,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.input = input_digest
        self.is_right = is_right
        self.left, self.right = left, right

    def generate_r1cs_constraints(self):
        for i in range(len(self.input.bits)):
            self.pb.add_r1cs_constraint(
                self.is_right,
                LinearCombination(self.right.bits[i]) - self.left.bits[i],
                LinearCombination(self.input.bits[i]) - self.left.bits[i],
                self.annot(f"propagate_{i}"))

    def generate_r1cs_witness(self):
        if self.pb.lc_val(self.is_right) == 1:
            for i, b in enumerate(self.input.bits):
                self.pb.setval(self.right.bits[i], self.pb.val(b))
        else:
            for i, b in enumerate(self.input.bits):
                self.pb.setval(self.left.bits[i], self.pb.val(b))


class MerkleTreeCheckReadGadget(Gadget):
    """Assert leaf-at-address authenticates against root
    (merkle_tree_check_read_gadget.tcc; hash = SHA-256 two-to-one)."""

    def __init__(self, pb, tree_depth, address_bits, leaf, root, path,
                 read_successful, annotation_prefix="",
                 hash_gadget_cls=SHA256TwoToOneHashGadget):
        super().__init__(pb, annotation_prefix)
        self.tree_depth = tree_depth
        self.address_bits = list(address_bits)
        self.leaf, self.root, self.path = leaf, root, path
        self.read_successful = read_successful
        assert tree_depth == len(self.address_bits) and tree_depth > 0
        digest_size = leaf.digest_size

        self.internal_output = [
            DigestVariable(pb, digest_size, self.annot(f"internal_{i}"))
            for i in range(tree_depth - 1)]
        self.computed_root = DigestVariable(
            pb, digest_size, self.annot("computed_root"))

        self.hashers = []
        for i in range(tree_depth):
            out = self.computed_root if i == 0 else self.internal_output[i - 1]
            self.hashers.append(hash_gadget_cls(
                pb, path.left_digests[i], path.right_digests[i], out,
                self.annot(f"hasher_{i}")))

        self.propagators = []
        for i in range(tree_depth):
            inp = (self.internal_output[i] if i < tree_depth - 1
                   else leaf)
            self.propagators.append(DigestSelectorGadget(
                pb, inp, self.address_bits[tree_depth - 1 - i],
                path.left_digests[i], path.right_digests[i],
                self.annot(f"selector_{i}")))

        self.check_root = BitVectorCopyGadget(
            pb, self.computed_root.bits, root.bits, read_successful,
            field_capacity(pb.p), self.annot("check_root"))

    def generate_r1cs_constraints(self):
        for h in self.hashers:
            h.generate_r1cs_constraints(False)
        for s in self.propagators:
            s.generate_r1cs_constraints()
        self.check_root.generate_r1cs_constraints(False, False)

    def generate_r1cs_witness(self):
        for i in range(self.tree_depth - 1, -1, -1):
            self.propagators[i].generate_r1cs_witness()
            self.hashers[i].generate_r1cs_witness()
        self.check_root.generate_r1cs_witness()

    @staticmethod
    def root_size_in_bits():
        return 256

    @staticmethod
    def expected_constraints(tree_depth: int) -> int:
        return 0  # informational only in the reference


class MerkleTreeCheckUpdateGadget(Gadget):
    """Assert both: old leaf under old root, and new leaf under new root,
    along the SAME path (merkle_tree_check_update_gadget.tcc)."""

    def __init__(self, pb, tree_depth, address_bits,
                 prev_leaf, prev_root, prev_path,
                 next_leaf, next_root, next_path,
                 update_successful, annotation_prefix="",
                 hash_gadget_cls=SHA256TwoToOneHashGadget):
        super().__init__(pb, annotation_prefix)
        self.read_prev = MerkleTreeCheckReadGadget(
            pb, tree_depth, address_bits, prev_leaf, prev_root, prev_path,
            update_successful, self.annot("read_prev"), hash_gadget_cls)
        self.read_next = MerkleTreeCheckReadGadget(
            pb, tree_depth, address_bits, next_leaf, next_root, next_path,
            update_successful, self.annot("read_next"), hash_gadget_cls)
        self.tree_depth = tree_depth
        self.address_bits = list(address_bits)
        self.prev_path, self.next_path = prev_path, next_path
        self.update_successful = update_successful
        # siblings must agree between the two paths: the untouched side
        # is equal (reference enforces via copy gadgets conditioned on
        # the address bits)
        self.ands = []
        self.same_siblings = []
        for i in range(tree_depth):
            bit = self.address_bits[tree_depth - 1 - i]
            # if bit==1 the sibling is the LEFT slot; else the RIGHT slot
            and_l = _ANDGadget(pb, bit, update_successful, False,
                               self.annot(f"and_L_{i}"))
            and_r = _ANDGadget(pb, bit, update_successful, True,
                               self.annot(f"and_R_{i}"))
            self.ands += [and_l, and_r]
            self.same_siblings.append(BitVectorCopyGadget(
                pb, prev_path.left_digests[i].bits,
                next_path.left_digests[i].bits, and_l.out,
                field_capacity(pb.p), self.annot(f"same_L_{i}")))
            self.same_siblings.append(BitVectorCopyGadget(
                pb, prev_path.right_digests[i].bits,
                next_path.right_digests[i].bits, and_r.out,
                field_capacity(pb.p), self.annot(f"same_R_{i}")))

    def generate_r1cs_constraints(self):
        self.read_prev.generate_r1cs_constraints()
        self.read_next.generate_r1cs_constraints()
        for g in self.ands:
            g.generate_r1cs_constraints()
        for g in self.same_siblings:
            g.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        self.read_prev.generate_r1cs_witness()
        self.read_next.generate_r1cs_witness()
        for g in self.ands:
            g.generate_r1cs_witness()
        for g in self.same_siblings:
            g.generate_r1cs_witness()


class _ANDGadget(Gadget):
    """out = a AND b (or (1-a) AND b when negate_a) for boolean lcs."""

    def __init__(self, pb, a, b, negate_a: bool, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.a = LinearCombination._coerce(a)
        self.b = LinearCombination._coerce(b)
        self.negate_a = negate_a
        self.out = PBVariable().allocate(pb, self.annot("out"))

    def generate_r1cs_constraints(self):
        a = (1 - self.a) if self.negate_a else self.a
        self.pb.add_r1cs_constraint(a, self.b, self.out, self.annot("and"))

    def generate_r1cs_witness(self):
        av = self.pb.lc_val(self.a)
        if self.negate_a:
            av = (1 - av) % self.pb.p
        self.pb.setval(self.out, av * self.pb.lc_val(self.b) % self.pb.p)
