"""Merkle-tree set commitment (reference common/data_structures/
set_commitment.{hpp,tcc}).

Accumulate hashed values into a sparse Merkle tree at sequential
positions; commitment = root, membership proof = (address, path).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from .merkle_tree import MerkleTree


@dataclasses.dataclass
class SetMembershipProof:
    address: int
    merkle_path: List[list]


class SetCommitmentAccumulator:
    def __init__(self, max_entries: int, value_size: int,
                 hash_fn: Callable[[list], list],
                 two_to_one_fn: Callable[[list, list], list],
                 digest_size: int = 256):
        self.depth = max(1, (max_entries - 1).bit_length())
        self.value_size = value_size
        self.digest_size = digest_size
        self.hash_fn = hash_fn
        self.tree = MerkleTree(self.depth, digest_size, two_to_one_fn,
                               digest_size)
        self.hash_to_pos: Dict[tuple, int] = {}

    def add(self, value_bits: list):
        h = tuple(self.hash_fn(value_bits))
        if h not in self.hash_to_pos:
            pos = len(self.hash_to_pos)
            self.tree.set_value(pos, list(h))
            self.hash_to_pos[h] = pos

    def is_in_set(self, value_bits: list) -> bool:
        return tuple(self.hash_fn(value_bits)) in self.hash_to_pos

    def get_commitment(self) -> list:
        return self.tree.get_root()

    def get_membership_proof(self, value_bits: list) -> SetMembershipProof:
        pos = self.hash_to_pos[tuple(self.hash_fn(value_bits))]
        return SetMembershipProof(address=pos,
                                  merkle_path=self.tree.get_path(pos))
