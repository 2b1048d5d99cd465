"""Sparse Merkle tree (reference common/data_structures/merkle_tree.{hpp,tcc}).

Heap-indexed sparse storage with per-level default hashes; any
two-to-one CRH via the `hash_fn(left_bits, right_bits) -> bits` callable
(the reference's HashT template). Path layout matches get_path
(merkle_tree.tcc:202-227): result[layer-1] is the sibling at `layer`,
leaf level = depth.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional


class MerkleTree:
    def __init__(self, depth: int, value_size: int,
                 hash_fn: Callable[[list, list], list],
                 digest_size: int = 256,
                 contents: Optional[Dict[int, list]] = None):
        self.depth = depth
        self.value_size = value_size
        self.digest_size = digest_size
        self.hash_fn = hash_fn
        self.values: Dict[int, list] = {}
        self.hashes: Dict[int, list] = {}
        # defaults[layer] = hash of an all-default subtree whose root sits
        # at `layer` (defaults[depth] = zero leaf digest)
        last = [0] * digest_size
        defaults = [last]
        for _ in range(depth):
            last = hash_fn(last, last)
            defaults.append(last)
        defaults.reverse()
        self.hash_defaults = defaults
        if contents:
            for address, value in sorted(contents.items()):
                self.set_value(address, value)

    def _pad(self, value: list) -> list:
        v = list(value)[: self.digest_size]
        return v + [0] * (self.digest_size - len(v))

    def get_value(self, address: int) -> list:
        v = self.values.get(address, [0] * self.digest_size)
        v = list(v)[: self.value_size]
        return v + [0] * (self.value_size - len(v))

    def set_value(self, address: int, value: list):
        assert 0 <= address < (1 << self.depth)
        idx = address + (1 << self.depth) - 1
        self.values[address] = list(value)
        self.hashes[idx] = self._pad(value)
        for layer in range(self.depth, 0, -1):
            sibling = ((idx + 1) ^ 1) - 1
            l_idx, r_idx = (idx, sibling) if idx < sibling else (sibling, idx)
            l = self.hashes.get(l_idx, self.hash_defaults[layer])
            r = self.hashes.get(r_idx, self.hash_defaults[layer])
            idx = (idx - 1) // 2
            self.hashes[idx] = self.hash_fn(l, r)

    def get_root(self) -> list:
        return self.hashes.get(0, self.hash_defaults[0])

    def get_path(self, address: int) -> List[list]:
        """result[layer-1] = sibling digest at layer (leaf layer = depth)."""
        result = [None] * self.depth
        idx = address + (1 << self.depth) - 1
        for layer in range(self.depth, 0, -1):
            sibling = ((idx + 1) ^ 1) - 1
            if layer == self.depth:
                v = self.values.get(sibling - ((1 << self.depth) - 1))
                result[layer - 1] = (self._pad(v) if v is not None
                                     else [0] * self.digest_size)
            else:
                result[layer - 1] = self.hashes.get(
                    sibling, self.hash_defaults[layer])
            idx = (idx - 1) // 2
        return result
