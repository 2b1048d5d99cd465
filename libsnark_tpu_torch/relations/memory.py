"""Memory interfaces (reference relations/ram_computations/memory/).

ra_memory: plain random-access memory (memory_interface.hpp:1-62);
memory_store_trace: address -> value map of a boot/state snapshot;
delegated_ra_memory: Merkle-authenticated memory whose root commits the
full contents (delegated_ra_memory.tcc).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..common.merkle_tree import MerkleTree


class MemoryInterface:
    def __init__(self, num_addresses: int, value_size: int):
        self.num_addresses = num_addresses
        self.value_size = value_size

    def get_value(self, address: int) -> int:
        raise NotImplementedError

    def set_value(self, address: int, value: int):
        raise NotImplementedError


class RAMemory(MemoryInterface):
    """Plain map-backed random access memory."""

    def __init__(self, num_addresses: int, value_size: int,
                 contents: Optional[Dict[int, int]] = None):
        super().__init__(num_addresses, value_size)
        self.contents = dict(contents or {})

    def get_value(self, address: int) -> int:
        assert 0 <= address < self.num_addresses
        return self.contents.get(address, 0)

    def set_value(self, address: int, value: int):
        assert 0 <= address < self.num_addresses
        self.contents[address] = value


class MemoryStoreTrace:
    """Timestamped (address, value) trace entries
    (memory_store_trace in memory_interface.hpp)."""

    def __init__(self):
        self.entries: Dict[int, tuple] = {}

    def get_trace_entry(self, timestamp: int) -> tuple:
        return self.entries.get(timestamp, (0, 0))

    def set_trace_entry(self, timestamp: int, av: tuple):
        self.entries[timestamp] = av

    def as_memory_contents(self) -> Dict[int, int]:
        return {a: v for (a, v) in self.entries.values()}


class DelegatedRAMemory(MemoryInterface):
    """Merkle-hashed memory: every value update refreshes the root
    (delegated_ra_memory.tcc). value bits are the leaf, int-encoded
    LSB-first to `value_size` bits."""

    def __init__(self, num_addresses: int, value_size: int,
                 hash_fn: Callable[[list, list], list],
                 contents: Optional[Dict[int, int]] = None,
                 digest_size: int = 256):
        super().__init__(num_addresses, value_size)
        depth = max(1, (num_addresses - 1).bit_length())
        self.tree = MerkleTree(depth, digest_size, hash_fn, digest_size)
        self.values: Dict[int, int] = {}
        for a, v in (contents or {}).items():
            self.set_value(a, v)

    def _bits(self, v: int) -> list:
        return [(v >> i) & 1 for i in range(self.value_size)]

    def get_value(self, address: int) -> int:
        return self.values.get(address, 0)

    def set_value(self, address: int, value: int):
        self.values[address] = value
        self.tree.set_value(address, self._bits(value))

    def get_root(self) -> list:
        return self.tree.get_root()

    def get_path(self, address: int):
        return self.tree.get_path(address)
