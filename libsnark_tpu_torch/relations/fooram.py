"""FOORAM: the reference's minimal toy RAM for exercising the universal
machine plumbing (relations/ram_computations/rams/fooram/fooram_aux).

One w-bit accumulator; the "instruction" at pc is mem[pc]; each step:
acc <- acc + mem[pc]; pc <- acc mod 2^w. Accepts when acc == 0 after the
final step (structure mirrors the reference's toy semantics: a RAM small
enough that the CPU checker is a couple of gadgets).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class FooRAMParams:
    w: int   # accumulator / address width

    @property
    def address_size(self):
        return self.w

    @property
    def value_size(self):
        return self.w


class FooRAMExecutor:
    def __init__(self, ap: FooRAMParams, boot_memory: Dict[int, int]):
        self.ap = ap
        self.memory = dict(boot_memory)

    def run(self, num_steps: int):
        mask = (1 << self.ap.w) - 1
        acc, pc = 0, 0
        trace = []
        for ts in range(num_steps):
            v = self.memory.get(pc, 0)
            acc = (acc + v) & mask
            pc = acc
            trace.append((ts + 1, pc, acc, v))
        return acc, trace
