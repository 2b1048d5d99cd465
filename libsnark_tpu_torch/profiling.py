"""Hierarchical profiling (the port of libsnark_tpu/profiling.py; libff
enter_block / leave_block equivalent).

A context manager of nested wall-clock timers with op-count counters
(PROFILE_OP_COUNTS analogue) as plain dict increments. CUDA launches are
asynchronous, so a block that times device work names what to wait for:
``sync`` is a tensor or a ``torch.device``, and the block synchronises its
device before it stops the clock (``torch.cuda.synchronize(device)``;
nothing on the CPU).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def synchronize(sync):
    """Wait for the device of ``sync`` (a tensor or a ``torch.device``) if
    it is a CUDA device."""
    dev = sync.device if isinstance(sync, torch.Tensor) else sync
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.depth = 0
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.op_counts = defaultdict(int)
        self._start = time.monotonic()

    def start_profiling(self):
        self._start = time.monotonic()
        self.totals.clear()
        self.counts.clear()

    @contextlib.contextmanager
    def block(self, name: str, sync=None):
        """enter_block/leave_block pair. ``sync``: what to synchronise
        before stopping the clock (a tensor or a device; see module doc)."""
        if not self.enabled:
            yield
            return
        indent = "  " * self.depth
        print(f"{indent}(enter) {name}", flush=True)
        self.depth += 1
        t0 = time.monotonic()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            dt = time.monotonic() - t0
            self.depth -= 1
            self.totals[name] += dt
            self.counts[name] += 1
            print(f"{indent}(leave) {name}  [{dt:.4f}s]", flush=True)

    def count_op(self, name: str, n: int = 1):
        self.op_counts[name] += n

    def print_summary(self):
        print("== profiling summary ==")
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            print(f"  {name}: {t:.4f}s x{self.counts[name]}")
        if self.op_counts:
            print("== op counts ==")
            for name, n in sorted(self.op_counts.items()):
                print(f"  {name}: {n}")


PROFILER = Profiler(enabled=False)


def start_profiling():
    PROFILER.enabled = True
    PROFILER.start_profiling()


def enter_block(name, sync=None):
    return PROFILER.block(name, sync)
