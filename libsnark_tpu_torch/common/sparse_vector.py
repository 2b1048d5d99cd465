"""Sparse and accumulation vectors (reference common/data_structures/
sparse_vector.hpp:33-68, accumulation_vector.hpp:34-72).

Index+value compressed vectors of group elements with the `accumulate`
fold used for verification-key input consistency. Host-side objects (the
verifier path touches a handful of points); the heavy accumulate over a
large chunk can ride the device MSM by passing an MSMKernel.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List


class SparseVector:
    """values[i] sits at logical position indices[i]; rest are zero."""

    def __init__(self, indices: List[int] = None, values: list = None,
                 domain_size: int = 0):
        self.indices = list(indices or [])
        self.values = list(values or [])
        self.domain_size_ = domain_size
        assert len(self.indices) == len(self.values)

    @classmethod
    def from_dense(cls, vals, is_zero=lambda v: v.is_zero()):
        idx, vs = [], []
        for i, v in enumerate(vals):
            if not is_zero(v):
                idx.append(i)
                vs.append(v)
        return cls(idx, vs, len(vals))

    def domain_size(self):
        return self.domain_size_

    def size(self):
        return len(self.indices)

    def empty(self):
        return not self.indices

    def is_valid(self):
        if len(self.indices) != len(self.values):
            return False
        return all(self.indices[i] < self.indices[i + 1]
                   for i in range(len(self.indices) - 1)) and \
            (not self.indices or self.indices[-1] < self.domain_size_)

    def __getitem__(self, idx: int):
        """Value at logical index (zero element must be supplied by caller
        via get(idx, zero))."""
        j = bisect.bisect_left(self.indices, idx)
        if j < len(self.indices) and self.indices[j] == idx:
            return self.values[j]
        return None

    def get(self, idx: int, zero):
        v = self[idx]
        return zero if v is None else v

    def accumulate(self, scalars: list, offset: int):
        """sum over logical positions [offset, offset + len(scalars)) of
        scalar * value (sparse_vector.tcc:208-260). Returns (accumulated
        group element, SparseVector of the remaining suffix)."""
        end = offset + len(scalars)
        lo = bisect.bisect_left(self.indices, offset)
        hi = bisect.bisect_left(self.indices, end)
        acc = None
        for j in range(lo, hi):
            s = scalars[self.indices[j] - offset]
            term = self.values[j] * s
            acc = term if acc is None else acc + term
        rest = SparseVector(self.indices[hi:], self.values[hi:],
                            self.domain_size_)
        return acc, rest

    def __eq__(self, o):
        if not isinstance(o, SparseVector):
            return NotImplemented
        return (self.indices == o.indices and self.values == o.values
                and self.domain_size_ == o.domain_size_)


@dataclasses.dataclass
class AccumulationVector:
    """`first` (already-folded group element) + `rest` (sparse remainder).

    accumulate_chunk folds a window of scalars into `first`
    (accumulation_vector.hpp:68-72) -- the verifier's input-consistency
    step in every proof system.
    """
    first: object
    rest: SparseVector

    @classmethod
    def from_values(cls, first, values: list):
        return cls(first=first,
                   rest=SparseVector(list(range(len(values))), list(values),
                                     len(values)))

    def domain_size(self):
        return self.rest.domain_size()

    def size(self):
        return self.rest.size()

    def is_fully_accumulated(self):
        return self.rest.empty()

    def accumulate_chunk(self, scalars: list, offset: int):
        acc, rest = self.rest.accumulate(scalars, offset)
        first = self.first if acc is None else self.first + acc
        return AccumulationVector(first=first, rest=rest)

    def __eq__(self, o):
        if not isinstance(o, AccumulationVector):
            return NotImplemented
        return self.first == o.first and self.rest == o.rest
