"""Integer permutations (reference common/routing_algorithms/integer_permutation.hpp:22)."""
from __future__ import annotations

import random


class IntegerPermutation:
    """Permutation of the contiguous range [min_element, max_element]."""

    def __init__(self, size_or_contents, min_element: int = 0):
        if isinstance(size_or_contents, int):
            self.min_element = min_element
            self.contents = list(range(min_element,
                                       min_element + size_or_contents))
        else:
            self.min_element = min_element
            self.contents = list(size_or_contents)

    @property
    def size(self):
        return len(self.contents)

    def get(self, pos: int) -> int:
        return self.contents[pos - self.min_element]

    def set(self, pos: int, value: int):
        self.contents[pos - self.min_element] = value

    def __getitem__(self, pos):
        return self.get(pos)

    def is_valid(self) -> bool:
        lo = self.min_element
        hi = lo + self.size - 1
        seen = set()
        for v in self.contents:
            if v < lo or v > hi or v in seen:
                return False
            seen.add(v)
        return True

    def inverse(self) -> "IntegerPermutation":
        out = [0] * self.size
        for i, v in enumerate(self.contents):
            out[v - self.min_element] = i + self.min_element
        return IntegerPermutation(out, self.min_element)

    def slice(self, lo: int, hi: int) -> "IntegerPermutation":
        return IntegerPermutation(
            self.contents[lo - self.min_element: hi - self.min_element + 1], lo)

    def next_permutation(self) -> bool:
        """Lexicographic next (libsnark parity helper)."""
        c = self.contents
        i = len(c) - 2
        while i >= 0 and c[i] >= c[i + 1]:
            i -= 1
        if i < 0:
            return False
        j = len(c) - 1
        while c[j] <= c[i]:
            j -= 1
        c[i], c[j] = c[j], c[i]
        c[i + 1:] = reversed(c[i + 1:])
        return True

    def random_shuffle(self, rng=None):
        (rng or random).shuffle(self.contents)

    def __eq__(self, o):
        return (self.min_element == o.min_element
                and self.contents == o.contents)

    def __repr__(self):
        return f"IntegerPermutation({self.contents}, min={self.min_element})"
