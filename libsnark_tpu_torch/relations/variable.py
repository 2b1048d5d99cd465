"""Formal variables and linear combinations (reference relations/variable.hpp).

Host-side circuit-authoring objects with operator arithmetic, matching the
reference semantics: variable index 0 is the constant ``1``; a full
assignment vector is ``[1, primary..., auxiliary...]``
(variable.hpp:47,96,159; evaluate :181). Coefficients are python ints
(reduced modulo the scalar field when a constraint system is compiled for
the device).
"""
from __future__ import annotations

import operator


class Variable:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __add__(self, o):
        return LinearCombination(self) + o

    __radd__ = __add__

    def __sub__(self, o):
        return LinearCombination(self) - o

    def __rsub__(self, o):
        return -(LinearCombination(self) - o)

    def __mul__(self, k):
        return LinearCombination(self) * k

    __rmul__ = __mul__

    def __neg__(self):
        return LinearCombination(self) * -1

    def __repr__(self):
        return f"x_{self.index}"


ONE = Variable(0)


class LinearTerm:
    __slots__ = ("index", "coeff")

    def __init__(self, index: int, coeff: int = 1):
        self.index = index
        self.coeff = coeff

    def __repr__(self):
        return f"{self.coeff}*x_{self.index}"


_INDEX = operator.attrgetter("index")
_COEFF = operator.attrgetter("coeff")


def compact_terms(terms, p: int):
    """(indices, coefficients) of the terms with duplicate indices merged,
    in index order, coefficients reduced mod p, zeros dropped. Each sum is
    reduced once, at its end: the same value as a reduction a term."""
    acc = {}
    get = acc.get
    for t in terms:
        i = t.index
        acc[i] = get(i, 0) + t.coeff
    idx, coeffs = [], []
    for i in sorted(acc):
        c = acc[i] % p
        if c:
            idx.append(i)
            coeffs.append(c)
    return idx, coeffs


class LinearCombination:
    """Sum of linear terms; supports +, -, scalar *."""

    __slots__ = ("terms",)

    def __init__(self, init=None):
        if init is None:
            self.terms = []
        elif isinstance(init, LinearCombination):
            self.terms = list(init.terms)
        elif isinstance(init, Variable):
            self.terms = [LinearTerm(init.index, 1)]
        elif isinstance(init, LinearTerm):
            self.terms = [init]
        elif isinstance(init, int):
            self.terms = [LinearTerm(0, init)] if init else []
        else:
            raise TypeError(f"cannot build LC from {type(init)}")

    @staticmethod
    def _coerce(o):
        if isinstance(o, LinearCombination):
            return o
        return LinearCombination(o)

    def __add__(self, o):
        o = self._coerce(o)
        out = LinearCombination()
        out.terms = self.terms + o.terms
        return out

    __radd__ = __add__

    def __sub__(self, o):
        return self + (self._coerce(o) * -1)

    def __rsub__(self, o):
        return self._coerce(o) - self

    def __neg__(self):
        return self * -1

    def __mul__(self, k: int):
        if not isinstance(k, int):
            raise TypeError("LC can only be scaled by ints")
        out = LinearCombination()
        out.terms = [LinearTerm(t.index, t.coeff * k) for t in self.terms]
        return out

    __rmul__ = __mul__

    def compact(self, p: int):
        """Merge duplicate indices and reduce coefficients mod p."""
        out = LinearCombination()
        out.terms = list(map(LinearTerm, *compact_terms(self.terms, p)))
        return out

    def evaluate(self, assignment, p: int) -> int:
        """assignment: full vector [1, primary, aux] of ints."""
        return sum(map(operator.mul, map(_COEFF, self.terms),
                       map(assignment.__getitem__,
                           map(_INDEX, self.terms)))) % p

    def is_valid(self, num_vars: int) -> bool:
        return all(0 <= t.index <= num_vars for t in self.terms)

    def __repr__(self):
        return " + ".join(map(repr, self.terms)) or "0"
