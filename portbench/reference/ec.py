"""Plain-integer curve arithmetic for the benchmark's reference.

Short Weierstrass curves y^2 = x^3 + a x + b over Fq (G1) and over
Fq2 = Fq[u] / (u^2 - beta) (G2), in Jacobian coordinates on Python
integers. Only what the reference needs: scalar multiplication by
double-and-add and the conversion to affine coordinates. Nothing here
imports the program under test; the constants come from
``curves/<name>.json``.
"""
from __future__ import annotations

import json
from pathlib import Path

CURVES = Path(__file__).resolve().parent / "curves"


class Fq:
    """The prime field: elements are ints in [0, q)."""

    def __init__(self, q: int):
        self.q = q
        self.zero, self.one = 0, 1

    def add(self, x, y):
        return (x + y) % self.q

    def sub(self, x, y):
        return (x - y) % self.q

    def mul(self, x, y):
        return x * y % self.q

    def small(self, x, k: int):
        return x * k % self.q

    def inv(self, x):
        return pow(x, -1, self.q)

    def is_zero(self, x) -> bool:
        return x == 0


class Fq2:
    """Fq[u] / (u^2 - beta): elements are pairs (c0, c1) of ints."""

    def __init__(self, q: int, beta: int):
        self.q, self.beta = q, beta % q
        self.zero, self.one = (0, 0), (1, 0)

    def add(self, x, y):
        q = self.q
        return ((x[0] + y[0]) % q, (x[1] + y[1]) % q)

    def sub(self, x, y):
        q = self.q
        return ((x[0] - y[0]) % q, (x[1] - y[1]) % q)

    def mul(self, x, y):
        q = self.q
        return ((x[0] * y[0] + self.beta * x[1] * y[1]) % q,
                (x[0] * y[1] + x[1] * y[0]) % q)

    def small(self, x, k: int):
        return (x[0] * k % self.q, x[1] * k % self.q)

    def inv(self, x):
        q = self.q
        norm = (x[0] * x[0] - self.beta * x[1] * x[1]) % q
        n_inv = pow(norm, -1, q)
        return (x[0] * n_inv % q, -x[1] * n_inv % q)

    def is_zero(self, x) -> bool:
        return x == (0, 0)


class Group:
    """Points of y^2 = x^3 + a x + b over ``field``; affine points are
    (x, y) pairs and None is the point at infinity."""

    def __init__(self, field, a, generator):
        self.F = field
        self.a = a
        self.generator = generator

    def _dbl(self, P):
        F = self.F
        X, Y, Z = P
        if F.is_zero(Z) or F.is_zero(Y):
            return (F.one, F.one, F.zero)
        XX, YY = F.mul(X, X), F.mul(Y, Y)
        YYYY, ZZ = F.mul(YY, YY), F.mul(Z, Z)
        S = F.small(F.sub(F.sub(F.mul(F.add(X, YY), F.add(X, YY)), XX),
                          YYYY), 2)
        M = F.small(XX, 3)
        if not F.is_zero(self.a):
            M = F.add(M, F.mul(self.a, F.mul(ZZ, ZZ)))
        X3 = F.sub(F.mul(M, M), F.small(S, 2))
        Y3 = F.sub(F.mul(M, F.sub(S, X3)), F.small(YYYY, 8))
        Z3 = F.small(F.mul(Y, Z), 2)
        return (X3, Y3, Z3)

    def _add_affine(self, P, Q):
        """Jacobian P plus affine Q."""
        F = self.F
        X1, Y1, Z1 = P
        if F.is_zero(Z1):
            return (Q[0], Q[1], F.one)
        Z1Z1 = F.mul(Z1, Z1)
        U2 = F.mul(Q[0], Z1Z1)
        S2 = F.mul(Q[1], F.mul(Z1, Z1Z1))
        H = F.sub(U2, X1)
        R = F.sub(S2, Y1)
        if F.is_zero(H):
            if F.is_zero(R):
                return self._dbl(P)
            return (F.one, F.one, F.zero)
        HH = F.mul(H, H)
        HHH = F.mul(H, HH)
        V = F.mul(X1, HH)
        X3 = F.sub(F.sub(F.mul(R, R), HHH), F.small(V, 2))
        Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(Y1, HHH))
        Z3 = F.mul(Z1, H)
        return (X3, Y3, Z3)

    def to_affine(self, P):
        F = self.F
        X, Y, Z = P
        if F.is_zero(Z):
            return None
        zi = F.inv(Z)
        zi2 = F.mul(zi, zi)
        return (F.mul(X, zi2), F.mul(Y, F.mul(zi, zi2)))

    def mul(self, k: int, P=None):
        """k P (P: an affine point, the generator by default), affine."""
        P = self.generator if P is None else P
        if P is None or k == 0:
            return None
        F = self.F
        acc = (F.one, F.one, F.zero)
        for bit in bin(k)[2:]:
            acc = self._dbl(acc)
            if bit == "1":
                acc = self._add_affine(acc, P)
        return self.to_affine(acc)

    def on_curve(self, P, b) -> bool:
        F = self.F
        x, y = P
        rhs = F.add(F.add(F.mul(F.mul(x, x), x), F.mul(self.a, x)), b)
        return F.mul(y, y) == rhs


class Curve:
    """A pairing curve's scalar field r and its groups G1 and G2 (G2 over
    Fq2), read from ``curves/<name>.json``."""

    def __init__(self, name: str):
        spec = json.loads((CURVES / f"{name}.json").read_text())
        self.name = name
        self.q = int(spec["q"], 0)
        self.r = int(spec["r"], 0)
        self.b = int(spec["b"])
        self.fr_generator = int(spec["fr_multiplicative_generator"])
        fq = Fq(self.q)
        fq2 = Fq2(self.q, int(spec["fq2_non_residue"]))
        a = int(spec["a"]) % self.q
        g1 = tuple(int(v) for v in spec["g1"])
        g2 = tuple(tuple(int(c) for c in v) for v in spec["g2"])
        self.G1 = Group(fq, a, g1)
        self.G2 = Group(fq2, fq2.small(fq2.one, a), g2)

    def root_of_unity(self, m: int) -> int:
        """The generator of the order-m subgroup of Fr* (m a power of two)
        that libfqfft's radix-2 domain takes: g^((r - 1) / m) for the
        field's multiplicative generator g."""
        if m & (m - 1) or (self.r - 1) % m:
            raise ValueError(f"no radix-2 domain of size {m}")
        return pow(self.fr_generator, (self.r - 1) // m, self.r)
