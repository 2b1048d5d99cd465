"""Batched cubic-extension field (the port of libsnark_tpu/ops/fp3.py).

Elements have shape (3, N, *batch): coefficient axis leading, then limbs,
then batch. Used for G2 on MNT6 (beta = 5) and edwards (beta = 61), the
quadratic twists over Fq3 (curves/mnt.py, curves/edwards.py). Karatsuba
multiplication with its 6 base products stacked into one call; the
products go through ``FpKernel.mul`` (the mont_mul kernel on the card).
"""
from __future__ import annotations

import torch

from .fp import FpKernel


class Fp3Kernel:
    """Fp[v]/(v^3 - beta) with small integer beta (e.g. 5)."""

    ext_degree = 3

    def __init__(self, fp: FpKernel, non_residue: int):
        self.fp = fp
        self.non_residue = int(non_residue)
        b = self.non_residue % fp.p
        self.beta_is_neg = b > fp.p // 2
        self.beta_small = fp.p - b if self.beta_is_neg else b
        self.N = fp.N
        self.device = fp.device
        self.nw = fp.nw
        self._plain_twin = None

    def __hash__(self):
        return hash((self.fp.p, self.beta_small, self.beta_is_neg, 3))

    def __eq__(self, o):
        return (isinstance(o, Fp3Kernel) and o.fp == self.fp
                and o.beta_small == self.beta_small
                and o.beta_is_neg == self.beta_is_neg)

    def as_plain(self) -> "Fp3Kernel":
        if self.fp.plain:
            return self
        if self._plain_twin is None:
            self._plain_twin = Fp3Kernel(self.fp.as_plain(), self.non_residue)
        return self._plain_twin

    # -- structure ---------------------------------------------------------
    def zeros(self, batch_shape, device=None):
        return torch.stack([self.fp.zeros(batch_shape, device)] * 3)

    def one(self, batch_shape, device=None):
        z = self.fp.zeros(batch_shape, device)
        return torch.stack([self.fp.one(batch_shape, device), z, z.clone()])

    def mul_by_nonresidue(self, a):
        """a * beta in the base field via an addition chain on |beta|."""
        fp = self.fp
        if self.beta_small <= 8:
            out = a
            for bit in bin(self.beta_small)[3:]:
                out = fp.double(out)
                if bit == "1":
                    out = fp.add(out, a)
        else:
            out = fp.mul_small(a, self.beta_small)
        return fp.neg(out) if self.beta_is_neg else out

    # -- arithmetic -----------------------------------------------------------
    def _flat(self, a):
        return a.movedim(0, 1)        # (N, 3, *batch)

    def _unflat(self, a):
        return a.movedim(1, 0)

    def add(self, a, b):
        return self._unflat(self.fp.add(self._flat(a), self._flat(b)))

    def sub(self, a, b):
        return self._unflat(self.fp.sub(self._flat(a), self._flat(b)))

    def neg(self, a):
        return self._unflat(self.fp.neg(self._flat(a)))

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Karatsuba (6 base products, libff Fp3_model::operator*), the six
        products stacked into one call, and the additions of the three
        coefficients stacked likewise."""
        fp = self.fp
        a, b = torch.broadcast_tensors(a, b)
        sums = fp.add(fp.stack([a[1], a[0], a[0], b[1], b[0], b[0]]),
                      fp.stack([a[2], a[1], a[2], b[2], b[1], b[2]]))
        s12, s01, s02, u12, u01, u02 = fp.unstack(sums)
        prod = fp.mul(fp.stack([a[0], a[1], a[2], s12, s01, s02]),
                      fp.stack([b[0], b[1], b[2], u12, u01, u02]))
        v0, v1, v2, t12, t01, t02 = fp.unstack(prod)
        # c0 = v0 + beta (t12 - v1 - v2), c1 = (t01 - v0 - v1) + beta v2,
        # c2 = (t02 - v0 - v2) + v1
        d = fp.sub(fp.sub(fp.stack([t12, t01, t02]), fp.stack([v1, v0, v0])),
                   fp.stack([v2, v1, v2]))
        d12, d01, d02 = fp.unstack(d)
        n12, n2 = fp.unstack(self.mul_by_nonresidue(fp.stack([d12, v2])))
        c = fp.add(fp.stack([v0, d01, d02]), fp.stack([n12, n2, v1]))
        return torch.stack(fp.unstack(c))

    def sqr(self, a):
        return self.mul(a, a)

    @staticmethod
    def stack(xs):
        return torch.stack(xs, dim=2)

    @staticmethod
    def unstack(a):
        return [a[:, :, i] for i in range(a.shape[2])]

    def mul_small(self, a, k: int):
        return torch.stack([self.fp.mul_small(a[i], k) for i in range(3)])

    def mul_by_const(self, a, k0: int, k1: int, k2: int):
        """a * (k0 + k1 v + k2 v^2) for python-int constants (the
        a-coefficient a v^2 of the MNT6 and edwards twists): schoolbook
        with v^3 = beta; terms with a zero constant are left out."""
        fp = self.fp
        nr = fp.p - self.beta_small if self.beta_is_neg else self.beta_small

        def coeff(*terms):
            out = None
            for x, k in terms:
                if k % fp.p:
                    t = fp.mul_small(x, k % fp.p)
                    out = t if out is None else fp.add(out, t)
            return torch.zeros_like(a[0]) if out is None else out

        c0 = coeff((a[0], k0), (a[2], nr * k1), (a[1], nr * k2))
        c1 = coeff((a[1], k0), (a[0], k1), (a[2], nr * k2))
        c2 = coeff((a[2], k0), (a[1], k1), (a[0], k2))
        return torch.stack([c0, c1, c2])

    def inv(self, a):
        """libff Fp3_model::inverse (CH81): one base-field inversion."""
        fp = self.fp
        t0 = fp.sqr(a[0])
        t1 = fp.sqr(a[1])
        t2 = fp.sqr(a[2])
        t3 = fp.mul(a[0], a[1])
        t4 = fp.mul(a[0], a[2])
        t5 = fp.mul(a[1], a[2])
        c0 = fp.sub(t0, self.mul_by_nonresidue(t5))
        c1 = fp.sub(self.mul_by_nonresidue(t2), t3)
        c2 = fp.sub(t1, t4)
        t6 = fp.inv(fp.add(fp.mul(a[0], c0), self.mul_by_nonresidue(
            fp.add(fp.mul(a[2], c1), fp.mul(a[1], c2)))))
        return torch.stack([fp.mul(t6, c0), fp.mul(t6, c1), fp.mul(t6, c2)])

    # -- predicates / select -------------------------------------------------------
    def is_zero(self, a):
        return (self.fp.is_zero(a[0]) & self.fp.is_zero(a[1])
                & self.fp.is_zero(a[2]))

    def eq(self, a, b):
        return (self.fp.eq(a[0], b[0]) & self.fp.eq(a[1], b[1])
                & self.fp.eq(a[2], b[2]))

    def select(self, cond, a, b):
        return torch.where(cond.unsqueeze(0).unsqueeze(0), a, b)

    # -- host conversions -------------------------------------------------------------
    def encode(self, xs, mont=True, device=None):
        """List of host Fp3 elements (with .c0/.c1/.c2) -> (3, N, len)
        tensor."""
        return torch.stack([self.fp.encode([int(getattr(x, c)) for x in xs],
                                           mont, device)
                            for c in ("c0", "c1", "c2")])

    def decode(self, arr, mont=True):
        return tuple(self.fp.decode(arr[i], mont) for i in range(3))
