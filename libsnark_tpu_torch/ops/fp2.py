"""Batched quadratic-extension field (the port of libsnark_tpu/ops/fp2.py).

Elements have shape (2, N, *batch): coefficient axis leading, then limbs,
then batch. Used for G2 on alt_bn128 (beta = -1), BLS12-377 (beta = -5)
and MNT4 (beta = 17, a twist with an a-coefficient: ``mul_by_const``).
Karatsuba multiplication with its 3 base products stacked into one call.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .fp import FpKernel


class Fp2Kernel:
    """Fp[s]/(s^2 - beta) with small signed integer beta (e.g. -1)."""

    ext_degree = 2

    def __init__(self, fp: FpKernel, non_residue: int):
        self.fp = fp
        self.non_residue = int(non_residue)
        b = self.non_residue % fp.p
        self.beta_is_neg = b > fp.p // 2
        self.beta_small = fp.p - b if self.beta_is_neg else b
        self.N = fp.N
        self.device = fp.device
        self._plain_twin = None
        self.nw = fp.nw
        self.mod = cuda_lib.make_mod(fp.p, fp.N, self.beta_small,
                                     self.beta_is_neg)

    def __hash__(self):
        return hash((self.fp.p, self.beta_small, self.beta_is_neg))

    def __eq__(self, o):
        return (isinstance(o, Fp2Kernel) and o.fp == self.fp
                and o.beta_small == self.beta_small
                and o.beta_is_neg == self.beta_is_neg)

    def as_plain(self) -> "Fp2Kernel":
        if self.fp.plain:
            return self
        if self._plain_twin is None:
            self._plain_twin = Fp2Kernel(self.fp.as_plain(), self.non_residue)
        return self._plain_twin

    # -- structure ---------------------------------------------------------
    def zeros(self, batch_shape, device=None):
        return torch.stack([self.fp.zeros(batch_shape, device)] * 2)

    def one(self, batch_shape, device=None):
        return torch.stack([self.fp.one(batch_shape, device),
                            self.fp.zeros(batch_shape, device)])

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
        return a.movedim(0, 1)        # (N, 2, *batch)

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
        fp = self.fp
        a, b = torch.broadcast_tensors(a, b)
        sums = fp.add(fp.stack([a[0], b[0]]), fp.stack([a[1], b[1]]))
        sa, sb = fp.unstack(sums)
        prod = fp.mul(fp.stack([a[0], a[1], sa]),
                      fp.stack([b[0], b[1], sb]))
        v0, v1, t = fp.unstack(prod)
        c0 = fp.add(v0, self.mul_by_nonresidue(v1))
        c1 = fp.sub(t, fp.add(v0, v1))
        return torch.stack([c0, c1])

    def sqr(self, a):
        return self.mul(a, a)

    @staticmethod
    def stack(xs):
        return torch.stack(xs, dim=2)

    @staticmethod
    def unstack(a):
        return [a[:, :, i] for i in range(a.shape[2])]

    def mul_small(self, a, k: int):
        return torch.stack([self.fp.mul_small(a[0], k),
                            self.fp.mul_small(a[1], k)])

    def mul_by_const(self, a, k0: int, k1: int):
        """a * (k0 + k1 s) for python-int constants (the a-coefficient of
        MNT4's twist): (k0 a0 + beta k1 a1, k0 a1 + k1 a0)."""
        fp = self.fp
        t0 = fp.mul_small(a[0], k0) if k0 != 1 else a[0]
        t1 = fp.mul_small(a[1], k0) if k0 != 1 else a[1]
        if k1 == 0:
            return torch.stack([t0, t1])
        c0 = fp.add(t0, self.mul_by_nonresidue(fp.mul_small(a[1], k1)))
        c1 = fp.add(t1, fp.mul_small(a[0], k1))
        return torch.stack([c0, c1])

    def inv(self, a):
        # (a0 - a1 s) / (a0^2 - beta a1^2)
        fp = self.fp
        norm = fp.sub(fp.sqr(a[0]), self.mul_by_nonresidue(fp.sqr(a[1])))
        t = fp.inv(norm)
        return torch.stack([fp.mul(a[0], t), fp.neg(fp.mul(a[1], t))])

    def conjugate(self, a):
        return torch.stack([a[0], self.fp.neg(a[1])])

    # -- predicates / select -------------------------------------------------------
    def is_zero(self, a):
        return torch.logical_and(self.fp.is_zero(a[0]), self.fp.is_zero(a[1]))

    def eq(self, a, b):
        return torch.logical_and(self.fp.eq(a[0], b[0]), self.fp.eq(a[1], b[1]))

    def select(self, cond, a, b):
        return torch.where(cond.unsqueeze(0).unsqueeze(0), a, b)

    # -- host conversions -------------------------------------------------------------
    def encode(self, xs, mont=True, device=None):
        """List of host Fp2 elements (with .c0/.c1) -> (2, N, len) tensor."""
        c0 = self.fp.encode([int(x.c0) for x in xs], mont, device)
        c1 = self.fp.encode([int(x.c1) for x in xs], mont, device)
        return torch.stack([c0, c1])

    def decode(self, arr, mont=True):
        return self.fp.decode(arr[0], mont), self.fp.decode(arr[1], mont)
