"""Batched elliptic-curve group ops over limb tensors (the port of
libsnark_tpu/ops/ec.py).

Points are Jacobian triples ``(X, Y, Z)`` of field tensors (infinity is
Z = 0), batched on trailing axes, generic over the coordinate field
(FpKernel for G1, Fp2Kernel or Fp3Kernel for G2). On a = 0 curves dbl /
add / madd / aadd go through the kernels of ops/cuda_ec.py (their plain
versions on CPU tensors); curves with an a-coefficient (``mul_by_a`` set:
MNT4, MNT6, edwards) stay on torch formulas (dbl-2007-bl) over the field
kernel's product, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from . import cuda_ec


class CurveKernel:
    """Batched Jacobian group ops over field kernel ``fk``."""

    def __init__(self, fk, name="G", mul_by_a=None, a_tag="",
                 a_coeffs=None):
        """mul_by_a: multiplies a field tensor by the curve's a (None: a =
        0); a_coeffs: a's plain coefficients over fk (the integer forms of
        the plain versions take them)."""
        self.fk = fk
        self.name = name
        self.mul_by_a = mul_by_a
        self.a_tag = a_tag
        self.a_coeffs = a_coeffs

    def __hash__(self):
        return hash((self.name, self.fk, self.a_tag))

    def __eq__(self, o):
        return (isinstance(o, CurveKernel) and o.name == self.name
                and o.fk == self.fk and o.a_tag == self.a_tag)

    def _batch_shape(self, arr):
        return tuple(arr.shape[len(cuda_ec.lead_of(self.fk)):])

    # -- constructors ---------------------------------------------------------
    def zero(self, batch_shape, device=None):
        one = self.fk.one(batch_shape, device)
        return (one, one.clone(), self.fk.zeros(batch_shape, device))

    def is_zero(self, P):
        return self.fk.is_zero(P[2])

    def select(self, cond, P, Q):
        return tuple(self.fk.select(cond, a, b) for a, b in zip(P, Q))

    def neg(self, P):
        return (P[0], self.fk.neg(P[1]), P[2])

    # -- group law ------------------------------------------------------------
    def _dbl_generic(self, P):
        """dbl-2007-bl with M = 3*XX + a*ZZ^2 (generic a), the independent
        products stacked into one call each, as in the JAX package."""
        return cuda_ec.dbl_generic_formula(self.fk, P, self.mul_by_a)

    def dbl(self, P):
        """Jacobian doubling; uniform over Z = 0."""
        if self.mul_by_a is not None:
            return self._dbl_generic(P)
        return cuda_ec.dbl(self.fk, P)

    def dbl_n(self, P, n: int):
        """n successive doublings: ONE kernel launch on the card."""
        if self.mul_by_a is None:
            return cuda_ec.dbl(self.fk, P, reps=n)
        for _ in range(n):
            P = self._dbl_generic(P)
        return P

    def add(self, P, Q):
        """Complete Jacobian addition (add-2007-bl + selects)."""
        if self.mul_by_a is None:
            return cuda_ec.add(self.fk, P, Q)
        return cuda_ec.add_formula(self.fk, P, Q, self._dbl_generic)

    def madd(self, P, Q_aff, valid=None):
        """Mixed addition with Q affine (x, y, inf_mask); lanes with
        valid=False keep P."""
        if self.mul_by_a is None:
            return cuda_ec.madd(self.fk, P, Q_aff, valid)
        return cuda_ec.madd_formula(self.fk, P, Q_aff, valid,
                                    self._dbl_generic)

    def aadd(self, P_aff, Q_aff):
        """Affine + affine -> Jacobian (mmadd-2007-bl, six products): both
        operands are (x, y, inf) triples, the shape of level 0 of the
        dense MSM's bucket tree."""
        if self.mul_by_a is None:
            return cuda_ec.aadd(self.fk, P_aff, Q_aff)
        return cuda_ec.aadd_formula(self.fk, P_aff, Q_aff, self._dbl_generic)

    def scalar_mul_const(self, P, k: int):
        """P * k for a python-int constant k (test / reference use): double
        and add over k's bits, most significant first (the JAX package's
        scan, whose every step doubles and keeps the sum where the bit is
        set)."""
        if k == 0:
            return self.zero(self._batch_shape(P[0]), P[0].device)
        acc = P
        for i in range(k.bit_length() - 2, -1, -1):
            acc = self.dbl(acc)
            if (k >> i) & 1:
                acc = self.add(acc, P)
        return acc

    # -- conversions -------------------------------------------------------------
    def batch_inv(self, Z):
        """The inverses of every lane of Z (batch on the trailing axes, no
        lane zero) by Montgomery's trick over a product tree: the products
        of lane pairs level by level up to one root, one Fermat inversion
        of the root (``fk.inv``), then each level's inverses from its
        parent's times the sibling. About 3 products a lane in
        2 log2(lanes) ``fk.mul`` calls, against a Fermat inversion's
        ~bits(p) products a lane; the inverses are unique, so the limbs are
        those of ``fk.inv``."""
        fk = self.fk
        lead = cuda_ec.lead_of(fk)
        n = math.prod(self._batch_shape(Z))
        level = Z.reshape(lead + (n,))
        levels = []
        while level.shape[-1] > 1:
            if level.shape[-1] % 2:
                level = torch.cat([level, fk.one((1,), Z.device)], dim=-1)
            levels.append(level)
            level = fk.mul(level[..., 0::2], level[..., 1::2])
        inv = fk.inv(level)
        for lv in reversed(levels):
            # the inverse of each pair's product (its parent, less the
            # parent level's pad lane) times the sibling
            sib = torch.stack([lv[..., 1::2], lv[..., 0::2]], dim=-1)
            par = inv[..., :sib.shape[-2]].unsqueeze(-1).expand(sib.shape)
            inv = fk.mul(par, sib).flatten(-2)
        return inv[..., :n].reshape(Z.shape)

    def to_affine(self, P):
        """Batch-normalize to affine; returns (x, y, is_inf_mask). The Z
        inverses come from one ``batch_inv``; infinity lanes take Z = 1
        there (``zsafe``) and keep their own limbs."""
        fk = self.fk
        X, Y, Z = P
        inf = fk.is_zero(Z)
        zsafe = fk.select(inf, fk.one(self._batch_shape(Z), Z.device), Z)
        zi = self.batch_inv(zsafe)
        zi2 = fk.sqr(zi)
        zi3 = fk.mul(zi2, zi)
        return (fk.mul(X, zi2), fk.mul(Y, zi3), inf)

    # -- host conversions -----------------------------------------------------------
    def encode_points(self, pts, jacobian=True, device=None):
        """Host ECPoints -> Jacobian (X, Y, Z) tensors (Z = 0 for infinity)
        or affine (x, y, inf_mask) when jacobian=False."""
        fk = self.fk
        device = device or fk.device
        F = pts[0].group.F if pts else None
        xs, ys, infs = [], [], []
        for p in pts:
            if p.is_zero():
                xs.append(F.one() if hasattr(F, "one") else 1)
                ys.append(F.one() if hasattr(F, "one") else 1)
                infs.append(True)
            else:
                xs.append(p.x)
                ys.append(p.y)
                infs.append(False)
        if hasattr(fk, "fp"):  # Fp2, Fp3
            X = fk.encode(xs, device=device)
            Y = fk.encode(ys, device=device)
        else:
            X = fk.encode([int(x) for x in xs], device=device)
            Y = fk.encode([int(y) for y in ys], device=device)
        infm = torch.tensor(infs, dtype=torch.bool, device=device)
        if not jacobian:
            return (X, Y, infm)
        one = fk.one((len(pts),), device)
        Z = fk.select(infm, fk.zeros((len(pts),), device), one)
        return (X, Y, Z)

    def decode_affine(self, aff, group):
        """Affine (x, y, inf) tensors -> list of host points (flat)."""
        x, y, inf = aff
        inf = inf.detach().cpu().reshape(-1).tolist()
        if hasattr(self.fk, "fp"):      # extension coordinates (Fp2, Fp3)
            xs = self.fk.decode(x)
            ys = self.fk.decode(y)
            F = group.F
            return [group.zero() if inf[j] else
                    group.point(F(*(c[j] for c in xs)),
                                F(*(c[j] for c in ys)))
                    for j in range(len(inf))]
        xs = self.fk.decode(x)
        ys = self.fk.decode(y)
        return [group.zero() if inf[j] else group.point(xs[j], ys[j])
                for j in range(len(inf))]

    def decode_points(self, P, group):
        """Device Jacobian points -> list of host ECPoints in ``group``."""
        return self.decode_affine(self.to_affine(P), group)
