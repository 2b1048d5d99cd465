"""The plain versions' integer forms: one lane of a coordinate field on
Python integers.

On the CPU, up to ``INT_LANES`` lanes, the plain group law (``cuda_ec``'s
dbl / add / madd, and so dbl_chain's and the fixed-base scan's plain
versions), the plain Horner combine (``cuda_bucket``) and the generic-a
window loop (``msm``) run their formulas lane by lane on
``IntLaneField``: the limbs are read into integers once, every field
operation is a Python integer operation (a canonical result, so the
formulas give the torch forms' values and limbs), and the results are
packed once. The torch forms' one call a field operation of one lane
would otherwise take most of a small CPU prove. ``on_lanes`` runs a
formula so over the lanes of its tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .limbs import LIMB_BITS, LIMB_MASK, ints_to_limbs, limbs_to_ints


def _ext(fk) -> int:
    return getattr(fk, "ext_degree", 1)


class LaneBool:
    """One lane's flag in the formulas (``&``, ``|``, ``~``, ``any``, a
    scalar's ``shape`` and ``device``): the masks of the torch forms."""

    __slots__ = ("v",)
    shape = ()
    device = None

    def __init__(self, v):
        self.v = bool(v)

    def __and__(self, o):
        return LaneBool(self.v and bool(o))

    def __or__(self, o):
        return LaneBool(self.v or bool(o))

    def __invert__(self):
        return LaneBool(not self.v)

    def __bool__(self):
        return self.v

    def any(self):
        return self.v


class IntLaneField:
    """One lane of a coordinate field (Fp, Fp2 or Fp3) on Python integers
    in Montgomery form: an int, or a tuple of the coefficients over an
    extension; a stack is a list. The operations ``dbl_formula``,
    ``dbl_generic_formula`` and ``add_formula`` call, each result
    canonical, so the formulas give the values -- and so the limbs -- of
    their torch forms over the field kernel. ``mul_const(a, ks)``: a times
    the constant with plain coefficients ks (a curve's a-coefficient)."""

    def __init__(self, fk):
        self.ext = _ext(fk)
        fp = fk.fp if self.ext > 1 else fk
        self.p = p = fp.p
        R = 1 << (LIMB_BITS * fp.N)
        self.rinv = pow(R, -1, p)
        self.one_m = R % p
        self.beta = fk.non_residue % p if self.ext > 1 else None

    def _prod(self, a, b):
        """The coefficients of a b over the extension, unreduced."""
        if self.ext == 1:
            return a * b
        be = self.beta
        if self.ext == 2:
            a0, a1 = a
            b0, b1 = b
            return (a0 * b0 + be * a1 * b1, a0 * b1 + a1 * b0)
        a0, a1, a2 = a
        b0, b1, b2 = b
        return (a0 * b0 + be * (a1 * b2 + a2 * b1),
                a0 * b1 + a1 * b0 + be * a2 * b2,
                a0 * b2 + a1 * b1 + a2 * b0)

    def mul_const(self, a, ks):
        p = self.p
        if self.ext == 1:
            return a * ks[0] % p
        return tuple(c % p for c in self._prod(a, tuple(ks)))

    def _map(self, f, a, b):
        if isinstance(a, list):
            return [f(x, y) for x, y in zip(a, b)]
        return f(a, b)

    def _mul1(self, a, b):
        p, ri = self.p, self.rinv
        if self.ext == 1:
            return a * b * ri % p
        return tuple(c * ri % p for c in self._prod(a, b))

    def _add1(self, a, b):
        if self.ext == 1:
            return (a + b) % self.p
        return tuple((x + y) % self.p for x, y in zip(a, b))

    def _sub1(self, a, b):
        if self.ext == 1:
            return (a - b) % self.p
        return tuple((x - y) % self.p for x, y in zip(a, b))

    def mul(self, a, b):
        return self._map(self._mul1, a, b)

    def sqr(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return self._map(self._add1, a, b)

    def sub(self, a, b):
        return self._map(self._sub1, a, b)

    def double(self, a):
        return self.add(a, a)

    @staticmethod
    def stack(xs):
        return list(xs)

    @staticmethod
    def unstack(a):
        return a

    def is_zero(self, a):
        return LaneBool(a == 0 if self.ext == 1 else not any(a))

    @staticmethod
    def select(cond, a, b):
        return a if cond else b

    def one(self, shape, device=None):
        return self.one_m if self.ext == 1 else (
            (self.one_m,) + (0,) * (self.ext - 1))

    def zero(self):
        return 0 if self.ext == 1 else (0,) * self.ext


def lane_values(fk, a):
    """(FW, L) limbs -> L lane values of IntLaneField (None if a limb lies
    outside [0, 2^16))."""
    ext = _ext(fk)
    N = fk.N
    a = a.reshape(ext * N, -1).numpy()
    if a.min() < 0 or a.max() > LIMB_MASK:
        return None
    comps = [limbs_to_ints(a[k * N:(k + 1) * N]) for k in range(ext)]
    return comps[0] if ext == 1 else list(zip(*comps))


def lane_limbs(fk, vals) -> torch.Tensor:
    """lane_values' inverse: (FW, L) int32."""
    ext, N = _ext(fk), fk.N
    comps = [vals] if ext == 1 else [[v[k] for v in vals]
                                     for k in range(ext)]
    return torch.from_numpy(np.concatenate(
        [ints_to_limbs(c, N) for c in comps]).view(np.int32))


# Lanes up to which on_lanes runs a formula: past ~128 (G1 at 16 limbs on
# one CPU core; ~256 over Fp2) a formula a lane costs more than the torch
# forms' integer passes a field operation over all lanes
INT_LANES = 128


def on_lanes(fk, fn, fields, masks=()):
    """fn(F, field values, flags) -> a tuple of field values, run on each
    lane of ``fields`` (field tensors of fk: (N, *batch) or (ext, N,
    *batch)) and ``masks`` (bool tensors of the batch shape, or None),
    which broadcast to one batch. Returns the outputs as field tensors of
    that batch, or None for more than INT_LANES lanes or where a limb lies
    outside [0, 2^16) (the caller takes the torch form)."""
    lead = 1 + (_ext(fk) > 1)
    FW = _ext(fk) * fk.N
    batch = torch.broadcast_shapes(*[f.shape[lead:] for f in fields],
                                   *[m.shape for m in masks if m is not None])
    L = math.prod(batch)
    if not 0 < L <= INT_LANES:
        return None
    cols = []
    for f in fields:
        v = lane_values(fk, f.expand(f.shape[:lead] + tuple(batch))
                        .reshape(FW, L))
        if v is None:
            return None
        cols.append(v)
    flags = [None if m is None else
             [LaneBool(b) for b in m.expand(batch).reshape(L).tolist()]
             for m in masks]
    F = IntLaneField(fk)
    outs = None
    for i in range(L):
        res = fn(F, [c[i] for c in cols],
                 [None if f is None else f[i] for f in flags])
        if outs is None:
            outs = [[] for _ in res]
        for o, r in zip(outs, res):
            o.append(r)
    shape = fields[0].shape[:lead] + tuple(batch)
    return tuple(lane_limbs(fk, o).reshape(shape) for o in outs)
