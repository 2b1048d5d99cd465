"""Field-tower arithmetic gadgets: Fp2 / Fp6 (3 over 2) / Fp12
(reference gadgetlib1/gadgets/fields/{fp2,fp6_3over2,fp12_2over3over2}
_gadgets + exponentiation_gadget).

Elements are tuples of linear combinations over the protoboard field
(which equals the INNER curve's base field in the one-layer recursion
setting, e.g. Fr(BW6-761) = Fq(BLS12-377)). Multiplications allocate
result variables with Karatsuba/Toom constraint shapes; additions,
frobenius maps and non-residue multiplications are free (linear).

Witnessing: every constrained op pushes a closure onto the shared
ordered work queue (Fp2Gadgets._wq); generate_witness() replays it once
the input variables are set -- the functional-composition equivalent of
the reference's per-gadget generate_r1cs_witness() cascade.
"""
from __future__ import annotations

from typing import List, Tuple

from .protoboard import Gadget, Protoboard, PBVariable
from ..relations.variable import LinearCombination


def _lc(x):
    return LinearCombination._coerce(x)


class Fp2Gadgets:
    """Arithmetic over Fp2 = Fp[u]/(u^2 - nr); elements = (c0, c1) LCs."""

    def __init__(self, pb: Protoboard, non_residue: int, prefix="fp2"):
        self.pb = pb
        self.nr = non_residue % pb.p
        self.prefix = prefix
        self._ctr = 0
        self._wq = []        # ordered witness closures

    def _var(self, tag):
        self._ctr += 1
        return PBVariable().allocate(self.pb,
                                     f"{self.prefix}.{tag}{self._ctr}")

    def generate_witness(self):
        """Replay all deferred witness computations in creation order."""
        for fn in self._wq:
            fn()

    # -- free ops ----------------------------------------------------------
    def const(self, e):
        return (_lc(int(e.c0)), _lc(int(e.c1)))

    def zero(self):
        return (_lc(0), _lc(0))

    def one(self):
        return (_lc(1), _lc(0))

    def add(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def sub(self, a, b):
        return (a[0] - b[0], a[1] - b[1])

    def neg(self, a):
        return (-a[0], -a[1])

    def scale_int(self, a, k: int):
        k %= self.pb.p
        return (a[0] * k, a[1] * k)

    def mul_const(self, a, m0: int, m1: int):
        """Multiply by the CONSTANT m0 + m1 u (linear)."""
        p = self.pb.p
        c0 = a[0] * (m0 % p) + a[1] * (m1 * self.nr % p)
        c1 = a[0] * (m1 % p) + a[1] * (m0 % p)
        return (c0, c1)

    def conjugate(self, a):
        return (a[0], -a[1])

    # -- constrained ops -----------------------------------------------------
    def scale_fp(self, a, k_lc):
        """Multiply by an Fp linear operand (2 constraints)."""
        pb = self.pb
        k_lc = _lc(k_lc)
        c0, c1 = self._var("s"), self._var("s")
        pb.add_r1cs_constraint(a[0], k_lc, c0, "fp2_scale0")
        pb.add_r1cs_constraint(a[1], k_lc, c1, "fp2_scale1")

        def wit(a=a, k=k_lc, c0=c0, c1=c1):
            kv = pb.lc_val(k)
            pb.setval(c0, pb.lc_val(a[0]) * kv % pb.p)
            pb.setval(c1, pb.lc_val(a[1]) * kv % pb.p)
        self._wq.append(wit)
        return (_lc(c0), _lc(c1))

    def mul(self, a, b):
        """Karatsuba: 3 constraints (fp2 mul gadget parity)."""
        pb = self.pb
        v0, v1, c1 = self._var("v0"), self._var("v1"), self._var("c1")
        pb.add_r1cs_constraint(a[0], b[0], v0, "fp2_v0")
        pb.add_r1cs_constraint(a[1], b[1], v1, "fp2_v1")
        pb.add_r1cs_constraint(a[0] + a[1], b[0] + b[1],
                               _lc(c1) + v0 + v1, "fp2_c1")

        def wit(a=a, b=b, v0=v0, v1=v1, c1=c1):
            p = pb.p
            a0, a1 = pb.lc_val(a[0]), pb.lc_val(a[1])
            b0, b1 = pb.lc_val(b[0]), pb.lc_val(b[1])
            pb.setval(v0, a0 * b0 % p)
            pb.setval(v1, a1 * b1 % p)
            pb.setval(c1, (a0 * b1 + a1 * b0) % p)
        self._wq.append(wit)
        return (_lc(v0) + _lc(v1) * self.nr, _lc(c1))

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        pb = self.pb
        i0, i1 = self._var("i0"), self._var("i1")

        def wit(a=a, i0=i0, i1=i1):
            p = pb.p
            a0, a1 = pb.lc_val(a[0]), pb.lc_val(a[1])
            d = (a0 * a0 - self.nr * a1 * a1) % p
            dinv = pow(d, -1, p)
            pb.setval(i0, a0 * dinv % p)
            pb.setval(i1, (-a1) * dinv % p)
        self._wq.append(wit)
        inv = (_lc(i0), _lc(i1))
        prod = self.mul(a, inv)
        pb.add_r1cs_constraint(1, prod[0], 1, "fp2_inv0")
        pb.add_r1cs_constraint(1, prod[1], 0, "fp2_inv1")
        return inv

    def assert_eq(self, a, b, ann="fp2_eq"):
        self.pb.add_r1cs_constraint(1, a[0] - b[0], 0, ann + "0")
        self.pb.add_r1cs_constraint(1, a[1] - b[1], 0, ann + "1")

    # -- witness helpers -----------------------------------------------------
    def eval(self, a, F2):
        return F2(self.pb.lc_val(a[0]), self.pb.lc_val(a[1]))

    def alloc_input(self, e=None):
        """Allocate a variable pair (and optionally set it)."""
        v = (self._var("in"), self._var("in"))
        if e is not None:
            self.pb.setval(v[0], int(e.c0))
            self.pb.setval(v[1], int(e.c1))
        return (_lc(v[0]), _lc(v[1])), v


class Fp6Gadgets:
    """Fp6 = Fp2[v]/(v^3 - xi); elements = 3-tuples of Fp2 pairs."""

    def __init__(self, fp2: Fp2Gadgets, xi_host, prefix="fp6"):
        self.fp2 = fp2
        self.xi0 = int(xi_host.c0)
        self.xi1 = int(xi_host.c1)

    def const(self, e):
        f = self.fp2
        return (f.const(e.c0), f.const(e.c1), f.const(e.c2))

    def zero(self):
        z = self.fp2.zero()
        return (z, z, z)

    def one(self):
        return (self.fp2.one(), self.fp2.zero(), self.fp2.zero())

    def add(self, a, b):
        f = self.fp2
        return tuple(f.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        f = self.fp2
        return tuple(f.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        f = self.fp2
        return tuple(f.neg(x) for x in a)

    def mul_by_xi(self, x):
        return self.fp2.mul_const(x, self.xi0, self.xi1)

    def mul_by_v(self, a):
        return (self.mul_by_xi(a[2]), a[0], a[1])

    def mul(self, a, b):
        f = self.fp2
        v0 = f.mul(a[0], b[0])
        v1 = f.mul(a[1], b[1])
        v2 = f.mul(a[2], b[2])
        t1 = f.mul(f.add(a[1], a[2]), f.add(b[1], b[2]))
        t2 = f.mul(f.add(a[0], a[1]), f.add(b[0], b[1]))
        t3 = f.mul(f.add(a[0], a[2]), f.add(b[0], b[2]))
        c0 = f.add(v0, self.mul_by_xi(f.sub(f.sub(t1, v1), v2)))
        c1 = f.add(f.sub(f.sub(t2, v0), v1), self.mul_by_xi(v2))
        c2 = f.add(f.sub(f.sub(t3, v0), v2), v1)
        return (c0, c1, c2)

    def sqr(self, a):
        return self.mul(a, a)


class Fp12Gadgets:
    """Fp12 = Fp6[w]/(w^2 - v); elements = (c0, c1) of Fp6 triples."""

    def __init__(self, fp6: Fp6Gadgets, host_Fq12, prefix="fp12"):
        self.fp6 = fp6
        self.fp2 = fp6.fp2
        self.host = host_Fq12
        self._frob_cache = {}

    def const(self, e):
        return (self.fp6.const(e.c0), self.fp6.const(e.c1))

    def one(self):
        return (self.fp6.one(), self.fp6.zero())

    def add(self, a, b):
        return (self.fp6.add(a[0], b[0]), self.fp6.add(a[1], b[1]))

    def conjugate(self, a):
        """Unitary inverse on the cyclotomic subgroup."""
        return (a[0], self.fp6.neg(a[1]))

    def mul(self, a, b):
        f6 = self.fp6
        v0 = f6.mul(a[0], b[0])
        v1 = f6.mul(a[1], b[1])
        t = f6.mul(f6.add(a[0], a[1]), f6.add(b[0], b[1]))
        c0 = f6.add(v0, f6.mul_by_v(v1))
        c1 = f6.sub(f6.sub(t, v0), v1)
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """Witnessed inverse + product check (12 vars, one mul)."""
        f2 = self.fp2
        vars_ = [[(f2._var("iv"), f2._var("iv")) for _ in range(3)]
                 for _ in range(2)]

        def wit(a=a, vars_=vars_):
            av = self.eval(a)
            iv = av.inverse()
            pb = f2.pb
            for h, half in enumerate((iv.c0, iv.c1)):
                for j, c in enumerate((half.c0, half.c1, half.c2)):
                    pb.setval(vars_[h][j][0], int(c.c0))
                    pb.setval(vars_[h][j][1], int(c.c1))
        f2._wq.append(wit)
        inv = tuple(tuple((_lc(p[0]), _lc(p[1])) for p in half)
                    for half in vars_)
        prod = self.mul(a, inv)
        one = self.one()
        for h in range(2):
            for j in range(3):
                f2.assert_eq(prod[h][j], one[h][j], f"fp12_inv_{h}{j}")
        return inv

    def frobenius(self, a, power: int):
        mults = self._frob_mults(power)
        conj = (power % 2) == 1
        out = []
        for h in range(2):
            row = []
            for j in range(3):
                c = a[h][j]
                base = (c[0], -c[1]) if conj else c
                m = mults[h][j]
                row.append(self.fp2.mul_const(base, int(m.c0), int(m.c1)))
            out.append(tuple(row))
        return tuple(out)

    def _frob_mults(self, power):
        if power in self._frob_cache:
            return self._frob_cache[power]
        F12 = self.host
        F6 = F12.base_field
        F2 = F6.base_field
        mults = []
        for h in range(2):
            row = []
            for j in range(3):
                c2 = [F2.zero()] * 3
                c2[j] = F2.one()
                half = F6(*c2)
                e = F12(half, F6.zero()) if h == 0 else F12(F6.zero(), half)
                img = e.frobenius(power)
                coord_half = img.c0 if h == 0 else img.c1
                row.append((coord_half.c0, coord_half.c1,
                            coord_half.c2)[j])
            mults.append(row)
        self._frob_cache[power] = mults
        return mults

    def cyclotomic_exp(self, a, e: int):
        """a^e by square-and-multiply (a must be in the cyclotomic
        subgroup when e < 0 semantics rely on conjugation)."""
        assert e > 0
        bits = bin(e)[3:]      # skip leading 1
        acc = a
        for b in bits:
            acc = self.sqr(acc)
            if b == "1":
                acc = self.mul(acc, a)
        return acc

    def assert_eq(self, a, b, ann="fp12_eq"):
        for h in range(2):
            for j in range(3):
                self.fp2.assert_eq(a[h][j], b[h][j], f"{ann}_{h}{j}")

    # -- witness helpers -------------------------------------------------------
    def eval(self, a, F12=None):
        F12 = F12 or self.host
        F6 = F12.base_field
        F2 = F6.base_field
        pb = self.fp2.pb
        halves = []
        for h in range(2):
            coords = [F2(pb.lc_val(a[h][j][0]), pb.lc_val(a[h][j][1]))
                      for j in range(3)]
            halves.append(F6(*coords))
        return F12(*halves)


class Fp3Gadgets:
    """Cubic extension Fp[v]/(v^3 - nr); elements = (c0, c1, c2) LCs
    (reference gadgetlib1/gadgets/fields/fp3_gadgets.hpp: mul/sqr/inv
    gadget family for the MNT towers)."""

    def __init__(self, pb: Protoboard, non_residue: int, prefix="fp3"):
        self.pb = pb
        self.nr = non_residue % pb.p
        self.prefix = prefix
        self._ctr = 0
        self._wq = []

    def _var(self, tag):
        self._ctr += 1
        return PBVariable().allocate(self.pb,
                                     f"{self.prefix}.{tag}{self._ctr}")

    def generate_witness(self):
        for fn in self._wq:
            fn()

    # -- free ops ----------------------------------------------------------
    def const(self, e):
        return (_lc(int(e.c0)), _lc(int(e.c1)), _lc(int(e.c2)))

    def zero(self):
        return (_lc(0), _lc(0), _lc(0))

    def one(self):
        return (_lc(1), _lc(0), _lc(0))

    def add(self, a, b):
        return tuple(x + y for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(x - y for x, y in zip(a, b))

    def neg(self, a):
        return tuple(-x for x in a)

    def scale_int(self, a, k: int):
        k %= self.pb.p
        return tuple(x * k for x in a)

    def mul_by_v(self, a):
        """Multiply by v: (nr*c2, c0, c1). Linear."""
        return (a[2] * self.nr, a[0], a[1])

    # -- constrained ops -----------------------------------------------------
    def mul(self, a, b):
        """Karatsuba-3: 6 product constraints."""
        pb, p, nr = self.pb, self.pb.p, self.nr
        v0, v1, v2 = self._var("v0"), self._var("v1"), self._var("v2")
        t1, t2, t3 = self._var("t1"), self._var("t2"), self._var("t3")
        pb.add_r1cs_constraint(a[0], b[0], v0, "fp3_v0")
        pb.add_r1cs_constraint(a[1], b[1], v1, "fp3_v1")
        pb.add_r1cs_constraint(a[2], b[2], v2, "fp3_v2")
        pb.add_r1cs_constraint(a[1] + a[2], b[1] + b[2], t1, "fp3_t1")
        pb.add_r1cs_constraint(a[0] + a[1], b[0] + b[1], t2, "fp3_t2")
        pb.add_r1cs_constraint(a[0] + a[2], b[0] + b[2], t3, "fp3_t3")

        def wit(a=a, b=b, vars_=(v0, v1, v2, t1, t2, t3)):
            av = [pb.lc_val(x) for x in a]
            bv = [pb.lc_val(x) for x in b]
            vals = (av[0] * bv[0], av[1] * bv[1], av[2] * bv[2],
                    (av[1] + av[2]) * (bv[1] + bv[2]),
                    (av[0] + av[1]) * (bv[0] + bv[1]),
                    (av[0] + av[2]) * (bv[0] + bv[2]))
            for var, val in zip(vars_, vals):
                pb.setval(var, val % p)
        self._wq.append(wit)
        c0 = _lc(v0) + (_lc(t1) - v1 - v2) * nr
        c1 = _lc(t2) - v0 - v1 + _lc(v2) * nr
        c2 = _lc(t3) - v0 - v2 + _lc(v1)
        return (c0, c1, c2)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """Witness the inverse (libff Fp3 inverse formula), constrain
        a * a^{-1} == 1."""
        pb, p, nr = self.pb, self.pb.p, self.nr
        iv = (self._var("i0"), self._var("i1"), self._var("i2"))

        def wit(a=a, iv=iv):
            a0, a1, a2 = (pb.lc_val(x) for x in a)
            c0 = (a0 * a0 - nr * a1 * a2) % p
            c1 = (nr * a2 * a2 - a0 * a1) % p
            c2 = (a1 * a1 - a0 * a2) % p
            t = pow((a0 * c0 + nr * (a2 * c1 + a1 * c2)) % p, -1, p)
            for var, cv in zip(iv, (c0, c1, c2)):
                pb.setval(var, t * cv % p)
        self._wq.append(wit)
        inv = tuple(_lc(v) for v in iv)
        prod = self.mul(a, inv)
        one = self.one()
        for k in range(3):
            pb.add_r1cs_constraint(1, prod[k] - one[k], 0, f"fp3_inv{k}")
        return inv

    def assert_eq(self, a, b, ann="fp3_eq"):
        for k in range(3):
            self.pb.add_r1cs_constraint(1, a[k] - b[k], 0, f"{ann}{k}")

    # -- witness helpers -----------------------------------------------------
    def eval(self, a, F3):
        return F3(self.pb.lc_val(a[0]), self.pb.lc_val(a[1]),
                  self.pb.lc_val(a[2]))

    def alloc_input(self, e=None):
        v = tuple(self._var("in") for _ in range(3))
        if e is not None:
            for var, c in zip(v, (e.c0, e.c1, e.c2)):
                self.pb.setval(var, int(c))
        return tuple(_lc(x) for x in v), v


class Fp4Gadgets:
    """Fp4 = Fp2[s]/(s^2 - xi), xi an Fp2 non-residue; elements =
    (c0, c1) of Fp2 pairs (reference fp4_gadgets.hpp, the MNT4 Fq4)."""

    def __init__(self, fp2: Fp2Gadgets, xi_host, host_F4, prefix="fp4"):
        self.fp2 = fp2
        self.xi0 = int(xi_host.c0)
        self.xi1 = int(xi_host.c1)
        self.host_F4 = host_F4

    def mul_by_xi(self, x):
        return self.fp2.mul_const(x, self.xi0, self.xi1)

    def const(self, e):
        f = self.fp2
        return (f.const(e.c0), f.const(e.c1))

    def zero(self):
        z = self.fp2.zero()
        return (z, z)

    def one(self):
        return (self.fp2.one(), self.fp2.zero())

    def add(self, a, b):
        f = self.fp2
        return (f.add(a[0], b[0]), f.add(a[1], b[1]))

    def sub(self, a, b):
        f = self.fp2
        return (f.sub(a[0], b[0]), f.sub(a[1], b[1]))

    def neg(self, a):
        f = self.fp2
        return (f.neg(a[0]), f.neg(a[1]))

    def conjugate(self, a):
        """Unitary inverse (Frobenius^2 component): (c0, -c1)."""
        return (a[0], self.fp2.neg(a[1]))

    def mul(self, a, b):
        """Karatsuba over Fp2: 3 Fp2 muls (9 constraints)."""
        f = self.fp2
        v0 = f.mul(a[0], b[0])
        v1 = f.mul(a[1], b[1])
        t = f.mul(f.add(a[0], a[1]), f.add(b[0], b[1]))
        c0 = f.add(v0, self.mul_by_xi(v1))
        c1 = f.sub(f.sub(t, v0), v1)
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """Host-witnessed inverse + product-is-one constraints."""
        f, pb = self.fp2, self.fp2.pb
        iv = tuple(f._var("fp4i") for _ in range(4))

        def wit(a=a, iv=iv):
            F4 = self.host_F4
            F2 = F4.base_field
            av = F4(F2(pb.lc_val(a[0][0]), pb.lc_val(a[0][1])),
                    F2(pb.lc_val(a[1][0]), pb.lc_val(a[1][1])))
            r = av.inverse()
            for var, val in zip(iv, (r.c0.c0, r.c0.c1, r.c1.c0, r.c1.c1)):
                pb.setval(var, int(val))
        f._wq.append(wit)
        inv = ((_lc(iv[0]), _lc(iv[1])), (_lc(iv[2]), _lc(iv[3])))
        prod = self.mul(a, inv)
        one = self.one()
        f.assert_eq(prod[0], one[0], "fp4_inv0")
        f.assert_eq(prod[1], one[1], "fp4_inv1")
        return inv

    def assert_eq(self, a, b, ann="fp4_eq"):
        self.fp2.assert_eq(a[0], b[0], ann + "c0")
        self.fp2.assert_eq(a[1], b[1], ann + "c1")

    def eval(self, a, F4):
        f = self.fp2
        F2 = F4.base_field
        return F4(f.eval(a[0], F2), f.eval(a[1], F2))

    def alloc_input(self, e=None):
        (l0, v0) = self.fp2.alloc_input(e.c0 if e is not None else None)
        (l1, v1) = self.fp2.alloc_input(e.c1 if e is not None else None)
        return (l0, l1), (v0, v1)


class Fp6_2over3Gadgets:
    """Fp6 = Fp3[w]/(w^2 - v); elements = (c0, c1) of Fp3 triples
    (reference fp6_gadgets.hpp [2-over-3], the MNT6 Fq6 / the BW6-761
    GT field)."""

    def __init__(self, fp3: Fp3Gadgets, host_F6, prefix="fp6_2o3"):
        self.fp3 = fp3
        self.host_F6 = host_F6

    def const(self, e):
        f = self.fp3
        return (f.const(e.c0), f.const(e.c1))

    def zero(self):
        z = self.fp3.zero()
        return (z, z)

    def one(self):
        return (self.fp3.one(), self.fp3.zero())

    def add(self, a, b):
        f = self.fp3
        return (f.add(a[0], b[0]), f.add(a[1], b[1]))

    def sub(self, a, b):
        f = self.fp3
        return (f.sub(a[0], b[0]), f.sub(a[1], b[1]))

    def neg(self, a):
        f = self.fp3
        return (f.neg(a[0]), f.neg(a[1]))

    def conjugate(self, a):
        """Unitary inverse for GT elements: (c0, -c1)."""
        return (a[0], self.fp3.neg(a[1]))

    def mul(self, a, b):
        """Karatsuba over Fp3: 3 Fp3 muls (18 constraints);
        w^2 = v so the cross term shifts through mul_by_v."""
        f = self.fp3
        v0 = f.mul(a[0], b[0])
        v1 = f.mul(a[1], b[1])
        t = f.mul(f.add(a[0], a[1]), f.add(b[0], b[1]))
        c0 = f.add(v0, f.mul_by_v(v1))
        c1 = f.sub(f.sub(t, v0), v1)
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        f, pb = self.fp3, self.fp3.pb
        iv = tuple(f._var("fp6i") for _ in range(6))

        def wit(a=a, iv=iv):
            F6 = self.host_F6
            F3 = F6.base_field
            av = F6(F3(*(pb.lc_val(x) for x in a[0])),
                    F3(*(pb.lc_val(x) for x in a[1])))
            r = av.inverse()
            vals = (r.c0.c0, r.c0.c1, r.c0.c2, r.c1.c0, r.c1.c1, r.c1.c2)
            for var, val in zip(iv, vals):
                pb.setval(var, int(val))
        f._wq.append(wit)
        inv = (tuple(_lc(v) for v in iv[:3]), tuple(_lc(v) for v in iv[3:]))
        prod = self.mul(a, inv)
        one = self.one()
        f.assert_eq(prod[0], one[0], "fp6_inv0")
        f.assert_eq(prod[1], one[1], "fp6_inv1")
        return inv

    def assert_eq(self, a, b, ann="fp6_2o3_eq"):
        self.fp3.assert_eq(a[0], b[0], ann + "c0")
        self.fp3.assert_eq(a[1], b[1], ann + "c1")

    def eval(self, a, F6):
        f = self.fp3
        F3 = F6.base_field
        return F6(f.eval(a[0], F3), f.eval(a[1], F3))

    def alloc_input(self, e=None):
        (l0, v0) = self.fp3.alloc_input(e.c0 if e is not None else None)
        (l1, v1) = self.fp3.alloc_input(e.c1 if e is not None else None)
        return (l0, l1), (v0, v1)
