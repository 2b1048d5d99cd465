"""variable_or_identity + scalar-multiplication gadget family.

Parity with the reference's gadgetlib1/gadgets/curves/
scalar_multiplication.hpp:35-342 (Clearmatics): a group variable paired
with a boolean is_identity flag, selector gadgets, identity-aware
add/dbl wrappers, and double-and-add scalar multiplication for BOTH a
variable scalar (point_mul_by_scalar_gadget) and a constant scalar
(point_mul_by_const_scalar_gadget). These remove the scalar = 0 /
identity-result domain restriction from the verifier gadgets: a zero
scalar yields is_identity = 1 instead of an unsatisfiable slope
constraint.

Same caveat as the reference: the underlying witnessed-slope add/dbl
gadgets assume non-exceptional operands among NON-identity points
(scalar_multiplication.hpp "At most one element may be the identity");
the bit-0 dummy-add trick (scalar_multiplication.tcc:645-700) keeps the
final addition well-defined when the low bit is 0.

Generic over a group-ops adapter so one implementation serves G1 (Fp
coordinates) and G2 (Fp2 coordinates).
"""
from __future__ import annotations

import dataclasses
from typing import List

from .protoboard import Protoboard, PBVariable
from .fields_gadgets import _lc
from ..relations.variable import LinearCombination


@dataclasses.dataclass
class VarOrIdentity:
    """Group point (adapter-specific coordinate structure) + boolean
    is_identity LC (reference variable_or_identity)."""
    pt: object
    is_id: object      # LinearCombination, boolean-constrained


class G1Ops:
    """Adapter over pairing_gadgets.G1Gadgets: flat-coordinate access,
    muxes and on-curve checking for Fp points."""

    def __init__(self, g1, curve):
        self.g = g1
        self.pb = g1.pb
        self.curve = curve
        self.one_host = curve.G1.one()

    def add(self, P, Q):
        return self.g.add(P, Q)

    def dbl(self, P):
        return self.g.dbl(P)

    def const(self, P_host):
        return self.g.const(P_host)

    def coords(self, P):
        return [P[0], P[1]]

    def from_coords(self, cs):
        return (cs[0], cs[1])

    def alloc_mux_vars(self, tag):
        return [self.g._var(tag + "x"), self.g._var(tag + "y")]

    def queue(self, fn):
        self.g._wq.append(fn)

    def checker(self, P, ann="g1_checker"):
        """y^2 = x^3 + a*x + b (reference G1_checker_gadget)."""
        pb = self.pb
        b = int(self.curve.b)
        a = self.g.a
        xx = self.g._var("chk_xx")
        pb.add_r1cs_constraint(P[0], P[0], xx, ann + "_xx")
        # x * xx = y^2 - a*x - b  <=>  y^2 = x^3 + ax + b
        yy = self.g._var("chk_yy")
        pb.add_r1cs_constraint(P[1], P[1], yy, ann + "_yy")
        pb.add_r1cs_constraint(P[0], _lc(xx),
                               _lc(yy) - P[0] * a - b, ann + "_curve")

        def wit(P=P, xx=xx, yy=yy):
            p = pb.p
            x = pb.lc_val(P[0])
            pb.setval(xx, x * x % p)
            y = pb.lc_val(P[1])
            pb.setval(yy, y * y % p)
        self.queue(wit)


class G2Ops:
    """Adapter over pairing_gadgets.G2Gadgets (Fp2 coordinate pairs)."""

    def __init__(self, g2, curve):
        self.g = g2
        self.f = g2.fp2
        self.pb = g2.pb
        self.curve = curve
        self.one_host = curve.G2.one()

    def add(self, P, Q):
        return self.g.add(P, Q)

    def dbl(self, P):
        return self.g.dbl(P)

    def const(self, P_host):
        return self.g.const(P_host)

    def coords(self, P):
        return [P[0][0], P[0][1], P[1][0], P[1][1]]

    def from_coords(self, cs):
        return ((cs[0], cs[1]), (cs[2], cs[3]))

    def alloc_mux_vars(self, tag):
        return [self.f._var(tag + str(i)) for i in range(4)]

    def queue(self, fn):
        self.f._wq.append(fn)

    def checker(self, P, ann="g2_checker"):
        """y^2 = x^3 + b2 over Fp2 (reference G2_checker_gadget)."""
        f = self.f
        b2 = self.curve.b2
        xx = f.sqr(P[0])
        xxx = f.mul(xx, P[0])
        yy = f.sqr(P[1])
        rhs = f.add(xxx, f.const(b2))
        f.assert_eq(yy, rhs, ann)


class ScalarMulGadgets:
    """Selector / identity-aware add-dbl / mul_by_scalar builders over a
    group adapter. Witness generation runs through the adapter's queue
    in construction order (set scalar/point values first)."""

    def __init__(self, ops):
        self.ops = ops
        self.pb = ops.pb

    # ------------------------------------------------------------- selectors
    def select_point(self, bit, zero_pt, one_pt, tag="sel"):
        """result = bit ? one_pt : zero_pt, one mux constraint per
        coordinate (reference G1/G2_variable_selector_gadget)."""
        pb, ops = self.pb, self.ops
        zc, oc = ops.coords(zero_pt), ops.coords(one_pt)
        rv = ops.alloc_mux_vars(tag)
        for r, z, o in zip(rv, zc, oc):
            pb.add_r1cs_constraint(bit, o - z, _lc(r) - z, tag + "_mux")

        def wit(bit=bit, zc=zc, oc=oc, rv=rv):
            b = pb.lc_val(_lc(bit))
            src = oc if b else zc
            for r, s in zip(rv, src):
                pb.setval(r, pb.lc_val(s))
        ops.queue(wit)
        return ops.from_coords([_lc(v) for v in rv])

    def _mul_flag(self, a_lc, b_lc, tag):
        """Allocated product of two boolean LCs."""
        pb = self.pb
        v = PBVariable().allocate(pb, tag)
        pb.add_r1cs_constraint(a_lc, b_lc, v, tag)

        def wit(a=a_lc, b=b_lc, v=v):
            pb.setval(v, pb.lc_val(_lc(a)) * pb.lc_val(_lc(b)) % pb.p)
        self.ops.queue(wit)
        return _lc(v)

    def select_vi_and_var(self, bit, zero_vi: VarOrIdentity, one_pt,
                          tag="selvi"):
        """bit ? plain variable : variable_or_identity (reference
        variable_and_variable_or_identity_selector):
        is_id = (1 - bit) * zero_vi.is_id."""
        pt = self.select_point(bit, zero_vi.pt, one_pt, tag)
        is_id = self._mul_flag(1 - _lc(bit), zero_vi.is_id, tag + "_id")
        return VarOrIdentity(pt, is_id)

    def select_vi_vi(self, bit, zero_vi, one_vi, tag="selvv"):
        """bit ? one_vi : zero_vi (reference
        variable_or_identity_selector)."""
        pb = self.pb
        pt = self.select_point(bit, zero_vi.pt, one_vi.pt, tag)
        v = PBVariable().allocate(pb, tag + "_id")
        pb.add_r1cs_constraint(bit, one_vi.is_id - zero_vi.is_id,
                               _lc(v) - zero_vi.is_id, tag + "_idmux")

        def wit(bit=bit, z=zero_vi.is_id, o=one_vi.is_id, v=v):
            b = pb.lc_val(_lc(bit))
            pb.setval(v, pb.lc_val(o if b else z))
        self.ops.queue(wit)
        return VarOrIdentity(pt, _lc(v))

    # -------------------------------------------------- identity-aware ops
    def identity_const(self):
        """Constant identity: value parked at the generator (so dbl/add
        witnesses stay well-defined; the flag masks it out)."""
        return VarOrIdentity(self.ops.const(self.ops.one_host), _lc(1))

    def dbl_vi(self, A: VarOrIdentity):
        """(dbl(A.value), A.is_id) -- reference dbl_variable_or_identity."""
        return VarOrIdentity(self.ops.dbl(A.pt), A.is_id)

    def add_vi_and_var(self, A: VarOrIdentity, B_pt, tag="addvi"):
        """A + B for plain variable B: A.is_id ? B : add(A.value, B)
        (reference add_variable_and_variable_or_identity). Exceptional
        when A.value == +-B with A non-identity (reference caveat)."""
        s = self.ops.add(A.pt, B_pt)
        return self.select_point(A.is_id, s, B_pt, tag)

    def add_vi_vi(self, A: VarOrIdentity, B: VarOrIdentity, tag="addvv"):
        """A + B over variable_or_identity (reference
        add_variable_or_identity): at most one may be the identity in
        non-degenerate witnesses."""
        s = self.ops.add(A.pt, B.pt)
        a_nz = self.select_point(B.is_id, s, A.pt, tag + "_bnz")
        pt = self.select_point(A.is_id, a_nz, B.pt, tag + "_anz")
        is_id = self._mul_flag(A.is_id, B.is_id, tag + "_id")
        return VarOrIdentity(pt, is_id)

    # ------------------------------------------------------- scalar mults
    def mul_by_scalar(self, bits: List, P_pt, tag="vmul") -> VarOrIdentity:
        """[scalar] * P for a variable scalar given as boolean LCs
        (LSB first). MSB-first double-add-select over
        variable_or_identity, with the reference's bit-0 dummy-add
        (scalar_multiplication.tcc:563-720). Returns VarOrIdentity
        (scalar = 0 => is_identity)."""
        ops = self.ops
        n = len(bits)
        acc = self.select_vi_and_var(bits[n - 1], self.identity_const(),
                                     P_pt, f"{tag}.s{n-1}")
        for i in range(n - 2, 0, -1):
            d = self.dbl_vi(acc)
            # identity-aware add (reference add_variable_and_variable_
            # or_identity): while the accumulator is still the identity
            # (leading zero bits) the add must yield P, not parked+P
            a = self.add_vi_and_var(d, P_pt, f"{tag}.a{i}")
            pt = self.select_point(bits[i], d.pt, a, f"{tag}.s{i}")
            is_id = self._mul_flag(1 - _lc(bits[i]), d.is_id,
                                   f"{tag}.s{i}_id")
            acc = VarOrIdentity(pt, is_id)
        # bit 0: if set, final = add(dbl, P); else a DUMMY add(1*G, 2*G)
        # keeps the slope witness well-defined and the dbl result is
        # selected instead.
        d = self.dbl_vi(acc)
        sel = 1 - _lc(bits[0])            # 1 when bit0 == 0
        left = self.select_vi_and_var(
            sel, d, ops.const(ops.one_host), f"{tag}.fl")
        right = self.select_point(sel, P_pt,
                                  ops.const(ops.one_host + ops.one_host),
                                  f"{tag}.fr")
        a = self.add_vi_and_var(left, right, f"{tag}.fa")
        pt = self.select_point(bits[0], d.pt, a, f"{tag}.s0")
        is_id = self._mul_flag(1 - _lc(bits[0]), d.is_id, f"{tag}.s0_id")
        return VarOrIdentity(pt, is_id)

    def mul_by_const_scalar(self, k: int, P_pt, tag="cmul"):
        """[k] * P for a CONSTANT nonzero scalar (reference
        point_mul_by_const_scalar_gadget): plain double-and-add on the
        fixed bit pattern; returns a plain variable point. Exceptional
        iff an intermediate hits +-P (as in the reference)."""
        assert k > 0
        ops = self.ops
        acc = P_pt
        for bit in bin(k)[3:]:
            acc = ops.dbl(acc)
            if bit == "1":
                acc = ops.add(acc, P_pt)
        return acc
