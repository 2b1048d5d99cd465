"""In-circuit MNT4/MNT6 ate pairings — the reference's PCD cycle gadgets.

Reference surface: gadgetlib1/gadgets/pairing/mnt/mnt_pairing_params.hpp
(+ weierstrass_precomputation/miller loop gadget family) — verify an
MNT4 proof inside a circuit over Fq(MNT4) = Fr(MNT6) and vice versa:
the two halves of unbounded MNT-cycle recursion
(common/default_types/r1cs_ppzkpcd_pp.hpp:27-38).

Same design as pairing_gadgets.PairingGadgets (BLS12-377): embed both
arguments into the full target tower (Fq4 / Fq6-2over3) and mirror the
host engine loop exactly, so curves/pairing.MNT{4,6}PairingEngine is the
bit-exact oracle for every intermediate. MNT specifics handled here:

  * generic j-invariant (a != 0): the tangent-slope numerator carries
    the curve's a embedded in the target field;
  * quadratic twists: untwist psi(x,y) = (x/w^2, y/w^3) is an Fp-LINEAR
    map of the Fq2/Fq3 coordinates (implemented by probing the host
    field on basis elements — zero constraints);
  * final exponentiation hard parts in x-chains (verified at import
    against the engines' (q^2+1)/r and (q^2-q+1)/r):
      MNT4: (q^2+1)/r   = x^2+2x+2 -> m^x, (m^x)^x * (m^x)^2 * m^2
      MNT6: (q^2-q+1)/r = x^2-x+1  -> (m^x)^x * conj(m^x) * m
    (both run in the norm-1 cyclotomic subgroup where conj = inverse).
"""
from __future__ import annotations

from .protoboard import Protoboard
from .fields_gadgets import (Fp2Gadgets, Fp3Gadgets, Fp4Gadgets,
                             Fp6_2over3Gadgets, _lc)
from ..relations.variable import LinearCombination


class MNTPairingGadgets:
    """In-circuit ate pairing for an MNT cycle curve.

    `inner_curve` is the curve whose proofs are being verified; the
    protoboard field must equal its base field (= the OTHER cycle
    curve's scalar field). Exposes the PairingGadgets surface consumed
    by the verifier gadgets: fp12 (target tower gadget), embed_g1/g2,
    miller_loop, miller_loop_const_q, mul_const12, final_exp,
    alloc_g2_point/set_g2_witness, generate_witness.
    """

    def __init__(self, pb: Protoboard, inner_curve, prefix="mntpair"):
        assert pb.p == inner_curve.q, \
            "circuit field must equal the inner curve's base field"
        self.pb = pb
        self.curve = inner_curve
        self.eng = eng = inner_curve.pairing_engine
        self.family = inner_curve.family
        x = inner_curve.x_param
        self.x_param = x
        q = inner_curve.q
        if self.family == "mnt4":
            self.base_deg = 2
            self.fpk = Fp2Gadgets(
                pb, int(inner_curve.Fq2.NON_RESIDUE), prefix + ".fp2")
            u = inner_curve.Fq2(inner_curve.Fq.zero(), inner_curve.Fq.one())
            self.fp12 = Fp4Gadgets(self.fpk, u, inner_curve.Fq4)
            self.host_GT = inner_curve.Fq4
            assert eng._hard_exp == x * x + 2 * x + 2  # (q^2+1)/r
        else:
            assert self.family == "mnt6"
            self.base_deg = 3
            self.fpk = Fp3Gadgets(
                pb, int(inner_curve.Fq3.NON_RESIDUE), prefix + ".fp3")
            self.fp12 = Fp6_2over3Gadgets(self.fpk, inner_curve.Fq6)
            self.host_GT = inner_curve.Fq6
            assert eng._hard_exp == x * x - x + 1    # (q^2-q+1)/r
        # verifier_gadgets compatibility: `fp2` is the G2-coordinate
        # field gadget regardless of its degree
        self.fp2 = self.fpk
        self._host_cols_cache = {}
        # the curve a-coefficient embedded in the target field, as a
        # symbolic constant (tangent slope numerator term)
        self._ea_sym = self._const_target(eng._ea)

    # -- flattening helpers ---------------------------------------------------
    def _flat_host(self, e):
        """Host target element -> list of base-Fp ints, order
        (c0.c0..c0.ck, c1.c0..c1.ck)."""
        out = []
        for half in (e.c0, e.c1):
            if self.base_deg == 2:
                out += [int(half.c0), int(half.c1)]
            else:
                out += [int(half.c0), int(half.c1), int(half.c2)]
        return out

    def _flat_sym(self, a):
        return list(a[0]) + list(a[1])

    def _unflat(self, lcs):
        k = self.base_deg
        return (tuple(lcs[:k]), tuple(lcs[k:]))

    def _const_target(self, e):
        return self._unflat([_lc(v) for v in self._flat_host(e)])

    def _host_basis(self):
        """Unit elements of the target field (cached columns probe)."""
        GT = self.host_GT
        B = GT.base_field
        F = B.base_field
        k = self.base_deg
        basis = []
        for h in range(2):
            for j in range(k):
                coords = [F.zero()] * k
                coords[j] = F.one()
                half = B(*coords)
                basis.append(GT(half, B.zero()) if h == 0
                             else GT(B.zero(), half))
        return basis

    def linear_map(self, a, fn, cache_key=None):
        """Apply an Fp-LINEAR host map `fn` to symbolic target element
        `a` — pure LC arithmetic, zero constraints."""
        if cache_key is not None and cache_key in self._host_cols_cache:
            cols = self._host_cols_cache[cache_key]
        else:
            cols = [self._flat_host(fn(b)) for b in self._host_basis()]
            if cache_key is not None:
                self._host_cols_cache[cache_key] = cols
        flat = self._flat_sym(a)
        d = 2 * self.base_deg
        out = []
        for j in range(d):
            acc = LinearCombination()
            for i in range(d):
                v = cols[i][j]
                if v:
                    acc = acc + flat[i] * v
            out.append(acc)
        return self._unflat(out)

    # -- constant ops (linear) ------------------------------------------------
    def mul_const12(self, a, K_host):
        return self.linear_map(a, lambda e: e * K_host)

    def frobenius_sym(self, a, power):
        return self.linear_map(a, lambda e: e.frobenius(power),
                               cache_key=("frob", power))

    # -- embeddings -----------------------------------------------------------
    def embed_g1(self, P):
        """G1 (x_lc, y_lc over Fp) -> target-field affine pair (c0.c0
        slot placement)."""
        k = self.base_deg
        z = tuple(_lc(0) for _ in range(k))
        mk = lambda v: ((v,) + tuple(_lc(0) for _ in range(k - 1)), z)
        return (mk(P[0]), mk(P[1]))

    def embed_g2(self, Q):
        """G2 (base-ext coordinate LC tuples on the twist) -> E(target):
        psi(x, y) = (x/w^2, y/w^3): linear placement maps."""
        eng = self.eng
        w2i = self.host_GT.one() / eng._w2
        w3i = self.host_GT.one() / eng._w3
        return (self._placed_mul_const(Q[0], w2i, "w2i"),
                self._placed_mul_const(Q[1], w3i, "w3i"))

    def _placed_mul_const(self, c_sym, K_host, tag):
        """(base-field element c placed in the target c0 slot) * K, as a
        linear map of c's coordinates."""
        key = ("placed", tag)
        if key in self._host_cols_cache:
            cols = self._host_cols_cache[key]
        else:
            GT = self.host_GT
            B = GT.base_field
            F = B.base_field
            k = self.base_deg
            cols = []
            for j in range(k):
                coords = [F.zero()] * k
                coords[j] = F.one()
                cols.append(self._flat_host(GT(B(*coords), B.zero())
                                            * K_host))
            self._host_cols_cache[key] = cols
        d = 2 * self.base_deg
        out = []
        for j in range(d):
            acc = LinearCombination()
            for i, ci in enumerate(c_sym):
                v = cols[i][j]
                if v:
                    acc = acc + ci * v
            out.append(acc)
        return self._unflat(out)

    # -- G2 proof-point plumbing (verifier gadgets) ---------------------------
    def alloc_g2_point(self):
        x, xv = self.fpk.alloc_input()
        y, yv = self.fpk.alloc_input()
        return (x, y), (xv, yv)

    def set_g2_witness(self, vars_, pt):
        xv, yv = vars_
        for vs, c in ((xv, pt.x), (yv, pt.y)):
            coords = ((c.c0, c.c1) if self.base_deg == 2
                      else (c.c0, c.c1, c.c2))
            for var, val in zip(vs, coords):
                self.pb.setval(var, int(val))

    # -- GT (target-field) variable plumbing ----------------------------------
    def alloc_gt(self):
        """Allocate a variable target-field element; returns
        (symbolic, raw_vars)."""
        l0, v0 = self.fpk.alloc_input()
        l1, v1 = self.fpk.alloc_input()
        return (l0, l1), (v0, v1)

    def set_gt_witness(self, vars_, val):
        for vs, half in zip(vars_, (val.c0, val.c1)):
            coords = ((half.c0, half.c1) if self.base_deg == 2
                      else (half.c0, half.c1, half.c2))
            for var, c in zip(vs, coords):
                self.pb.setval(var, int(c))

    def gt_coord_lcs(self, sym):
        """Flat coordinate LCs of a symbolic target element (canonical
        order, for hash binding)."""
        return self._flat_sym(sym)

    def gt_host_coords(self, val):
        """Flat coordinate ints of a host target element (same order)."""
        return self._flat_host(val)

    # -- target-field point ops (witnessed slopes) ----------------------------
    def _sub12(self, a, b):
        f = self.fpk
        return (f.sub(a[0], b[0]), f.sub(a[1], b[1]))

    def _scale12(self, a, kk):
        f = self.fpk
        return (f.scale_int(a[0], kk), f.scale_int(a[1], kk))

    def _add12(self, a, b):
        f = self.fpk
        return (f.add(a[0], b[0]), f.add(a[1], b[1]))

    def _pt_add(self, P1, P2):
        f12 = self.fp12
        lam = f12.mul(self._sub12(P2[1], P1[1]),
                      f12.inv(self._sub12(P2[0], P1[0])))
        x3 = self._sub12(self._sub12(f12.sqr(lam), P1[0]), P2[0])
        y3 = self._sub12(f12.mul(lam, self._sub12(P1[0], x3)), P1[1])
        return (x3, y3), lam

    def _pt_dbl(self, P):
        """MNT tangent: lam = (3x^2 + a) / (2y) — the a term is what
        distinguishes this from the a = 0 families."""
        f12 = self.fp12
        num = self._add12(self._scale12(f12.sqr(P[0]), 3), self._ea_sym)
        lam = f12.mul(num, f12.inv(self._scale12(P[1], 2)))
        x3 = self._sub12(f12.sqr(lam), self._scale12(P[0], 2))
        y3 = self._sub12(f12.mul(lam, self._sub12(P[0], x3)), P[1])
        return (x3, y3), lam

    def _line(self, lam, Pfrom, T):
        f12 = self.fp12
        return self._sub12(f12.mul(lam, self._sub12(T[0], Pfrom[0])),
                           self._sub12(T[1], Pfrom[1]))

    # -- Miller loop ----------------------------------------------------------
    def miller_loop(self, embQ, embP):
        """f_{|T|,Q}(P), inverted at the end when the ate count T = t-1
        is negative (MNT6) — engine parity."""
        f12 = self.fp12
        n = self.eng.loop_count
        R = embQ
        f = f12.one()
        for i in range(n.bit_length() - 2, -1, -1):
            f = f12.sqr(f)
            R2, lam = self._pt_dbl(R)
            f = f12.mul(f, self._line(lam, R, embP))
            R = R2
            if (n >> i) & 1:
                Radd, lam2 = self._pt_add(R, embQ)
                f = f12.mul(f, self._line(lam2, R, embP))
                R = Radd
        if self.eng.loop_is_neg:
            f = f12.inv(f)
        return f

    def miller_loop_const_q(self, Q_host, embP):
        """Miller loop with a CONSTANT G2 point: the R-chain and slopes
        are host values, every line is LINEAR in embP."""
        eng = self.eng
        f12 = self.fp12
        R = eng.embed_g2(Q_host)
        Qe = R
        n = eng.loop_count
        f = f12.one()

        def line_sym(P1, P2):
            x1, y1 = P1
            x2, y2 = P2
            if x1 == x2 and y1 == y2:
                slope = eng._tangent_slope(x1, y1)
            else:
                slope = (y2 - y1) / (x2 - x1)
            sx = self.mul_const12(embP[0], slope)
            const_part = self._const_target(-(slope * x1) + y1)
            return self._add12(self._add12(sx, self._neg12(embP[1])),
                               const_part)

        for i in range(n.bit_length() - 2, -1, -1):
            f = f12.sqr(f)
            f = f12.mul(f, line_sym(R, R))
            R = eng._add(R, R)
            if (n >> i) & 1:
                f = f12.mul(f, line_sym(R, Qe))
                R = eng._add(R, Qe)
        if eng.loop_is_neg:
            f = f12.inv(f)
        return f

    def _neg12(self, a):
        f = self.fpk
        return (f.neg(a[0]), f.neg(a[1]))

    # -- final exponentiation -------------------------------------------------
    def cyclotomic_exp(self, a, e: int):
        """Plain square-and-multiply in the norm-1 subgroup (e > 0)."""
        f12 = self.fp12
        assert e > 0
        r = a
        for i in range(e.bit_length() - 2, -1, -1):
            r = f12.sqr(r)
            if (e >> i) & 1:
                r = f12.mul(r, a)
        return r

    def final_exp(self, f):
        f12 = self.fp12
        x = self.x_param
        if self.family == "mnt4":
            # easy: f^(q^2-1) = conj(f) * inv(f)
            m = f12.mul(f12.conjugate(f), f12.inv(f))
            # hard: m^(x^2+2x+2)
            u1 = self.cyclotomic_exp(m, x)
            return f12.mul(f12.mul(self.cyclotomic_exp(u1, x),
                                   f12.sqr(u1)), f12.sqr(m))
        # mnt6 easy: f^(q^3-1) then ^(q+1)
        m = f12.mul(f12.conjugate(f), f12.inv(f))
        m = f12.mul(self.frobenius_sym(m, 1), m)
        # hard: m^(x^2-x+1)
        u1 = self.cyclotomic_exp(m, x)
        return f12.mul(f12.mul(self.cyclotomic_exp(u1, x),
                               f12.conjugate(u1)), m)

    # -- top-level helpers ----------------------------------------------------
    def assert_pairing_product_one(self, pairs):
        """Constrain prod e(Pi, Qi) == 1; pairs = [(g1_sym, g2_emb)]."""
        f12 = self.fp12
        f = None
        for P, embQ in pairs:
            ml = self.miller_loop(embQ, self.embed_g1(P))
            f = ml if f is None else f12.mul(f, ml)
        out = self.final_exp(f)
        f12.assert_eq(out, f12.one(), "mnt_pairing_product_one")
        return out

    def generate_witness(self):
        self.fpk.generate_witness()


def make_pairing_gadgets(pb, inner_curve, prefix="pair"):
    """Family dispatch: the one-layer BLS12-377 gadgets or the MNT cycle
    gadgets, by inner-curve family."""
    fam = getattr(inner_curve, "family",
                  getattr(inner_curve.pairing_engine, "family", None))
    if fam in ("mnt4", "mnt6"):
        return MNTPairingGadgets(pb, inner_curve, prefix)
    from .pairing_gadgets import PairingGadgets
    return PairingGadgets(pb, inner_curve, prefix)
