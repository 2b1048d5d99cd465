"""In-circuit BLS12-377 pairing + Groth16 verifier gadgets.

The reference's recursion enablers (gadgetlib1/gadgets/pairing/
bw6_761_bls12_377/ + gadgets/verifiers/r1cs_gg_ppzksnark_verifier_
gadget.hpp:30-176): verify a BLS12-377 Groth16 proof INSIDE a circuit
whose field is Fq(BLS12-377) = Fr(BW6-761) -- the one-layer proof
composition pattern.

Components:
  * G1Gadgets: affine Weierstrass arithmetic with witnessed slopes
  * MillerLoopGadget: the BLS ate loop over embedded E(Fq12) points
    (mirrors curves/pairing.PairingEngine exactly, so host values are
    the oracle)
  * FinalExpGadget: easy part by frobenius/conjugate/witnessed inverse;
    hard part via the lambda-decomposition 5-exponentiation chain
    (computes the CUBE of the reference pairing -- equal-to-one checks
    are unaffected since 3 is coprime to r)
  * Groth16VerifierGadget: e(A,B) = e(alpha,beta) e(acc,gamma) e(C,delta)
    with vk as circuit constants and the public input given in bits.
"""
from __future__ import annotations

from typing import List

from .protoboard import Gadget, Protoboard, PBVariable
from .fields_gadgets import Fp2Gadgets, Fp6Gadgets, Fp12Gadgets, _lc
from ..relations.variable import LinearCombination


class G1Gadgets:
    """Affine short-Weierstrass arithmetic over the protoboard field
    (a = 0 curves); witnessed-slope add/dbl (weierstrass_g1_gadget
    parity). Points = (x_lc, y_lc); NON-exceptional cases only (the
    reference gadgets carry the same assumption)."""

    def __init__(self, pb: Protoboard, prefix="g1", a: int = 0):
        self.pb = pb
        self.prefix = prefix
        self.a = a % pb.p          # curve a-coefficient (MNT curves != 0)
        self._ctr = 0
        self._wq = []

    def _var(self, tag):
        self._ctr += 1
        return PBVariable().allocate(self.pb,
                                     f"{self.prefix}.{tag}{self._ctr}")

    def generate_witness(self):
        for fn in self._wq:
            fn()

    def const(self, P):
        return (_lc(int(P.x)), _lc(int(P.y)))

    def alloc(self, P=None):
        xv, yv = self._var("x"), self._var("y")
        if P is not None:
            self.pb.setval(xv, int(P.x))
            self.pb.setval(yv, int(P.y))
        return (_lc(xv), _lc(yv))

    def neg(self, P):
        return (P[0], -P[1])

    def add(self, P, Q):
        """P + Q for P != +-Q."""
        pb = self.pb
        lam, x3, y3 = self._var("lam"), self._var("x3"), self._var("y3")
        pb.add_r1cs_constraint(lam, Q[0] - P[0], Q[1] - P[1], "g1_add_lam")
        pb.add_r1cs_constraint(lam, lam, _lc(x3) + P[0] + Q[0], "g1_add_x")
        pb.add_r1cs_constraint(lam, P[0] - x3, _lc(y3) + P[1], "g1_add_y")

        def wit(P=P, Q=Q, lam=lam, x3=x3, y3=y3):
            p = pb.p
            x1, y1 = pb.lc_val(P[0]), pb.lc_val(P[1])
            x2, y2 = pb.lc_val(Q[0]), pb.lc_val(Q[1])
            l = (y2 - y1) * pow(x2 - x1, -1, p) % p
            xv = (l * l - x1 - x2) % p
            pb.setval(lam, l)
            pb.setval(x3, xv)
            pb.setval(y3, (l * (x1 - xv) - y1) % p)
        self._wq.append(wit)
        return (_lc(x3), _lc(y3))

    def dbl(self, P):
        pb = self.pb
        lam, x3, y3 = self._var("lam"), self._var("x3"), self._var("y3")
        xx = self._var("xx")
        pb.add_r1cs_constraint(P[0], P[0], xx, "g1_dbl_xx")
        pb.add_r1cs_constraint(_lc(lam), P[1] * 2, _lc(xx) * 3 + self.a,
                               "g1_dbl_lam")
        pb.add_r1cs_constraint(lam, lam, _lc(x3) + P[0] * 2, "g1_dbl_x")
        pb.add_r1cs_constraint(lam, P[0] - x3, _lc(y3) + P[1], "g1_dbl_y")

        def wit(P=P, lam=lam, x3=x3, y3=y3, xx=xx):
            p = pb.p
            x1, y1 = pb.lc_val(P[0]), pb.lc_val(P[1])
            pb.setval(xx, x1 * x1 % p)
            l = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
            xv = (l * l - 2 * x1) % p
            pb.setval(lam, l)
            pb.setval(x3, xv)
            pb.setval(y3, (l * (x1 - xv) - y1) % p)
        self._wq.append(wit)
        return (_lc(x3), _lc(y3))

    def conditional_add(self, acc, bit, T):
        """acc + bit * T for a VARIABLE point T (the variable-vk
        verifier's IC accumulation; reference
        r1cs_ppzksnark_verifier_gadget.hpp G1_add_variable use)."""
        pb = self.pb
        S = self.add(acc, T)
        rx, ry = self._var("mx"), self._var("my")
        pb.add_r1cs_constraint(bit, S[0] - acc[0], _lc(rx) - acc[0],
                               "g1_vcadd_x")
        pb.add_r1cs_constraint(bit, S[1] - acc[1], _lc(ry) - acc[1],
                               "g1_vcadd_y")

        def wit(acc=acc, S=S, bit=bit, rx=rx, ry=ry):
            b = pb.lc_val(_lc(bit))
            src = S if b else acc
            pb.setval(rx, pb.lc_val(src[0]))
            pb.setval(ry, pb.lc_val(src[1]))
        self._wq.append(wit)
        return (_lc(rx), _lc(ry))

    def conditional_add_const(self, acc, bit, T_host):
        """acc + bit * T for a CONSTANT point T: computes S = acc + T
        (witnessed), result = bit ? S : acc (2 mux constraints)."""
        pb = self.pb
        S = self.add(acc, self.const(T_host))
        rx, ry = self._var("mx"), self._var("my")
        pb.add_r1cs_constraint(bit, S[0] - acc[0], _lc(rx) - acc[0],
                               "g1_cadd_x")
        pb.add_r1cs_constraint(bit, S[1] - acc[1], _lc(ry) - acc[1],
                               "g1_cadd_y")

        def wit(acc=acc, S=S, bit=bit, rx=rx, ry=ry):
            b = pb.lc_val(_lc(bit))
            src = S if b else acc
            pb.setval(rx, pb.lc_val(src[0]))
            pb.setval(ry, pb.lc_val(src[1]))
        self._wq.append(wit)
        return (_lc(rx), _lc(ry))


class G2Gadgets:
    """Affine arithmetic for G2 points over Fp2 (weierstrass_g2_gadget
    parity): points = (x, y) pairs of Fp2 LC pairs; slopes witnessed via
    the Fp2 gadget ops (non-exceptional cases)."""

    def __init__(self, fp2, prefix="g2"):
        self.fp2 = fp2
        self.pb = fp2.pb
        self.prefix = prefix

    def const(self, Q):
        f = self.fp2
        return (f.const(Q.x), f.const(Q.y))

    def neg(self, Q):
        return (Q[0], self.fp2.neg(Q[1]))

    def add(self, P, Q):
        f = self.fp2
        lam = f.mul(f.sub(Q[1], P[1]), f.inv(f.sub(Q[0], P[0])))
        x3 = f.sub(f.sub(f.sqr(lam), P[0]), Q[0])
        y3 = f.sub(f.mul(lam, f.sub(P[0], x3)), P[1])
        return (x3, y3)

    def dbl(self, P):
        f = self.fp2
        lam = f.mul(f.scale_int(f.sqr(P[0]), 3),
                    f.inv(f.scale_int(P[1], 2)))
        x3 = f.sub(f.sqr(lam), f.scale_int(P[0], 2))
        y3 = f.sub(f.mul(lam, f.sub(P[0], x3)), P[1])
        return (x3, y3)

    def conditional_add_const(self, acc, bit, T_host):
        """acc + bit * T for a constant host G2 point T."""
        f = self.fp2
        pb = self.pb
        S = self.add(acc, self.const(T_host))
        out = []
        for coord_S, coord_acc in ((S[0], acc[0]), (S[1], acc[1])):
            pair = []
            for c in range(2):
                v = f._var("m")
                pb.add_r1cs_constraint(
                    bit, coord_S[c] - coord_acc[c],
                    LinearCombination(v) - coord_acc[c], "g2_cadd")

                def wit(v=v, bit=bit, s=coord_S[c], a=coord_acc[c]):
                    b = pb.lc_val(LinearCombination._coerce(bit))
                    pb.setval(v, pb.lc_val(s) if b else pb.lc_val(a))
                f._wq.append(wit)
                pair.append(LinearCombination(v))
            out.append(tuple(pair))
        return tuple(out)


class PairingGadgets:
    """Miller loop + final exponentiation for BLS12-377 inside a circuit
    over Fq(BLS12-377). G2 points are embedded into E(Fq12) coordinates
    (the same untwist as curves/pairing.PairingEngine, so the host
    engine is the bit-exact oracle for every intermediate)."""

    def __init__(self, pb: Protoboard, inner_curve, prefix="pair"):
        assert pb.p == inner_curve.q, \
            "circuit field must equal the inner curve's base field"
        self.pb = pb
        self.curve = inner_curve
        self.fp2 = Fp2Gadgets(pb, int(inner_curve.Fq2.NON_RESIDUE),
                              prefix + ".fp2")
        self.fp6 = Fp6Gadgets(self.fp2, inner_curve.xi)
        self.fp12 = Fp12Gadgets(self.fp6, inner_curve.Fq12)
        self.x_param = inner_curve.x_param

    # -- embeddings (linear) ---------------------------------------------------
    def embed_g1(self, P):
        """G1 point (x_lc, y_lc over Fp) -> E(Fq12) symbolic affine pair.
        Coordinates land in the c0.c0 slot."""
        f2, f6 = self.fp2, self.fp6
        z2 = f2.zero()
        mk = lambda v: ((( _lc(v), _lc(0)), z2, z2), (z2, z2, z2))
        return (mk(P[0]), mk(P[1]))

    def embed_g2(self, Q):
        """G2 (Fp2 coordinate pairs on the D-twist) -> E(Fq12): multiply
        by the constant w^2 / w^3 basis elements -- a LINEAR placement of
        the Fp2 coordinates into tower slots."""
        eng = self.curve.pairing_engine
        # host: psi(x, y) = (x * w2, y * w3) (D twist) -- w2/w3 constant
        # Fq12 elements; multiplication by them permutes/scales tower
        # coordinates. Compute the linear action by probing host basis.
        return (self._mul_by_host_const_placed(Q[0], eng._w2),
                self._mul_by_host_const_placed(Q[1], eng._w3))

    def _mul_by_host_const_placed(self, c_fp2, W):
        """(c placed in Fq12 c0.c0 slot) * host-constant W, as a linear
        map of the Fp2 pair c. W's action: result coordinate (h,j) =
        c * W_{h,j} (Fq2 mult by constant)."""
        f2 = self.fp2
        out = []
        for h, half in enumerate((W.c0, W.c1)):
            row = []
            for j, w_c in enumerate((half.c0, half.c1, half.c2)):
                row.append(f2.mul_const(c_fp2, int(w_c.c0), int(w_c.c1)))
            out.append(tuple(row))
        return tuple(out)

    # -- E(Fq12) point ops (witnessed Fq12 slopes) ------------------------------
    def _pt_add(self, P1, P2):
        f12 = self.fp12
        num = self._sub12(P2[1], P1[1])
        den = self._sub12(P2[0], P1[0])
        lam = f12.mul(num, f12.inv(den))
        x3 = self._sub12(self._sub12(f12.sqr(lam), P1[0]), P2[0])
        y3 = self._sub12(f12.mul(lam, self._sub12(P1[0], x3)), P1[1])
        return (x3, y3), lam

    def _pt_dbl(self, P):
        f12 = self.fp12
        three_x2 = self._scale12(f12.sqr(P[0]), 3)
        lam = f12.mul(three_x2, f12.inv(self._scale12(P[1], 2)))
        x3 = self._sub12(f12.sqr(lam), self._scale12(P[0], 2))
        y3 = self._sub12(f12.mul(lam, self._sub12(P[0], x3)), P[1])
        return (x3, y3), lam

    def _sub12(self, a, b):
        f6 = self.fp6
        return (f6.sub(a[0], b[0]), f6.sub(a[1], b[1]))

    def _scale12(self, a, k):
        f2 = self.fp2
        return tuple(tuple(f2.scale_int(c, k) for c in half) for half in a)

    def _line(self, lam, Pfrom, T):
        """line through Pfrom with slope lam, evaluated at T:
        lam * (xT - x1) - (yT - y1)."""
        f12 = self.fp12
        return self._sub12(f12.mul(lam, self._sub12(T[0], Pfrom[0])),
                           self._sub12(T[1], Pfrom[1]))

    # -- Miller loop -------------------------------------------------------------
    def miller_loop(self, embQ, embP):
        """f_{|x|, Q}(P) for the BLS loop count (pairing.py parity)."""
        f12 = self.fp12
        n = abs(self.x_param)
        R = embQ
        f = f12.one()
        for i in range(n.bit_length() - 2, -1, -1):
            f = f12.sqr(f)
            (R2, lam) = self._pt_dbl(R)
            f = f12.mul(f, self._line(lam, R, embP))
            R = R2
            if (n >> i) & 1:
                (Radd, lam2) = self._pt_add(R, embQ)
                f = f12.mul(f, self._line(lam2, R, embP))
                R = Radd
        return f

    # -- final exponentiation ------------------------------------------------------
    def final_exp(self, f):
        """f^(3 * (q^12-1)/r) via easy part + lambda chain (docstring)."""
        f12 = self.fp12
        x = abs(self.x_param)
        # easy: m = f^(q^6-1) = conj(f) * inv(f); then ^(q^2+1)
        m = f12.mul(f12.conjugate(f), f12.inv(f))
        m = f12.mul(f12.frobenius(m, 2), m)
        # hard (cubed): lam3 = (x-1)^2, lam2 = lam3 x, lam1 = lam2 x - lam3,
        # lam0 = lam1 x + 3
        u = f12.cyclotomic_exp(m, x - 1)
        t3 = f12.cyclotomic_exp(u, x - 1)          # m^(x-1)^2
        t2 = f12.cyclotomic_exp(t3, x)
        t1 = f12.mul(f12.cyclotomic_exp(t2, x), f12.conjugate(t3))
        t0 = f12.mul(f12.cyclotomic_exp(t1, x),
                     f12.mul(m, f12.mul(m, m)))
        out = f12.mul(t0, f12.frobenius(t1, 1))
        out = f12.mul(out, f12.frobenius(t2, 2))
        out = f12.mul(out, f12.frobenius(t3, 3))
        return out

    # -- constant-operand optimizations --------------------------------------
    def mul_const12(self, a, K_host):
        """a * K for a CONSTANT Fq12 element K: a pure linear map (the
        12x12 structure matrix over Fp), zero constraints."""
        F12 = self.curve.Fq12
        F6 = F12.base_field
        F2 = F6.base_field
        p = self.pb.p
        # columns: K * basis_{h,j,c}
        cols = []
        for h in range(2):
            for j in range(3):
                for c in range(2):
                    coords = [F2.zero()] * 3
                    coords[j] = F2(1, 0) if c == 0 else F2(0, 1)
                    half = F6(*coords)
                    e = F12(half, F6.zero()) if h == 0 \
                        else F12(F6.zero(), half)
                    cols.append(e * K_host)
        # flatten symbolic input coords
        in_lcs = []
        for h in range(2):
            for j in range(3):
                in_lcs.extend([a[h][j][0], a[h][j][1]])
        # out coordinate (h,j,c) = sum_i in_i * cols[i].coord(h,j,c)
        out = []
        for h in range(2):
            row = []
            for j in range(3):
                pair = []
                for c in range(2):
                    acc = LinearCombination()
                    for i, col in enumerate(cols):
                        half = col.c0 if h == 0 else col.c1
                        coord = (half.c0, half.c1, half.c2)[j]
                        v = int(coord.c0) if c == 0 else int(coord.c1)
                        if v:
                            acc = acc + in_lcs[i] * v
                    pair.append(acc)
                row.append(tuple(pair))
            out.append(tuple(row))
        return tuple(out)

    def miller_loop_const_q(self, Q_host, embP):
        """Miller loop with a CONSTANT G2 point: the R-chain and slopes
        are host constants, every line is LINEAR in P; only the f
        accumulation multiplications cost constraints."""
        eng = self.curve.pairing_engine
        f12 = self.fp12
        embQ_host = eng.embed_g2(Q_host)
        n = abs(self.x_param)
        R = embQ_host
        f = f12.one()
        F12 = self.curve.Fq12

        def line_sym(P1_host, P2_host, R_host):
            """Host line data -> symbolic line evaluated at embP."""
            x1, y1 = P1_host
            x2, y2 = P2_host
            if x1 == x2 and y1 == y2:
                slope = (x1 * x1 * 3) / (y1 + y1)
            else:
                slope = (y2 - y1) / (x2 - x1)
            # l = slope * (xT - x1) - (yT - y1)
            sx = self.mul_const12(embP[0], slope)
            const_part = f12.const(-(slope * x1) + y1)
            return self.add12(self.add12(sx, self.neg12(embP[1])),
                              const_part)

        for i in range(n.bit_length() - 2, -1, -1):
            f = f12.sqr(f)
            l = line_sym(R, R, None)
            f = f12.mul(f, l)
            R = eng._add(R, R)
            if (n >> i) & 1:
                l = line_sym(R, embQ_host, None)
                f = f12.mul(f, l)
                R = eng._add(R, embQ_host)
        return f

    def add12(self, a, b):
        f6 = self.fp6
        return (f6.add(a[0], b[0]), f6.add(a[1], b[1]))

    def neg12(self, a):
        f6 = self.fp6
        return (f6.neg(a[0]), f6.neg(a[1]))

    def alloc_g2_point(self):
        """Allocate a variable G2 point (Fp2 coordinate pairs); returns
        (symbolic_point, raw_vars) — fill with set_g2_witness."""
        x, xv = self.fp2.alloc_input()
        y, yv = self.fp2.alloc_input()
        return (x, y), (xv, yv)

    def set_g2_witness(self, vars_, pt):
        xv, yv = vars_
        for vs, c in ((xv, pt.x), (yv, pt.y)):
            self.pb.setval(vs[0], int(c.c0))
            self.pb.setval(vs[1], int(c.c1))

    def assert_pairing_product_one(self, pairs):
        """Constrain prod e(Pi, Qi) == 1; pairs = [(g1_pt, g2_emb)] with
        g1_pt symbolic (x,y) and g2_emb an embedded E(Fq12) pair."""
        f12 = self.fp12
        f = None
        for P, embQ in pairs:
            ml = self.miller_loop(embQ, self.embed_g1(P))
            f = ml if f is None else f12.mul(f, ml)
        out = self.final_exp(f)
        f12.assert_eq(out, f12.one(), "pairing_product_one")
        return out

    def generate_witness(self):
        self.fp2.generate_witness()
