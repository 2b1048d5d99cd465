"""In-circuit curve-equation + subgroup membership checks for
BLS12-377 G1/G2 variables (reference gadgetlib1/gadgets/pairing/
bw6_761_bls12_377/bls12_377_membership_check_gadgets.hpp).

G1 (reference bls12_377_G1_membership_check_gadget): witness P' with
[h1] P' = P; constrain P' on-curve and the cofactor multiple. Any point
satisfying this lies in the order-r subgroup (h1 * r = #E(Fq)).

G2 (reference bls12_377_G2_membership_check_gadget, following libff's
is_in_safe_subgroup): constrain P on-curve and
    P + [t](psi(P) - P) = psi^2(P)
where psi is the untwist-Frobenius-twist endomorphism. psi acts on
coordinates as a CONSTANT Fp2 multiple of the Fp2-conjugate
(psi(x, y) = (c_x * conj(x), c_y * conj(y))) -- conjugation and
constant multiplication are both linear, so psi costs zero constraints.
The constants are derived host-side from the tower (frob(w^k)/w^k), not
hard-coded.
"""
from __future__ import annotations

from .fields_gadgets import _lc
from .curve_scalar_mul import G1Ops, G2Ops, ScalarMulGadgets, VarOrIdentity


def psi_constants(curve):
    """(c_x, c_y): host Fq2 constants with
    psi(x, y) = (c_x * x^q, c_y * y^q) for the D-twist G2."""
    eng = curve.pairing_engine
    w2q = eng._w2.frobenius(1)
    w3q = eng._w3.frobenius(1)
    cx12 = w2q / eng._w2
    cy12 = w3q / eng._w3
    # both live in the Fq2 c0.c0 slot of the tower
    for e in (cx12, cy12):
        assert e.c1.is_zero() and e.c0.c1.is_zero() and e.c0.c2.is_zero(), \
            "psi constant does not collapse to Fq2"
    return cx12.c0.c0, cy12.c0.c0


def psi_host(curve, Q):
    """Endomorphism on host G2 points (for witnesses and tests)."""
    cx, cy = psi_constants(curve)
    F2 = curve.Fq2
    conj = lambda e: F2(e.c0, -e.c1)
    if Q.is_zero():
        return Q
    return curve.G2.point(cx * conj(Q.x), cy * conj(Q.y))


class G1MembershipCheckGadget:
    """P on-curve and in the order-r subgroup: witness P' = [1/h1] P,
    constrain P' on-curve and [h1] P' == P."""

    def __init__(self, pb, inner_curve, g1, P, prefix="g1member"):
        self.pb = pb
        self.curve = inner_curve
        self.ops = G1Ops(g1, inner_curve)
        self.sm = ScalarMulGadgets(self.ops)
        self.P = P
        h = int(inner_curve.g1_cofactor)
        assert h > 1
        self.h = h
        # witnessed preimage P'
        self.Pp = (g1._var("ppx"), g1._var("ppy"))
        Pp_lc = (_lc(self.Pp[0]), _lc(self.Pp[1]))
        self.ops.checker(Pp_lc, prefix + "_pp_curve")
        hP = self.sm.mul_by_const_scalar(h, Pp_lc, prefix + "_cof")
        pb.add_r1cs_constraint(1, hP[0] - P[0], 0, prefix + "_x")
        pb.add_r1cs_constraint(1, hP[1] - P[1], 0, prefix + "_y")

    def generate_witness(self, P_host):
        r = self.curve.r
        hinv = pow(self.h, -1, r)
        Pp = P_host * hinv
        self.pb.setval(self.Pp[0], int(Pp.x))
        self.pb.setval(self.Pp[1], int(Pp.y))


class G2MembershipCheckGadget:
    """P on-curve and P + [t](psi(P) - P) == psi^2(P) (libff
    bls12_377_G2::is_in_safe_subgroup parity)."""

    def __init__(self, pb, inner_curve, g2, P, prefix="g2member"):
        self.pb = pb
        self.curve = inner_curve
        self.ops = G2Ops(g2, inner_curve)
        self.sm = ScalarMulGadgets(self.ops)
        f = g2.fp2
        self.ops.checker(P, prefix + "_curve")
        cx, cy = psi_constants(inner_curve)

        def psi(Q):
            # conj is linear; constant Fp2 multiply is linear
            xc = (Q[0][0], -Q[0][1])
            yc = (Q[1][0], -Q[1][1])
            return (f.mul_const(xc, int(cx.c0), int(cx.c1)),
                    f.mul_const(yc, int(cy.c0), int(cy.c1)))

        psiP = psi(P)
        psi2P = psi(psiP)
        # t = Frobenius trace x + 1: psi satisfies psi^2 - t*psi + q = 0
        # and q = x mod r, so 1 + t*(q - 1) - q^2 = 0 mod r -- the
        # characteristic identity [h?]P = 0 reduces to the check below
        # exactly on the order-r subgroup (libff is_in_safe_subgroup)
        t = abs(int(inner_curve.x_param)) + 1
        d = g2.add(psiP, g2.neg(P))          # psi(P) - P
        td = self.sm.mul_by_const_scalar(t, d, prefix + "_t")
        lhs = g2.add(P, td)
        for c in range(2):
            pb.add_r1cs_constraint(1, lhs[0][c] - psi2P[0][c], 0,
                                   prefix + f"_x{c}")
            pb.add_r1cs_constraint(1, lhs[1][c] - psi2P[1][c], 0,
                                   prefix + f"_y{c}")

    def generate_witness(self):
        pass  # all witnesses ride the shared fp2 queue
