"""The reference's "edwards" curve: an 80-bit-security pairing-friendly
twisted Edwards curve with embedding degree 6 (libff edwards_pp; the
constants live in the reference's empty libff submodule, so — as with
the MNT cycle (curves/mnt.py) — the famous parameters are re-stated and
every structural property is VERIFIED rather than trusted, at import
and in tests/test_edwards.py).

The curve in Edwards form is  x^2 + y^2 = 1 + d x^2 y^2  over Fq with
#E = 4r (cofactor 4 — the reason an Edwards form exists at all).

TPU-first design: the *internal* representation is the birationally
equivalent short Weierstrass curve, so G1/G2/pairing/MSM reuse the
generic k=6 machinery (the same ate engine as MNT6: quadratic twist
over Fq3, GT in Fq6); the Edwards form is exposed as `EdwardsForm`
with the COMPLETE unified addition law (branch-free — the natural fit
for SIMD lanes) plus the birational maps both ways. Verified: the map
is a group isomorphism and the engine is bilinear (test_edwards.py).

Derivation chain (verified at import):
  Edwards(1, d)  ->  Montgomery(A, B):  A = 2(1+d)/(1-d), B = 4/(1-d)
                 ->  Weierstrass(a4, a6):
                       a4 = (3 - A^2)/(3 B^2),  a6 = (2A^3 - 9A)/(27 B^3)
  maps: (x, y) -> u = (1+y)/(1-y), v = u/x;  X = (3u + A)/(3B), Y = v/B.
"""
from __future__ import annotations

from ..fields import make_prime_field, make_cubic_ext, make_quadratic_ext
from .host_ec import ECGroup, find_point_from_x
from .pairing import MNT6PairingEngine
from .curve import FieldParams
from .mnt import _MNTBase, _smallest_qnr

Q = 6210044120409721004947206240885978274523751269793792001
R = 1552511030102430251236801561344621993261920897571225601
D = 600581931845324488256649384912508268813600056237543024
TRACE = Q + 1 - 4 * R                     # negative, ~2^92
COFACTOR = 4

# 61 is simultaneously a cubic non-residue (Fq3 = Fq[v]/(v^3-61)) and a
# quadratic non-residue (so v, whose norm is 61, is a non-square in Fq3
# and Fq6 = Fq3[w]/(w^2 - v) is a field)
EDWARDS_FQ3_NON_RESIDUE = 61

# structural verification (the recalled constants are self-checking:
# a wrong q/r/d fails one of these)
assert (Q * Q - Q + 1) % R == 0, "embedding degree 6: r | Phi_6(q)"
assert pow(D, (Q - 1) // 2, Q) == Q - 1, \
    "d must be a non-square (completeness of the Edwards addition law)"
assert Q % 3 == 1
assert pow(EDWARDS_FQ3_NON_RESIDUE, (Q - 1) // 3, Q) != 1
assert pow(EDWARDS_FQ3_NON_RESIDUE, (Q - 1) // 2, Q) == Q - 1

_inv = lambda x: pow(x % Q, Q - 2, Q)
MONT_A = 2 * (1 + D) * _inv(1 - D) % Q
MONT_B = 4 * _inv(1 - D) % Q
A4 = (3 - MONT_A * MONT_A) * _inv(3 * MONT_B * MONT_B) % Q
A6 = (2 * MONT_A ** 3 - 9 * MONT_A) * _inv(27 * MONT_B ** 3) % Q


class EdwardsForm:
    """The curve in its native twisted Edwards coordinates: COMPLETE
    unified addition (no branches, no exceptional cases — every input
    pair uses the same formula because d is a non-square), plus the
    birational maps to/from the internal Weierstrass G1.

    Points are affine (x, y) tuples; identity is (0, 1)."""

    def __init__(self, curve: "EdwardsCurve"):
        self.curve = curve
        self.d = D
        self.identity = (0, 1)

    def is_on_curve(self, P) -> bool:
        x, y = P
        return (x * x + y * y - 1 - self.d * x * x * y * y) % Q == 0

    def add(self, P, Q_):
        """Complete unified addition — also correct for P == Q_ and for
        inputs involving the identity or order-2/4 points."""
        x1, y1 = P
        x2, y2 = Q_
        t = self.d * x1 * x2 % Q * y1 % Q * y2 % Q
        x3 = (x1 * y2 + y1 * x2) * _inv(1 + t) % Q
        y3 = (y1 * y2 - x1 * x2) * _inv(1 - t) % Q
        return (x3, y3)

    def neg(self, P):
        return (-P[0] % Q, P[1])

    def mul(self, P, k: int):
        k %= 4 * R
        Rp = self.identity
        while k:
            if k & 1:
                Rp = self.add(Rp, P)
            P = self.add(P, P)
            k >>= 1
        return Rp

    # -- birational maps ---------------------------------------------------
    def to_weierstrass(self, P):
        """Edwards -> internal Weierstrass G1 point. Exceptional inputs:
        identity -> zero; (0, -1) (the order-2 point) -> (A/3B, 0)."""
        x, y = P
        G1 = self.curve.G1
        if x == 0 and y % Q == 1:
            return G1.zero()
        if x == 0:                          # (0, -1): order 2
            return G1.point(self.curve.Fq(MONT_A * _inv(3 * MONT_B) % Q),
                            self.curve.Fq(0))
        u = (1 + y) * _inv(1 - y) % Q
        v = u * _inv(x) % Q
        X = (3 * u + MONT_A) * _inv(3 * MONT_B) % Q
        Y = v * _inv(MONT_B) % Q
        return G1.point(self.curve.Fq(X), self.curve.Fq(Y))

    def from_weierstrass(self, W):
        """Inverse map. The zero point -> identity; (A/3B, 0) -> (0,-1);
        the two order-4 points with u = 0 have y = -1 exceptions handled
        by the general formula (u=0 -> x=0 case only for v=0)."""
        if W.is_zero():
            return self.identity
        X, Y = int(W.x), int(W.y)
        u = (3 * MONT_B * X - MONT_A) * _inv(3) % Q
        v = MONT_B * Y % Q
        if v == 0 and u == 0:
            return (0, Q - 1)
        x = u * _inv(v) % Q
        y = (u - 1) * _inv(u + 1) % Q
        return (x, y)

    def random_point(self, seed: int = 0):
        x = seed
        while True:
            den = (1 - self.d * x * x) % Q
            num = (1 - x * x) % Q
            y2 = num * _inv(den) % Q
            if pow(y2, (Q - 1) // 2, Q) == 1:
                y = int(self.curve.Fq(y2).sqrt())
                return (x, y)
            x += 1


class EdwardsCurve(_MNTBase):
    """k=6 curve bundle (internal Weierstrass form; Edwards form via
    .edwards). Same engine shape as MNT6: quadratic twist over Fq3,
    GT = Fq6, ate loop |t-1| (~2^92 — the cheapest pairing in the
    registry)."""

    g2_field_degree = 3
    family = "mnt6"          # dispatches the generic k=6 machinery

    def __init__(self):
        self.name = "edwards"
        self.q, self.r, self.trace = Q, R, TRACE
        self.a, self.b = A4, A6
        self.twist_type = "M"
        self.g1_cofactor = COFACTOR
        t3 = TRACE ** 3 - 3 * Q * TRACE
        n3 = Q ** 3 + 1 + t3
        assert n3 % R == 0
        self.g2_cofactor = n3 // R

        self.Fq = make_prime_field(Q, "edwards.Fq")
        self.Fr = make_prime_field(R, "edwards.Fr")
        nr = self.Fq(EDWARDS_FQ3_NON_RESIDUE)
        self.Fq3 = make_cubic_ext(self.Fq, nr, "edwards.Fq3")
        v = self.Fq3(self.Fq.zero(), self.Fq.one(), self.Fq.zero())
        self.Fq6 = make_quadratic_ext(self.Fq3, v, "edwards.Fq6")
        self.GT = self.Fq6

        self.G1 = ECGroup(self.Fq, A4, self.Fq(A6), "edwards.G1",
                          cofactor=COFACTOR, order=R)
        # v-twist: a' = a*v^2 = (0,0,a); b' = b*v^3 = b*nr in Fq
        self.a2 = self.Fq3(self.Fq.zero(), self.Fq.zero(), self.Fq(A4))
        self.b2 = self.Fq3(
            self.Fq(A6 * EDWARDS_FQ3_NON_RESIDUE % Q))
        self.G2 = ECGroup(self.Fq3, self.a2, self.b2, "edwards.G2",
                          cofactor=self.g2_cofactor, order=R)
        self._derive_g1_generator_cofactor()
        self._derive_g2_generator(self.Fq3)

        self.pairing_engine = MNT6PairingEngine(
            self.Fq6, self.G1, self.G2, TRACE, R, A4)

        self.edwards = EdwardsForm(self)

        self.fq_params = FieldParams.build(Q, _smallest_qnr(Q))
        self.fr_params = FieldParams.build(R, _smallest_qnr(R))

    def _derive_g1_generator_cofactor(self):
        """Smallest-x point, cleared by the cofactor (G1 has cofactor 4,
        unlike the prime-order MNT curves)."""
        x = 1
        while True:
            xf = self.Fq.from_int(x)
            rhs = xf * xf * xf + self.G1.a * xf + self.G1.b
            try:
                y = rhs.sqrt()
            except ValueError:
                x += 1
                continue
            G = self.G1.point(xf, y).mul_unreduced(COFACTOR)
            if not G.is_zero() and G.mul_unreduced(self.r).is_zero():
                self.G1._generator = (G.x, G.y)
                self.generator_derived = True
                return
            x += 1


def build():
    return EdwardsCurve()
