"""MNT4-298 / MNT6-298: the PCD cycle curves.

The reference's recursive proof systems default to this cycle
(common/default_types/r1cs_ppzkpcd_pp.hpp:27-38: MNT4 for the main
predicate, MNT6 for the translation step); the curve constants live in
libff (an empty submodule in the mounted reference), so everything here
is re-derived / re-verified from first principles at import:

  * q and r are the famous MNT 298-bit cycle primes; we VERIFY (rather
    than trust) every structural property: primality is implied by the
    order checks below failing otherwise; the MNT parameterization
    q4 = x^2+x+1, r4 = x^2+1 (trace x+1) and q6 = x^2+1, r6 = x^2+x+1
    (trace 1-x) with one shared x; embedding degrees via
    r | Phi_k(q); curve orders via random-point order checks in the
    test-suite (tests/test_mnt_curves.py).
  * generators are DERIVED (smallest-x points; both groups are
    prime-order so any point generates) -- we intentionally do not claim
    byte-compat with libff's arbitrary generator choice.
  * tower non-residues (17 for MNT4's Fq2, 5 for MNT6's Fq3) are
    asserted to be actual non-residues at import.

MNT curves have a != 0 (generic j-invariant), so only QUADRATIC twists
exist: G2 lives over Fq2 (MNT4, k=4) / Fq3 (MNT6, k=6), and the device
curve kernels carry the a-coefficient term (ops/ec.py).
"""
from __future__ import annotations

from ..fields import make_prime_field, make_quadratic_ext, make_cubic_ext
from .host_ec import ECGroup, find_point_from_x
from .pairing import MNT4PairingEngine, MNT6PairingEngine
from .curve import FieldParams

# the shared MNT parameter x (re-derived in tests from q = x^2+x+1)
X_PARAM = 689871209842287392837045615510547309923794944

Q4 = X_PARAM * X_PARAM + X_PARAM + 1          # MNT4 base field
R4 = X_PARAM * X_PARAM + 1                    # MNT4 scalar field
T4 = X_PARAM + 1                              # MNT4 trace
A4 = 2
B4 = 423894536526684178289416011533888240029318103673896002803341544124054745019340795360841685

Q6, R6, T6 = R4, Q4, 1 - X_PARAM              # the cycle: fields swap
A6 = 11
B6 = 106700080510851735677967319632585352256454251201367587890185989362936000262606668469523074

MNT4_FQ2_NON_RESIDUE = 17
MNT6_FQ3_NON_RESIDUE = 5

assert Q4 + 1 - T4 == R4 and Q6 + 1 - T6 == R6
assert (Q4 * Q4 + 1) % R4 == 0                # k = 4: r | Phi_4(q)
assert (Q6 * Q6 - Q6 + 1) % R6 == 0           # k = 6: r | Phi_6(q)


def _smallest_qnr(p: int) -> int:
    g = 2
    while pow(g, (p - 1) // 2, p) != p - 1:
        g += 1
    return g


class _MNTBase:
    """Shared bundle plumbing for the two cycle curves."""

    def pairing(self, P, Q):
        return self.pairing_engine.pairing(P, Q)

    def pairing_check(self, pairs):
        return self.pairing_engine.pairing_check(pairs)

    def _derive_g1_generator(self):
        P = find_point_from_x(self.G1, 1)
        assert not P.is_zero() and P.mul_unreduced(self.r).is_zero()
        self.G1._generator = (P.x, P.y)
        self.generator_derived = True

    def _derive_g2_generator(self, Fext):
        x = Fext.from_int(1)
        one = Fext.one()
        while True:
            rhs = x * x * x + self.G2.a * x + self.G2.b
            try:
                y = rhs.sqrt()
            except ValueError:
                x = x + one
                continue
            Q = self.G2.point(x, y).mul_unreduced(self.g2_cofactor)
            if not Q.is_zero() and Q.mul_unreduced(self.r).is_zero():
                self.G2._generator = (Q.x, Q.y)
                return
            x = x + one

    def __repr__(self):
        return f"Curve({self.name})"


class MNT4Curve(_MNTBase):
    """k=4 cycle curve: E/Fq: y^2 = x^3 + 2x + b, G2 over Fq2."""

    g2_field_degree = 2
    family = "mnt4"

    def __init__(self):
        self.name = "mnt4"
        self.x_param = X_PARAM
        self.q, self.r, self.trace = Q4, R4, T4
        self.a, self.b = A4, B4
        self.twist_type = "M"
        self.g1_cofactor = 1
        # quadratic twist over Fq2: #E'(Fq2) = q^2 + 1 + (t^2 - 2q)
        n2 = Q4 * Q4 + 1 + (T4 * T4 - 2 * Q4)
        assert n2 % R4 == 0
        self.g2_cofactor = n2 // R4

        self.Fq = make_prime_field(Q4, "mnt4.Fq")
        self.Fr = make_prime_field(R4, "mnt4.Fr")
        nr = self.Fq(MNT4_FQ2_NON_RESIDUE)
        assert pow(MNT4_FQ2_NON_RESIDUE, (Q4 - 1) // 2, Q4) == Q4 - 1, \
            "17 must be a QNR mod q"
        self.Fq2 = make_quadratic_ext(self.Fq, nr, "mnt4.Fq2")
        u = self.Fq2(self.Fq.zero(), self.Fq.one())
        self.Fq4 = make_quadratic_ext(self.Fq2, u, "mnt4.Fq4")
        self.GT = self.Fq4

        self.G1 = ECGroup(self.Fq, A4, self.Fq(B4), "mnt4.G1",
                          cofactor=1, order=R4)
        # u-twist: a' = a*nr in Fq; b' = b*nr*u
        self.a2 = self.Fq2(self.Fq(A4 * MNT4_FQ2_NON_RESIDUE % Q4))
        self.b2 = self.Fq2(self.Fq.zero(),
                           self.Fq(B4 * MNT4_FQ2_NON_RESIDUE % Q4))
        self.G2 = ECGroup(self.Fq2, self.a2, self.b2, "mnt4.G2",
                          cofactor=self.g2_cofactor, order=R4)
        self._derive_g1_generator()
        self._derive_g2_generator(self.Fq2)

        self.pairing_engine = MNT4PairingEngine(
            self.Fq4, self.G1, self.G2, T4, R4, A4)

        self.fq_params = FieldParams.build(Q4, _smallest_qnr(Q4))
        self.fr_params = FieldParams.build(R4, _smallest_qnr(R4))


class MNT6Curve(_MNTBase):
    """k=6 cycle curve: E/Fq: y^2 = x^3 + 11x + b, G2 over Fq3."""

    g2_field_degree = 3
    family = "mnt6"

    def __init__(self):
        self.name = "mnt6"
        self.x_param = X_PARAM
        self.q, self.r, self.trace = Q6, R6, T6
        self.a, self.b = A6, B6
        self.twist_type = "M"
        self.g1_cofactor = 1
        # quadratic twist over Fq3: #E'(Fq3) = q^3 + 1 + (t^3 - 3qt)
        t3 = T6 ** 3 - 3 * Q6 * T6
        n3 = Q6 ** 3 + 1 + t3
        assert n3 % R6 == 0
        self.g2_cofactor = n3 // R6

        self.Fq = make_prime_field(Q6, "mnt6.Fq")
        self.Fr = make_prime_field(R6, "mnt6.Fr")
        assert Q6 % 3 == 1 and pow(MNT6_FQ3_NON_RESIDUE,
                                   (Q6 - 1) // 3, Q6) != 1, \
            "5 must be a cubic non-residue mod q"
        nr = self.Fq(MNT6_FQ3_NON_RESIDUE)
        self.Fq3 = make_cubic_ext(self.Fq, nr, "mnt6.Fq3")
        v = self.Fq3(self.Fq.zero(), self.Fq.one(), self.Fq.zero())
        self.Fq6 = make_quadratic_ext(self.Fq3, v, "mnt6.Fq6")
        self.GT = self.Fq6

        self.G1 = ECGroup(self.Fq, A6, self.Fq(B6), "mnt6.G1",
                          cofactor=1, order=R6)
        # v-twist: a' = a*v^2 = (0,0,a); b' = b*v^3 = b*nr in Fq
        self.a2 = self.Fq3(self.Fq.zero(), self.Fq.zero(), self.Fq(A6))
        self.b2 = self.Fq3(self.Fq(B6 * MNT6_FQ3_NON_RESIDUE % Q6))
        self.G2 = ECGroup(self.Fq3, self.a2, self.b2, "mnt6.G2",
                          cofactor=self.g2_cofactor, order=R6)
        self._derive_g1_generator()
        self._derive_g2_generator(self.Fq3)

        self.pairing_engine = MNT6PairingEngine(
            self.Fq6, self.G1, self.G2, T6, R6, A6)

        self.fq_params = FieldParams.build(Q6, _smallest_qnr(Q6))
        self.fr_params = FieldParams.build(R6, _smallest_qnr(R6))


def build_mnt4():
    return MNT4Curve()


def build_mnt6():
    return MNT6Curve()
