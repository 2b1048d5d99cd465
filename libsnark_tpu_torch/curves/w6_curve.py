"""Embedding-degree-6 curve bundle: G2 over Fq, GT in Fq6.

The shape of BW6-761 (reference: Clearmatics BLS12-377/BW6-761 pairing
gadgets, gadgetlib1/gadgets/pairing/bw6_761_bls12_377/): a Cocks-Pinch
outer curve whose SCALAR field equals the inner curve's BASE field, so
inner-curve verifier arithmetic is native in the outer circuit -- the
one-layer proof-composition pattern.
"""
from __future__ import annotations

from ..fields import make_prime_field, make_cubic_ext, make_quadratic_ext
from .host_ec import ECGroup, find_point_from_x
from .pairing import W6PairingEngine
from .curve import FieldParams


class W6Curve:
    """k=6, D=3 curve: E/Fq: y^2 = x^3 + b; twist E'/Fq: y^2 = x^3 + b*xi."""

    g2_field_degree = 1

    def __init__(self, name, q, r, trace, b, xi, g1_cofactor, g2_cofactor,
                 fr_mult_gen, fq_mult_gen, twist_type="M"):
        self.name = name
        self.family = "w6"
        self.q = q
        self.r = r
        self.trace = trace
        self.xi = xi
        self.twist_type = twist_type
        self.g1_cofactor = g1_cofactor
        self.g2_cofactor = g2_cofactor

        self.Fq = make_prime_field(q, f"{name}.Fq")
        self.Fr = make_prime_field(r, f"{name}.Fr")
        self.Fq3 = make_cubic_ext(self.Fq, self.Fq(xi), f"{name}.Fq3")
        v = self.Fq3(self.Fq.zero(), self.Fq.one(), self.Fq.zero())
        self.Fq6 = make_quadratic_ext(self.Fq3, v, f"{name}.Fq6")
        self.GT = self.Fq6

        self.b = self.Fq(b)
        self.b2 = self.Fq(b * xi % q)
        self.G1 = ECGroup(self.Fq, 0, self.b, f"{name}.G1",
                          cofactor=g1_cofactor, order=r)
        self.G2 = ECGroup(self.Fq, 0, self.b2, f"{name}.G2",
                          cofactor=g2_cofactor, order=r)
        self._derive_generator(self.G1, g1_cofactor)
        self._derive_generator(self.G2, g2_cofactor)

        self.pairing_engine = W6PairingEngine(
            self.Fq6, self.G1, self.G2, trace, r, twist_type)

        self.fq_params = FieldParams.build(q, fq_mult_gen)
        self.fr_params = FieldParams.build(r, fr_mult_gen)

    def _derive_generator(self, group, cofactor):
        x = 1
        while True:
            P = find_point_from_x(group, x)
            P = P.mul_unreduced(cofactor)
            if not P.is_zero() and P.mul_unreduced(self.r).is_zero():
                group._generator = (P.x, P.y)
                return
            x += 7

    def pairing(self, P, Q):
        return self.pairing_engine.pairing(P, Q)

    def pairing_check(self, pairs):
        return self.pairing_engine.pairing_check(pairs)

    def __repr__(self):
        return f"W6Curve({self.name})"
