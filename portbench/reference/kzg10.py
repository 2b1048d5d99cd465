"""Plain reference of a KZG10 commitment and opening, worked out in the
exponent.

With the SRS [tau^i]_1 made from the secret tau, the commitment to
f = sum_i f_i x^i is [f(tau)]_1, the opening at z is the value f(z), and
its witness is [q(tau)]_1 for q(x) = (f(x) - f(z)) / (x - z), so
q(tau) = (f(tau) - f(z)) / (tau - z). Every equality is exact.
"""
from __future__ import annotations

from .ec import Curve


def evaluate(coeffs, x: int, r: int) -> int:
    """f(x) by Horner's rule over the coefficients f_0, f_1, ..."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % r
    return acc


def commit_and_open(curve: Curve, tau: int, coeffs, z: int) -> tuple:
    """(commitment, value, witness): affine G1 points and an int."""
    r = curve.r
    f_tau = evaluate(coeffs, tau, r)
    v = evaluate(coeffs, z, r)
    q_tau = (f_tau - v) * pow((tau - z) % r, -1, r) % r
    return curve.G1.mul(f_tau), v, curve.G1.mul(q_tau)
