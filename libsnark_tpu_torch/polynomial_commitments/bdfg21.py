"""BDFG21 multi-point multi-polynomial openings (the port of
libsnark_tpu/polynomial_commitments/bdfg21.py; reference
polynomial_commitments/bdfg21.{hpp,tcc}, [BDFG21] section 4.1,
"plonk-style" openings).

Each polynomial set f_sets[j] is opened at point T[j]. Two-phase
witness: W = [ (f/Z_T)(x) ]_1 from the gamma-combined difference
polynomials, then (after challenge z) W' = [ (L/(X-z))(x) ]_1.
Verification: one two-pairing check.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .kzg10 import KZG10
from .polynomial_ops import (
    poly_eval, poly_add, poly_scalar_mul, poly_divide_by_linear)


@dataclasses.dataclass
class BDFG21Phase1Output:
    public_witness_phase_1: object     # host G1 (W)
    private_f_over_Z_T: List[int]      # polynomial coefficients


@dataclasses.dataclass
class BDFG21EvaluationWitness:
    W: object
    W_prime: object


def _accumulate_with_start(polys, start_factor: int, factor: int, r: int):
    """start_factor * sum_i factor^i * polys[i]."""
    acc: List[int] = []
    alpha = start_factor % r
    for f in polys:
        acc = poly_add(acc, poly_scalar_mul(f, alpha, r), r)
        alpha = alpha * factor % r
    return acc


def _f_minus_r_polynomial(f_set, evals, start_factor, factor, r):
    """start_factor * sum factor^i (f_i(X) - f_i(z_j))
    (bdfg21.tcc:117-160)."""
    A = _accumulate_with_start(f_set, start_factor, factor, r)
    alpha = start_factor % r
    B = 0
    for e in evals:
        B = (B + alpha * e) % r
        alpha = alpha * factor % r
    if not A:
        A = [0]
    A[0] = (A[0] - B) % r
    return A


def _z_t_minus_z_j_values(T, z, r):
    """Y[j] = prod_{i != j} (z - T[i]) (bdfg21.tcc:69-103)."""
    n = len(T)
    Y = [1] * n
    for i in range(1, n):
        Y[i] = Y[i - 1] * (z - T[i - 1]) % r
    zz = 1
    for i in range(n - 2, -1, -1):
        zz = zz * (z - T[i + 1]) % r
        Y[i] = Y[i] * zz % r
    return Y


class BDFG21:
    def __init__(self, kzg: KZG10):
        self.kzg = kzg
        self.r = kzg.curve.r

    def evaluate_polynomials(self, f_sets, z_s):
        r = self.r
        return [[poly_eval(f, z, r) for f in fset]
                for fset, z in zip(f_sets, z_s)]

    def create_evaluation_witness_phase_1(self, f_sets, T, evaluations,
                                          srs, gamma):
        r = self.r
        f_over_Z_T: List[int] = [0]
        gamma_power = 1
        for j, z_j in enumerate(T):
            H_j = _f_minus_r_polynomial(
                f_sets[j], evaluations[j], gamma_power, gamma, r)
            G_j, rem = poly_divide_by_linear(H_j, z_j, r)
            if rem != 0:
                raise ValueError("H_j not divisible by (X - z_j): the "
                                 "evaluations do not match the polynomials")
            f_over_Z_T = poly_add(f_over_Z_T, G_j, r)
            gamma_power = gamma_power * pow(gamma, len(f_sets[j]), r) % r
        W = self.kzg.commit(srs, f_over_Z_T).point
        return BDFG21Phase1Output(public_witness_phase_1=W,
                                  private_f_over_Z_T=f_over_Z_T)

    def create_evaluation_witness(self, f_sets, T, evaluations, srs,
                                  gamma, phase_1_out, z):
        r = self.r
        Y = _z_t_minus_z_j_values(T, z, r)
        Z_T_at_z = Y[0] * (z - T[0]) % r
        L = poly_scalar_mul(phase_1_out.private_f_over_Z_T,
                            (-Z_T_at_z) % r, r)
        gamma_power = 1
        for j in range(len(T)):
            H_j = _f_minus_r_polynomial(
                f_sets[j], evaluations[j], gamma_power * Y[j] % r, gamma, r)
            L = poly_add(L, H_j, r)
            gamma_power = gamma_power * pow(gamma, len(f_sets[j]), r) % r
        L_q, rem = poly_divide_by_linear(L, z, r)
        if rem != 0:
            raise ValueError("L(z) != 0: the evaluations do not match the "
                             "polynomials")
        W_prime = self.kzg.commit(srs, L_q).point
        return BDFG21EvaluationWitness(
            W=phase_1_out.public_witness_phase_1, W_prime=W_prime)

    def verify_evaluations(self, T, evaluations, srs, gamma, z, witness,
                           cm_sets) -> bool:
        curve = self.kzg.curve
        r = self.r
        Y = _z_t_minus_z_j_values(T, z, r)
        Z_T_at_z = Y[0] * (z - T[0]) % r
        gamma_power = 1
        G = curve.G1.zero()
        H = 0
        for j in range(len(T)):
            for cm, e in zip(cm_sets[j], evaluations[j]):
                factor = gamma_power * Y[j] % r
                G = G + cm.point * factor
                H = (H + factor * e) % r
                gamma_power = gamma_power * gamma % r
        F = G - curve.G1.one() * H - witness.W * Z_T_at_z
        # e(F + z W', [1]_2) = e(W', [x]_2)
        return curve.pairing_check([
            (F + witness.W_prime * z, curve.G2.one()),
            (-witness.W_prime, srs.alpha_g2),
        ])
