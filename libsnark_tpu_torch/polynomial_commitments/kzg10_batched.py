"""Batched 2-point KZG openings (the port of
libsnark_tpu/polynomial_commitments/kzg10_batched.py; reference
polynomial_commitments/kzg10_batched.{hpp,tcc}, [GWC19] section 3).

Two polynomial sets fs, gs opened at z_1, z_2 with challenges
gamma_1, gamma_2; witness = 2 G1 elements; verification = one
double-pairing check with verifier randomness r.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .kzg10 import KZG10
from .polynomial_ops import (
    poly_eval, poly_accumulate_with_power_factors)


@dataclasses.dataclass
class BatchedEvaluations:
    s_1s: List[int]
    s_2s: List[int]


@dataclasses.dataclass
class BatchedEvaluationWitness:
    W_1: object    # host G1
    W_2: object


class KZG10Batched2Point:
    """kzg10_batched_2_point<ppT> equivalent, sharing KZG10's device MSM."""

    def __init__(self, kzg: KZG10):
        self.kzg = kzg
        self.r = kzg.curve.r

    def evaluate_polynomials(self, fs, gs, z_1: int, z_2: int):
        r = self.r
        return BatchedEvaluations(
            s_1s=[poly_eval(f, z_1, r) for f in fs],
            s_2s=[poly_eval(g, z_2, r) for g in gs])

    def create_evaluation_witness(self, fs, gs, z_1, z_2, evaluations,
                                  srs, gamma_1, gamma_2):
        r = self.r
        f_accum = poly_accumulate_with_power_factors(fs, gamma_1, r)
        f_accum_eval = poly_eval(evaluations.s_1s, gamma_1, r)
        _, W_1 = self.kzg.create_evaluation_witness(srs, f_accum, z_1)
        g_accum = poly_accumulate_with_power_factors(gs, gamma_2, r)
        g_accum_eval = poly_eval(evaluations.s_2s, gamma_2, r)
        _, W_2 = self.kzg.create_evaluation_witness(srs, g_accum, z_2)
        # the accumulated evaluations must match the witness values
        if (poly_eval(f_accum, z_1, r) != f_accum_eval
                or poly_eval(g_accum, z_2, r) != g_accum_eval):
            raise ValueError("evaluations do not match the polynomials")
        return BatchedEvaluationWitness(W_1=W_1.point, W_2=W_2.point)

    def verify_evaluations(self, z_1, z_2, evaluations, srs, gamma_1,
                           gamma_2, witness, cm_1s, cm_2s, r_rand) -> bool:
        """kzg10_batched.tcc:218-302: one double-pairing check."""
        curve = self.kzg.curve
        r = self.r
        s1, s2 = evaluations.s_1s, evaluations.s_2s
        t1, t2 = len(cm_1s), len(cm_2s)
        if t1 != len(s1) or t2 != len(s2):
            raise ValueError("one evaluation per commitment is required")

        s_1_accum = s1[t1 - 1] % r
        cm_1_accum = cm_1s[t1 - 1].point
        for i in range(t1 - 2, -1, -1):
            cm_1_accum = cm_1_accum * gamma_1 + cm_1s[i].point
            s_1_accum = (s_1_accum * gamma_1 + s1[i]) % r
        G = cm_1_accum - curve.G1.one() * s_1_accum

        s_2_accum = s2[t2 - 1] % r
        cm_2_accum = cm_2s[t2 - 1].point
        for i in range(t2 - 2, -1, -1):
            cm_2_accum = cm_2_accum * gamma_2 + cm_2s[i].point
            s_2_accum = (s_2_accum * gamma_2 + s2[i]) % r
        H = (cm_2_accum - curve.G1.one() * s_2_accum) * r_rand

        F = G + H
        r_W_2 = witness.W_2 * r_rand
        A = F + witness.W_1 * z_1 + r_W_2 * z_2
        C = -(witness.W_1 + r_W_2)
        return curve.pairing_check([
            (A, curve.G2.one()),
            (C, srs.alpha_g2),
        ])
