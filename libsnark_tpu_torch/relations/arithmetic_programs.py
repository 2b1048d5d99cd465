"""QAP / SAP / SSP instance, evaluation, and witness classes.

Host-side mirrors of the reference's arithmetic-program relations
(relations/arithmetic_programs/{qap/qap.hpp:51-167, sap/sap.hpp:47-155,
ssp/ssp.hpp:46-147}): instances in Lagrange basis (sparse dict maps),
instances evaluated at a secret t, and witnesses holding the H
coefficients. Satisfaction checks are the divisibility identities
  QAP:  A(t)B(t) - C(t) = H(t)Z(t)
  SAP:  A(t)^2   - C(t) = H(t)Z(t)
  SSP:  V(t)^2   - 1    = H(t)Z(t)
with the ZK shifts d1/d2/d3 folded in exactly as the reference does
(qap.tcc:89-115 and the sap/ssp analogues). These run at test/debug time;
the prover-side witness maps are the device pipelines in reductions/.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


# --------------------------------------------------------------------- QAP

@dataclasses.dataclass
class QAPInstance:
    """A/B/C in Lagrange basis: list (per variable) of {row: coeff}."""
    p: int
    degree: int
    num_inputs: int
    num_variables: int
    A: List[Dict[int, int]]
    B: List[Dict[int, int]]
    C: List[Dict[int, int]]


@dataclasses.dataclass
class QAPWitness:
    d1: int
    d2: int
    d3: int
    num_inputs: int
    num_variables: int
    degree: int
    coefficients_for_ABCs: List[int]   # the variable assignment (len nv)
    coefficients_for_H: List[int]      # len degree + 1


def qap_eval_is_satisfied(qap_eval, wit: QAPWitness, p: int) -> bool:
    """qap_eval: QAPInstanceEvaluation (reductions/r1cs_to_qap.py) or any
    object with At/Bt/Ct/Ht/Zt/t/degree/num_variables fields."""
    if wit.num_variables != qap_eval.num_variables:
        return False
    full = [1] + [v % p for v in wit.coefficients_for_ABCs]
    ans_A = (qap_eval.At[0] + wit.d1 * qap_eval.Zt) % p
    ans_B = (qap_eval.Bt[0] + wit.d2 * qap_eval.Zt) % p
    ans_C = (qap_eval.Ct[0] + wit.d3 * qap_eval.Zt) % p
    for i in range(1, wit.num_variables + 1):
        ans_A = (ans_A + full[i] * qap_eval.At[i]) % p
        ans_B = (ans_B + full[i] * qap_eval.Bt[i]) % p
        ans_C = (ans_C + full[i] * qap_eval.Ct[i]) % p
    ans_H = 0
    for i, h in enumerate(wit.coefficients_for_H):
        ans_H = (ans_H + h * qap_eval.Ht[i]) % p
    return (ans_A * ans_B - ans_C - ans_H * qap_eval.Zt) % p == 0


# --------------------------------------------------------------------- SAP

@dataclasses.dataclass
class SAPInstanceEvaluation:
    """A_i(t), C_i(t), t^i, Z(t) for the square arithmetic program."""
    t: int
    At: List[int]
    Ct: List[int]
    Ht: List[int]            # t^0 .. t^degree
    Zt: int
    degree: int
    num_inputs: int
    num_variables: int


@dataclasses.dataclass
class SAPWitness:
    d1: int
    d2: int
    num_inputs: int
    num_variables: int
    degree: int
    coefficients_for_ACs: List[int]    # extended assignment (len nv)
    coefficients_for_H: List[int]      # len degree + 1


def sap_eval_is_satisfied(sap_eval: SAPInstanceEvaluation,
                          wit: SAPWitness, p: int) -> bool:
    if wit.num_variables != sap_eval.num_variables:
        return False
    full = [1] + [v % p for v in wit.coefficients_for_ACs]
    ans_A = (sap_eval.At[0] + wit.d1 * sap_eval.Zt) % p
    ans_C = (sap_eval.Ct[0] + wit.d2 * sap_eval.Zt) % p
    for i in range(1, wit.num_variables + 1):
        ans_A = (ans_A + full[i] * sap_eval.At[i]) % p
        ans_C = (ans_C + full[i] * sap_eval.Ct[i]) % p
    ans_H = 0
    for i, h in enumerate(wit.coefficients_for_H):
        ans_H = (ans_H + h * sap_eval.Ht[i]) % p
    return (ans_A * ans_A - ans_C - ans_H * sap_eval.Zt) % p == 0


# --------------------------------------------------------------------- SSP

@dataclasses.dataclass
class SSPInstanceEvaluation:
    t: int
    Vt: List[int]            # V_i(t) for 0..nv, PLUS Z(t) appended by caller
    Ht: List[int]
    Zt: int
    degree: int
    num_inputs: int
    num_variables: int


@dataclasses.dataclass
class SSPWitness:
    d: int
    num_inputs: int
    num_variables: int
    degree: int
    coefficients_for_Vs: List[int]
    coefficients_for_H: List[int]


def ssp_eval_is_satisfied(ssp_eval: SSPInstanceEvaluation,
                          wit: SSPWitness, p: int) -> bool:
    if wit.num_variables != ssp_eval.num_variables:
        return False
    full = [1] + [v % p for v in wit.coefficients_for_Vs]
    ans_V = (ssp_eval.Vt[0] + wit.d * ssp_eval.Zt) % p
    for i in range(1, wit.num_variables + 1):
        ans_V = (ans_V + full[i] * ssp_eval.Vt[i]) % p
    ans_H = 0
    for i, h in enumerate(wit.coefficients_for_H):
        ans_H = (ans_H + h * ssp_eval.Ht[i]) % p
    return (ans_V * ans_V - 1 - ans_H * ssp_eval.Zt) % p == 0
