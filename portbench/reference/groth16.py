"""Plain reference of a Groth16 proof (r1cs_gg_ppzksnark), worked out in
the exponent.

The benchmark knows the set-up's secrets (t, alpha, beta, gamma, delta)
and each proof's randomness (r, s), so the proof's three group elements
are [a]_1, [b]_2 and [c]_1 for scalars that plain field arithmetic gives:

  a = alpha + A(t) + r delta
  b = beta + B(t) + s delta
  c = (A(t) B(t) - C(t) + sum_{i > k} w_i (beta u_i(t) + alpha v_i(t)
       + c_i(t))) / delta + s a + r b - r s delta

with u_i, v_i, c_i the QAP's polynomials of variable i evaluated at t
and A(t) = sum_i w_i u_i(t) (likewise B, C). A(x) B(x) - C(x) = h(x) Z(x)
for a satisfying witness, so the first term is what the H query
carries. The QAP is libsnark's r1cs_to_qap: constraint j at the j-th
point of the radix-2 domain of size m >= n + k + 1, then the input
consistency rows (A_{n+i} = x_i for i = 0..k), with A and B swapped
first when B holds more distinct auxiliary variables
(r1cs_constraint_system::swap_AB_if_beneficial). Every equality is exact.
"""
from __future__ import annotations

import operator
import random

from .ec import Curve


def lagrange_at(t: int, m: int, omega: int, r: int) -> list:
    """L_j(t) over the radix-2 domain {omega^j}: (t^m - 1) / m omega^j /
    (t - omega^j), the inverses by one batched inversion."""
    Z = (pow(t, m, r) - 1) % r
    if Z == 0:
        raise ValueError("t lies on the domain")
    dens, w = [], 1
    for _ in range(m):
        dens.append((t - w) % r)
        w = w * omega % r
    prefix, acc = [], 1
    for d in dens:
        prefix.append(acc)
        acc = acc * d % r
    inv = pow(acc, -1, r)
    out = [0] * m
    for j in range(m - 1, -1, -1):
        out[j] = inv * prefix[j] % r
        inv = inv * dens[j] % r
    lead = Z * pow(m, -1, r) % r
    w = 1
    for j in range(m):
        out[j] = out[j] * lead % r * w % r
        w = w * omega % r
    return out


def _distinct_aux(mat, k: int) -> int:
    return len({c for c in mat[1] if c > k})


class QAPAtT:
    """u_i(t), v_i(t), c_i(t) for every variable i (0 is the constant 1)."""

    def __init__(self, curve: Curve, circuit, t: int):
        r = curve.r
        n, k = circuit.num_constraints, circuit.num_inputs
        nv = circuit.num_inputs + circuit.num_aux
        m = n + k + 1
        if m & (m - 1):
            # libfqfft's basic radix-2 domain; other sizes take other domains
            raise ValueError(f"n + k + 1 = {m} is not a power of two")
        A, B, C = circuit.A, circuit.B, circuit.C
        if _distinct_aux(B, k) > _distinct_aux(A, k):
            A, B = B, A
        L = lagrange_at(t, m, curve.root_of_unity(m), r)
        self.m = m
        self.Zt = (pow(t, m, r) - 1) % r
        self.polys = []
        for mat in (A, B, C):
            acc = [0] * (nv + 1)
            for row, col, coeff in zip(*mat):
                acc[col] += coeff * L[row]
            self.polys.append([v % r for v in acc])
        u = self.polys[0]
        for i in range(k + 1):
            u[i] = (u[i] + L[n + i]) % r


def proof_scalars(curve: Curve, qap: QAPAtT, num_inputs: int,
                  secrets: dict, primary: list, auxiliary: list,
                  rnd_r: int, rnd_s: int) -> tuple:
    """(a, b, c): the discrete logarithms of the proof's elements."""
    r = curve.r
    w = [1] + [v % r for v in primary] + [v % r for v in auxiliary]
    k = num_inputs
    alpha, beta, delta = secrets["alpha"], secrets["beta"], secrets["delta"]
    At, Bt, Ct = (sum(map(operator.mul, w, p)) % r for p in qap.polys)
    pub = [sum(map(operator.mul, w[:k + 1], p[:k + 1])) % r
           for p in qap.polys]
    l_part = (beta * (At - pub[0]) + alpha * (Bt - pub[1])
              + (Ct - pub[2])) % r
    a = (alpha + At + rnd_r * delta) % r
    b = (beta + Bt + rnd_s * delta) % r
    c = ((At * Bt - Ct + l_part) * pow(delta, -1, r) + rnd_s * a
         + rnd_r * b - rnd_r * rnd_s % r * delta) % r
    return a, b, c


def proof_randomness(curve: Curve, seed: int) -> tuple:
    """(r, s) of a proof made with ``prover(..., seed=seed)``: the prover's
    documented draw, random.Random(seed).randrange(r) twice."""
    rng = random.Random(seed)
    return rng.randrange(curve.r), rng.randrange(curve.r)


def proof(curve: Curve, qap: QAPAtT, num_inputs: int, secrets: dict,
          primary: list, auxiliary: list, seed: int) -> tuple:
    """The proof (A in G1, B in G2, C in G1) as affine integer points."""
    a, b, c = proof_scalars(curve, qap, num_inputs, secrets, primary,
                            auxiliary, *proof_randomness(curve, seed))
    return curve.G1.mul(a), curve.G2.mul(b), curve.G1.mul(c)
