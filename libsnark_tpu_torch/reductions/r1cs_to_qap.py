"""R1CS -> QAP reduction (the port of libsnark_tpu/reductions/r1cs_to_qap.py;
reference reductions/r1cs_to_qap/r1cs_to_qap.tcc).

* ``qap_instance_map_with_evaluation`` (tcc:106-175): evaluate the QAP at
  a secret point t, host-side python ints, once per circuit at setup;
  ``qap_instance_map_on_device`` gives the same integers from the device
  R1CS's transposed products (A^T u, B^T u, C^T u for the Lagrange
  coefficients u at t), what the Groth16, BCTV14 and ADSNARK keygens
  take.
* ``qap_witness_map`` (tcc:209-344): the prover hot path -- 3 sparse
  mat-vecs + input-consistency rows, one stacked iFFT and coset FFT,
  pointwise a*b - c, icosetFFT with divide-by-Z -- over (N, m) Montgomery
  limb tensors.
* ``qap_witness_map_zk`` (the same with nonzero d1, d2, d3): H of degree
  m with the zero-knowledge patch, for BCTV14.

Domain size = num_constraints + num_inputs + 1 (rounded to a supported
domain), the extra rows being the per-input consistency constraints.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..ops.domains import (
    add_scaled_z, get_evaluation_domain, sub_constant_term)


def qap_domain(fr_kernel, fr_params, cs, force_pow_2: bool = False):
    """The libfqfft-parity domain for min_size = n + k + 1."""
    return get_evaluation_domain(
        fr_kernel, fr_params, cs.num_constraints + cs.num_inputs + 1,
        force_pow_2)


@dataclasses.dataclass
class QAPInstanceEvaluation:
    """A_i(t), B_i(t), C_i(t), t^i, Z(t) -- host ints."""
    t: int
    At: List[int]
    Bt: List[int]
    Ct: List[int]
    Ht: List[int]     # powers t^0 .. t^m
    Zt: int
    degree: int
    num_inputs: int
    num_variables: int


def qap_instance_map_with_evaluation(cs, domain, t: int):
    """The host form, the tests' reference for qap_instance_map_on_device.
    The sums are reduced mod p once each, at the end: the same values as a
    reduction a term."""
    p = cs.p
    nv = cs.num_variables
    u = domain.lagrange_coeffs_at(t)
    compacted = cs.compacted()
    At = [0] * (nv + 1)
    Bt = [0] * (nv + 1)
    Ct = [0] * (nv + 1)
    # input consistency: A_i(t) += L_{n + i}(t) for i = 0..num_inputs
    for i in range(cs.num_inputs + 1):
        At[i] = u[cs.num_constraints + i]
    for out, (rows, cols, coeffs) in zip((At, Bt, Ct), compacted):
        for j, i, c in zip(rows, cols, coeffs):
            out[i] += c * u[j]
    At, Bt, Ct = ([x % p for x in v] for v in (At, Bt, Ct))
    Ht = [1] * (domain.m + 1)
    for i in range(1, domain.m + 1):
        Ht[i] = Ht[i - 1] * t % p
    return QAPInstanceEvaluation(
        t=t, At=At, Bt=Bt, Ct=Ct, Ht=Ht, Zt=domain.vanishing_eval(t),
        degree=domain.m, num_inputs=cs.num_inputs, num_variables=nv)


def qap_instance_map_on_device(r1cs_dev, domain, t: int):
    """qap_instance_map_with_evaluation's A_i(t), B_i(t), C_i(t) as the
    device R1CS's transposed products with u = L_j(t) (mont_mul on the
    card): the same integers, decoded to the host; t^i and Z(t) on the
    host."""
    fk = domain.fk
    p = r1cs_dev.p
    n, k = r1cs_dev.num_constraints, r1cs_dev.num_inputs
    nv = r1cs_dev.num_variables
    u = domain.lagrange_coeffs_at(t)
    u_mont = fk.encode(u)
    At, Bt, Ct = (fk.decode(fk.from_mont(m.evaluate_transposed(
        fk, u_mont, nv + 1)), mont=False)
        for m in (r1cs_dev.A, r1cs_dev.B, r1cs_dev.C))
    # input consistency: A_i(t) += L_{n + i}(t) for i = 0..num_inputs
    for i in range(k + 1):
        At[i] = (At[i] + u[n + i]) % p
    Ht = [1] * (domain.m + 1)
    for i in range(1, domain.m + 1):
        Ht[i] = Ht[i - 1] * t % p
    return QAPInstanceEvaluation(
        t=t, At=At, Bt=Bt, Ct=Ct, Ht=Ht, Zt=domain.vanishing_eval(t),
        degree=domain.m, num_inputs=k, num_variables=nv)


def qap_witness_map(r1cs_dev, domain, assignment_mont):
    """Coefficients of H(x) = (A(x)B(x) - C(x)) / Z(x).

    r1cs_dev: R1CSDevice; assignment_mont: (N, num_vars+1) Montgomery
    limbs with the constant 1 at index 0. Returns (N, m) Montgomery
    coefficients (degree <= m-2: the last column is zero).
    """
    fk = domain.fk
    m = domain.m
    n = r1cs_dev.num_constraints
    k = r1cs_dev.num_inputs
    aA = r1cs_dev.A.evaluate(fk, assignment_mont, m)
    aB = r1cs_dev.B.evaluate(fk, assignment_mont, m)
    aC = r1cs_dev.C.evaluate(fk, assignment_mont, m)
    # input consistency rows: aA[n + i] = s_i for i = 0..k
    aA = torch.cat([aA[..., :n], assignment_mont[..., :k + 1],
                    aA[..., n + k + 1:]], dim=-1)
    # A/B/C ride ONE stacked transform
    S = torch.stack([aA, aB, aC], dim=-2)          # (N, 3, m)
    eS = domain.coset_fft(domain.ifft(S))
    H = fk.sub(fk.mul(eS[..., 0, :], eS[..., 1, :]), eS[..., 2, :])
    return domain.icoset_fft_divz(H)


def qap_witness_map_zk(r1cs_dev, domain, assignment_mont, d1_m, d2_m, d3_m):
    """ZK-patched witness map (r1cs_to_qap.tcc:209-344 with nonzero d1, d2,
    d3): coefficients of

      H = (A*B - C)/Z + (d2*A + d1*B - d3) + d1*d2*Z

    d1_m, d2_m, d3_m: (N, 1) Montgomery limbs. Returns (N, m+1)
    Montgomery coefficients (degree m, top coefficient d1*d2). Used by
    BCTV14; Groth16 takes ``qap_witness_map``."""
    fk = domain.fk
    m = domain.m
    n = r1cs_dev.num_constraints
    k = r1cs_dev.num_inputs
    aA = r1cs_dev.A.evaluate(fk, assignment_mont, m)
    aA = torch.cat([aA[..., :n], assignment_mont[..., :k + 1],
                    aA[..., n + k + 1:]], dim=-1)
    aB = r1cs_dev.B.evaluate(fk, assignment_mont, m)
    aC = r1cs_dev.C.evaluate(fk, assignment_mont, m)
    # A/B/C ride one stacked transform, as in qap_witness_map
    cS = domain.ifft(torch.stack([aA, aB, aC], dim=-2))    # (N, 3, m)
    patch = fk.add(fk.mul(cS[..., 0, :], d2_m), fk.mul(cS[..., 1, :], d1_m))
    eS = domain.coset_fft(cS)
    H = fk.sub(fk.mul(eS[..., 0, :], eS[..., 1, :]), eS[..., 2, :])
    Hc = domain.icoset_fft_divz(H)                         # (N, m)
    out = torch.cat([fk.add(Hc, patch), fk.zeros((1,), Hc.device)], dim=-1)
    # -= d3 at the constant term; += d1*d2 * Z(x), Z sparse and
    # domain-shaped (x^m - 1 only for the basic radix-2 domain)
    out = sub_constant_term(fk, out, d3_m)
    return add_scaled_z(fk, domain, out, fk.mul(d1_m, d2_m))
