"""USCS -> SSP reduction (the port of libsnark_tpu/reductions/uscs_to_ssp.py;
reference reductions/uscs_to_ssp/uscs_to_ssp.tcc).

V polynomials scatter the USCS constraint coefficients row-per-constraint;
rows beyond num_constraints are the dummy constraint 1^2 = 1 (V_0 += 1,
tcc:43-52). Witness map (tcc:151-243): mat-vec, iFFT, ZK patch
(2 d V + d^2 Z), cosetFFT, square-minus-one, /Z on the coset, icosetFFT,
over (N, m) Montgomery limbs (the ``mont_mul`` kernel on the card under
every product). The host half (``ssp_domain``, ``_ssp_rows``,
``ssp_instance_map_with_evaluation``) is copied from the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.domains import add_scaled_z, get_evaluation_domain
from ..relations.arithmetic_programs import SSPInstanceEvaluation
from ..relations.r1cs import SparseMatrix


def ssp_domain(fr_kernel, fr_params, cs, force_pow_2: bool = False):
    """libfqfft-parity domain for min_size = num_constraints
    (reference uscs_to_ssp.tcc:37-38)."""
    return get_evaluation_domain(fr_kernel, fr_params,
                                 cs.num_constraints, force_pow_2)


def _ssp_rows(cs, m):
    p = cs.p
    rows = []
    for i, con in enumerate(cs.constraints):
        for t in con.compact(p).terms:
            rows.append((i, t.index, t.coeff))
    for i in range(cs.num_constraints, m):
        rows.append((i, 0, 1))
    return rows


def ssp_instance_map_with_evaluation(cs, domain, t: int):
    p = cs.p
    nv = cs.num_variables
    u = domain.lagrange_coeffs_at(t)
    Vt = [0] * (nv + 1)
    for row, idx, coeff in _ssp_rows(cs, domain.m):
        Vt[idx] = (Vt[idx] + coeff * u[row]) % p
    Ht = [1] * (domain.m + 1)
    for i in range(1, domain.m + 1):
        Ht[i] = Ht[i - 1] * t % p
    return SSPInstanceEvaluation(
        t=t, Vt=Vt, Ht=Ht, Zt=domain.vanishing_eval(t),
        degree=domain.m, num_inputs=cs.num_inputs, num_variables=nv)


@dataclasses.dataclass
class SSPDevice:
    V: SparseMatrix
    num_constraints: int
    num_inputs: int
    num_variables: int
    p: int

    @classmethod
    def build(cls, cs, fk, m):
        return cls(V=SparseMatrix.from_triples(fk, _ssp_rows(cs, m), m,
                                               cs.num_variables + 1),
                   num_constraints=cs.num_constraints,
                   num_inputs=cs.num_inputs,
                   num_variables=cs.num_variables, p=cs.p)


def ssp_witness_map(dev: SSPDevice, domain, assignment_mont, d_m):
    """Coefficients of H = (V^2 - 1)/Z + (2 d V + d^2 Z), (N, m+1)
    Montgomery limbs; d_m: (N, 1) Montgomery limbs."""
    fk = domain.fk
    m = domain.m
    aV = dev.V.evaluate(fk, assignment_mont, m)
    cV = domain.ifft(aV)
    patch = fk.mul(cV, fk.add(d_m, d_m))
    eV = domain.coset_fft(cV)
    H = fk.sub(fk.mul(eV, eV), fk.one((1,), eV.device))
    Hc = domain.icoset_fft_divz(H)
    out = torch.cat([fk.add(Hc, patch), fk.zeros((1,), Hc.device)], dim=-1)
    return add_scaled_z(fk, domain, out, fk.mul(d_m, d_m))
