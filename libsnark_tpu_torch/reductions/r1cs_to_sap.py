"""R1CS -> SAP reduction (the port of libsnark_tpu/reductions/r1cs_to_sap.py;
reference reductions/r1cs_to_sap/r1cs_to_sap.tcc).

Each R1CS constraint <a,x>*<b,x>=<c,x> becomes two square constraints
  (<a+b, x>)^2 = 4<c,x> + x'    and   (<a-b, x>)^2 = x'
with a fresh variable x' per constraint (tcc:80-117), plus input
consistency squares: x_0^2 = x_0 and, per input i >= 1,
  (x_i + x_0)^2 = 4 x_i + x''_i  and  (x_i - x_0)^2 = x''_i
(tcc:119-161). Domain size 2n + 2k + 1; SAP variables nv + n + k.

* host, once per circuit: ``sap_domain``, ``_sap_rows`` and
  ``sap_instance_map_with_evaluation`` (copied from the JAX package);
* device: ``SAPDevice`` holds A and C over the extended variable set and
  the (a_i - b_i) rows; ``sap_extend_assignment`` squares those rows into
  the n + k extra witness values, and ``sap_witness_map`` runs the two
  mat-vecs, one stacked iFFT and coset FFT, the square, divide-by-Z and
  the icosetFFT over (N, m) Montgomery limbs (the ``mont_mul`` kernel on
  the card under every product).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.domains import add_scaled_z, get_evaluation_domain, \
    sub_constant_term
from ..relations.arithmetic_programs import SAPInstanceEvaluation
from ..relations.r1cs import SparseMatrix


def sap_domain(fr_kernel, fr_params, cs, force_pow_2: bool = False):
    """libfqfft-parity domain for min_size = 2n + 2k + 1
    (reference r1cs_to_sap.tcc domain selection)."""
    return get_evaluation_domain(
        fr_kernel, fr_params,
        2 * cs.num_constraints + 2 * cs.num_inputs + 1, force_pow_2)


def sap_num_variables(cs) -> int:
    return cs.num_variables + cs.num_constraints + cs.num_inputs


def _sap_rows(cs):
    """Yield (row, index, coeff) triples of the SAP A and C matrices, over
    the extended variable set [1, x_1..x_nv, x'_1..x'_n, x''_1..x''_k]."""
    p = cs.p
    n, k, nv = cs.num_constraints, cs.num_inputs, cs.num_variables
    extra_var = nv + 1             # x'_i at extra_var + i
    extra_var2 = nv + n            # x''_i at extra_var2 + i (i >= 1)
    A, C = [], []
    for i, con in enumerate(cs.constraints):
        for t in con.a.compact(p).terms:
            A.append((2 * i, t.index, t.coeff))
            A.append((2 * i + 1, t.index, t.coeff))
        for t in con.b.compact(p).terms:
            A.append((2 * i, t.index, t.coeff))
            A.append((2 * i + 1, t.index, (-t.coeff) % p))
        for t in con.c.compact(p).terms:
            C.append((2 * i, t.index, 4 * t.coeff % p))
        C.append((2 * i, extra_var + i, 1))
        C.append((2 * i + 1, extra_var + i, 1))
    off = 2 * n
    A.append((off, 0, 1))
    C.append((off, 0, 1))
    for i in range(1, k + 1):
        A.append((off + 2 * i - 1, i, 1))
        A.append((off + 2 * i - 1, 0, 1))
        C.append((off + 2 * i - 1, i, 4))
        C.append((off + 2 * i - 1, extra_var2 + i, 1))
        A.append((off + 2 * i, i, 1))
        A.append((off + 2 * i, 0, (-1) % p))
        C.append((off + 2 * i, extra_var2 + i, 1))
    return A, C


def sap_instance_map_with_evaluation(cs, domain, t: int):
    """Host-side SAP evaluation at secret t (tcc:178-266)."""
    p = cs.p
    nv_sap = sap_num_variables(cs)
    u = domain.lagrange_coeffs_at(t)
    At = [0] * (nv_sap + 1)
    Ct = [0] * (nv_sap + 1)
    rowsA, rowsC = _sap_rows(cs)
    for row, idx, coeff in rowsA:
        At[idx] = (At[idx] + coeff * u[row]) % p
    for row, idx, coeff in rowsC:
        Ct[idx] = (Ct[idx] + coeff * u[row]) % p
    Ht = [1] * (domain.m + 1)
    for i in range(1, domain.m + 1):
        Ht[i] = Ht[i - 1] * t % p
    return SAPInstanceEvaluation(
        t=t, At=At, Ct=Ct, Ht=Ht, Zt=domain.vanishing_eval(t),
        degree=domain.m, num_inputs=cs.num_inputs, num_variables=nv_sap)


@dataclasses.dataclass
class SAPDevice:
    """The SAP on the device: matrices over the extended variable set."""
    A: SparseMatrix            # (2n+2k+1) x (nv_sap+1)
    C: SparseMatrix
    AB_diff: SparseMatrix      # max(n, 1) x (nv+1): rows <a_i - b_i>
    num_constraints: int       # original R1CS n
    num_inputs: int
    num_variables: int         # original R1CS nv
    sap_num_variables: int
    p: int

    @classmethod
    def build(cls, cs, fk):
        p = cs.p
        n, k, nv = cs.num_constraints, cs.num_inputs, cs.num_variables
        nv_sap = sap_num_variables(cs)
        rowsA, rowsC = _sap_rows(cs)
        diff = []
        for i, con in enumerate(cs.constraints):
            for t in con.a.compact(p).terms:
                diff.append((i, t.index, t.coeff))
            for t in con.b.compact(p).terms:
                diff.append((i, t.index, (-t.coeff) % p))
        rows = 2 * n + 2 * k + 1
        return cls(A=SparseMatrix.from_triples(fk, rowsA, rows, nv_sap + 1),
                   C=SparseMatrix.from_triples(fk, rowsC, rows, nv_sap + 1),
                   AB_diff=SparseMatrix.from_triples(fk, diff, max(n, 1),
                                                     nv + 1),
                   num_constraints=n, num_inputs=k, num_variables=nv,
                   sap_num_variables=nv_sap, p=p)


def sap_extend_assignment(dev: SAPDevice, fk, assignment_mont):
    """[1, x] -> [1, x, (a_i-b_i|x)^2, (x_i-1)^2] (tcc:330-351), (N, nv+1)
    -> (N, nv_sap+1) Montgomery limbs."""
    n, k = dev.num_constraints, dev.num_inputs
    d = dev.AB_diff.evaluate(fk, assignment_mont, max(n, 1))
    parts = [assignment_mont, fk.sqr(d)[..., :n]]
    if k > 0:
        xi = assignment_mont[..., 1:k + 1]
        parts.append(fk.sqr(fk.sub(xi, fk.one((1,), xi.device))))
    return torch.cat(parts, dim=-1)


def sap_witness_map(dev: SAPDevice, domain, sap_assign_mont, d1_m, d2_m):
    """Coefficients of H = (A^2 - C)/Z + (2 d1 A - d2 + d1^2 Z).

    d1_m, d2_m: (N, 1) Montgomery limbs. Returns (N, m+1) Montgomery
    coefficients (tcc:297-466: mat-vec, iFFT, ZK patch, cosetFFT, square,
    subtract the C coset, /Z, icosetFFT)."""
    fk = domain.fk
    m = domain.m
    aA = dev.A.evaluate(fk, sap_assign_mont, m)
    aC = dev.C.evaluate(fk, sap_assign_mont, m)
    cAC = domain.ifft(torch.stack([aA, aC], dim=-2))        # (N, 2, m)
    patch = fk.mul(cAC[..., 0, :], fk.add(d1_m, d1_m))
    eAC = domain.coset_fft(cAC)
    eA = eAC[..., 0, :]
    Hc = domain.icoset_fft_divz(fk.sub(fk.mul(eA, eA), eAC[..., 1, :]))
    out = torch.cat([fk.add(Hc, patch), fk.zeros((1,), Hc.device)], dim=-1)
    # - d2 at coefficient 0; += d1^2 * Z(x) (domain-shaped, sparse)
    out = sub_constant_term(fk, out, d2_m)
    return add_scaled_z(fk, domain, out, fk.mul(d1_m, d1_m))
