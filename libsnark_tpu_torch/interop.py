"""Carry a proving key (Groth16, BCTV14, GM17, DFGK14) or a KZG10 SRS across
into the port from plain numpy data.

``proving_key_from_numpy`` builds the port's ``Groth16ProvingKey`` from:

* queries: name -> (x, y, inf) numpy triples -- uint32 limbs, limbs leading
  ((N, n) for G1, (2, N, n) for G2; N = 16 for alt_bn128, 24 for
  BLS12-377), in Montgomery form, padded to the
  power-of-two bucket, and a bool infinity mask (the layout of the JAX
  package's device arrays);
* points: name -> integer affine coordinates of the host points
  (alpha_g1, beta_g1, delta_g1 as (x, y); beta_g2, delta_g2 as
  ((x0, x1), (y0, y1)));
* matrices: "A" / "B" / "C" -> (rows, cols, coeffs) numpy, coeffs the
  (N, nnz) uint32 Montgomery limbs;
* the constraint-system sizes.

``srs_from_numpy`` builds the port's ``KZG10SRS`` from the three affine
arrays of [alpha^i]_1 in the same layout ((N, n) uint32 Montgomery limbs
for x and y, a bool infinity mask) and the integer affine coordinates of
[alpha]_2.

``bctv14_proving_key_from_numpy``, ``gm17_proving_key_from_numpy`` and
``dfgk14_proving_key_from_numpy`` do the same for the other pairing
systems: their query triples in the same layout (names as in each
system's ``QUERIES``), GM17's host points as integer coordinates, their
sparse matrices as (rows, cols, coeffs) -- R1CS "A" / "B" / "C", SAP "A" /
"C" / "AB_diff", SSP "V" -- and their sizes.

All of them take numpy and ints only and import nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.cuda_lib import resolve_device
from .ops.limbs import to_torch
from .polynomial_commitments.kzg10 import KZG10SRS
from .proof_systems import bctv14, dfgk14, gm17
from .proof_systems.groth16 import Groth16ProvingKey
from .reductions.r1cs_to_sap import SAPDevice
from .reductions.uscs_to_ssp import SSPDevice
from .relations.r1cs import R1CSDevice, SparseMatrix

QUERIES = ("A_query", "B_query_g2", "B_query_g1", "H_query", "L_query")


def _g1(curve, xy):
    return curve.G1.point(int(xy[0]), int(xy[1]))


def _g2(curve, xy):
    (x0, x1), (y0, y1) = xy
    F2 = curve.Fq2
    return curve.G2.point(F2(int(x0), int(x1)), F2(int(y0), int(y1)))


def _matrix(dev, triple, num_rows: int, num_cols: int):
    rows, cols, coeffs = triple
    return SparseMatrix(
        rows=torch.from_numpy(np.asarray(rows, np.int64)).to(dev),
        cols=torch.from_numpy(np.asarray(cols, np.int64)).to(dev),
        coeffs=to_torch(coeffs, dev), num_rows=num_rows, num_cols=num_cols)


def _queries(dev, queries: dict, names):
    return {name: tuple(to_torch(a, dev) for a in queries[name])
            for name in names}


def _r1cs_device(system, matrices, num_constraints, num_inputs,
                 num_variables):
    dev = system.device

    def mat(name):
        return _matrix(dev, matrices[name], num_constraints,
                       num_variables + 1)

    return R1CSDevice(A=mat("A"), B=mat("B"), C=mat("C"),
                      num_constraints=num_constraints, num_inputs=num_inputs,
                      num_variables=num_variables, p=system.curve.r)


def proving_key_from_numpy(system, queries: dict, points: dict,
                           matrices: dict, num_constraints: int,
                           num_inputs: int, num_variables: int):
    """The port's Groth16 proving key on ``system.device`` (see module
    doc)."""
    curve = system.curve
    g1 = {n: _g1(curve, points[n]) for n in ("alpha_g1", "beta_g1",
                                             "delta_g1")}
    g2 = {n: _g2(curve, points[n]) for n in ("beta_g2", "delta_g2")}
    return Groth16ProvingKey(
        r1cs_dev=_r1cs_device(system, matrices, num_constraints, num_inputs,
                              num_variables),
        **g1, **g2, **_queries(system.device, queries, QUERIES))


def bctv14_proving_key_from_numpy(system, queries: dict, matrices: dict,
                                  num_constraints: int, num_inputs: int,
                                  num_variables: int):
    """The port's BCTV14 proving key: the eight queries of
    ``bctv14.QUERIES`` and the R1CS matrices "A", "B", "C"."""
    return bctv14.BCTV14ProvingKey(
        r1cs_dev=_r1cs_device(system, matrices, num_constraints, num_inputs,
                              num_variables),
        **_queries(system.device, queries, bctv14.QUERIES))


def gm17_proving_key_from_numpy(system, queries: dict, points: dict,
                                matrices: dict, num_constraints: int,
                                num_inputs: int, num_variables: int):
    """The port's GM17 proving key: the five queries of ``gm17.QUERIES``,
    the host points G_gamma_Z, G_ab_gamma_Z, G_gamma2_Z2, G_gamma2_Z_t0
    ((x, y)) and H_gamma_Z (((x0, x1), (y0, y1))), and the SAP matrices
    "A", "C" (2n + 2k + 1 rows over the nv + n + k + 1 extended variables)
    and "AB_diff" (max(n, 1) rows over nv + 1)."""
    curve, dev = system.curve, system.device
    n, k, nv = num_constraints, num_inputs, num_variables
    nv_sap = nv + n + k
    rows = 2 * n + 2 * k + 1
    sap = SAPDevice(
        A=_matrix(dev, matrices["A"], rows, nv_sap + 1),
        C=_matrix(dev, matrices["C"], rows, nv_sap + 1),
        AB_diff=_matrix(dev, matrices["AB_diff"], max(n, 1), nv + 1),
        num_constraints=n, num_inputs=k, num_variables=nv,
        sap_num_variables=nv_sap, p=curve.r)
    g1 = {name: _g1(curve, points[name]) for name in (
        "G_gamma_Z", "G_ab_gamma_Z", "G_gamma2_Z2", "G_gamma2_Z_t0")}
    return gm17.GM17ProvingKey(
        H_gamma_Z=_g2(curve, points["H_gamma_Z"]), sap_dev=sap, **g1,
        **_queries(dev, queries, gm17.QUERIES))


def dfgk14_proving_key_from_numpy(system, queries: dict, matrices: dict,
                                  num_constraints: int, num_inputs: int,
                                  num_variables: int, degree: int):
    """The port's DFGK14 proving key: the four queries of
    ``dfgk14.QUERIES`` and the SSP matrix "V" (degree rows: the SSP
    domain's size, over nv + 1 variables)."""
    dev = system.device
    ssp = SSPDevice(V=_matrix(dev, matrices["V"], degree, num_variables + 1),
                    num_constraints=num_constraints, num_inputs=num_inputs,
                    num_variables=num_variables, p=system.curve.r)
    return dfgk14.DFGK14ProvingKey(
        ssp_dev=ssp, **_queries(dev, queries, dfgk14.QUERIES))


def srs_from_numpy(curve, alpha_powers_g1, alpha_g2, degree: int,
                   device="cuda"):
    """The port's KZG10 SRS on ``device`` (see module doc).

    alpha_powers_g1: (x, y, inf) numpy triple with at least degree + 1
    lanes; alpha_g2: ((x0, x1), (y0, y1)) integer coordinates."""
    x, y, inf = (np.asarray(a) for a in alpha_powers_g1)
    if x.shape != y.shape or x.shape[-1] != inf.shape[-1] \
            or x.shape[-1] < degree + 1:
        raise ValueError("srs_from_numpy: x, y and inf must share their "
                         "lanes and hold at least degree + 1 points")
    dev = resolve_device(device)
    return KZG10SRS(
        alpha_powers_g1=tuple(to_torch(a, dev) for a in (x, y, inf)),
        alpha_g2=_g2(curve, alpha_g2), degree=degree)
