"""Carry a proving key (Groth16, BCTV14, GM17, DFGK14) or a KZG10 SRS across
into the port from plain numpy data.

``proving_key_from_numpy`` builds the port's ``Groth16ProvingKey`` from:

* queries: name -> (x, y, inf) numpy triples -- uint32 limbs, limbs leading
  ((N, n) for G1, (2, N, n) for G2 over Fq2, (3, N, n) over Fq3; N = 16
  for alt_bn128, 24 for BLS12-377, 48 for BW6-761, 19 for MNT4 and MNT6,
  12 for edwards), in Montgomery form, padded to the
  power-of-two bucket, and a bool infinity mask (the layout of the JAX
  package's device arrays);
* points: name -> integer affine coordinates of the host points
  (alpha_g1, beta_g1, delta_g1 as (x, y); beta_g2, delta_g2 as
  ((x0, x1), (y0, y1)) over Fq2, ((x0, x1, x2), (y0, y1, y2)) over Fq3
  (MNT6, edwards), or (x, y) where G2 lies over Fq: BW6-761);
* matrices: "A" / "B" / "C" -> (rows, cols, coeffs) numpy, coeffs the
  (N, nnz) uint32 Montgomery limbs;
* the constraint-system sizes.

``srs_from_numpy`` builds the port's ``KZG10SRS`` from the three affine
arrays of [alpha^i]_1 in the same layout ((N, n) uint32 Montgomery limbs
for x and y, a bool infinity mask) and the integer affine coordinates of
[alpha]_2.

``bctv14_proving_key_from_numpy``, ``gm17_proving_key_from_numpy``,
``dfgk14_proving_key_from_numpy`` and ``adsnark_proving_key_from_numpy``
do the same for the other pairing systems: their query triples in the
same layout (names as in each system's ``QUERIES``), GM17's and ADSNARK's
host points as integer coordinates, their
sparse matrices as (rows, cols, coeffs) -- R1CS "A" / "B" / "C", SAP "A" /
"C" / "AB_diff", SSP "V" -- and their sizes.

``cycle_pcd_verification_key_from_ints`` and ``cycle_pcd_proof_from_ints``
build the MNT-cycle PCD's verification key (the translation circuit's
Groth16 key over curve B and the message size) and a PCD proof (the
message and the translation proof) from integer coordinates, so a key and
a proof made elsewhere can be checked by ``CycleSpPCD.verifier``.

``ram_ppzksnark_keypair_from_numpy`` builds a RAM ppzkSNARK keypair: the
BCTV14 proving key as above, wrapped with the TinyRAM shape (w, k), the
boot-trace size bound and the time bound, and the BCTV14 verification key
from integer coordinates. RamZkSnark's inner keypair is a Groth16 one and
goes through ``proving_key_from_numpy``.

All of them take numpy and ints only and import nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.cuda_lib import resolve_device
from .ops.limbs import to_torch
from .polynomial_commitments.kzg10 import KZG10SRS
from .proof_systems import adsnark, bctv14, dfgk14, gm17
from .common.sparse_vector import AccumulationVector
from .proof_systems.compliance_predicate import PCDMessage
from .proof_systems.groth16 import (
    Groth16Proof, Groth16ProvingKey, Groth16VerificationKey)
from .proof_systems.pcd_cycle import CyclePCDProof, CyclePCDVerificationKey
from .proof_systems.ram_ppzksnark import (
    RAMPpzksnarkKeypair, RAMPpzksnarkProvingKey)
from .reductions.r1cs_to_sap import SAPDevice
from .reductions.uscs_to_ssp import SSPDevice
from .relations.r1cs import R1CSDevice, SparseMatrix
from .relations.tinyram import TinyRAMParams

QUERIES = ("A_query", "B_query_g2", "B_query_g1", "H_query", "L_query")


def _g1(curve, xy):
    return curve.G1.point(int(xy[0]), int(xy[1]))


def _g2(curve, xy):
    """G2 from ((x0, x1), (y0, y1)) over Fq2, ((x0, x1, x2), (y0, y1, y2))
    over Fq3 (``g2_field_degree`` 3: MNT6, edwards), or (x, y) where G2
    lies over Fq itself (``g2_field_degree`` 1: BW6-761)."""
    deg = getattr(curve, "g2_field_degree", 2)
    if deg == 1:
        return curve.G2.point(int(xy[0]), int(xy[1]))
    F = curve.Fq2 if deg == 2 else curve.Fq3
    x, y = ([int(c) for c in v] for v in xy)
    return curve.G2.point(F(*x), F(*y))


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


def ram_ppzksnark_keypair_from_numpy(system, w: int, k: int,
                                     boot_trace_size_bound: int,
                                     time_bound: int, queries: dict,
                                     matrices: dict, vk_points: dict,
                                     num_constraints: int, num_inputs: int,
                                     num_variables: int):
    """The port's RAM ppzkSNARK keypair for TinyRAM with k registers of w
    bits: the BCTV14 proving key of ``bctv14_proving_key_from_numpy``, and
    the BCTV14 verification key from vk_points -- alphaB_g1 and
    gamma_beta_g1 as (x, y); alphaA_g2, alphaC_g2, gamma_g2, gamma_beta_g2
    and rC_Z_g2 as ((x0, x1), (y0, y1)); "IC" the num_inputs + 1 points of
    the encoded IC query as (x, y), None for the point at infinity."""
    curve = system.curve
    pk = bctv14_proving_key_from_numpy(system, queries, matrices,
                                       num_constraints, num_inputs,
                                       num_variables)
    ic = [curve.G1.zero() if xy is None else _g1(curve, xy)
          for xy in vk_points["IC"]]
    vk = bctv14.BCTV14VerificationKey(
        encoded_IC_query=AccumulationVector.from_values(ic[0], ic[1:]),
        **{n: _g1(curve, vk_points[n]) for n in ("alphaB_g1",
                                                  "gamma_beta_g1")},
        **{n: _g2(curve, vk_points[n]) for n in (
            "alphaA_g2", "alphaC_g2", "gamma_g2", "gamma_beta_g2",
            "rC_Z_g2")})
    return RAMPpzksnarkKeypair(
        pk=RAMPpzksnarkProvingKey(
            ap=TinyRAMParams(w=w, k=k),
            boot_trace_size_bound=boot_trace_size_bound,
            time_bound=time_bound, r1cs_pk=pk),
        vk=vk)


def adsnark_proving_key_from_numpy(system, queries: dict, points: dict,
                                   matrices: dict, num_constraints: int,
                                   num_inputs: int, num_variables: int):
    """The port's ADSNARK proving key: the eight queries of
    ``adsnark.QUERIES``, the host point rA_i_Z_g1 ((x, y)) and the R1CS
    matrices "A", "B", "C"."""
    return adsnark.ADSNARKProvingKey(
        rA_i_Z_g1=_g1(system.curve, points["rA_i_Z_g1"]),
        r1cs_dev=_r1cs_device(system, matrices, num_constraints, num_inputs,
                              num_variables),
        **_queries(system.device, queries, adsnark.QUERIES))


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


def _g1_or_zero(curve, xy):
    return curve.G1.zero() if xy is None else _g1(curve, xy)


def _g2_or_zero(curve, xy):
    return curve.G2.zero() if xy is None else _g2(curve, xy)


def cycle_pcd_verification_key_from_ints(curve_b, points: dict,
                                         msg_size: int):
    """The MNT-cycle PCD verification key over curve_b (the translation
    side, MNT6 for the default cycle): alpha_g1 as (x, y); beta_g2,
    gamma_g2 and delta_g2 as G2 coordinates (see ``_g2``); gamma_ABC a
    list of (x, y), None for the point at infinity."""
    vk_b = Groth16VerificationKey(
        alpha_g1=_g1_or_zero(curve_b, points["alpha_g1"]),
        **{n: _g2_or_zero(curve_b, points[n])
           for n in ("beta_g2", "gamma_g2", "delta_g2")},
        gamma_ABC=[_g1_or_zero(curve_b, xy) for xy in points["gamma_ABC"]])
    return CyclePCDVerificationKey(vk_b=vk_b, msg_size=msg_size)


def cycle_pcd_proof_from_ints(curve_b, msg_type: int, payload,
                              proof: dict):
    """An MNT-cycle PCD proof: the message (its type and payload as
    integers) and the translation proof over curve_b (g_A and g_C as
    (x, y), g_B as G2 coordinates; None for infinity)."""
    return CyclePCDProof(
        msg=PCDMessage(type=int(msg_type), payload=[int(v) for v in payload]),
        translation_proof=Groth16Proof(
            g_A=_g1_or_zero(curve_b, proof["g_A"]),
            g_B=_g2_or_zero(curve_b, proof["g_B"]),
            g_C=_g1_or_zero(curve_b, proof["g_C"])))
