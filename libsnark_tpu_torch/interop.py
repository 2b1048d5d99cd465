"""Carry a Groth16 proving key across into the port from plain numpy data.

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

It takes numpy and ints only and imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.limbs import to_torch
from .proof_systems.groth16 import Groth16ProvingKey
from .relations.r1cs import R1CSDevice, SparseMatrix

QUERIES = ("A_query", "B_query_g2", "B_query_g1", "H_query", "L_query")


def proving_key_from_numpy(system, queries: dict, points: dict,
                           matrices: dict, num_constraints: int,
                           num_inputs: int, num_variables: int):
    """The port's proving key on ``system.device`` (see module doc)."""
    dev = system.device
    curve = system.curve
    G1, G2, F2 = curve.G1, curve.G2, curve.Fq2

    def g1(xy):
        return G1.point(int(xy[0]), int(xy[1]))

    def g2(xy):
        (x0, x1), (y0, y1) = xy
        return G2.point(F2(int(x0), int(x1)), F2(int(y0), int(y1)))

    def mat(name):
        rows, cols, coeffs = matrices[name]
        return SparseMatrix(
            rows=torch.from_numpy(np.asarray(rows, np.int64)).to(dev),
            cols=torch.from_numpy(np.asarray(cols, np.int64)).to(dev),
            coeffs=to_torch(coeffs, dev),
            num_rows=num_constraints, num_cols=num_variables + 1)

    q = {name: tuple(to_torch(a, dev) for a in queries[name])
         for name in QUERIES}
    r1cs_dev = R1CSDevice(A=mat("A"), B=mat("B"), C=mat("C"),
                          num_constraints=num_constraints,
                          num_inputs=num_inputs,
                          num_variables=num_variables, p=curve.r)
    return Groth16ProvingKey(
        alpha_g1=g1(points["alpha_g1"]), beta_g1=g1(points["beta_g1"]),
        beta_g2=g2(points["beta_g2"]), delta_g1=g1(points["delta_g1"]),
        delta_g2=g2(points["delta_g2"]), r1cs_dev=r1cs_dev, **q)
