"""Rank-1 constraint systems (reference relations/constraint_satisfaction_problems/r1cs).

Host authoring class mirroring r1cs_constraint_system
(r1cs.hpp:50,114,134) -- including swap_AB_if_beneficial (r1cs.tcc:198-242)
and satisfaction checks -- plus compilation to a device-side COO form where
witness evaluation <A_j, s> is a batched sparse matvec: gather + Montgomery
mul (the mont_mul kernel on the card) + index_add_ into int64 lazy columns
+ one lazy reduction (the replacement for the reference's per-constraint
dot-product loop, r1cs_to_qap.tcc:240-248). Integer sums are exact, so the
order of the atomic adds does not change the result.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .variable import LinearCombination, LinearTerm


class R1CSConstraint:
    __slots__ = ("a", "b", "c", "annotation")

    def __init__(self, a, b, c, annotation: str = ""):
        self.a = LinearCombination._coerce(a)
        self.b = LinearCombination._coerce(b)
        self.c = LinearCombination._coerce(c)
        self.annotation = annotation

    def __repr__(self):
        return f"<{self.a}> * <{self.b}> = <{self.c}>"


class R1CSConstraintSystem:
    """Constraint system over scalar field of prime order p."""

    def __init__(self, p: int, primary_input_size: int = 0,
                 auxiliary_input_size: int = 0):
        self.p = p
        self.primary_input_size = primary_input_size
        self.auxiliary_input_size = auxiliary_input_size
        self.constraints: List[R1CSConstraint] = []

    # -- libsnark API parity ---------------------------------------------------
    @property
    def num_inputs(self):
        return self.primary_input_size

    @property
    def num_variables(self):
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_constraints(self):
        return len(self.constraints)

    def add_constraint(self, a, b, c, annotation: str = ""):
        self.constraints.append(R1CSConstraint(a, b, c, annotation))

    def is_valid(self) -> bool:
        nv = self.num_variables
        return all(c.a.is_valid(nv) and c.b.is_valid(nv) and c.c.is_valid(nv)
                   for c in self.constraints)

    def is_satisfied(self, primary: list, auxiliary: list) -> bool:
        full = [1] + [v % self.p for v in primary] + [v % self.p for v in auxiliary]
        for i, c in enumerate(self.constraints):
            if (c.a.evaluate(full, self.p) * c.b.evaluate(full, self.p)
                    - c.c.evaluate(full, self.p)) % self.p != 0:
                return False
        return True

    def swap_AB_if_beneficial(self):
        """Swap A<->B when B is denser in non-input variables (the reference
        heuristic reduces prover G2 work since the B query is the G2 MSM)."""
        a_nz, b_nz = set(), set()
        for c in self.constraints:
            for t in c.a.terms:
                if t.index > self.primary_input_size:
                    a_nz.add(t.index)
            for t in c.b.terms:
                if t.index > self.primary_input_size:
                    b_nz.add(t.index)
        if len(b_nz) > len(a_nz):
            for c in self.constraints:
                c.a, c.b = c.b, c.a
            return True
        return False

    # -- device compilation ----------------------------------------------------------
    def to_device(self, fr_kernel):
        return R1CSDevice.build(self, fr_kernel)

    def __eq__(self, o):
        if not isinstance(o, R1CSConstraintSystem):
            return NotImplemented
        def norm(cs):
            return [[sorted((t.index, t.coeff % cs.p) for t in lc.compact(cs.p).terms)
                     for lc in (c.a, c.b, c.c)] for c in cs.constraints]
        return (self.p == o.p
                and self.primary_input_size == o.primary_input_size
                and self.auxiliary_input_size == o.auxiliary_input_size
                and norm(self) == norm(o))


@dataclasses.dataclass
class SparseMatrix:
    """COO sparse matrix of field coefficients on the device."""
    rows: "torch.Tensor"    # (nnz,) int64 constraint indices
    cols: "torch.Tensor"    # (nnz,) int64 variable indices
    coeffs: "torch.Tensor"  # (N, nnz) int32 Montgomery limbs
    num_rows: int
    num_cols: int

    @classmethod
    def from_triples(cls, fk, triples, num_rows: int, num_cols: int):
        """From host (row, col, coeff) triples, coefficients encoded on
        ``fk.device`` (one zero entry if there are none: shapes stay
        non-empty)."""
        import torch
        triples = triples or [(0, 0, 0)]
        rows, cols, coefs = zip(*triples)
        dev = fk.device
        return cls(rows=torch.from_numpy(np.asarray(rows, np.int64)).to(dev),
                   cols=torch.from_numpy(np.asarray(cols, np.int64)).to(dev),
                   coeffs=fk.encode(coefs), num_rows=num_rows,
                   num_cols=num_cols)

    def evaluate(self, fk, assignment, num_segments: int):
        """<M_j, s> for all rows j.

        assignment: (N, num_vars+1) Montgomery limbs (index 0 = 1).
        Returns (N, num_segments) Montgomery values.
        """
        import torch
        vals = assignment[:, self.cols]
        prod = fk.mul(vals, self.coeffs)                  # (N, nnz)
        sums = torch.zeros((fk.N, num_segments), dtype=torch.int64,
                           device=prod.device)
        sums.index_add_(1, self.rows, prod.to(torch.int64))
        return fk.reduce_lazy(sums)


@dataclasses.dataclass
class R1CSDevice:
    """Device-ready sparse form of an R1CS."""
    A: SparseMatrix
    B: SparseMatrix
    C: SparseMatrix
    num_constraints: int
    num_inputs: int
    num_variables: int
    p: int

    @classmethod
    def build(cls, cs: R1CSConstraintSystem, fk):
        import torch

        def mat(select):
            rows, cols, coefs = [], [], []
            for j, con in enumerate(cs.constraints):
                lc = select(con).compact(cs.p)
                for t in lc.terms:
                    rows.append(j)
                    cols.append(t.index)
                    coefs.append(t.coeff)
            if not rows:  # keep shapes non-empty
                rows, cols, coefs = [0], [0], [0]
            dev = fk.device
            return SparseMatrix(
                rows=torch.from_numpy(np.asarray(rows, np.int64)).to(dev),
                cols=torch.from_numpy(np.asarray(cols, np.int64)).to(dev),
                coeffs=fk.encode(coefs),
                num_rows=cs.num_constraints,
                num_cols=cs.num_variables + 1)
        return cls(A=mat(lambda c: c.a), B=mat(lambda c: c.b),
                   C=mat(lambda c: c.c),
                   num_constraints=cs.num_constraints,
                   num_inputs=cs.num_inputs,
                   num_variables=cs.num_variables, p=cs.p)
