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
        heuristic reduces prover G2 work since the B query is the G2 MSM).
        Every term counts, whatever its coefficient; the native codec's
        ``mark`` reads the terms."""
        from ..native import limbcodec
        mark = limbcodec().mark
        k = self.primary_input_size
        counts = []
        for name in "ab":
            seen = bytearray(self.num_variables + 1)
            mark([getattr(c, name).terms for c in self.constraints], seen)
            counts.append(seen.count(1, k + 1))
        a_nz, b_nz = counts
        if b_nz > a_nz:
            for c in self.constraints:
                c.a, c.b = c.b, c.a
            return True
        return False

    def compacted(self) -> tuple:
        """The A, B and C matrices as flat (rows, cols, coeffs) lists, each
        constraint's terms merged by index, reduced mod p, zeros dropped,
        in index order (variable.compact_terms, LinearCombination.compact's
        terms): what the device form reads (and the host QAP evaluation,
        the tests' reference), by the native codec's ``compact``
        (compact_terms in C).
        Flat lists of integers hold no object the collector tracks, at any
        size."""
        from ..native import limbcodec
        compact = limbcodec().compact
        mats = tuple(([], [], []) for _ in range(3))
        for name, (rows, cols, coeffs) in zip("abc", mats):
            compact([getattr(con, name).terms for con in self.constraints],
                    self.p, rows, cols, coeffs)
        return mats

    # -- device compilation ----------------------------------------------------------
    def to_device(self, fr_kernel, compacted=None):
        """compacted: this system's compacted(), if the caller has it."""
        return R1CSDevice.build(self, fr_kernel, compacted)

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

    def evaluate_transposed(self, fk, vec, num_out: int):
        """M^T v: sum over rows j of M_{j,i} v_j for all columns i (the
        keygen's A_i(t) = sum_j A_{j,i} L_j(t)).

        vec: (N, >= num_rows) Montgomery limbs. Returns (N, num_out)
        Montgomery values: gather by row, product (mont_mul), index_add_
        by column into int64 lazy columns, one lazy reduction (a column's
        sum of its terms, each below p, stays below R * p)."""
        import torch
        prod = fk.mul(vec[:, self.rows], self.coeffs)      # (N, nnz)
        sums = torch.zeros((fk.N, num_out), dtype=torch.int64,
                           device=prod.device)
        sums.index_add_(1, self.cols, prod.to(torch.int64))
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
    def build(cls, cs: R1CSConstraintSystem, fk, compacted=None):
        import torch
        if compacted is None:
            compacted = cs.compacted()

        def mat(k):
            rows, cols, coefs = compacted[k]
            if not rows:  # keep shapes non-empty
                rows, cols, coefs = [0], [0], [0]
            dev = fk.device
            return SparseMatrix(
                rows=torch.from_numpy(np.asarray(rows, np.int64)).to(dev),
                cols=torch.from_numpy(np.asarray(cols, np.int64)).to(dev),
                coeffs=fk.encode(coefs),
                num_rows=cs.num_constraints,
                num_cols=cs.num_variables + 1)
        return cls(A=mat(0), B=mat(1), C=mat(2),
                   num_constraints=cs.num_constraints,
                   num_inputs=cs.num_inputs,
                   num_variables=cs.num_variables, p=cs.p)

    def first_unsatisfied_row(self, fk, assignment_mont) -> Optional[int]:
        """The first row j with <A_j, s> * <B_j, s> != <C_j, s>, or None:
        the host check's verdict (R1CSConstraintSystem.is_satisfied), from
        the three mat-vecs of the witness map, one product and one
        subtraction (the mont_mul and fp_addsub kernels on the card). Rows
        are the constraints in order: compaction merges each row's terms
        and swap_AB_if_beneficial swaps A and B whole, neither changes the
        product. assignment_mont: (N, num_vars+1) Montgomery limbs with the
        constant 1 at index 0."""
        import torch
        n = self.num_constraints
        aA, aB, aC = (m.evaluate(fk, assignment_mont, n)
                      for m in (self.A, self.B, self.C))
        bad = torch.nonzero(~fk.is_zero(fk.sub(fk.mul(aA, aB), aC)))
        return int(bad[0, 0]) if bad.numel() else None
