"""Wrap an arbitrary R1CS constraint system as a gadget (reference
gadgetlib1/gadgets/gadget_from_r1cs.{hpp,tcc} -- used by the PCD
cp_handler to splice compiled predicate systems into larger circuits).

The wrapped system's variables 1..n are remapped onto caller-provided
variable blocks (in order), with fresh auxiliaries allocated for the
remainder.
"""
from __future__ import annotations

from typing import List

from .protoboard import Gadget, Protoboard, PBVariable, PBVariableArray
from ..relations.variable import LinearCombination, LinearTerm


class GadgetFromR1CS(Gadget):
    def __init__(self, pb: Protoboard, variable_blocks: List[list], cs,
                 annotation_prefix="from_r1cs"):
        super().__init__(pb, annotation_prefix)
        self.cs = cs
        flat = [v for block in variable_blocks for v in block]
        n_mapped = len(flat)
        assert n_mapped <= cs.num_variables
        extra = PBVariableArray().allocate(
            pb, cs.num_variables - n_mapped, self.annot("aux"))
        # index map: wrapped index i (1-based) -> outer variable index
        self._map = [0] + [v.index for v in flat] + [v.index for v in extra]
        self.extra = extra

    def _remap(self, lc):
        out = LinearCombination()
        for t in lc.terms:
            out.terms.append(LinearTerm(self._map[t.index], t.coeff))
        return out

    def generate_r1cs_constraints(self):
        for i, con in enumerate(self.cs.constraints):
            self.pb.add_r1cs_constraint(
                self._remap(con.a), self._remap(con.b), self._remap(con.c),
                self.annot(f"c{i}"))

    def generate_r1cs_witness(self, full_assignment: List[int]):
        """full_assignment: the wrapped system's variables 1..n."""
        assert len(full_assignment) == self.cs.num_variables
        for i, v in enumerate(full_assignment):
            self.pb._values[self._map[i + 1]] = int(v) % self.pb.p
