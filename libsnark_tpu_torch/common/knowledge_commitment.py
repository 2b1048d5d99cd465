"""Knowledge commitments (reference knowledge_commitment/
knowledge_commitment.hpp:34-104 and kc_multiexp.tcc).

A knowledge commitment is a pair (g in T1, h in T2) forming a group under
componentwise addition -- the "query with knowledge-exponent shadow" used
by the BCTV14 A/B/C queries. `KCVector` is the sparse vector of pairs;
`kc_batch_exp`-style construction and the prover-side kc MSM live on the
proof systems, which dispatch the two component MSMs to the device
kernels (the reference's branch-per-scalar loop kc_multiexp.tcc:63-112
becomes two batched Pippenger calls -- zero-skipping is subsumed by
bucket 0 never being raked).
"""
from __future__ import annotations

import dataclasses

from .sparse_vector import SparseVector


@dataclasses.dataclass
class KnowledgeCommitment:
    g: object
    h: object

    def __add__(self, o):
        return KnowledgeCommitment(self.g + o.g, self.h + o.h)

    def __mul__(self, s: int):
        return KnowledgeCommitment(self.g * s, self.h * s)

    __rmul__ = __mul__

    def __eq__(self, o):
        if not isinstance(o, KnowledgeCommitment):
            return NotImplemented
        return self.g == o.g and self.h == o.h

    def is_zero(self):
        return self.g.is_zero() and self.h.is_zero()

    def is_well_formed(self):
        return self.g.is_well_formed() and self.h.is_well_formed()

    @classmethod
    def zero(cls, G1_group, G2_group):
        return cls(G1_group.zero(), G2_group.zero())


class KCVector(SparseVector):
    """Sparse vector of knowledge commitments
    (knowledge_commitment_vector, knowledge_commitment.hpp:104)."""

    @classmethod
    def batch_exp_host(cls, T1_one, T2_one, coeff_g: int, coeff_h: int,
                       scalars: list, r: int):
        """Host-side kc_batch_exp (kc_multiexp.tcc:115+): entries
        (coeff_g * s_i * T1_one, coeff_h * s_i * T2_one) for nonzero s_i.
        Used only for small queries / tests -- the proof systems build the
        real queries with device fixed-base batch exp."""
        idx, vals = [], []
        for i, s in enumerate(scalars):
            s = s % r
            if s == 0:
                continue
            idx.append(i)
            vals.append(KnowledgeCommitment(T1_one * (coeff_g * s % r),
                                            T2_one * (coeff_h * s % r)))
        return cls(idx, vals, len(scalars))
