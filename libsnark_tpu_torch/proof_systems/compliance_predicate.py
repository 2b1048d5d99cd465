"""Compliance predicates: the PCD message/predicate model (reference
zk_proof_systems/pcd/r1cs_pcd/compliance_predicate/
{compliance_predicate.hpp, cp_handler.hpp} and the tally example
examples/tally_cp.hpp).

A compliance predicate Pi(msg_out, local_data, msg_ins) decides whether
an outgoing message complies with incoming messages + local data. The
handler wraps a protoboard so user constraints see the messages as
variable blocks; `is_satisfied` mirrors the reference's debug check.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..gadgets.protoboard import Protoboard, PBVariable, PBVariableArray


@dataclasses.dataclass
class PCDMessage:
    """type + payload (r1cs_pcd_message)."""
    type: int
    payload: List[int]


@dataclasses.dataclass
class PCDLocalData:
    values: List[int]


class CompliancePredicateHandler:
    """cp_handler equivalent: owns a protoboard with variable blocks
    [outgoing | arity | incoming... | local data]; subclasses add the
    compliance constraints and witness logic."""

    def __init__(self, p: int, name: int, type_: int, max_arity: int,
                 outgoing_size: int, incoming_size: int, local_size: int):
        self.pb = Protoboard(p)
        self.name = name
        self.type = type_
        self.max_arity = max_arity
        self.outgoing = PBVariableArray().allocate(
            self.pb, 1 + outgoing_size, "outgoing")  # [type, payload...]
        self.arity = PBVariable().allocate(self.pb, "arity")
        self.incoming = [
            PBVariableArray().allocate(self.pb, 1 + incoming_size,
                                       f"incoming_{i}")
            for i in range(max_arity)]
        self.local = PBVariableArray().allocate(self.pb, local_size,
                                                "local")
        # outgoing message + arity are the primary input of the step
        self.pb.set_input_sizes(1 + outgoing_size + 1)

    def generate_r1cs_constraints(self):
        raise NotImplementedError

    def generate_r1cs_witness(self, incoming: List[PCDMessage],
                              local: PCDLocalData) -> PCDMessage:
        raise NotImplementedError

    def get_constraint_system(self):
        return self.pb.get_constraint_system()

    def is_satisfied(self) -> bool:
        return self.pb.is_satisfied()


class TallyCompliancePredicate(CompliancePredicateHandler):
    """The reference's example predicate (tally_cp.hpp): each node sums
    its incoming tallies plus its local value; outgoing payload =
    [sum, count]."""

    TYPE = 1

    def __init__(self, p: int, max_arity: int = 2):
        super().__init__(p, name=1, type_=self.TYPE, max_arity=max_arity,
                         outgoing_size=2, incoming_size=2, local_size=1)

    def generate_r1cs_constraints(self):
        pb = self.pb
        # outgoing type is the predicate type
        pb.add_r1cs_constraint(1, self.outgoing[0], self.TYPE, "out_type")
        # sum = local + sum of incoming sums; count = 1 + sum of counts
        from ..relations.variable import LinearCombination
        sum_lc = LinearCombination(self.local[0])
        cnt_lc = LinearCombination(1)
        for inc in self.incoming:
            sum_lc = sum_lc + inc[1]
            cnt_lc = cnt_lc + inc[2]
        pb.add_r1cs_constraint(1, sum_lc, self.outgoing[1], "sum")
        pb.add_r1cs_constraint(1, cnt_lc, self.outgoing[2], "count")
        # incoming messages are base-case (type 0, zero payload) or
        # this predicate's type: type * (type - TYPE) = 0
        from ..relations.variable import LinearCombination as LC
        for inc in self.incoming:
            pb.add_r1cs_constraint(inc[0], LC(inc[0]) - self.TYPE, 0,
                                   "in_type")

    def generate_r1cs_witness(self, incoming, local):
        pb = self.pb
        total, count = local.values[0], 1
        pb.setval(self.local[0], local.values[0])
        pb.setval(self.arity, len(incoming))
        for i in range(self.max_arity):
            msg = (incoming[i] if i < len(incoming)
                   else PCDMessage(type=0, payload=[0, 0]))
            pb.setval(self.incoming[i][0], msg.type)
            pb.setval(self.incoming[i][1], msg.payload[0])
            pb.setval(self.incoming[i][2], msg.payload[1])
            total += msg.payload[0]
            count += msg.payload[1]
        total %= pb.p
        out = PCDMessage(type=self.TYPE, payload=[total, count])
        pb.setval(self.outgoing[0], out.type)
        pb.setval(self.outgoing[1], total)
        pb.setval(self.outgoing[2], count)
        return out
