"""Routing network gadgets (reference gadgetlib1/gadgets/routing/).

Route num_packets packets (each a vector of field words) through a
Benes or AS-Waksman switch network. Per switch: one boolean selector
bit b and, per word, one mux constraint

    b * (in1_w - in0_w) = out0_w - in0_w

with the second output the LINEAR form out1_w = in0_w + in1_w - out0_w
(the reference's constraint-saving trick,
as_waksman_routing_gadget.tcc / benes_routing_gadget.tcc). The network
topology mirrors common/routing.py's recursion, so the routing
settings produced by BenesNetwork.route / ASWaksmanNetwork.route drop
straight into the witness.
"""
from __future__ import annotations

from typing import Dict, List

from .protoboard import Gadget, PBVariable, PBVariableArray
from .basic import generate_boolean_r1cs_constraint
from ..relations.variable import LinearCombination
from ..common.routing import BenesNetwork, ASWaksmanNetwork
from ..common.integer_permutation import IntegerPermutation


def _lc(x):
    return LinearCombination._coerce(x)


class _SwitchNetworkGadget(Gadget):
    """Shared machinery: recursive switch allocation + witnessing."""

    def __init__(self, pb, inputs: List[List], outputs: List[List],
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        assert len(inputs) == len(outputs) >= 2
        self.num_packets = len(inputs)
        self.num_words = len(inputs[0])
        self.inputs = [[_lc(w) for w in pkt] for pkt in inputs]
        self.outputs = outputs
        self.switch_bits: Dict[tuple, PBVariable] = {}
        self._muxes: List[tuple] = []   # (bit, in0, in1, out0_vars)
        final = self._build(self.inputs)
        # tie computed network outputs to the caller's output variables
        self._output_ties = []
        for pkt, out_pkt in zip(final, outputs):
            for w, ow in zip(pkt, out_pkt):
                self._output_ties.append((w, ow))

    # -- subclass hook -------------------------------------------------------
    def _build(self, packets):
        raise NotImplementedError

    def _route(self, perm):
        raise NotImplementedError

    # -- switch primitive ---------------------------------------------------
    def _mux_pair(self, key, pkt0, pkt1):
        bit = PBVariable().allocate(self.pb, self.annot(f"bit_{key}"))
        self.switch_bits[key] = bit
        out0 = [PBVariable().allocate(self.pb, self.annot(f"o_{key}_{w}"))
                for w in range(self.num_words)]
        self._muxes.append((bit, pkt0, pkt1, out0))
        out1 = [_lc(a) + _lc(b) - o
                for a, b, o in zip(pkt0, pkt1, out0)]
        return [_lc(o) for o in out0], out1

    # -- R1CS ------------------------------------------------------------------
    def generate_r1cs_constraints(self):
        for bit, pkt0, pkt1, out0 in self._muxes:
            generate_boolean_r1cs_constraint(
                self.pb, bit, self.annot("switch_bit"))
            for a, b, o in zip(pkt0, pkt1, out0):
                self.pb.add_r1cs_constraint(
                    bit, _lc(b) - a, _lc(o) - a, self.annot("mux"))
        for w, ow in self._output_ties:
            self.pb.add_r1cs_constraint(1, w, ow, self.annot("tie"))

    def generate_r1cs_witness(self, perm: IntegerPermutation):
        settings = self._route(perm)
        p = self.pb.p
        for key, bit in self.switch_bits.items():
            self.pb.setval(bit, 1 if settings.get(key, False) else 0)
        for bit, pkt0, pkt1, out0 in self._muxes:
            b = self.pb.val(bit)
            src = pkt1 if b else pkt0
            for s, o in zip(src, out0):
                self.pb.setval(o, self.pb.lc_val(s))
        for w, ow in self._output_ties:
            self.pb.setval(ow, self.pb.lc_val(w))


class BenesRoutingGadget(_SwitchNetworkGadget):
    """Benes network gadget for 2^k packets
    (benes_routing_gadget.hpp)."""

    def _build(self, packets):
        return self._rec(packets, 0, 0)

    def _rec(self, packets, col, row_offset):
        from ..common.routing import benes_num_columns
        n = len(packets)
        if n == 2:
            o0, o1 = self._mux_pair((col, row_offset),
                                    packets[0], packets[1])
            return [o0, o1]
        half = n // 2
        upper_in, lower_in = [], []
        for i in range(half):
            o0, o1 = self._mux_pair((col, row_offset + i),
                                    packets[2 * i], packets[2 * i + 1])
            upper_in.append(o0)
            lower_in.append(o1)
        out_col = col + benes_num_columns(n) - 1
        upper_out = self._rec(upper_in, col + 1, row_offset)
        lower_out = self._rec(lower_in, col + 1, row_offset + half // 2)
        out = [None] * n
        for j in range(half):
            o0, o1 = self._mux_pair((out_col, row_offset + j),
                                    upper_out[j], lower_out[j])
            out[2 * j] = o0
            out[2 * j + 1] = o1
        return out

    def _route(self, perm):
        return BenesNetwork(self.num_packets).route(perm)


class ASWaksmanRoutingGadget(_SwitchNetworkGadget):
    """AS-Waksman network gadget for any number of packets
    (as_waksman_routing_gadget.hpp; fewer switches than Benes)."""

    def _build(self, packets):
        return self._rec(packets, 0, ())

    def _rec(self, packets, depth, key):
        n = len(packets)
        if n == 1:
            return list(packets)
        if n == 2:
            o0, o1 = self._mux_pair(key + ("sw",), packets[0], packets[1])
            return [o0, o1]
        half_low = n // 2
        half_up = n - half_low
        upper_in = [None] * half_up
        lower_in = [None] * half_low
        for i in range(n // 2):
            o0, o1 = self._mux_pair(key + ("in", depth, i),
                                    packets[2 * i], packets[2 * i + 1])
            upper_in[i] = o0
            lower_in[i] = o1
        if n % 2 == 1:
            upper_in[half_up - 1] = packets[n - 1]
        upper_out = self._rec(upper_in, depth + 1, key + ("U",))
        lower_out = self._rec(lower_in, depth + 1, key + ("L",))
        out = [None] * n
        num_out_sw = (n - 1) // 2 if n % 2 == 1 else n // 2 - 1
        for j in range(num_out_sw):
            o0, o1 = self._mux_pair(key + ("out", depth, j),
                                    upper_out[j], lower_out[j])
            out[2 * j] = o0
            out[2 * j + 1] = o1
        if n % 2 == 1:
            out[n - 1] = upper_out[half_up - 1]
        else:
            out[n - 2] = upper_out[half_up - 1]
            out[n - 1] = lower_out[half_low - 1]
        return out

    def _route(self, perm):
        return ASWaksmanNetwork(self.num_packets).route(perm)
