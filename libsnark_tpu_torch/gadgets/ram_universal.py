"""RAM universal gadget + ram->r1cs reduction (reference
reductions/ram_to_r1cs/: ram_universal_gadget.hpp:88-140,
memory_checker_gadget, trace_lines; ram_to_r1cs.hpp:25).

The universal circuit for T steps of TinyRAM:

  * B boot lines (program + primary input written into memory),
  * per step: one instruction-FETCH memory line (read mem[pc]) and one
    DATA memory line (the step's load/store, or a dummy read of addr 0),
  * T chained TinyRAMCPUChecker instances,
  * an AS-Waksman routing network permuting all memory lines into
    (address, timestamp)-sorted order,
  * a memory checker on each consecutive sorted pair:
      - strictly increasing (address, timestamp) keys,
      - a read at a previously-touched address sees the last value,
      - a read at a fresh address sees 0,
  * accept condition: the final step executes ANSWER with value 0.

The boot trace is the circuit's public input (packed as
addr * 2^(2w) + value per line, reference packed_input semantics).
"""
from __future__ import annotations

from typing import List

from .protoboard import Gadget, Protoboard, PBVariable, PBVariableArray
from .basic import ComparisonGadget, generate_boolean_r1cs_constraint
from .routing_gadgets import ASWaksmanRoutingGadget
from .tinyram_cpu_checker import TinyRAMCPUChecker, IsZeroGadget, _lc
from ..common.integer_permutation import IntegerPermutation
from ..relations.tinyram import (
    TinyRAMParams, TinyRAMUnifiedExecutor, TinyRAMProgram, Opcode,
    tinyram_boot_trace)


class MemoryCheckerGadget(Gadget):
    """Order + value consistency for one consecutive sorted pair.

    Lines are (addr, timestamp, value_before, value_after) -- every
    memory op is a read-modify-write on one dword cell (byte/word
    stores rewrite the untouched part), so consistency is the chain
    rule: same address => before2 == after1; fresh address =>
    before2 == 0."""

    def __init__(self, pb, ap, tbits, line1, line2, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.ap, self.tbits = ap, tbits
        self.a1, self.t1, self.vb1, self.va1 = line1
        self.a2, self.t2, self.vb2, self.va2 = line2
        A = self.annot
        # strict key ordering: key = addr * 2^tbits + t
        self.less = PBVariable().allocate(pb, A("less"))
        self.leq = PBVariable().allocate(pb, A("leq"))
        key1 = _lc(self.a1) * (1 << tbits) + self.t1
        key2 = _lc(self.a2) * (1 << tbits) + self.t2
        self.cmp = ComparisonGadget(pb, ap.w + tbits, key1, key2,
                                    self.less, self.leq, A("cmp"))
        # same-address indicator
        self.same_addr = PBVariable().allocate(pb, A("same_addr"))
        self.is_zero = IsZeroGadget(pb, _lc(self.a2) - self.a1,
                                    self.same_addr, A("iszero"))
        self.zv = PBVariable().allocate(pb, A("zv"))

    def generate_r1cs_constraints(self):
        pb, A = self.pb, self.annot
        self.cmp.generate_r1cs_constraints()
        pb.add_r1cs_constraint(1, self.less, 1, A("strict_order"))
        self.is_zero.generate_r1cs_constraints()
        # zv = same_addr * after1
        pb.add_r1cs_constraint(self.same_addr, self.va1, self.zv, A("zv"))
        # chain rule: before2 = same_addr ? after1 : 0
        pb.add_r1cs_constraint(1, _lc(self.vb2) - self.zv, 0,
                               A("chain_consistency"))

    def generate_r1cs_witness(self):
        pb = self.pb
        self.cmp.generate_r1cs_witness()
        self.is_zero.generate_r1cs_witness()
        pb.setval(self.zv, pb.val(self.same_addr) * pb.lc_val(self.va1)
                  % pb.p)


class RAMUniversalGadget(Gadget):
    """T-step TinyRAM universal circuit."""

    def __init__(self, pb: Protoboard, ap: TinyRAMParams,
                 boot_trace_size_bound: int, time_bound: int,
                 annotation_prefix="ram"):
        super().__init__(pb, annotation_prefix)
        self.ap = ap
        self.B = boot_trace_size_bound
        self.T = time_bound
        w, k = ap.w, ap.k
        A = self.annot
        num_lines = self.B + 2 * self.T
        self.tbits = max(1, (num_lines - 1).bit_length() + 1)

        # ---- public input: packed boot lines -----------------------------
        self.packed_boot = PBVariableArray().allocate(
            pb, self.B, A("packed_boot"))
        pb.set_input_sizes(self.B)

        # ---- boot memory lines --------------------------------------------
        # line tuple = (addr, t, value_before, value_after)
        self.boot_addr = PBVariableArray().allocate(pb, self.B, A("baddr"))
        self.boot_val = PBVariableArray().allocate(pb, self.B, A("bval"))
        self.lines = []
        for i in range(self.B):
            # packed = addr * 2^(2w) + value; boot writes fresh cells
            self.lines.append((self.boot_addr[i], i, 0, self.boot_val[i]))

        # ---- per-step state -------------------------------------------------
        self.regs = [[PBVariable().allocate(pb, A(f"r{s}_{j}"))
                      for j in range(k)] for s in range(self.T + 1)]
        self.flags = [PBVariable().allocate(pb, A(f"f{s}"))
                      for s in range(self.T + 1)]
        self.pcs = [PBVariable().allocate(pb, A(f"pc{s}"))
                    for s in range(self.T + 1)]
        self.instrs = [PBVariable().allocate(pb, A(f"ins{s}"))
                       for s in range(self.T)]
        self.mem_addr = [PBVariable().allocate(pb, A(f"ma{s}"))
                         for s in range(self.T)]
        self.mem_in = [PBVariable().allocate(pb, A(f"mi{s}"))
                       for s in range(self.T)]
        self.mem_out = [PBVariable().allocate(pb, A(f"mo{s}"))
                        for s in range(self.T)]
        self.mem_st = [PBVariable().allocate(pb, A(f"ms{s}"))
                       for s in range(self.T)]

        self.checkers = []
        for s in range(self.T):
            self.checkers.append(TinyRAMCPUChecker(
                pb, ap, self.regs[s], self.flags[s], self.pcs[s],
                self.regs[s + 1], self.flags[s + 1], self.pcs[s + 1],
                self.instrs[s], self.mem_addr[s], self.mem_in[s],
                self.mem_out[s], self.mem_st[s], A(f"cpu_{s}")))
            # fetch line: read instr at pc (t = B + 2s); before == after
            self.lines.append((self.pcs[s], self.B + 2 * s,
                               self.instrs[s], self.instrs[s]))
            # data line (t = B + 2s + 1): read-modify-write of the cell
            self.lines.append((self.mem_addr[s], self.B + 2 * s + 1,
                               self.mem_in[s], self.mem_out[s]))

        # ---- routing: packets (addr, t, before, after) --------------------
        self.routed = [
            [PBVariable().allocate(pb, A(f"srt_{i}_{c}"))
             for c in range(4)] for i in range(num_lines)]
        inputs = [[_lc(a), _lc(t) if isinstance(t, int) else _lc(t),
                   _lc(vb), _lc(va)] for (a, t, vb, va) in self.lines]
        self.network = ASWaksmanRoutingGadget(
            pb, inputs, self.routed, A("route"))

        self.mem_checkers = []
        for i in range(num_lines - 1):
            self.mem_checkers.append(MemoryCheckerGadget(
                pb, ap, self.tbits,
                tuple(self.routed[i]), tuple(self.routed[i + 1]),
                A(f"mc_{i}")))

    # ------------------------------------------------------------ constraints
    def generate_r1cs_constraints(self):
        pb, A = self.pb, self.annot
        w = self.ap.w
        # boot unpacking: packed = addr * 2^(2w) + value, both range-checked
        self._boot_bits = []
        from .basic import PackingGadget
        for i in range(self.B):
            bits = PBVariableArray().allocate(pb, 3 * w, A(f"bb_{i}"))
            g = PackingGadget(pb, bits, self.packed_boot[i], A(f"bu_{i}"))
            g.generate_r1cs_constraints(True)
            self._boot_bits.append(g)
            # value = low 2w bits, addr = high w bits
            from .basic import pb_packing_sum
            pb.add_r1cs_constraint(1, pb_packing_sum(bits[: 2 * w]),
                                   self.boot_val[i], A(f"bval_{i}"))
            pb.add_r1cs_constraint(1, pb_packing_sum(bits[2 * w:]),
                                   self.boot_addr[i], A(f"baddr_{i}"))
        # initial state: all zero
        for j in range(self.ap.k):
            pb.add_r1cs_constraint(1, self.regs[0][j], 0, A(f"init_r{j}"))
        pb.add_r1cs_constraint(1, self.flags[0], 0, A("init_f"))
        pb.add_r1cs_constraint(1, self.pcs[0], 0, A("init_pc"))
        for c in self.checkers:
            c.generate_r1cs_constraints()
        self.network.generate_r1cs_constraints()
        for mc in self.mem_checkers:
            mc.generate_r1cs_constraints()
        # accept: final step is ANSWER with value 0
        last = self.checkers[-1]
        pb.add_r1cs_constraint(
            1, last.op_onehot.alpha[int(Opcode.ANSWER)], 1, A("is_answer"))
        pb.add_r1cs_constraint(1, last.a2, 0, A("answer_zero"))

    # --------------------------------------------------------------- witness
    def generate_r1cs_witness(self, program: TinyRAMProgram,
                              primary_input: List[int],
                              aux_tape: List[int]):
        pb, ap = self.pb, self.ap
        w = ap.w
        boot = tinyram_boot_trace(ap, program, primary_input)
        assert len(boot) <= self.B
        boot_items = sorted(boot.items())
        # pad boot lines with dummy writes to fresh high addresses
        # (2^w - 1 is reserved for the cpu checker's dummy reads)
        pad_addr = (1 << w) - 2
        while len(boot_items) < self.B:
            boot_items.append((pad_addr, 0))
            pad_addr -= 1
        for i, (addr, val) in enumerate(boot_items):
            pb.setval(self.packed_boot[i], addr * (1 << (2 * w)) + val)
            pb.setval(self.boot_addr[i], addr)
            pb.setval(self.boot_val[i], val)
            self._boot_bits[i].generate_r1cs_witness_from_packed()

        ex = TinyRAMUnifiedExecutor(ap, program)
        answer, accepted, trace = ex.run_from_boot(
            boot, primary_input, aux_tape, max_steps=self.T)
        assert len(trace) <= self.T
        # pad the trace by repeating the final (stalled ANSWER) step
        mem_after = dict(boot)
        for s in trace:
            if s.mem_op and s.mem_op[0] == "w":
                mem_after[s.mem_op[1]] = s.mem_op[3]
        while len(trace) < self.T:
            last = trace[-1]
            import dataclasses as _dc
            trace.append(_dc.replace(
                last, timestamp=last.timestamp + 1, pc=last.pc_after,
                regs_before=list(last.regs_after),
                flag_before=last.flag_after,
                regs_after=list(last.regs_after),
                flag_after=last.flag_after, pc_after=last.pc_after,
                mem_op=None,
                instruction=last.instruction))

        # per-step state + checker witnesses
        for j in range(ap.k):
            pb.setval(self.regs[0][j], 0)
        pb.setval(self.flags[0], 0)
        pb.setval(self.pcs[0], 0)
        fetch_mem = dict(boot)
        for s, step in enumerate(trace):
            pb.setval(self.pcs[s], step.pc)
            dword = step.instruction.as_dword(ap)
            pb.setval(self.instrs[s], dword)
            self.checkers[s].generate_r1cs_witness(step)
            pb.setval(self.pcs[s + 1], step.pc_after)
            pb.setval(self.flags[s + 1], 1 if step.flag_after else 0)
            for j in range(ap.k):
                pb.setval(self.regs[s + 1][j], step.regs_after[j])

        # ---- route to memory-sorted order ----------------------------------
        lines_vals = []
        for (a, t, vb, va) in self.lines:
            av = pb.lc_val(_lc(a))
            tv = t if isinstance(t, int) else pb.lc_val(_lc(t))
            vbv = pb.lc_val(_lc(vb))
            vav = pb.lc_val(_lc(va))
            lines_vals.append((av, tv, vbv, vav))
        order = sorted(range(len(lines_vals)),
                       key=lambda i: (lines_vals[i][0], lines_vals[i][1]))
        # permutation: input i -> position perm[i]
        perm_list = [0] * len(order)
        for pos, i in enumerate(order):
            perm_list[i] = pos
        perm = IntegerPermutation(perm_list)
        self.network.generate_r1cs_witness(perm)
        for mc in self.mem_checkers:
            mc.generate_r1cs_witness()
        return answer, accepted


def ram_to_r1cs_instance_map(p: int, ap: TinyRAMParams,
                             boot_trace_size_bound: int, time_bound: int):
    """Build the universal circuit; returns (protoboard, gadget)
    (reference ram_to_r1cs::instance_map)."""
    pb = Protoboard(p)
    g = RAMUniversalGadget(pb, ap, boot_trace_size_bound, time_bound)
    g.generate_r1cs_constraints()
    return pb, g
