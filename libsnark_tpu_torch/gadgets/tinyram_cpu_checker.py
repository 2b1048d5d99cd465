"""In-circuit TinyRAM CPU checker (reference gadgetlib1/gadgets/
cpu_checkers/tinyram/: argument decoder, ALU arithmetic/bitwise ops,
control flow, consistency enforcer -- components/tinyram_cpu_checker).

One gadget instance verifies ONE execution step: instruction decode,
every opcode's result computed in parallel, a 32-way one-hot select by
opcode, then register/flag/pc consistency. Word width w, k registers.

Design notes vs the reference's 6,700-LoC checker: same constraint
semantics, built compositionally from the basic gadget set
(packing / comparison / inner-product / one-hot muxing).
"""
from __future__ import annotations

from typing import List

from .protoboard import Gadget, PBVariable, PBVariableArray
from .basic import (PackingGadget, generate_boolean_r1cs_constraint,
                    pb_packing_sum, pb_sum, ComparisonGadget)
from ..relations.variable import LinearCombination, Variable
from ..relations.tinyram import Opcode, TinyRAMParams


def _lc(x):
    return LinearCombination._coerce(x)


class WordGadget(Gadget):
    """A w-bit word: packed variable + bit decomposition (the reference's
    word_variable_gadget)."""

    def __init__(self, pb, w, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.w = w
        self.packed = PBVariable().allocate(pb, self.annot("packed"))
        self.bits = PBVariableArray().allocate(pb, w, self.annot("bits"))
        self.pack = PackingGadget(pb, self.bits, self.packed,
                                  self.annot("pack"))

    def generate_r1cs_constraints(self, enforce_bitness=True):
        self.pack.generate_r1cs_constraints(enforce_bitness)

    def set(self, value: int):
        self.pb.setval(self.packed, value)
        self.pack.generate_r1cs_witness_from_packed()

    def msb(self):
        return self.bits[self.w - 1]


class OneHotGadget(Gadget):
    """alpha[i] = (index == i) for i < n; index < n enforced
    (loose_multiplexing specialised to in-range)."""

    def __init__(self, pb, index, n, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.index = index
        self.n = n
        self.alpha = PBVariableArray().allocate(pb, n, self.annot("alpha"))

    def generate_r1cs_constraints(self):
        for i in range(self.n):
            self.pb.add_r1cs_constraint(
                self.alpha[i], _lc(self.index) - i, 0,
                self.annot(f"alpha_{i}"))
            generate_boolean_r1cs_constraint(self.pb, self.alpha[i],
                                             self.annot(f"bool_{i}"))
        self.pb.add_r1cs_constraint(1, pb_sum(self.alpha), 1,
                                    self.annot("sum_one"))

    def generate_r1cs_witness(self):
        idx = self.pb.lc_val(self.index)
        assert idx < self.n, f"one-hot index {idx} out of range {self.n}"
        for i in range(self.n):
            self.pb.setval(self.alpha[i], 1 if i == idx else 0)


class IsZeroGadget(Gadget):
    """out = (x == 0) via the inverse trick."""

    def __init__(self, pb, x, out, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.x, self.out = _lc(x), out
        self.inv = PBVariable().allocate(pb, self.annot("inv"))

    def generate_r1cs_constraints(self):
        # x * inv = 1 - out ; x * out = 0
        self.pb.add_r1cs_constraint(self.x, self.inv,
                                    1 - _lc(self.out), self.annot("inv"))
        self.pb.add_r1cs_constraint(self.x, self.out, 0, self.annot("zero"))

    def generate_r1cs_witness(self):
        v = self.pb.lc_val(self.x)
        p = self.pb.p
        if v == 0:
            self.pb.setval(self.out, 1)
            self.pb.setval(self.inv, 0)
        else:
            self.pb.setval(self.out, 0)
            self.pb.setval(self.inv, pow(v, -1, p))


class TinyRAMCPUChecker(Gadget):
    """Check one step: (regs, flag, pc) --instr--> (regs', flag', pc').

    Public interface variables (allocated by the caller):
      regs_before/regs_after : lists of k packed word vars
      flag_before/flag_after : boolean vars
      pc_before/pc_after     : packed vars (word-sized)
      instruction            : packed dword var (the fetched value)
      mem_addr, mem_in, mem_out, mem_is_store : the step's data-memory op
      tape_value, tape_flag  : nondeterministic READ advice
      is_answer, answer_val  : exposed for the accept condition
    """

    def __init__(self, pb, ap: TinyRAMParams,
                 regs_before, flag_before, pc_before,
                 regs_after, flag_after, pc_after,
                 instruction,
                 mem_addr, mem_in, mem_out, mem_is_store,
                 annotation_prefix="", dummy_addr=None):
        super().__init__(pb, annotation_prefix)
        self.ap = ap
        w, k = ap.w, ap.k
        self.dummy_addr = ((1 << w) - 1 if dummy_addr is None
                           else dummy_addr)
        self.regs_before, self.regs_after = regs_before, regs_after
        self.flag_before, self.flag_after = flag_before, flag_after
        self.pc_before, self.pc_after = pc_before, pc_after
        self.instruction = instruction
        self.mem_addr, self.mem_in, self.mem_out = mem_addr, mem_in, mem_out
        self.mem_is_store = mem_is_store

        A = self.annot

        # ---- decode: unpack the instruction dword ------------------------
        self.instr_bits = PBVariableArray().allocate(
            pb, 2 * w, A("instr_bits"))
        self.unpack_instr = PackingGadget(pb, self.instr_bits,
                                          instruction, A("unpack_instr"))
        raw = ap.reg_arg_or_imm_width + ap.instruction_padding_width
        self.arg2_field = self.instr_bits[:ap.reg_arg_or_imm_width]
        off = raw
        self.arg1_bits = self.instr_bits[off: off + ap.reg_arg_width]
        off += ap.reg_arg_width
        self.des_bits = self.instr_bits[off: off + ap.reg_arg_width]
        off += ap.reg_arg_width
        self.imm_bit = self.instr_bits[off]
        off += 1
        self.opcode_bits = self.instr_bits[off: off + 5]

        self.opcode = PBVariable().allocate(pb, A("opcode"))
        self.pack_opcode = PackingGadget(pb, self.opcode_bits, self.opcode,
                                         A("pack_opcode"))
        self.desidx = PBVariable().allocate(pb, A("desidx"))
        self.pack_des = PackingGadget(pb, self.des_bits, self.desidx,
                                      A("pack_des"))
        self.arg1idx = PBVariable().allocate(pb, A("arg1idx"))
        self.pack_arg1 = PackingGadget(pb, self.arg1_bits, self.arg1idx,
                                       A("pack_arg1"))
        self.arg2_packed = PBVariable().allocate(pb, A("arg2_packed"))
        self.pack_arg2 = PackingGadget(pb, self.arg2_field,
                                       self.arg2_packed, A("pack_arg2"))

        self.op_onehot = OneHotGadget(pb, self.opcode, 32, A("op_onehot"))
        self.des_onehot = OneHotGadget(pb, self.desidx, k, A("des_onehot"))
        self.arg1_onehot = OneHotGadget(pb, self.arg1idx, k,
                                        A("arg1_onehot"))

        # ---- operand values -----------------------------------------------
        # a1 = regs[arg1idx]; r2 = regs[arg2idx]; a2 = imm ? imm_val : r2
        self.a1 = PBVariable().allocate(pb, A("a1"))
        self.r2 = PBVariable().allocate(pb, A("r2"))
        self.a2 = PBVariable().allocate(pb, A("a2"))
        self.des_old = PBVariable().allocate(pb, A("des_old"))
        # arg2-as-register one-hot: only meaningful when !imm; index may
        # exceed k when imm (mask in witness, constraint relaxed by imm)
        self.arg2_reg_onehot = PBVariableArray().allocate(
            pb, k, A("arg2_onehot"))

        # words with bit decompositions for a1, a2
        self.a1_word = WordGadget(pb, w, A("a1_word"))
        self.a2_word = WordGadget(pb, w, A("a2_word"))

        # ---- memory masking (byte/word access into dword cells) -----------
        # (reference memory_masking_gadget.tcc + cpu_checker.tcc:156-291:
        # memory is dword cells at address a2 >> subaddr_len; mem_in/out
        # are the PREV/NEXT dword; subcontents the addressed byte/word)
        sal = ap.subaddr_len
        nbytes = 2 * ap.bytes_in_word
        self.des_word = WordGadget(pb, w, A("des_word"))
        self.mem_prev_bits = PBVariableArray().allocate(
            pb, 2 * w, A("mem_prev_bits"))
        self.unpack_mem_prev = PackingGadget(pb, self.mem_prev_bits,
                                             mem_in, A("unpack_mprev"))
        self.mem_next_bits = PBVariableArray().allocate(
            pb, 2 * w, A("mem_next_bits"))
        self.unpack_mem_next = PackingGadget(pb, self.mem_next_bits,
                                             mem_out, A("unpack_mnext"))
        self.subcontents = PBVariable().allocate(pb, A("subcontents"))
        self.is_subaddress = PBVariableArray().allocate(
            pb, nbytes, A("is_subaddress"))
        self.is_byte = PBVariableArray().allocate(pb, nbytes, A("is_byte"))
        self.is_word0 = PBVariable().allocate(pb, A("is_word0"))
        self.is_word1 = PBVariable().allocate(pb, A("is_word1"))
        self.masked_t = PBVariableArray().allocate(
            pb, nbytes + 2, A("masked_t"))     # indicator * masked_value

        # ---- per-opcode results -------------------------------------------
        self.results = {}       # opcode -> (result_lc, flag_lc)
        self._aux_gadgets: List[Gadget] = []
        self._build_alu()

        # pc candidates
        self.pc_plus_one = _lc(self.pc_before) + 1

    # ------------------------------------------------------------- ALU build
    def _build_alu(self):
        pb, w = self.pb, self.ap.w
        A = self.annot
        a1b, a2b = self.a1_word.bits, self.a2_word.bits

        # bitwise: AND/OR/XOR/NOT (reference alu_bitwise)
        and_bits = PBVariableArray().allocate(pb, w, A("and_bits"))
        self._bitwise = []
        for i in range(w):
            self._bitwise.append(("and", a1b[i], a2b[i], and_bits[i]))
        or_lc = (pb_packing_sum(a1b) + pb_packing_sum(a2b)
                 - pb_packing_sum(and_bits))
        xor_lc = or_lc - pb_packing_sum(and_bits)
        not_lc = LinearCombination((1 << w) - 1) - self.a2
        and_lc = pb_packing_sum(and_bits)

        zf = {}
        for name, lc in (("and", and_lc), ("or", or_lc), ("xor", xor_lc),
                         ("not", not_lc)):
            out = PBVariable().allocate(pb, A(f"z_{name}"))
            g = IsZeroGadget(pb, lc, out, A(f"iszero_{name}"))
            self._aux_gadgets.append(g)
            zf[name] = out
        self.results[Opcode.AND] = (and_lc, _lc(zf["and"]))
        self.results[Opcode.OR] = (or_lc, _lc(zf["or"]))
        self.results[Opcode.XOR] = (xor_lc, _lc(zf["xor"]))
        self.results[Opcode.NOT] = (not_lc, _lc(zf["not"]))

        # ADD / SUB (alu_arithmetic): unpack into w+1 bits
        self.add_word = PBVariableArray().allocate(pb, w + 1, A("add_bits"))
        self.add_unpack = PackingGadget(
            pb, self.add_word, _lc(self.a1) + self.a2, A("add_unpack"))
        self.results[Opcode.ADD] = (pb_packing_sum(self.add_word[:w]),
                                    _lc(self.add_word[w]))
        self.sub_word = PBVariableArray().allocate(pb, w + 1, A("sub_bits"))
        self.sub_unpack = PackingGadget(
            pb, self.sub_word,
            LinearCombination(1 << w) + self.a1 - self.a2, A("sub_unpack"))
        self.results[Opcode.SUB] = (pb_packing_sum(self.sub_word[:w]),
                                    1 - _lc(self.sub_word[w]))

        # MULL / UMULH: product unpacked to 2w bits
        self.prod = PBVariable().allocate(pb, A("prod"))
        self.prod_bits = PBVariableArray().allocate(pb, 2 * w, A("prod_bits"))
        self.prod_unpack = PackingGadget(pb, self.prod_bits, self.prod,
                                         A("prod_unpack"))
        hi = pb_packing_sum(self.prod_bits[w:])
        lo = pb_packing_sum(self.prod_bits[:w])
        self.mul_hi_nz = PBVariable().allocate(pb, A("mul_hi_nz"))
        hi_zero = PBVariable().allocate(pb, A("mul_hi_zero"))
        self._aux_gadgets.append(IsZeroGadget(pb, hi, hi_zero,
                                              A("iszero_hi")))
        self._mul_hi_zero = hi_zero
        self.results[Opcode.MULL] = (lo, 1 - _lc(hi_zero))
        self.results[Opcode.UMULH] = (hi, 1 - _lc(hi_zero))

        # SMULH: signed product, offset-encoded into 2w bits
        # p = (a1 - 2^w m1)(a2 - 2^w m2); p_enc = p + 2^(2w-1)
        self.sprod_bits = PBVariableArray().allocate(
            pb, 2 * w, A("sprod_bits"))
        self._sprod_pack = PackingGadget(
            pb, self.sprod_bits, PBVariable().allocate(pb, A("sprod")),
            A("sprod_unpack"))
        self.sprod = self._sprod_pack.packed
        smulh_hi = pb_packing_sum(self.sprod_bits[w:])
        # result = (hi - 2^(w-1)) mod 2^w = hi with top bit flipped
        smulh_res = (smulh_hi - _lc(self.sprod_bits[2 * w - 1]) * (1 << (w - 1))
                     + (1 - _lc(self.sprod_bits[2 * w - 1])) * (1 << (w - 1)))
        # flag: p outside [-2^(w-1), 2^(w-1)) -- p_enc outside
        # [2^(2w-1)-2^(w-1), 2^(2w-1)+2^(w-1))
        self.smulh_ge = PBVariable().allocate(pb, A("smulh_ge"))
        self.smulh_lt = PBVariable().allocate(pb, A("smulh_lt"))
        ge_l = PBVariable().allocate(pb, A("smulh_ge_l"))
        lt_l = PBVariable().allocate(pb, A("smulh_lt_l"))
        lo_bound = (1 << (2 * w - 1)) - (1 << (w - 1))
        hi_bound = (1 << (2 * w - 1)) + (1 << (w - 1))
        self._smulh_cmp1 = ComparisonGadget(
            pb, 2 * w + 1, LinearCombination(lo_bound) - 0, self.sprod,
            ge_l, self.smulh_ge, A("smulh_cmp1"))   # lo_bound <= p_enc
        self._smulh_cmp2 = ComparisonGadget(
            pb, 2 * w + 1, self.sprod, LinearCombination(hi_bound) - 1,
            lt_l, self.smulh_lt, A("smulh_cmp2"))   # p_enc <= hi_bound-1
        in_range = PBVariable().allocate(pb, A("smulh_inrange"))
        self._smulh_in_range = in_range
        self.results[Opcode.SMULH] = (smulh_res, 1 - _lc(in_range))

        # UDIV / UMOD: advice quotient/remainder
        self.div_q = PBVariable().allocate(pb, A("div_q"))
        self.div_r = PBVariable().allocate(pb, A("div_r"))
        self.a2_zero = PBVariable().allocate(pb, A("a2_zero"))
        self._aux_gadgets.append(IsZeroGadget(pb, self.a2, self.a2_zero,
                                              A("iszero_a2")))
        self.divr_less = PBVariable().allocate(pb, A("divr_less"))
        self.divr_leq = PBVariable().allocate(pb, A("divr_leq"))
        self._div_cmp = ComparisonGadget(
            pb, w, self.div_r, self.a2, self.divr_less, self.divr_leq,
            A("div_cmp"))
        self.div_q_bits = PBVariableArray().allocate(pb, w, A("div_q_bits"))
        self._div_q_pack = PackingGadget(pb, self.div_q_bits, self.div_q,
                                         A("div_q_pack"))
        self.results[Opcode.UDIV] = (_lc(self.div_q), _lc(self.a2_zero))
        self.results[Opcode.UMOD] = (_lc(self.div_r), _lc(self.a2_zero))

        # SHL / SHR: one-hot over effective shift amounts 0..w
        self.sh_amt = PBVariable().allocate(pb, A("sh_amt"))
        self.sh_onehot = OneHotGadget(pb, self.sh_amt, w + 1, A("sh_onehot"))
        self.sh_oor = PBVariable().allocate(pb, A("sh_oor"))  # a2 > w
        shl_terms = LinearCombination()
        shr_terms = LinearCombination()
        self.shl_parts = PBVariableArray().allocate(pb, w + 1, A("shl_p"))
        self.shr_parts = PBVariableArray().allocate(pb, w + 1, A("shr_p"))
        for i in range(w + 1):
            shl_i = LinearCombination()
            for j in range(w - i):
                shl_i = shl_i + _lc(a1b[j]) * (1 << (i + j))
            shr_i = LinearCombination()
            for j in range(i, w):
                shr_i = shr_i + _lc(a1b[j]) * (1 << (j - i))
            self._aux_gadgets.append(_ProductGadget(
                pb, _lc(self.sh_onehot.alpha[i]), shl_i, self.shl_parts[i],
                A(f"shl_{i}")))
            self._aux_gadgets.append(_ProductGadget(
                pb, _lc(self.sh_onehot.alpha[i]), shr_i, self.shr_parts[i],
                A(f"shr_{i}")))
        self.results[Opcode.SHL] = (pb_sum(self.shl_parts),
                                    _lc(self.a1_word.msb()))
        self.results[Opcode.SHR] = (pb_sum(self.shr_parts),
                                    _lc(self.a1_word.bits[0]))

        # compares
        self.cmp_eq = PBVariable().allocate(pb, A("cmp_eq"))
        self._aux_gadgets.append(IsZeroGadget(
            pb, _lc(self.a1) - self.a2, self.cmp_eq, A("cmpe")))
        self.cmp_less = PBVariable().allocate(pb, A("cmp_less"))
        self.cmp_leq = PBVariable().allocate(pb, A("cmp_leq"))
        # a2 < a1  <=> CMPA (a1 > a2)
        self._cmp_u = ComparisonGadget(pb, w, self.a2, self.a1,
                                       self.cmp_less, self.cmp_leq,
                                       A("cmp_u"))
        self.results[Opcode.CMPE] = (_lc(self.des_old), _lc(self.cmp_eq))
        self.results[Opcode.CMPA] = (_lc(self.des_old), _lc(self.cmp_less))
        self.results[Opcode.CMPAE] = (_lc(self.des_old), _lc(self.cmp_leq))
        # signed compares: flip MSBs (adds 2^(w-1) mod 2^w)
        s1 = (_lc(self.a1) + (1 << (w - 1))
              - _lc(a1b[w - 1]) * (1 << w))
        s2 = (_lc(self.a2) + (1 << (w - 1))
              - _lc(a2b[w - 1]) * (1 << w))
        self.scmp_less = PBVariable().allocate(pb, A("scmp_less"))
        self.scmp_leq = PBVariable().allocate(pb, A("scmp_leq"))
        self._cmp_s = ComparisonGadget(pb, w, s2, s1, self.scmp_less,
                                       self.scmp_leq, A("cmp_s"))
        self.results[Opcode.CMPG] = (_lc(self.des_old), _lc(self.scmp_less))
        self.results[Opcode.CMPGE] = (_lc(self.des_old), _lc(self.scmp_leq))

        # MOV / CMOV
        self.results[Opcode.MOV] = (_lc(self.a2), _lc(self.flag_before))
        cmov_res = PBVariable().allocate(pb, A("cmov_res"))
        self._aux_gadgets.append(_MuxGadget(
            pb, _lc(self.flag_before), _lc(self.a2), _lc(self.des_old),
            cmov_res, A("cmov")))
        self.results[Opcode.CMOV] = (_lc(cmov_res), _lc(self.flag_before))

        # control flow / stalls keep registers; result = des_old
        for op in (Opcode.JMP, Opcode.CJMP, Opcode.CNJMP, Opcode.OP_10111,
                   Opcode.OP_11000, Opcode.OP_11001, Opcode.STOREB,
                   Opcode.STOREW, Opcode.ANSWER):
            self.results[op] = (_lc(self.des_old), _lc(self.flag_before))

        # memory loads: result = the addressed byte/word of the dword
        self.results[Opcode.LOADB] = (_lc(self.subcontents),
                                      _lc(self.flag_before))
        self.results[Opcode.LOADW] = (_lc(self.subcontents),
                                      _lc(self.flag_before))

        # READ: nondeterministic tape advice
        self.tape_value = PBVariable().allocate(pb, A("tape_value"))
        self.tape_flag = PBVariable().allocate(pb, A("tape_flag"))
        self.results[Opcode.READ] = (_lc(self.tape_value),
                                     _lc(self.tape_flag))

    # ---------------------------------------------------------- constraints
    def generate_r1cs_constraints(self):
        pb, w, k = self.pb, self.ap.w, self.ap.k
        A = self.annot
        self.unpack_instr.generate_r1cs_constraints(True)
        self.pack_opcode.generate_r1cs_constraints(False)
        self.pack_des.generate_r1cs_constraints(False)
        self.pack_arg1.generate_r1cs_constraints(False)
        self.pack_arg2.generate_r1cs_constraints(False)
        self.op_onehot.generate_r1cs_constraints()
        self.des_onehot.generate_r1cs_constraints()
        self.arg1_onehot.generate_r1cs_constraints()

        # a1 = <arg1_onehot, regs_before>; des_old = <des_onehot, regs>
        self._sel_t = {}
        for name, onehot, out in (
                ("a1", self.arg1_onehot.alpha, self.a1),
                ("des_old", self.des_onehot.alpha, self.des_old)):
            terms = []
            for j in range(k):
                t = PBVariable().allocate(pb, A(f"{name}_t{j}"))
                pb.add_r1cs_constraint(onehot[j], self.regs_before[j], t,
                                       A(f"{name}_sel_{j}"))
                terms.append(t)
            self._sel_t[name] = terms
            pb.add_r1cs_constraint(1, pb_sum(terms), out, A(f"{name}_sum"))

        # arg2 register one-hot: when !imm, alpha_j (arg2_packed - j) = 0
        imm = _lc(self.imm_bit)
        for j in range(k):
            generate_boolean_r1cs_constraint(pb, self.arg2_reg_onehot[j],
                                             A(f"a2oh_bool_{j}"))
            # (1-imm)-gated: alpha_j * (arg2_packed - j) = 0 always works
            # since witness sets alpha only when !imm and index == j
            pb.add_r1cs_constraint(self.arg2_reg_onehot[j],
                                   _lc(self.arg2_packed) - j, 0,
                                   A(f"a2oh_{j}"))
        pb.add_r1cs_constraint(1, pb_sum(self.arg2_reg_onehot),
                               1 - imm, A("a2oh_sum"))
        terms = []
        for j in range(k):
            t = PBVariable().allocate(pb, A(f"r2_t{j}"))
            pb.add_r1cs_constraint(self.arg2_reg_onehot[j],
                                   self.regs_before[j], t, A(f"r2_sel_{j}"))
            terms.append(t)
        self._sel_t["r2"] = terms
        pb.add_r1cs_constraint(1, pb_sum(terms), self.r2, A("r2_sum"))
        # a2 = imm ? arg2_packed : r2
        pb.add_r1cs_constraint(
            imm, _lc(self.arg2_packed) - self.r2,
            _lc(self.a2) - self.r2, A("a2_mux"))

        # word decompositions
        pb.add_r1cs_constraint(1, self.a1, self.a1_word.packed, A("a1_eq"))
        pb.add_r1cs_constraint(1, self.a2, self.a2_word.packed, A("a2_eq"))
        self.a1_word.generate_r1cs_constraints(True)
        self.a2_word.generate_r1cs_constraints(True)

        # ALU constraints
        for kind, x, y, o in self._bitwise:
            pb.add_r1cs_constraint(x, y, o, A("and_bit"))
        self.add_unpack.generate_r1cs_constraints(True)
        self.sub_unpack.generate_r1cs_constraints(True)
        pb.add_r1cs_constraint(self.a1, self.a2, self.prod, A("mul"))
        self.prod_unpack.generate_r1cs_constraints(True)
        # signed product: (a1 - 2^w m1)(a2 - 2^w m2) + 2^(2w-1) = sprod
        w_ = w
        s1 = _lc(self.a1) - _lc(self.a1_word.msb()) * (1 << w_)
        s2 = _lc(self.a2) - _lc(self.a2_word.msb()) * (1 << w_)
        pb.add_r1cs_constraint(
            s1, s2, _lc(self.sprod) - (1 << (2 * w_ - 1)), A("smul"))
        self._sprod_pack.generate_r1cs_constraints(True)
        self._smulh_cmp1.generate_r1cs_constraints()
        self._smulh_cmp2.generate_r1cs_constraints()
        pb.add_r1cs_constraint(self.smulh_ge, self.smulh_lt,
                               self._smulh_in_range, A("smulh_and"))
        # division: a2 * q + r = a1 ; (r < a2) unless a2 == 0;
        # q = 0 and r = a1 when a2 == 0 (then a2*q + r = a1 still holds)
        pb.add_r1cs_constraint(self.a2, self.div_q,
                               _lc(self.a1) - self.div_r, A("div"))
        self._div_q_pack.generate_r1cs_constraints(True)
        self._div_cmp.generate_r1cs_constraints()
        pb.add_r1cs_constraint(1 - _lc(self.a2_zero),
                               1 - _lc(self.divr_less), 0, A("div_range"))
        # shifts: effective amount = min(a2, w); out-of-range -> amt = w..
        # enforced: sh_oor boolean; when !oor: sh_amt == a2;
        # when oor: sh_amt == w and a2 > w... we enforce a2 >= sh_amt and
        # correctness via the one-hot width; cheap relaxation: the shift
        # result for any amt >= w is 0 for SHL (all terms dropped when
        # i = w ... only bit contributions j < w - i) and 0 for SHR.
        generate_boolean_r1cs_constraint(pb, self.sh_oor, A("sh_oor"))
        self.sh_onehot.generate_r1cs_constraints()
        # (1 - oor) * (a2 - sh_amt) = 0 ; oor * (sh_amt - w) = 0
        pb.add_r1cs_constraint(1 - _lc(self.sh_oor),
                               _lc(self.a2) - self.sh_amt, 0, A("sh_eq"))
        pb.add_r1cs_constraint(self.sh_oor, _lc(self.sh_amt) - w, 0,
                               A("sh_w"))
        self._cmp_u.generate_r1cs_constraints()
        self._cmp_s.generate_r1cs_constraints()
        for g in self._aux_gadgets:
            g.generate_r1cs_constraints()

        # ---- one-hot opcode selection of result / flag -------------------
        alpha = self.op_onehot.alpha
        self._res_t, self._flag_t = [], []
        for op in range(32):
            res_lc, flag_lc = self.results[Opcode(op)]
            tr = PBVariable().allocate(pb, A(f"res_t{op}"))
            tf = PBVariable().allocate(pb, A(f"flag_t{op}"))
            pb.add_r1cs_constraint(alpha[op], res_lc, tr, A(f"res_{op}"))
            pb.add_r1cs_constraint(alpha[op], flag_lc, tf, A(f"flag_{op}"))
            self._res_t.append(tr)
            self._flag_t.append(tf)
        self.result = PBVariable().allocate(pb, A("result"))
        pb.add_r1cs_constraint(1, pb_sum(self._res_t), self.result,
                               A("result_sum"))
        pb.add_r1cs_constraint(1, pb_sum(self._flag_t), self.flag_after,
                               A("flag_sum"))

        # ---- register update ----------------------------------------------
        writes = pb_sum([alpha[int(op)] for op in
                         (Opcode.AND, Opcode.OR, Opcode.XOR, Opcode.NOT,
                          Opcode.ADD, Opcode.SUB, Opcode.MULL, Opcode.UMULH,
                          Opcode.SMULH, Opcode.UDIV, Opcode.UMOD, Opcode.SHL,
                          Opcode.SHR, Opcode.MOV, Opcode.CMOV, Opcode.LOADB,
                          Opcode.LOADW, Opcode.READ)])
        self.writes_reg = PBVariable().allocate(pb, A("writes_reg"))
        pb.add_r1cs_constraint(1, writes, self.writes_reg, A("writes"))
        self._wsel_vars = []
        for j in range(k):
            # sel_j = des_onehot[j] * writes_reg
            sel = PBVariable().allocate(pb, A(f"wsel_{j}"))
            pb.add_r1cs_constraint(self.des_onehot.alpha[j],
                                   self.writes_reg, sel, A(f"wsel_c_{j}"))
            # reg_after = sel * (result - reg_before) + reg_before
            pb.add_r1cs_constraint(
                sel, _lc(self.result) - self.regs_before[j],
                _lc(self.regs_after[j]) - self.regs_before[j],
                A(f"reg_upd_{j}"))
            self._wsel_vars.append(sel)
        # ---- pc update ------------------------------------------------------
        is_jmp = alpha[int(Opcode.JMP)]
        is_cjmp = alpha[int(Opcode.CJMP)]
        is_cnjmp = alpha[int(Opcode.CNJMP)]
        stall = pb_sum([alpha[int(o)] for o in
                        (Opcode.ANSWER, Opcode.OP_10111, Opcode.OP_11000,
                         Opcode.OP_11001)])
        # jump_taken = jmp + cjmp*flag_before + cnjmp*(1-flag_before)
        self._tj1 = PBVariable().allocate(pb, A("tj1"))
        pb.add_r1cs_constraint(is_cjmp, self.flag_before, self._tj1,
                               A("cjmp_t"))
        self._tj2 = PBVariable().allocate(pb, A("tj2"))
        pb.add_r1cs_constraint(is_cnjmp, 1 - _lc(self.flag_before),
                               self._tj2, A("cnjmp_t"))
        jump_taken = _lc(is_jmp) + self._tj1 + self._tj2
        self.jump_taken = PBVariable().allocate(pb, A("jump_taken"))
        pb.add_r1cs_constraint(1, jump_taken, self.jump_taken, A("jt"))
        self.stalls = PBVariable().allocate(pb, A("stalls"))
        pb.add_r1cs_constraint(1, stall, self.stalls, A("st"))
        # pc_after = jump? a2 : (stall? pc : pc+1)
        # encode: pc_after - (pc+1) = jump*(a2 - pc - 1) + stall*(-1)
        self._t_jmp = PBVariable().allocate(pb, A("t_jmp"))
        pb.add_r1cs_constraint(self.jump_taken,
                               _lc(self.a2) - self.pc_plus_one, self._t_jmp,
                               A("pc_jmp"))
        pb.add_r1cs_constraint(
            1, self.pc_plus_one + self._t_jmp - _lc(self.stalls),
            self.pc_after, A("pc_after"))

        # ---- memory op wiring ------------------------------------------------
        # Dword-cell memory with byte/word masking (reference
        # memory_masking_gadget.tcc + tinyram_cpu_checker.tcc:156-291).
        ap = self.ap
        sal = ap.subaddr_len
        nbytes = 2 * ap.bytes_in_word
        is_load = (_lc(alpha[int(Opcode.LOADB)])
                   + alpha[int(Opcode.LOADW)])
        is_store = (_lc(alpha[int(Opcode.STOREB)])
                    + alpha[int(Opcode.STOREW)])
        pb.add_r1cs_constraint(1, is_store, self.mem_is_store, A("is_store"))
        touches = is_load + is_store
        self.touches_mem = PBVariable().allocate(pb, A("touches_mem"))
        pb.add_r1cs_constraint(1, touches, self.touches_mem, A("touch"))
        # ls_addr = a2 >> subaddr_len (from a2's bit decomposition)
        a2b = self.a2_word.bits
        ls_addr = LinearCombination()
        for i in range(sal, w):
            ls_addr = ls_addr + _lc(a2b[i]) * (1 << (i - sal))
        # mem_addr = touches ? ls_addr : DUMMY (a reserved never-written
        # address so the sorted-memory check sees a fresh zero read)
        D = self.dummy_addr
        pb.add_r1cs_constraint(self.touches_mem, ls_addr - D,
                               _lc(self.mem_addr) - D, A("mem_addr"))
        # dword bit decompositions of prev/next cell contents
        self.unpack_mem_prev.generate_r1cs_constraints(True)
        self.unpack_mem_next.generate_r1cs_constraints(True)
        self.des_word.generate_r1cs_constraints(True)
        pb.add_r1cs_constraint(1, self.des_word.packed, self.des_old,
                               A("des_word_eq"))
        # non-store steps write back the same dword (loads + dummies)
        pb.add_r1cs_constraint(1 - _lc(self.mem_is_store),
                               _lc(self.mem_in) - self.mem_out, 0,
                               A("rmw_identity"))
        # non-touching steps see value 0 (at the dummy address)
        pb.add_r1cs_constraint(1 - _lc(self.touches_mem), self.mem_out, 0,
                               A("dummy_mem"))

        # subaddress one-hot over byte positions
        sub_lc = LinearCombination()
        for i in range(sal):
            sub_lc = sub_lc + _lc(a2b[i]) * (1 << i)
        for i in range(nbytes):
            pb.add_r1cs_constraint(self.is_subaddress[i], sub_lc - i, 0,
                                   A(f"is_sub_{i}"))
            generate_boolean_r1cs_constraint(pb, self.is_subaddress[i],
                                             A(f"sub_bool_{i}"))
        pb.add_r1cs_constraint(1, pb_sum(self.is_subaddress), 1,
                               A("sub_onehot"))
        access_is_byte = (_lc(alpha[int(Opcode.LOADB)])
                          + alpha[int(Opcode.STOREB)])
        access_is_word = _lc(1) - access_is_byte
        for i in range(nbytes):
            pb.add_r1cs_constraint(access_is_byte, self.is_subaddress[i],
                                   self.is_byte[i], A(f"is_byte_{i}"))
        sub_msb = a2b[sal - 1]
        pb.add_r1cs_constraint(access_is_word, 1 - _lc(sub_msb),
                               self.is_word0, A("is_word0"))
        pb.add_r1cs_constraint(access_is_word, _lc(sub_msb),
                               self.is_word1, A("is_word1"))

        # masked-out values of the prev dword (addressed part zeroed)
        pbits = self.mem_prev_bits
        mask_vals = []
        mask_vals.append(pb_packing_sum(pbits[w: 2 * w]) * (1 << w))
        mask_vals.append(pb_packing_sum(pbits[: w]))
        for i in range(nbytes):
            mask_vals.append(
                _lc(self.mem_in)
                - pb_packing_sum(pbits[8 * i: 8 * (i + 1)]) * (1 << (8 * i)))
        indicators = [_lc(self.is_word0), _lc(self.is_word1)] + [
            _lc(self.is_byte[i]) for i in range(nbytes)]
        masked_sum = LinearCombination()
        for j, (ind, val) in enumerate(zip(indicators, mask_vals)):
            pb.add_r1cs_constraint(ind, val, self.masked_t[j],
                                   A(f"masked_t_{j}"))
            masked_sum = masked_sum + self.masked_t[j]
        # shift * subcontents = mem_out - masked_out_prev
        shift = (_lc(self.is_word0) + _lc(self.is_word1) * (1 << w))
        for i in range(nbytes):
            shift = shift + _lc(self.is_byte[i]) * (1 << (8 * i))
        pb.add_r1cs_constraint(shift, self.subcontents,
                               _lc(self.mem_out) - masked_sum,
                               A("mask_difference"))
        # stored subcontents: STOREB writes des_old's low byte, STOREW
        # writes the full des_old word
        pb.add_r1cs_constraint(
            alpha[int(Opcode.STOREB)],
            _lc(self.subcontents) - pb_packing_sum(self.des_word.bits[:8]),
            0, A("storeb_val"))
        pb.add_r1cs_constraint(
            alpha[int(Opcode.STOREW)],
            _lc(self.subcontents) - self.des_old, 0, A("storew_val"))

    # ------------------------------------------------------------- witness
    def generate_r1cs_witness(self, step):
        """step: relations.tinyram.TraceStep; caller has already set
        regs_before/flag_before/pc_before/instruction/mem_* variables."""
        pb, ap = self.pb, self.ap
        w, k = ap.w, ap.k
        mask = (1 << w) - 1
        self.unpack_instr.generate_r1cs_witness_from_packed()
        self.pack_opcode.generate_r1cs_witness_from_bits()
        self.pack_des.generate_r1cs_witness_from_bits()
        self.pack_arg1.generate_r1cs_witness_from_bits()
        self.pack_arg2.generate_r1cs_witness_from_bits()
        self.op_onehot.generate_r1cs_witness()
        self.des_onehot.generate_r1cs_witness()
        self.arg1_onehot.generate_r1cs_witness()

        ins = step.instruction
        regs = step.regs_before
        a1 = regs[ins.arg1idx % k]
        des_old = regs[ins.desidx % k]
        if ins.arg2_is_imm:
            r2 = 0
            a2 = ins.arg2idx_or_imm & mask
            for j in range(k):
                pb.setval(self.arg2_reg_onehot[j], 0)
        else:
            idx = ins.arg2idx_or_imm % k
            r2 = regs[idx]
            a2 = r2
            for j in range(k):
                pb.setval(self.arg2_reg_onehot[j], 1 if j == idx else 0)
        pb.setval(self.a1, a1)
        pb.setval(self.r2, r2)
        pb.setval(self.a2, a2)
        pb.setval(self.des_old, des_old)
        self.a1_word.set(a1)
        self.a2_word.set(a2)
        # selection-sum helper products a1/des_old/r2
        for j in range(k):
            self.pb.setval(self._sel_t["a1"][j],
                           regs[j] if j == ins.arg1idx % k else 0)
            self.pb.setval(self._sel_t["des_old"][j],
                           regs[j] if j == ins.desidx % k else 0)
            self.pb.setval(self._sel_t["r2"][j],
                           regs[j] if (not ins.arg2_is_imm
                                       and j == ins.arg2idx_or_imm % k)
                           else 0)

        # bitwise AND bits
        a1bits = [(a1 >> i) & 1 for i in range(w)]
        a2bits = [(a2 >> i) & 1 for i in range(w)]
        for i, (_, _, _, o) in enumerate(self._bitwise):
            pb.setval(o, a1bits[i] & a2bits[i])

        # memory op values (needed by the LOAD result rows below)
        touches = ins.opcode in {Opcode.LOADB, Opcode.LOADW,
                                 Opcode.STOREB, Opcode.STOREW}
        pb.setval(self.touches_mem, 1 if touches else 0)
        pb.setval(self.mem_is_store,
                  1 if ins.opcode in {Opcode.STOREB, Opcode.STOREW} else 0)
        if step.mem_op:
            kind, addr, before, after = step.mem_op
            pb.setval(self.mem_addr, addr)
            pb.setval(self.mem_in, before)
            pb.setval(self.mem_out, after)
        else:
            before = after = 0
            pb.setval(self.mem_addr, self.dummy_addr)
            pb.setval(self.mem_out, 0)
            pb.setval(self.mem_in, 0)
        # dword decompositions + des word
        self.unpack_mem_prev.generate_r1cs_witness_from_packed()
        self.unpack_mem_next.generate_r1cs_witness_from_packed()
        self.des_word.set(des_old)
        # masking indicators + subcontents
        sal = ap.subaddr_len
        nbytes = 2 * ap.bytes_in_word
        sub = a2 & ((1 << sal) - 1)
        is_byte_access = ins.opcode in {Opcode.LOADB, Opcode.STOREB}
        word_sel = (sub >> (sal - 1)) & 1
        for i in range(nbytes):
            pb.setval(self.is_subaddress[i], 1 if i == sub else 0)
            pb.setval(self.is_byte[i],
                      1 if (is_byte_access and i == sub) else 0)
        pb.setval(self.is_word0,
                  1 if (not is_byte_access and word_sel == 0) else 0)
        pb.setval(self.is_word1,
                  1 if (not is_byte_access and word_sel == 1) else 0)
        if is_byte_access:
            sub_val = ((after if ins.opcode == Opcode.STOREB else before)
                       >> (8 * sub)) & 0xFF
        else:
            sub_val = ((after if ins.opcode == Opcode.STOREW else before)
                       >> (w * word_sel)) & mask
        pb.setval(self.subcontents, sub_val)
        # masked_t[j] = indicator_j * masked_value_j
        mask_vals = [
            (before >> w) << w,                      # word0 masked out
            before & ((1 << w) - 1),                 # word1 masked out
        ] + [before - (((before >> (8 * i)) & 0xFF) << (8 * i))
             for i in range(nbytes)]
        inds = ([pb.val(self.is_word0), pb.val(self.is_word1)]
                + [pb.val(self.is_byte[i]) for i in range(nbytes)])
        for j in range(nbytes + 2):
            pb.setval(self.masked_t[j], inds[j] * mask_vals[j])

        # ALU witnesses
        pb.setval(self.prod, a1 * a2)
        self.add_unpack.generate_r1cs_witness_from_packed()
        self.sub_unpack.generate_r1cs_witness_from_packed()
        self.prod_unpack.generate_r1cs_witness_from_packed()
        sgn = lambda v: v - (1 << w) if v >> (w - 1) else v
        sp = sgn(a1) * sgn(a2) + (1 << (2 * w - 1))
        pb.setval(self.sprod, sp)
        self._sprod_pack.generate_r1cs_witness_from_packed()
        if a2 == 0:
            q, rm = 0, a1
        else:
            q, rm = a1 // a2, a1 % a2
        pb.setval(self.div_q, q)
        pb.setval(self.div_r, rm)
        self._div_q_pack.generate_r1cs_witness_from_packed()
        amt = min(a2, w)
        pb.setval(self.sh_amt, amt)
        pb.setval(self.sh_oor, 1 if a2 > w else 0)
        self.sh_onehot.generate_r1cs_witness()
        for i in range(w + 1):
            shl_v = (a1 << i) & mask if i <= w else 0
            shr_v = a1 >> i if i <= w else 0
            pb.setval(self.shl_parts[i], shl_v if i == amt else 0)
            pb.setval(self.shr_parts[i], shr_v if i == amt else 0)
        self._smulh_cmp1.generate_r1cs_witness()
        self._smulh_cmp2.generate_r1cs_witness()
        pb.setval(self._smulh_in_range,
                  pb.val(self.smulh_ge) * pb.val(self.smulh_lt))
        self._div_cmp.generate_r1cs_witness()
        self._cmp_u.generate_r1cs_witness()
        self._cmp_s.generate_r1cs_witness()
        for g in self._aux_gadgets:
            g.generate_r1cs_witness()

        if ins.opcode == Opcode.READ:
            pb.setval(self.tape_value, step.regs_after[ins.desidx % k])
            pb.setval(self.tape_flag, 1 if step.flag_after else 0)

        # selection sums + register/pc updates: evaluate directly
        alpha_vals = [pb.val(a) for a in self.op_onehot.alpha]
        res_lc, flag_lc = self.results[ins.opcode]
        result = pb.lc_val(res_lc)
        for op in range(32):
            r_lc, f_lc = self.results[Opcode(op)]
            pb.setval(self._res_t[op], pb.lc_val(r_lc) if alpha_vals[op] else 0)
            pb.setval(self._flag_t[op],
                      pb.lc_val(f_lc) if alpha_vals[op] else 0)
        pb.setval(self.result, result)
        pb.setval(self.flag_after, 1 if step.flag_after else 0)
        writes = 1 if (ins.opcode in
                       {Opcode.AND, Opcode.OR, Opcode.XOR, Opcode.NOT,
                        Opcode.ADD, Opcode.SUB, Opcode.MULL, Opcode.UMULH,
                        Opcode.SMULH, Opcode.UDIV, Opcode.UMOD, Opcode.SHL,
                        Opcode.SHR, Opcode.MOV, Opcode.CMOV, Opcode.LOADB,
                        Opcode.LOADW, Opcode.READ}) else 0
        pb.setval(self.writes_reg, writes)
        for j in range(k):
            pb.setval(self._wsel_vars[j],
                      writes if j == ins.desidx % k else 0)
            pb.setval(self.regs_after[j], step.regs_after[j])
        jt = 1 if (ins.opcode == Opcode.JMP
                   or (ins.opcode == Opcode.CJMP and step.flag_before)
                   or (ins.opcode == Opcode.CNJMP
                       and not step.flag_before)) else 0
        pb.setval(self._tj1, 1 if (ins.opcode == Opcode.CJMP
                                   and step.flag_before) else 0)
        pb.setval(self._tj2, 1 if (ins.opcode == Opcode.CNJMP
                                   and not step.flag_before) else 0)
        pb.setval(self.jump_taken, jt)
        stalls = 1 if ins.opcode in {Opcode.ANSWER, Opcode.OP_10111,
                                     Opcode.OP_11000, Opcode.OP_11001} else 0
        pb.setval(self.stalls, stalls)
        pcp1 = pb.lc_val(self.pc_plus_one)
        pb.setval(self._t_jmp, (a2 - pcp1) % pb.p if jt else 0)
        pb.setval(self.pc_after, step.pc_after)


class _ProductGadget(Gadget):
    """out = a * b (single constraint)."""

    def __init__(self, pb, a, b, out, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.a, self.b, self.out = _lc(a), _lc(b), out

    def generate_r1cs_constraints(self):
        self.pb.add_r1cs_constraint(self.a, self.b, self.out,
                                    self.annot("prod"))

    def generate_r1cs_witness(self):
        pass    # witnessed by the caller


class _MuxGadget(Gadget):
    """out = sel ? x : y."""

    def __init__(self, pb, sel, x, y, out, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.sel, self.x, self.y, self.out = _lc(sel), _lc(x), _lc(y), out

    def generate_r1cs_constraints(self):
        self.pb.add_r1cs_constraint(self.sel, self.x - self.y,
                                    _lc(self.out) - self.y,
                                    self.annot("mux"))

    def generate_r1cs_witness(self):
        s = self.pb.lc_val(self.sel)
        self.pb.setval(self.out, self.pb.lc_val(self.x) if s
                       else self.pb.lc_val(self.y))
