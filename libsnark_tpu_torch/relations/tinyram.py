"""TinyRAM ISA: architecture params, instructions, programs, executor.

Parity with reference relations/ram_computations/rams/tinyram/
tinyram_aux.{hpp,cpp}: the 29-opcode ISA (tinyram_aux.hpp:26-63),
instruction dword encoding (as_dword), program/input-tape formats, and a
host executor producing execution traces (the witness source for the
RAM-to-R1CS universal circuit). Semantics follow the TinyRAM 2.0 spec
(flag conventions per instruction class).
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Dict, List, Optional


class Opcode(IntEnum):
    AND = 0b00000
    OR = 0b00001
    XOR = 0b00010
    NOT = 0b00011
    ADD = 0b00100
    SUB = 0b00101
    MULL = 0b00110
    UMULH = 0b00111
    SMULH = 0b01000
    UDIV = 0b01001
    UMOD = 0b01010
    SHL = 0b01011
    SHR = 0b01100
    CMPE = 0b01101
    CMPA = 0b01110
    CMPAE = 0b01111
    CMPG = 0b10000
    CMPGE = 0b10001
    MOV = 0b10010
    CMOV = 0b10011
    JMP = 0b10100
    CJMP = 0b10101
    CNJMP = 0b10110
    OP_10111 = 0b10111
    OP_11000 = 0b11000
    OP_11001 = 0b11001
    STOREB = 0b11010
    LOADB = 0b11011
    STOREW = 0b11100
    LOADW = 0b11101
    READ = 0b11110
    ANSWER = 0b11111


# opcodes that may write a register / the flag (tinyram_aux.hpp:76-92)
REGISTER_OPCODES = {
    Opcode.AND, Opcode.OR, Opcode.XOR, Opcode.NOT, Opcode.ADD, Opcode.SUB,
    Opcode.MULL, Opcode.UMULH, Opcode.SMULH, Opcode.UDIV, Opcode.UMOD,
    Opcode.SHL, Opcode.SHR, Opcode.CMPE, Opcode.CMPA, Opcode.CMPAE,
    Opcode.CMPG, Opcode.CMPGE, Opcode.MOV, Opcode.CMOV, Opcode.LOADB,
    Opcode.LOADW, Opcode.READ}
CONTROL_FLOW_OPCODES = {Opcode.JMP, Opcode.CJMP, Opcode.CNJMP}
STALL_OPCODES = {Opcode.OP_10111, Opcode.OP_11000, Opcode.OP_11001,
                 Opcode.ANSWER}


@dataclasses.dataclass
class TinyRAMParams:
    """(w, k): register width and count (tinyram_aux.hpp:126-137)."""
    w: int
    k: int

    def __post_init__(self):
        assert self.w & (self.w - 1) == 0, "w must be a power of two"
        assert self.instruction_padding_width >= 0, \
            f"instruction does not fit in a double word (w={self.w}, " \
            f"k={self.k})"

    @property
    def address_size(self):
        return self.w

    @property
    def value_size(self):
        return 2 * self.w          # double-word memory lines

    @property
    def opcode_width(self):
        return 5

    @property
    def reg_arg_width(self):
        return max(1, (self.k - 1).bit_length())

    @property
    def reg_arg_or_imm_width(self):
        return max(self.w, self.reg_arg_width)

    @property
    def instruction_padding_width(self):
        used = (self.opcode_width + 1 + 2 * self.reg_arg_width
                + self.reg_arg_or_imm_width)
        return 2 * self.w - used

    @property
    def dwaddr_len(self):
        return self.w - ((2 * self.w - 1).bit_length() - self.w.bit_length())

    @property
    def bytes_in_word(self):
        return self.w // 8

    @property
    def subaddr_len(self):
        """Bits of a byte address that select within one double word
        (tinyram_protoboard subaddr_len: log2(2w/8))."""
        return max(1, (2 * self.bytes_in_word - 1).bit_length())

    def initial_pc_addr(self) -> int:
        return 0


@dataclasses.dataclass
class TinyRAMInstruction:
    opcode: Opcode
    arg2_is_imm: bool
    desidx: int
    arg1idx: int
    arg2idx_or_imm: int

    def as_dword(self, ap: TinyRAMParams) -> int:
        """Pack into a double word, opcode in the top bits
        (tinyram_aux.cpp as_dword layout)."""
        v = int(self.opcode)
        v = (v << 1) | (1 if self.arg2_is_imm else 0)
        v = (v << ap.reg_arg_width) | self.desidx
        v = (v << ap.reg_arg_width) | self.arg1idx
        v = (v << (ap.instruction_padding_width
                   + ap.reg_arg_or_imm_width)) | self.arg2idx_or_imm
        return v

    @classmethod
    def from_dword(cls, ap: TinyRAMParams, v: int) -> "TinyRAMInstruction":
        riw = ap.reg_arg_or_imm_width + ap.instruction_padding_width
        arg2 = v & ((1 << ap.reg_arg_or_imm_width) - 1)
        v >>= riw
        arg1 = v & ((1 << ap.reg_arg_width) - 1)
        v >>= ap.reg_arg_width
        des = v & ((1 << ap.reg_arg_width) - 1)
        v >>= ap.reg_arg_width
        imm = v & 1
        v >>= 1
        return cls(Opcode(v & 31), bool(imm), des, arg1, arg2)


DEFAULT_INSTRUCTION = TinyRAMInstruction(Opcode.ANSWER, True, 0, 0, 1)


class TinyRAMProgram:
    def __init__(self, instructions: Optional[list] = None):
        self.instructions: List[TinyRAMInstruction] = list(instructions or [])

    @property
    def size(self):
        return len(self.instructions)

    def add_instruction(self, instr: TinyRAMInstruction):
        self.instructions.append(instr)

    def add(self, opcode, arg2_is_imm, des, arg1, arg2):
        self.add_instruction(TinyRAMInstruction(
            Opcode(opcode), arg2_is_imm, des, arg1, arg2))


@dataclasses.dataclass
class TraceStep:
    """One executed step: pre-state snapshot + memory op description."""
    timestamp: int
    pc: int
    instruction: TinyRAMInstruction
    regs_before: List[int]
    flag_before: bool
    regs_after: List[int]
    flag_after: bool
    pc_after: int
    mem_op: Optional[tuple] = None   # (kind, address, value) kind in {r, w}


class TinyRAMExecutor:
    """Host executor with full TinyRAM 2.0 semantics. Produces a trace
    usable as the universal circuit's auxiliary input."""

    def __init__(self, ap: TinyRAMParams, program: TinyRAMProgram):
        self.ap = ap
        self.program = program

    def _signed(self, v):
        w = self.ap.w
        return v - (1 << w) if v >> (w - 1) else v

    def run(self, primary_tape: List[int], aux_tape: List[int],
            max_steps: int = 10000):
        """Execute; returns (answer, accepted, trace)."""
        ap = self.ap
        mask = (1 << ap.w) - 1
        regs = [0] * ap.k
        flag = False
        pc = 0
        mem: Dict[int, int] = {}
        tapes = [list(primary_tape), list(aux_tape)]
        tape_pos = [0, 0]
        trace: List[TraceStep] = []
        answer = None
        for ts in range(max_steps):
            if pc < len(self.program.instructions):
                ins = self.program.instructions[pc]
            else:
                ins = DEFAULT_INSTRUCTION
            step = _execute_one_step(ap, ins, regs, flag, pc, mem, tapes,
                                     tape_pos, ts)
            trace.append(step)
            regs, flag = list(step.regs_after), step.flag_after
            if ins.opcode == Opcode.ANSWER:
                answer = (ins.arg2idx_or_imm if ins.arg2_is_imm
                          else regs[ins.arg2idx_or_imm % ap.k]) & mask
                break
            pc = step.pc_after
        accepted = (answer == 0)
        return answer, accepted, trace


class TinyRAMUnifiedExecutor(TinyRAMExecutor):
    """Executor variant for the universal circuit: instructions are
    FETCHED from the unified memory (program booted at low addresses),
    so every step is fetch + optional data op on ONE address space --
    exactly what the RAM-to-R1CS memory-consistency argument checks
    (reference ram_universal_gadget memory lines)."""

    def run_from_boot(self, boot_contents: Dict[int, int],
                      primary_tape: List[int], aux_tape: List[int],
                      max_steps: int = 10000):
        ap = self.ap
        mask = (1 << ap.w) - 1
        mem = dict(boot_contents)
        regs = [0] * ap.k
        flag = False
        pc = 0
        tapes = [list(primary_tape), list(aux_tape)]
        tape_pos = [0, 0]
        trace: List[TraceStep] = []
        answer = None
        for ts in range(max_steps):
            dword = mem.get(pc, 0)
            ins = TinyRAMInstruction.from_dword(ap, dword)
            step_trace = _execute_one_step(
                ap, ins, regs, flag, pc, mem, tapes, tape_pos, ts)
            trace.append(step_trace)
            regs = list(step_trace.regs_after)
            flag = step_trace.flag_after
            if ins.opcode == Opcode.ANSWER:
                answer = (ins.arg2idx_or_imm if ins.arg2_is_imm
                          else regs[ins.arg2idx_or_imm % ap.k]) & mask
                break
            pc = step_trace.pc_after
        return answer, answer == 0, trace


def _execute_one_step(ap, ins, regs, flag, pc, mem, tapes, tape_pos, ts):
    """One TinyRAM step (the single source of ISA semantics)."""
    w = ap.w
    mask = (1 << w) - 1
    regs = list(regs)
    a2 = (ins.arg2idx_or_imm if ins.arg2_is_imm
          else regs[ins.arg2idx_or_imm % ap.k]) & mask
    a1 = regs[ins.arg1idx % ap.k]
    des = ins.desidx % ap.k
    next_pc = pc + 1
    mem_op = None
    op = ins.opcode
    regs_before = list(regs)
    flag_before = flag
    sgn = lambda v: v - (1 << w) if v >> (w - 1) else v

    if op == Opcode.AND:
        regs[des] = a1 & a2; flag = regs[des] == 0
    elif op == Opcode.OR:
        regs[des] = a1 | a2; flag = regs[des] == 0
    elif op == Opcode.XOR:
        regs[des] = a1 ^ a2; flag = regs[des] == 0
    elif op == Opcode.NOT:
        regs[des] = (~a2) & mask; flag = regs[des] == 0
    elif op == Opcode.ADD:
        s = a1 + a2; regs[des] = s & mask; flag = s >> w != 0
    elif op == Opcode.SUB:
        s = (1 << w) + a1 - a2; regs[des] = s & mask; flag = (s >> w) == 0
    elif op == Opcode.MULL:
        p = a1 * a2; regs[des] = p & mask; flag = p >> w != 0
    elif op == Opcode.UMULH:
        p = a1 * a2; regs[des] = (p >> w) & mask; flag = p >> w != 0
    elif op == Opcode.SMULH:
        p = sgn(a1) * sgn(a2); regs[des] = (p >> w) & mask
        flag = not (-(1 << (w - 1)) <= p < (1 << (w - 1)))
    elif op == Opcode.UDIV:
        regs[des], flag = (0, True) if a2 == 0 else (a1 // a2, False)
    elif op == Opcode.UMOD:
        regs[des], flag = (0, True) if a2 == 0 else (a1 % a2, False)
    elif op == Opcode.SHL:
        regs[des] = (a1 << min(a2, w)) & mask; flag = bool(a1 >> (w - 1))
    elif op == Opcode.SHR:
        regs[des] = a1 >> min(a2, w); flag = bool(a1 & 1)
    elif op == Opcode.CMPE:
        flag = a1 == a2
    elif op == Opcode.CMPA:
        flag = a1 > a2
    elif op == Opcode.CMPAE:
        flag = a1 >= a2
    elif op == Opcode.CMPG:
        flag = sgn(a1) > sgn(a2)
    elif op == Opcode.CMPGE:
        flag = sgn(a1) >= sgn(a2)
    elif op == Opcode.MOV:
        regs[des] = a2
    elif op == Opcode.CMOV:
        if flag:
            regs[des] = a2
    elif op == Opcode.JMP:
        next_pc = a2
    elif op == Opcode.CJMP:
        next_pc = a2 if flag else next_pc
    elif op == Opcode.CNJMP:
        next_pc = next_pc if flag else a2
    elif op in (Opcode.STOREB, Opcode.STOREW, Opcode.LOADB, Opcode.LOADW):
        # Memory is organized as double-word cells addressed by
        # A >> subaddr_len; A is a BYTE address. Byte ops touch the
        # (A mod 2w/8)-th byte; word ops touch the word selected by the
        # subaddress MSB (reference tinyram_cpu_checker.tcc:398-434 +
        # memory_masking_gadget). Every op is a read-modify-write on the
        # dword cell: mem_op = (kind, dw_addr, before, after).
        sal = ap.subaddr_len
        dw_addr = a2 >> sal
        sub = a2 & ((1 << sal) - 1)
        before = mem.get(dw_addr, 0)
        if op == Opcode.STOREB:
            sh = 8 * sub
            after = (before & ~(0xFF << sh)) | ((regs[des] & 0xFF) << sh)
            mem[dw_addr] = after
            mem_op = ("w", dw_addr, before, after)
        elif op == Opcode.LOADB:
            regs[des] = (before >> (8 * sub)) & 0xFF
            mem_op = ("r", dw_addr, before, before)
        elif op == Opcode.STOREW:
            word_sel = (sub >> (sal - 1)) & 1
            sh = w * word_sel
            after = (before & ~(mask << sh)) | ((regs[des] & mask) << sh)
            mem[dw_addr] = after
            mem_op = ("w", dw_addr, before, after)
        else:  # LOADW
            word_sel = (sub >> (sal - 1)) & 1
            regs[des] = (before >> (w * word_sel)) & mask
            mem_op = ("r", dw_addr, before, before)
    elif op == Opcode.READ:
        tid = a2 & 1
        if a2 < 2 and tape_pos[tid] < len(tapes[tid]):
            regs[des] = tapes[tid][tape_pos[tid]] & mask
            tape_pos[tid] += 1
            flag = False
        else:
            regs[des] = 0
            flag = True
    elif op == Opcode.ANSWER:
        next_pc = pc
    else:
        next_pc = pc

    return TraceStep(timestamp=ts + 1, pc=pc, instruction=ins,
                     regs_before=regs_before, flag_before=flag_before,
                     regs_after=regs, flag_after=flag, pc_after=next_pc,
                     mem_op=mem_op)


def load_preprocessed_program(ap: TinyRAMParams, text) -> TinyRAMProgram:
    """Parse the reference's preprocessed-assembly format
    (relations/.../tinyram_aux.cpp:312 load_preprocessed_program): one
    instruction per whitespace-separated record
    `opcode immflag des arg1 arg2`, with arg2 reduced mod 2^w. `text`
    is a string or an open file."""
    if hasattr(text, "read"):
        text = text.read()
    prog = TinyRAMProgram()
    toks = text.split()
    for i in range(0, len(toks) - 4, 5):
        name, immflag, des, a1, a2 = toks[i:i + 5]
        a2 = int(a2)
        a2 = ((1 << ap.w) + (a2 % (1 << ap.w))) % (1 << ap.w)
        prog.add(Opcode[name.upper()], int(immflag) != 0,
                 int(des), int(a1), a2)
    return prog


def tinyram_boot_trace(ap: TinyRAMParams, program: TinyRAMProgram,
                       primary_input: List[int]):
    """Boot memory: program dwords at low addresses, then the primary
    input laid out after it (tinyram_boot_trace_from_program_and_input
    parity)."""
    contents = {}
    for i, ins in enumerate(program.instructions):
        contents[i] = ins.as_dword(ap)
    base = len(program.instructions)
    for j, v in enumerate(primary_input):
        contents[base + j] = v
    return contents
