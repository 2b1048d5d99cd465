"""RAM zkSNARK: delegated-memory TinyRAM via proof-carrying data
(reference zk_proof_systems/zksnark/ram_zksnark/{ram_zksnark.tcc,
ram_compliance_predicate.tcc} -- the BCTV14 "Scalable Zero Knowledge"
construction).

Reference structure: each PCD application proves ONE CPU step; memory is
DELEGATED -- committed by a Merkle root carried in the PCD message, with
per-access authentication paths checked in-circuit (instruction fetch =
check-read at pc, data op = check-update). The message carries
(timestamp, root_initial, root, pc, cpu_state, initial copies,
has_accepted); the verifier only sees the FINAL message and checks it
against the boot trace (ram_zksnark.tcc verifier).

Two recursion backends exist here. RamZkSnarkCycle (below) is the
reference-parity one: truly unbounded recursion over the MNT4/MNT6 cycle
(curves/mnt.py, CycleSpPCD). The first backend is the BOUNDED
single-level aggregation variant -- inner proofs aggregated one level
up:

  * inner proofs: Groth16 over BLS12-377, one per step; the statement is
    a single field element h = KnapsackCRH(msg_in_bits || msg_out_bits)
    (the same statement-compression trick r1cs_sp_ppzkpcd uses --
    r1cs_sp_ppzkpcd.tcc hashes (vk, msg) into the input),
  * an outer circuit over Fr(BW6-761) = Fq(BLS12-377) with one
    Groth16VerifierGadget per step sharing message-boundary variables
    (chaining is structural), provable with Groth16 over BW6-761.

Both Groth16 systems run on ``device`` ("cuda" unless the caller asks for
the CPU); the circuits, the executor and the Merkle memory are host
Python. The generators and provers take an optional ``timings`` dict.

The Merkle hash is the knapsack CRH (dimension 1), as in the
reference's PCD instantiation; digest = |Fr| bits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..gadgets.protoboard import Protoboard, PBVariable, PBVariableArray
from ..gadgets.basic import PackingGadget, generate_boolean_r1cs_constraint
from ..gadgets.hashes.knapsack import (
    KnapsackTwoToOneHashGadget, KnapsackCRHFieldOutGadget,
    knapsack_crh_field_eval)
from ..gadgets.hashes.sha256_gadget import DigestVariable
from ..gadgets.merkle_tree_gadgets import (
    MerkleAuthenticationPathVariable, MerkleTreeCheckReadGadget,
    MerkleTreeCheckUpdateGadget)
from ..gadgets.tinyram_cpu_checker import TinyRAMCPUChecker, IsZeroGadget, _lc
from ..relations.memory import DelegatedRAMemory
from .base import PhaseClock
from ..relations.tinyram import (
    TinyRAMParams, TinyRAMProgram, TinyRAMUnifiedExecutor, Opcode,
    tinyram_boot_trace, TraceStep)


@dataclasses.dataclass
class RamZkSnarkArchParams:
    """ram_zksnark_architecture_params + the delegated-tree depth.

    tree_depth d <= w bounds the addressable memory to 2^d words (the
    reference uses the full address space; smaller d keeps test circuits
    small). Address 2^d - 1 is the cpu checker's reserved dummy."""
    ap: TinyRAMParams
    tree_depth: int = None
    ts_bits: int = 32

    def __post_init__(self):
        if self.tree_depth is None:
            self.tree_depth = self.ap.w
        assert self.tree_depth <= self.ap.w

    @property
    def dummy_addr(self):
        return (1 << self.tree_depth) - 1


@dataclasses.dataclass
class RamPCDMessage:
    """ram_pcd_message payload (ram_compliance_predicate.hpp:55-95)."""
    timestamp: int
    root_initial: List[int]          # digest bits
    root: List[int]                  # digest bits
    pc_addr: int
    regs: List[int]
    flag: int
    pc_addr_initial: int
    regs_initial: List[int]
    flag_initial: int
    has_accepted: int

    def payload_bits(self, arch: RamZkSnarkArchParams) -> List[int]:
        """Canonical bit layout (must match the in-circuit layout)."""
        ap, d = arch.ap, arch.tree_depth
        bits = [(self.timestamp >> i) & 1 for i in range(arch.ts_bits)]
        bits += [(self.pc_addr >> i) & 1 for i in range(d)]
        bits += [self.flag & 1]
        for r in self.regs:
            bits += [(r >> i) & 1 for i in range(ap.w)]
        bits += [self.has_accepted & 1]
        bits += list(self.root)
        bits += list(self.root_initial)
        bits += [(self.pc_addr_initial >> i) & 1 for i in range(d)]
        bits += [self.flag_initial & 1]
        for r in self.regs_initial:
            bits += [(r >> i) & 1 for i in range(ap.w)]
        return bits

    @staticmethod
    def initial(arch: RamZkSnarkArchParams, root: List[int]):
        """The canonical base-case message (ram_compliance_predicate
        ::gen_initial_message parity: zero state, root = boot root)."""
        k = arch.ap.k
        return RamPCDMessage(
            timestamp=0, root_initial=list(root), root=list(root),
            pc_addr=0, regs=[0] * k, flag=0,
            pc_addr_initial=0, regs_initial=[0] * k, flag_initial=0,
            has_accepted=0)


class _PaddedBits:
    """Digest-shaped view over value bits + a shared constant-zero pad
    (leaf leaves are value_size bits zero-extended to digest size)."""

    def __init__(self, bits, zero_var, digest_size):
        self.bits = list(bits) + [zero_var] * (digest_size - len(bits))
        self.digest_size = digest_size


class _MsgVars:
    """One message's variable block inside the predicate circuit."""

    def __init__(self, pb, arch, ds, tag):
        ap, d = arch.ap, arch.tree_depth
        self.ts = PBVariable().allocate(pb, f"{tag}_ts")
        self.ts_bits = PBVariableArray().allocate(pb, arch.ts_bits,
                                                  f"{tag}_tsb")
        self.ts_pack = PackingGadget(pb, self.ts_bits, self.ts,
                                     f"{tag}_tsp")
        self.pc = PBVariable().allocate(pb, f"{tag}_pc")
        self.pc_bits = PBVariableArray().allocate(pb, d, f"{tag}_pcb")
        self.pc_pack = PackingGadget(pb, self.pc_bits, self.pc,
                                     f"{tag}_pcp")
        self.flag = PBVariable().allocate(pb, f"{tag}_flag")
        self.regs = [PBVariable().allocate(pb, f"{tag}_r{j}")
                     for j in range(ap.k)]
        self.reg_bits = [PBVariableArray().allocate(pb, ap.w,
                                                    f"{tag}_rb{j}")
                         for j in range(ap.k)]
        self.reg_packs = [PackingGadget(pb, self.reg_bits[j], self.regs[j],
                                        f"{tag}_rp{j}")
                          for j in range(ap.k)]
        self.acc = PBVariable().allocate(pb, f"{tag}_acc")
        self.root = DigestVariable(pb, ds, f"{tag}_root")
        self.root_init = DigestVariable(pb, ds, f"{tag}_rooti")
        self.pc_init = PBVariable().allocate(pb, f"{tag}_pci")
        self.pc_init_bits = PBVariableArray().allocate(pb, d,
                                                       f"{tag}_pcib")
        self.pc_init_pack = PackingGadget(pb, self.pc_init_bits,
                                          self.pc_init, f"{tag}_pcip")
        self.flag_init = PBVariable().allocate(pb, f"{tag}_flagi")
        self.regs_init = [PBVariable().allocate(pb, f"{tag}_ri{j}")
                          for j in range(ap.k)]
        self.regs_init_bits = [
            PBVariableArray().allocate(pb, ap.w, f"{tag}_rib{j}")
            for j in range(ap.k)]
        self.regs_init_packs = [
            PackingGadget(pb, self.regs_init_bits[j], self.regs_init[j],
                          f"{tag}_rip{j}") for j in range(ap.k)]

    def all_bits(self):
        """Flattened bits; MUST mirror RamPCDMessage.payload_bits."""
        bits = list(self.ts_bits) + list(self.pc_bits) + [self.flag]
        for rb in self.reg_bits:
            bits += list(rb)
        bits += [self.acc]
        bits += list(self.root.bits) + list(self.root_init.bits)
        bits += list(self.pc_init_bits) + [self.flag_init]
        for rb in self.regs_init_bits:
            bits += list(rb)
        return bits

    def generate_r1cs_constraints(self, pb, tag):
        self.ts_pack.generate_r1cs_constraints(True)
        self.pc_pack.generate_r1cs_constraints(True)
        for g in self.reg_packs + self.regs_init_packs:
            g.generate_r1cs_constraints(True)
        self.pc_init_pack.generate_r1cs_constraints(True)
        for b in (self.flag, self.acc, self.flag_init):
            generate_boolean_r1cs_constraint(pb, b, f"{tag}_bool")
        self.root.generate_r1cs_constraints()
        self.root_init.generate_r1cs_constraints()

    def set_witness(self, pb, msg: RamPCDMessage):
        pb.setval(self.ts, msg.timestamp)
        self.ts_pack.generate_r1cs_witness_from_packed()
        pb.setval(self.pc, msg.pc_addr)
        self.pc_pack.generate_r1cs_witness_from_packed()
        pb.setval(self.flag, msg.flag)
        for j, r in enumerate(msg.regs):
            pb.setval(self.regs[j], r)
            self.reg_packs[j].generate_r1cs_witness_from_packed()
        pb.setval(self.acc, msg.has_accepted)
        self.root.generate_r1cs_witness(list(msg.root))
        self.root_init.generate_r1cs_witness(list(msg.root_initial))
        pb.setval(self.pc_init, msg.pc_addr_initial)
        self.pc_init_pack.generate_r1cs_witness_from_packed()
        pb.setval(self.flag_init, msg.flag_initial)
        for j, r in enumerate(msg.regs_initial):
            pb.setval(self.regs_init[j], r)
            self.regs_init_packs[j].generate_r1cs_witness_from_packed()


class _RamStepCore:
    """The one-CPU-step machinery between two message variable blocks:
    TinyRAM CPU checker + delegated-memory fetch check-read and data
    check-update + clocking/init-propagation/base-case/acceptance
    constraints. Shared by RamCompliancePredicate (statement-hash form)
    and RamCycleCompliancePredicate (MNT-cycle PCD handler form)."""

    def __init__(self, pb, arch, ds, msg_in: "_MsgVars",
                 msg_out: "_MsgVars", zero):
        ap, d = arch.ap, arch.tree_depth
        self.pb, self.arch, self.ds = pb, arch, ds
        self.msg_in, self.msg_out, self.zero = msg_in, msg_out, zero
        self.instruction = PBVariable().allocate(pb, "instr")
        self.mem_addr = PBVariable().allocate(pb, "mem_addr")
        # prev_val doubles as the checker's mem_in (the PREV dword cell,
        # Merkle-checked under root_in); mem_out is the NEXT dword
        self.prev_val = PBVariable().allocate(pb, "prev_val")
        self.mem_in = self.prev_val
        self.mem_out = PBVariable().allocate(pb, "mem_out")
        self.mem_is_store = PBVariable().allocate(pb, "mem_is_store")
        self.cpu = TinyRAMCPUChecker(
            pb, ap, msg_in.regs, msg_in.flag, msg_in.pc,
            msg_out.regs, msg_out.flag, msg_out.pc,
            self.instruction, self.mem_addr, self.mem_in, self.mem_out,
            self.mem_is_store, "cpu", dummy_addr=arch.dummy_addr)

        # ---- instruction fetch: check-read mem[pc] under root_in ----------
        fetch_leaf = _PaddedBits(self.cpu.instr_bits, zero, ds)
        self.fetch_path = MerkleAuthenticationPathVariable(
            pb, d, "fpath", digest_size=ds)
        from ..relations.variable import LinearCombination
        one = LinearCombination(1)
        self.fetch = MerkleTreeCheckReadGadget(
            pb, d, list(msg_in.pc_bits), fetch_leaf,
            msg_in.root, self.fetch_path, one, "fetch",
            hash_gadget_cls=KnapsackTwoToOneHashGadget)

        # ---- data op: check-update root_in -> root_out --------------------
        self.maddr_bits = PBVariableArray().allocate(pb, d, "mab")
        self.maddr_pack = PackingGadget(pb, self.maddr_bits, self.mem_addr,
                                        "map")
        self.prev_bits = PBVariableArray().allocate(pb, 2 * ap.w, "pvb")
        self.prev_pack = PackingGadget(pb, self.prev_bits, self.prev_val,
                                       "pvp")
        self.next_bits = PBVariableArray().allocate(pb, 2 * ap.w, "nvb")
        self.next_pack = PackingGadget(pb, self.next_bits, self.mem_out,
                                       "nvp")
        prev_leaf = _PaddedBits(self.prev_bits, zero, ds)
        next_leaf = _PaddedBits(self.next_bits, zero, ds)
        self.prev_path = MerkleAuthenticationPathVariable(
            pb, d, "ppath", digest_size=ds)
        self.next_path = MerkleAuthenticationPathVariable(
            pb, d, "npath", digest_size=ds)
        self.update = MerkleTreeCheckUpdateGadget(
            pb, d, list(self.maddr_bits),
            prev_leaf, msg_in.root, self.prev_path,
            next_leaf, msg_out.root, self.next_path,
            one, "update", hash_gadget_cls=KnapsackTwoToOneHashGadget)

        # ---- acceptance ---------------------------------------------------
        self.answer_zero = PBVariable().allocate(pb, "az")
        self.az_gadget = IsZeroGadget(pb, self.cpu.a2, self.answer_zero,
                                      "azg")
        # base case indicator: ts_in == 0
        self.is_base = PBVariable().allocate(pb, "is_base")
        self.base_gadget = IsZeroGadget(pb, msg_in.ts, self.is_base,
                                        "ibg")

    def generate_r1cs_constraints(self):
        pb, arch = self.pb, self.arch
        ap = arch.ap
        mi, mo = self.msg_in, self.msg_out
        # clocking
        pb.add_r1cs_constraint(1, _lc(mi.ts) + 1, mo.ts, "ts_incr")
        # initial values propagate unchanged
        for i in range(self.ds):
            pb.add_r1cs_constraint(
                1, _lc(mi.root_init.bits[i]) - mo.root_init.bits[i], 0,
                f"copy_rooti_{i}")
        pb.add_r1cs_constraint(1, _lc(mi.pc_init) - mo.pc_init, 0,
                               "copy_pci")
        pb.add_r1cs_constraint(1, _lc(mi.flag_init) - mo.flag_init, 0,
                               "copy_fi")
        for j in range(ap.k):
            pb.add_r1cs_constraint(
                1, _lc(mi.regs_init[j]) - mo.regs_init[j], 0,
                f"copy_ri{j}")
        # base case: incoming state must equal the carried initial values
        self.base_gadget.generate_r1cs_constraints()
        for i in range(self.ds):
            pb.add_r1cs_constraint(
                self.is_base, _lc(mi.root.bits[i]) - mi.root_init.bits[i],
                0, f"base_root_{i}")
        pb.add_r1cs_constraint(self.is_base, _lc(mi.pc) - mi.pc_init, 0,
                               "base_pc")
        pb.add_r1cs_constraint(self.is_base, _lc(mi.flag) - mi.flag_init,
                               0, "base_flag")
        for j in range(ap.k):
            pb.add_r1cs_constraint(
                self.is_base, _lc(mi.regs[j]) - mi.regs_init[j], 0,
                f"base_r{j}")
        pb.add_r1cs_constraint(self.is_base, mi.acc, 0, "base_acc")
        # the step itself
        self.cpu.generate_r1cs_constraints()
        self.fetch_path.generate_r1cs_constraints()
        self.fetch.generate_r1cs_constraints()
        self.maddr_pack.generate_r1cs_constraints(True)
        self.prev_pack.generate_r1cs_constraints(True)
        self.next_pack.generate_r1cs_constraints(True)
        self.prev_path.generate_r1cs_constraints()
        self.next_path.generate_r1cs_constraints()
        self.update.generate_r1cs_constraints()
        # (loads seeing the previous value is the checker's rmw_identity
        # constraint: mem_in IS prev_val here)
        # acceptance: answering 0
        self.az_gadget.generate_r1cs_constraints()
        pb.add_r1cs_constraint(
            self.cpu.op_onehot.alpha[int(Opcode.ANSWER)], self.answer_zero,
            self.msg_out.acc, "accepted")

    def witness_step(self, msg_in: "RamPCDMessage", step: "TraceStep",
                     mem: "DelegatedRAMemory", set_out) -> "RamPCDMessage":
        """Fill the step machinery. Caller must have set the msg_in
        variable block already; `set_out(msg_out)` is invoked to fill
        the outgoing block before the dependent gadget witnesses run.
        `mem` is mutated by the step's store."""
        pb, arch = self.pb, self.arch
        ap = arch.ap
        pb.setval(self.zero, 0)

        # fetch (before the data op)
        fetch_path = mem.get_path(step.pc)
        dword = step.instruction.as_dword(ap)
        assert mem.get_value(step.pc) == dword, "fetch mismatch"

        pb.setval(self.instruction, dword)
        self.cpu.generate_r1cs_witness(step)
        self.fetch_path.generate_r1cs_witness(step.pc, fetch_path)

        # data op (read-modify-write of one dword cell)
        if step.mem_op:
            kind, addr, before, after = step.mem_op
        else:
            kind, addr, before, after = "r", arch.dummy_addr, 0, 0
        assert mem.get_value(addr) == before, "memory state mismatch"
        pb.setval(self.prev_val, before)
        self.prev_pack.generate_r1cs_witness_from_packed()
        self.next_pack.generate_r1cs_witness_from_packed()
        self.maddr_pack.generate_r1cs_witness_from_packed()
        prev_path = mem.get_path(addr)
        mem.set_value(addr, after)         # loads rewrite the same value
        next_path = mem.get_path(addr)
        self.prev_path.generate_r1cs_witness(addr, prev_path)
        self.next_path.generate_r1cs_witness(addr, next_path)

        accepted = int(step.instruction.opcode == Opcode.ANSWER
                       and pb.lc_val(_lc(self.cpu.a2)) == 0)
        msg_out = RamPCDMessage(
            timestamp=msg_in.timestamp + 1,
            root_initial=list(msg_in.root_initial),
            root=mem.get_root(),
            pc_addr=step.pc_after, regs=list(step.regs_after),
            flag=1 if step.flag_after else 0,
            pc_addr_initial=msg_in.pc_addr_initial,
            regs_initial=list(msg_in.regs_initial),
            flag_initial=msg_in.flag_initial,
            has_accepted=accepted)
        set_out(msg_out)

        # gadget witnesses that depend on both sides
        self.az_gadget.generate_r1cs_witness()
        self.base_gadget.generate_r1cs_witness()
        self.fetch.generate_r1cs_witness()
        self.update.generate_r1cs_witness()
        return msg_out


class RamCompliancePredicate:
    """One-CPU-step compliance circuit over the inner scalar field
    (ram_compliance_predicate.tcc): primary input is the single
    statement hash h = CRH(msg_in || msg_out)."""

    def __init__(self, p: int, arch: RamZkSnarkArchParams):
        self.p = p
        self.arch = arch
        ap, d = arch.ap, arch.tree_depth
        self.ds = ds = p.bit_length()          # knapsack digest bits
        pb = self.pb = Protoboard(p)

        # primary input FIRST: separate hashes of msg_in and msg_out so
        # the outer aggregation circuit chains steps by SHARING the
        # h_out_i / h_in_{i+1} input-bit blocks (sound linkage without
        # non-native hashing; cf. r1cs_sp_ppzkpcd's statement binding)
        self.h_in = PBVariable().allocate(pb, "h_in")
        self.h_out = PBVariable().allocate(pb, "h_out")
        pb.set_input_sizes(2)

        self.zero = PBVariable().allocate(pb, "zero")
        self.msg_in = _MsgVars(pb, arch, ds, "in")
        self.msg_out = _MsgVars(pb, arch, ds, "out")
        self.core = _RamStepCore(pb, arch, ds, self.msg_in, self.msg_out,
                                 self.zero)
        # aliases (pre-refactor attribute surface)
        self.cpu = self.core.cpu
        self.is_base = self.core.is_base
        self.instruction = self.core.instruction
        self.fetch_path = self.core.fetch_path
        self.fetch = self.core.fetch
        self.update = self.core.update
        self.prev_path = self.core.prev_path
        self.next_path = self.core.next_path
        self.answer_zero = self.core.answer_zero

        self._generate_constraints()

    def _generate_constraints(self):
        pb = self.pb
        mi, mo = self.msg_in, self.msg_out
        pb.add_r1cs_constraint(1, self.zero, 0, "zero")
        mi.generate_r1cs_constraints(pb, "in")
        mo.generate_r1cs_constraints(pb, "out")
        # statement hashes (one linear row each)
        self.hash_in_gadget = KnapsackCRHFieldOutGadget(
            pb, mi.all_bits(), [self.h_in], 1, "stmt_in")
        self.hash_in_gadget.generate_r1cs_constraints()
        self.hash_out_gadget = KnapsackCRHFieldOutGadget(
            pb, mo.all_bits(), [self.h_out], 1, "stmt_out")
        self.hash_out_gadget.generate_r1cs_constraints()
        self.core.generate_r1cs_constraints()

    # ------------------------------------------------------------- witness
    def witness_step(self, msg_in: RamPCDMessage, step: TraceStep,
                     mem: DelegatedRAMemory) -> RamPCDMessage:
        """Fill the circuit for one step; `mem` is the delegated memory
        BEFORE the step and is mutated by its store. Returns msg_out."""
        pb = self.pb
        self.msg_in.set_witness(pb, msg_in)
        msg_out = self.core.witness_step(
            msg_in, step, mem,
            set_out=lambda mo_msg: self.msg_out.set_witness(pb, mo_msg))
        self.hash_in_gadget.generate_r1cs_witness()
        self.hash_out_gadget.generate_r1cs_witness()
        return msg_out

    def statement(self, msg_in: RamPCDMessage,
                  msg_out: RamPCDMessage) -> List[int]:
        """Host-side [h_in, h_out] (what the snark verifier checks)."""
        return [message_hash(self.p, self.arch, msg_in),
                message_hash(self.p, self.arch, msg_out)]


def message_hash(p: int, arch: RamZkSnarkArchParams,
                 msg: RamPCDMessage) -> int:
    return knapsack_crh_field_eval(p, msg.payload_bits(arch), 1)[0]


def statement_hash(p: int, arch: RamZkSnarkArchParams,
                   msg_in: RamPCDMessage, msg_out: RamPCDMessage):
    """Back-compat helper: the pair of per-message hashes."""
    return [message_hash(p, arch, msg_in), message_hash(p, arch, msg_out)]


def make_delegated_memory(p: int, arch: RamZkSnarkArchParams,
                          contents: Dict[int, int]) -> DelegatedRAMemory:
    ds = p.bit_length()
    return DelegatedRAMemory(
        1 << arch.tree_depth, 2 * arch.ap.w,
        KnapsackTwoToOneHashGadget.hash_fn(p), contents, digest_size=ds)


@dataclasses.dataclass
class RamZkSnarkKeypair:
    pk: "RamZkSnarkProvingKey"
    vk: "RamZkSnarkVerificationKey"


@dataclasses.dataclass
class RamZkSnarkProvingKey:
    arch: RamZkSnarkArchParams
    inner_pk: object


@dataclasses.dataclass
class RamZkSnarkVerificationKey:
    arch: RamZkSnarkArchParams
    inner_vk: object


@dataclasses.dataclass
class RamZkSnarkProof:
    """Bounded-PCD transcript: per-step inner proofs + the message
    chain endpoints (the intermediate messages are the chain itself;
    the aggregated single-proof form replaces them with one outer
    Groth16 proof -- see RamZkSnark.build_outer_circuit)."""
    messages: List[RamPCDMessage]
    inner_proofs: List[object]


class RamZkSnark:
    """Generator / prover / verifier (ram_zksnark.tcc API parity).

    device: where the inner (and, in the succinct form, the outer) Groth16
    runs -- "cuda" unless the caller asks for "cpu"."""

    def __init__(self, inner_curve, device="cuda"):
        from .groth16 import Groth16
        self.curve = inner_curve
        self.p = inner_curve.r
        self.device = device
        self.g16 = Groth16(inner_curve, device=device)

    def predicate(self, arch: RamZkSnarkArchParams):
        return RamCompliancePredicate(self.p, arch)

    def generator(self, arch: RamZkSnarkArchParams, seed=None,
                  _keygen=True, timings: Optional[dict] = None
                  ) -> RamZkSnarkKeypair:
        """timings: optional dict that receives wall seconds of the
        predicate build and the inner keygen's own phases."""
        clock = PhaseClock(timings, self.g16.device)
        pred = self.predicate(arch)
        clock.lap("predicate_build")
        inner_pk = inner_vk = None
        if _keygen:
            kp = self.g16.generator(pred.pb.get_constraint_system(),
                                    seed=seed, timings=timings)
            inner_pk, inner_vk = kp.pk, kp.vk
        return RamZkSnarkKeypair(
            RamZkSnarkProvingKey(arch, inner_pk),
            RamZkSnarkVerificationKey(arch, inner_vk))

    # ----------------------------------------------------------------- prove
    def _trace(self, arch: RamZkSnarkArchParams, program: TinyRAMProgram,
               primary_input: List[int], aux_tape: List[int],
               time_bound: int):
        """(delegated memory at boot, execution trace padded to
        time_bound with stalled ANSWER steps)."""
        boot = tinyram_boot_trace(arch.ap, program, primary_input)
        mem = make_delegated_memory(self.p, arch, boot)
        ex = TinyRAMUnifiedExecutor(arch.ap, program)
        _, _, trace = ex.run_from_boot(boot, primary_input, aux_tape,
                                       max_steps=time_bound)
        assert len(trace) <= time_bound
        while len(trace) < time_bound:       # pad with stalled ANSWER
            last = trace[-1]
            trace.append(dataclasses.replace(
                last, timestamp=last.timestamp + 1, pc=last.pc_after,
                regs_before=list(last.regs_after),
                flag_before=last.flag_after, mem_op=None))
        return mem, trace

    def run_and_chain(self, arch: RamZkSnarkArchParams,
                      program: TinyRAMProgram, primary_input: List[int],
                      aux_tape: List[int], time_bound: int,
                      pred: Optional[RamCompliancePredicate] = None,
                      check=False):
        """Execute + build the message chain; yields (pred, messages,
        per-step satisfiability). The proving key's predicate circuit is
        re-witnessed per step (one PCD application each)."""
        pred = pred or self.predicate(arch)
        assert program.size > 0, "empty TinyRAM program"
        boot = tinyram_boot_trace(arch.ap, program, primary_input)
        assert max(boot) < arch.dummy_addr, "boot exceeds delegated memory"
        mem, trace = self._trace(arch, program, primary_input, aux_tape,
                                 time_bound)
        msgs = [RamPCDMessage.initial(arch, mem.get_root())]
        oks = []
        for step in trace:
            msg_out = pred.witness_step(msgs[-1], step, mem)
            if check:
                bad = pred.pb.first_unsatisfied()
                oks.append(bad)
                assert bad is None, f"step {step.timestamp}: {bad}"
            msgs.append(msg_out)
        return pred, msgs, oks

    def _prove_steps(self, pk: RamZkSnarkProvingKey,
                     program: TinyRAMProgram, primary_input: List[int],
                     time_bound: int, aux_tape: List[int], seed,
                     timings: Optional[dict]):
        """(messages, inner proofs): one Groth16 proof per step, each from
        the predicate circuit re-witnessed for that step. timings gets the
        seconds of predicate_build (with the execution) and, summed over
        the steps, of witness (host) and inner_prove."""
        lap = {}
        clock = PhaseClock(None if timings is None else lap, self.g16.device)
        pred = self.predicate(pk.arch)
        mem, trace = self._trace(pk.arch, program, primary_input, aux_tape,
                                 time_bound)
        msgs = [RamPCDMessage.initial(pk.arch, mem.get_root())]
        clock.lap("predicate_build")
        proofs = []
        spent = dict(lap, witness=0.0, inner_prove=0.0)
        for step in trace:
            msgs.append(pred.witness_step(msgs[-1], step, mem))
            primary = pred.pb.primary_input()
            aux = pred.pb.auxiliary_input()
            clock.lap("witness")
            proofs.append(self.g16.prover(pk.inner_pk, primary, aux,
                                          seed=seed))
            clock.lap("inner_prove")
            for name in ("witness", "inner_prove"):
                spent[name] += lap[name]
        if timings is not None:
            timings.update(spent)
        return msgs, proofs

    def prover(self, pk: RamZkSnarkProvingKey, program: TinyRAMProgram,
               primary_input: List[int], time_bound: int,
               aux_tape: List[int], seed=None,
               timings: Optional[dict] = None) -> RamZkSnarkProof:
        """One inner Groth16 proof per step; the assignment is extracted
        from the re-witnessed predicate circuit after each step. timings:
        optional dict that receives predicate_build, witness and
        inner_prove (the last two summed over the steps)."""
        msgs, proofs = self._prove_steps(pk, program, primary_input,
                                         time_bound, aux_tape, seed, timings)
        return RamZkSnarkProof(messages=[msgs[0], msgs[-1]],
                               inner_proofs=proofs)

    # ---------------------------------------------------------------- verify
    def check_final_message(self, vk: RamZkSnarkVerificationKey,
                            program: TinyRAMProgram,
                            primary_input: List[int], time_bound: int,
                            msg0: RamPCDMessage,
                            msg_final: RamPCDMessage) -> bool:
        """The ram_zksnark verifier's host checks (ram_zksnark.tcc:
        construct the initial message from the boot trace, require the
        final message to have accepted at the right timestamp)."""
        arch = vk.arch
        boot = tinyram_boot_trace(arch.ap, program, primary_input)
        mem = make_delegated_memory(self.p, arch, boot)
        init = RamPCDMessage.initial(arch, mem.get_root())
        if msg0 != init:
            return False
        m = msg_final
        return (m.timestamp == time_bound
                and m.has_accepted == 1
                and m.root_initial == init.root
                and m.pc_addr_initial == 0
                and m.flag_initial == 0
                and m.regs_initial == [0] * arch.ap.k)

    def verify_transcript(self, vk: RamZkSnarkVerificationKey,
                          program: TinyRAMProgram,
                          primary_input: List[int], time_bound: int,
                          proof: RamZkSnarkProof,
                          all_messages: Optional[List[RamPCDMessage]]
                          = None) -> bool:
        """Verify the chunked transcript: every inner proof against its
        statement hash + endpoint checks (host pairings). (The succinct
        form verifies ONE outer proof of the aggregation circuit
        instead.)"""
        msgs = all_messages or proof.messages
        if len(msgs) != len(proof.inner_proofs) + 1:
            return False
        if not self.check_final_message(vk, program, primary_input,
                                        time_bound, msgs[0], msgs[-1]):
            return False
        hs = [message_hash(self.p, vk.arch, m) for m in msgs]
        for i, pi in enumerate(proof.inner_proofs):
            if not self.g16.verifier_strong_IC(vk.inner_vk,
                                               [hs[i], hs[i + 1]], pi):
                return False
        return True

    # ------------------------------------------------- outer aggregation
    def build_outer_circuit(self, outer_curve, inner_vk, arch,
                            time_bound: int):
        """BW6-761 aggregation circuit with SOUND chaining: one boundary
        bit block per message hash h_0..h_T; verifier gadget i consumes
        blocks (i, i+1) -- adjacent gadgets SHARE the block, so
        h_out_i == h_in_{i+1} is structural. The outer primary input is
        the endpoint blocks' bits (h_0, h_T); everything between is
        witness (the succinct form: ram_zksnark.tcc:142's recursion,
        bounded one level)."""
        from ..gadgets.verifier_gadgets import Groth16VerifierGadget
        assert outer_curve.r == self.curve.q
        pb = Protoboard(outer_curve.r)
        nbits = self.p.bit_length()
        # endpoint blocks FIRST (they are the primary input)
        first = PBVariableArray().allocate(pb, nbits, "h_0")
        last = PBVariableArray().allocate(pb, nbits, f"h_{time_bound}")
        pb.set_input_sizes(2 * nbits)
        blocks = [first]
        for i in range(1, time_bound):
            blocks.append(PBVariableArray().allocate(pb, nbits, f"h_{i}"))
        blocks.append(last)
        gadgets = []
        for i in range(time_bound):
            gadgets.append(Groth16VerifierGadget(
                pb, self.curve, inner_vk,
                [list(blocks[i]), list(blocks[i + 1])], f"v{i}"))
        return pb, blocks, gadgets

    # ------------------------------------------------ succinct two-level
    def _outer_system(self, outer_curve):
        from .groth16 import Groth16
        return Groth16(outer_curve, device=self.device)

    def generator_succinct(self, arch: RamZkSnarkArchParams, outer_curve,
                           time_bound: int, seed=None,
                           host_keygen: bool = False,
                           timings: Optional[dict] = None):
        """Keys for the chunked two-level system: inner step keys +
        outer aggregation keys for a fixed time bound. timings: optional
        dict that receives wall seconds of inner_keygen, outer_build and
        outer_keygen."""
        clock = PhaseClock(timings, self.g16.device)
        self.g16.host_keygen = host_keygen
        kp = self.generator(arch, seed=seed)
        clock.lap("inner_keygen")
        g16o = self._outer_system(outer_curve)
        g16o.host_keygen = host_keygen
        pb, blocks, gadgets = self.build_outer_circuit(
            outer_curve, kp.vk.inner_vk, arch, time_bound)
        cs_outer = pb.get_constraint_system()
        clock.lap("outer_build")
        okp = g16o.generator(cs_outer,
                             seed=None if seed is None else seed + 1)
        clock.lap("outer_keygen")
        return RamZkSnarkSuccinctKeypair(
            inner=kp, outer_keypair=okp, outer_curve=outer_curve,
            time_bound=time_bound)

    def prover_succinct(self, skp: "RamZkSnarkSuccinctKeypair",
                        program: TinyRAMProgram,
                        primary_input: List[int], time_bound: int,
                        aux_tape: List[int], seed=None,
                        timings: Optional[dict] = None):
        """Per-step inner proves + ONE outer Groth16 proof over the
        aggregation circuit. Returns RamZkSnarkSuccinctProof. timings:
        optional dict that receives the phases of ``prover`` and
        outer_build and outer_prove."""
        assert time_bound == skp.time_bound
        pk = skp.inner.pk
        msgs, proofs = self._prove_steps(pk, program, primary_input,
                                         time_bound, aux_tape, seed, timings)
        clock = PhaseClock(timings, self.g16.device)
        # outer aggregation
        g16o = self._outer_system(skp.outer_curve)
        pb, blocks, gadgets = self.build_outer_circuit(
            skp.outer_curve, skp.inner.vk.inner_vk, pk.arch, time_bound)
        hs = [message_hash(self.p, pk.arch, m) for m in msgs]
        for blk, h in zip(blocks, hs):
            blk.fill_with_bits_of_int(pb, h)
        for g, pi in zip(gadgets, proofs):
            g.set_proof_witness(pi)
        for g in gadgets:
            g.generate_witness()
        bad = g16o.first_unsatisfied(skp.outer_keypair.pk.r1cs_dev, pb)
        assert bad is None, f"outer aggregation unsatisfied: {bad}"
        clock.lap("outer_build")
        outer_proof = g16o.prover(skp.outer_keypair.pk,
                                  pb.primary_input(),
                                  pb.auxiliary_input(), seed=seed)
        clock.lap("outer_prove")
        return RamZkSnarkSuccinctProof(
            msg_initial=msgs[0], msg_final=msgs[-1],
            outer_proof=outer_proof)

    def verifier_succinct(self, skp_vk, arch, outer_curve,
                          program: TinyRAMProgram,
                          primary_input: List[int], time_bound: int,
                          proof: "RamZkSnarkSuccinctProof") -> bool:
        """Host checks: endpoints consistent with (boot, time_bound),
        then ONE outer Groth16 verification whose primary input is the
        endpoint hashes' bits."""
        vk_host = RamZkSnarkVerificationKey(arch, None)
        if not self.check_final_message(vk_host, program, primary_input,
                                        time_bound, proof.msg_initial,
                                        proof.msg_final):
            return False
        nbits = self.p.bit_length()
        h0 = message_hash(self.p, arch, proof.msg_initial)
        hT = message_hash(self.p, arch, proof.msg_final)
        primary = [(h0 >> b) & 1 for b in range(nbits)] + \
                  [(hT >> b) & 1 for b in range(nbits)]
        g16o = self._outer_system(outer_curve)
        return g16o.verifier_strong_IC(skp_vk, primary, proof.outer_proof)


@dataclasses.dataclass
class RamZkSnarkSuccinctKeypair:
    inner: RamZkSnarkKeypair
    outer_keypair: object
    outer_curve: object
    time_bound: int


@dataclasses.dataclass
class RamZkSnarkSuccinctProof:
    """Constant-size ram_zksnark proof: chain endpoints + one outer
    Groth16 proof aggregating every per-step inner proof."""
    msg_initial: RamPCDMessage
    msg_final: RamPCDMessage
    outer_proof: object


# --------------------------------------------------------------------------
# UNBOUNDED recursion backend: ram_zksnark over MNT-cycle sp-PCD
# (the reference's actual construction: ram_zksnark.tcc:142 drives
# r1cs_sp_ppzkpcd with the one-CPU-step compliance predicate of
# ram_compliance_predicate.tcc; depth = execution length, proof size
# constant).
# --------------------------------------------------------------------------

def ram_cycle_payload_size(arch: RamZkSnarkArchParams) -> int:
    """Field elements in the PCD payload encoding of RamPCDMessage."""
    return 2 * arch.ap.k + 10


def ram_cycle_payload(ds: int, arch: RamZkSnarkArchParams,
                      msg: RamPCDMessage) -> List[int]:
    """RamPCDMessage -> PCD payload [ts, pc, flag, regs..., acc,
    root_lo, root_hi, rooti_lo, rooti_hi, pc_init, flag_init,
    regs_init...]. Digests ride as two packed halves because a ds-bit
    digest may exceed the field modulus."""
    half = (ds + 1) // 2

    def halves(bits):
        lo = sum(b << i for i, b in enumerate(bits[:half]))
        hi = sum(b << i for i, b in enumerate(bits[half:]))
        return [lo, hi]

    return ([msg.timestamp, msg.pc_addr, msg.flag] + list(msg.regs)
            + [msg.has_accepted] + halves(msg.root)
            + halves(msg.root_initial)
            + [msg.pc_addr_initial, msg.flag_initial]
            + list(msg.regs_initial))


def payload_to_ram_msg(ds: int, arch: RamZkSnarkArchParams,
                       payload: List[int]) -> RamPCDMessage:
    half = (ds + 1) // 2
    k = arch.ap.k

    def unhalves(lo, hi):
        v = lo | (hi << half)
        return [(v >> i) & 1 for i in range(ds)]

    return RamPCDMessage(
        timestamp=payload[0], pc_addr=payload[1], flag=payload[2],
        regs=list(payload[3:3 + k]), has_accepted=payload[3 + k],
        root=unhalves(payload[4 + k], payload[5 + k]),
        root_initial=unhalves(payload[6 + k], payload[7 + k]),
        pc_addr_initial=payload[8 + k], flag_initial=payload[9 + k],
        regs_initial=list(payload[10 + k:10 + 2 * k]))


class RamCycleCompliancePredicate:
    """ram_compliance_predicate in cp_handler form for the MNT-cycle
    sp-PCD (reference ram_compliance_predicate.tcc): arity 1, message =
    [type | ram payload]; base case (type 0) is the boot-state message,
    validated in-circuit (ts == 0 forces state == carried initials),
    NOT the zero message -- hence base_case='type0'."""

    TYPE = 1
    base_case = "type0"

    def __init__(self, p: int, arch: RamZkSnarkArchParams):
        from .compliance_predicate import CompliancePredicateHandler
        self.p = p
        self.arch = arch
        self.ds = ds = p.bit_length()
        self.half = (ds + 1) // 2
        n = ram_cycle_payload_size(arch)
        # reuse the handler block layout (outgoing | arity | incoming |
        # local) so GadgetFromR1CS splicing lines up
        self._h = CompliancePredicateHandler(
            p, name=1, type_=self.TYPE, max_arity=1,
            outgoing_size=n, incoming_size=n, local_size=0)
        self.pb = self._h.pb
        self.max_arity = 1
        self.outgoing = self._h.outgoing
        self.arity = self._h.arity
        self.incoming = self._h.incoming
        pb = self.pb
        self.zero = PBVariable().allocate(pb, "zero")
        self.msg_in = _MsgVars(pb, arch, ds, "in")
        self.msg_out = _MsgVars(pb, arch, ds, "out")
        self.core = _RamStepCore(pb, arch, ds, self.msg_in, self.msg_out,
                                 self.zero)
        self._ctx = None
        self.last_msg_out: Optional[RamPCDMessage] = None

    # -- block <-> _MsgVars linkage (all linear rows) ----------------------
    def _link_block(self, block, mv: _MsgVars, tag: str):
        pb, ds, half = self.pb, self.ds, self.half
        from ..relations.variable import LinearCombination as LC
        items = [mv.ts, mv.pc, mv.flag] + mv.regs + [mv.acc]
        idx = 1
        for it in items:
            pb.add_r1cs_constraint(1, _lc(it) - block[idx], 0,
                                   f"{tag}_l{idx}")
            idx += 1
        for bits in (mv.root.bits, mv.root_init.bits):
            for lo in (0, half):
                hi = min(ds, lo + half)
                s = LC(0)
                for j in range(lo, hi):
                    s = s + LC(bits[j]) * (1 << (j - lo))
                pb.add_r1cs_constraint(1, s - block[idx], 0,
                                       f"{tag}_l{idx}")
                idx += 1
        for it in [mv.pc_init, mv.flag_init] + mv.regs_init:
            pb.add_r1cs_constraint(1, _lc(it) - block[idx], 0,
                                   f"{tag}_l{idx}")
            idx += 1
        assert idx == len(block)

    def generate_r1cs_constraints(self):
        pb = self.pb
        from ..relations.variable import LinearCombination as LC
        pb.add_r1cs_constraint(1, self.zero, 0, "zero")
        pb.add_r1cs_constraint(1, self.outgoing[0], self.TYPE, "out_type")
        t_in = self.incoming[0][0]
        generate_boolean_r1cs_constraint(pb, t_in, "in_type_bool")
        # a base-case (type-0) incoming message must be a boot-state
        # message: ts == 0, whereupon the core's base constraints bind
        # the full state to the carried initial values
        pb.add_r1cs_constraint(1 - LC(t_in), self.msg_in.ts, 0,
                               "base_ts0")
        # arity == type_in (0 for the base step, else 1)
        pb.add_r1cs_constraint(1, LC(self.arity) - t_in, 0, "arity_type")
        self.msg_in.generate_r1cs_constraints(pb, "in")
        self.msg_out.generate_r1cs_constraints(pb, "out")
        self._link_block(self.incoming[0], self.msg_in, "lin")
        self._link_block(self.outgoing, self.msg_out, "lout")
        self.core.generate_r1cs_constraints()

    # -- witness -----------------------------------------------------------
    def set_step_context(self, base_msg: RamPCDMessage, step: TraceStep,
                         mem: DelegatedRAMemory):
        """base_msg is consumed only when the step has no incoming
        message (the boot step)."""
        self._ctx = (base_msg, step, mem)

    def generate_r1cs_witness(self, incoming, local):
        base_msg, step, mem = self._ctx
        pb, ds, arch = self.pb, self.ds, self.arch
        if incoming:
            msg_in = payload_to_ram_msg(ds, arch, incoming[0].payload)
            t_in = 1
        else:
            msg_in = base_msg
            t_in = 0
        pb.setval(self.arity, t_in)
        pb.setval(self.incoming[0][0], t_in)
        for k, v in enumerate(ram_cycle_payload(ds, arch, msg_in)):
            pb.setval(self.incoming[0][1 + k], v)
        self.msg_in.set_witness(pb, msg_in)
        msg_out = self.core.witness_step(
            msg_in, step, mem,
            set_out=lambda m: self.msg_out.set_witness(pb, m))
        out_payload = ram_cycle_payload(ds, arch, msg_out)
        pb.setval(self.outgoing[0], self.TYPE)
        for k, v in enumerate(out_payload):
            pb.setval(self.outgoing[1 + k], v)
        self.last_msg_out = msg_out
        from .compliance_predicate import PCDMessage
        return PCDMessage(type=self.TYPE, payload=out_payload)

    def get_constraint_system(self):
        return self.pb.get_constraint_system()

    def is_satisfied(self) -> bool:
        return self.pb.is_satisfied()


@dataclasses.dataclass
class RamZkSnarkCycleKeypair:
    arch: RamZkSnarkArchParams
    pcd_pk: object
    pcd_vk: object


class RamZkSnarkCycle:
    """The TRUE ram_zksnark: unbounded MNT-cycle PCD over per-CPU-step
    compliance predicates (ram_zksnark.tcc generator :104 / prover :142 /
    verifier :201). Proof size is constant in the execution length."""

    def __init__(self, pcd=None, device="cuda"):
        """pcd: the CycleSpPCD to run (by default one over MNT4 -> MNT6 on
        ``device``: "cuda" unless the caller asks for the CPU)."""
        from .pcd_cycle import CycleSpPCD
        self.pcd = pcd or CycleSpPCD(device=device)
        self.p = self.pcd.A.r

    def predicate(self, arch: RamZkSnarkArchParams):
        h = RamCycleCompliancePredicate(self.p, arch)
        h.generate_r1cs_constraints()
        return h

    def generator(self, arch: RamZkSnarkArchParams, seed=None,
                  timings: Optional[dict] = None) -> RamZkSnarkCycleKeypair:
        """timings: optional dict that receives predicate_build and the
        phases of CycleSpPCD.generator."""
        clock = PhaseClock(timings, self.pcd.g16_a.device)
        handler = self.predicate(arch)
        clock.lap("predicate_build")
        pk, vk = self.pcd.generator(handler, seed=seed, timings=timings)
        return RamZkSnarkCycleKeypair(arch=arch, pcd_pk=pk, pcd_vk=vk)

    def _trace(self, arch, program, primary_input, aux_tape, time_bound):
        boot = tinyram_boot_trace(arch.ap, program, primary_input)
        assert max(boot) < arch.dummy_addr, "boot exceeds delegated memory"
        mem = make_delegated_memory(self.p, arch, boot)
        ex = TinyRAMUnifiedExecutor(arch.ap, program)
        _, _, trace = ex.run_from_boot(boot, primary_input, aux_tape,
                                       max_steps=time_bound)
        while len(trace) < time_bound:
            last = trace[-1]
            trace.append(dataclasses.replace(
                last, timestamp=last.timestamp + 1, pc=last.pc_after,
                regs_before=list(last.regs_after),
                flag_before=last.flag_after, mem_op=None))
        return mem, trace

    def prover(self, kp: RamZkSnarkCycleKeypair, program: TinyRAMProgram,
               primary_input: List[int], time_bound: int,
               aux_tape: List[int], seed=None,
               timings: Optional[dict] = None):
        """One PCD step per CPU step; returns the final CyclePCDProof
        (constant size -- message + one translation proof). timings:
        optional dict that receives trace (the execution) and
        predicate_build, and CycleSpPCD.prover's phases summed over the
        steps."""
        from .compliance_predicate import PCDLocalData
        lap = {}
        clock = PhaseClock(None if timings is None else lap,
                           self.pcd.g16_a.device)
        arch = kp.arch
        mem, trace = self._trace(arch, program, primary_input, aux_tape,
                                 time_bound)
        msg = RamPCDMessage.initial(arch, mem.get_root())
        clock.lap("trace")
        spent = dict(lap)
        cur = None
        for step in trace:
            handler = self.predicate(arch)
            handler.set_step_context(msg, step, mem)
            clock.lap("predicate_build")
            cur = self.pcd.prover(kp.pcd_pk, handler,
                                  [] if cur is None else [cur],
                                  PCDLocalData(values=[]), seed=seed,
                                  timings=lap)
            clock.lap("step")
            for k, v in lap.items():
                if k not in ("trace", "step"):
                    spent[k] = spent.get(k, 0.0) + v
            lap.clear()
            msg = handler.last_msg_out
        if timings is not None:
            timings.update(spent)
        return cur

    def verifier(self, pcd_vk, arch: RamZkSnarkArchParams,
                 program: TinyRAMProgram, primary_input: List[int],
                 time_bound: int, proof) -> bool:
        """Host endpoint checks against the boot trace + ONE pairing
        check (the PCD verifier) -- ram_zksnark.tcc:201."""
        final = payload_to_ram_msg(self.p.bit_length(), arch,
                                   list(proof.msg.payload))
        boot = tinyram_boot_trace(arch.ap, program, primary_input)
        mem = make_delegated_memory(self.p, arch, boot)
        init = RamPCDMessage.initial(arch, mem.get_root())
        if not (proof.msg.type == RamCycleCompliancePredicate.TYPE
                and final.timestamp == time_bound
                and final.has_accepted == 1
                and final.root_initial == init.root
                and final.pc_addr_initial == 0
                and final.flag_initial == 0
                and final.regs_initial == [0] * arch.ap.k):
            return False
        return self.pcd.verifier(pcd_vk, proof.msg, proof)
