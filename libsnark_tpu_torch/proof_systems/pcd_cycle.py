"""Unbounded-depth single-predicate PCD over the MNT4/MNT6 cycle — the
reference's r1cs_sp_ppzkpcd re-designed TPU-first (reference
zk_proof_systems/pcd/r1cs_pcd/r1cs_sp_ppzkpcd/{r1cs_sp_ppzkpcd.tcc:149,
213,271, sp_pcd_circuits.tcc}; cycle choice
common/default_types/r1cs_ppzkpcd_pp.hpp:27-38).

Two circuits, one per cycle curve (A = mnt4, B = mnt6):

  * COMPLIANCE circuit C_A over Fr(A): primary input = ONE field element
    h_out = KnapsackCRH(bits(processed vk_B) || bits(msg_out)). Witness:
    msg_out, incoming messages, local data, the predicate's logic
    (spliced via gadget_from_r1cs), the PROCESSED translation vk_B
    (witness variables, hash-authenticated through h — the reference's
    circularity break: C_A is generated before vk_B exists), and per
    incoming message a translation proof verified by a SOFT
    processed-vk verifier gadget (result bit; base-case incoming
    messages set is_base and skip the check, reference
    sp_compliance_step_pcd_circuit arity handling).
  * TRANSLATION circuit C_B over Fr(B): primary input = the SAME h
    value carried into the other field (Fr(A) < Fr(B), injection);
    unpacks h to canonical bits (strict < r(A) range check) and
    verifies the compliance proof with a HARDCODED-vk mnt4 verifier
    gadget.

A PCD proof for message m is (m, pi_B): the translation proof under
vk_B for statement h = CRH(bits(pvk_B) || bits(m)). Verification is one
host pairing check. Depth is unbounded: each compliance step consumes
translation proofs and emits one, alternating curves exactly as the
reference's cycle recursion.

Soundness notes (documented deviations / choices):
  * vk binding uses the PROCESSED vk (e(alpha,beta), gamma, delta, IC)
    — the in-circuit mirror of verifier_process_vk — hashed with the
    knapsack CRH over canonical coordinate bits.
  * message/vk coordinate bit-packings are mod-r packings (two integer
    encodings can exist); forging via the non-canonical encoding
    requires an offset subset-sum preimage, which is exactly the
    knapsack CRH hardness assumption. Statement (h) decompositions DO
    carry strict canonicity range checks, which is what statement
    binding requires.

The port of libsnark_tpu/proof_systems/pcd_cycle.py. Both Groth16 systems
run on ``device`` ("cuda" unless the caller asks for the CPU); the circuits
are host Python. The generator keeps its two boards and the prover
re-witnesses them each step (the same R1CS, and the same assignment as a
fresh board's); each board's satisfaction is checked on its proving key's
device R1CS (PairingSystem.first_unsatisfied). generator and prover take
an optional ``timings`` dict.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .base import PhaseClock
from .compliance_predicate import PCDMessage, PCDLocalData
from ..gadgets.protoboard import Protoboard, PBVariable, PBVariableArray
from ..gadgets.basic import PackingGadget, generate_boolean_r1cs_constraint
from ..gadgets.gadget_from_r1cs import GadgetFromR1CS
from ..gadgets.hashes.knapsack import (KnapsackCRHFieldOutGadget,
                                       knapsack_crh_field_eval)
from ..gadgets.pairing_gadgets import G1Gadgets
from ..gadgets.mnt_pairing_gadgets import make_pairing_gadgets
from ..gadgets.verifier_gadgets import (
    Groth16VerifierGadget, Groth16ProcessedVKVariable,
    Groth16VerifierGadgetSoft, processed_vk_host_coords)
from ..relations.variable import LinearCombination as LC


class _Sub:
    """Per-part timings dicts for the Groth16 calls under a phase: sub(name)
    gives a dict (None when the caller passed no timings), merge() copies
    each into the caller's as name.<phase>."""

    def __init__(self, timings: Optional[dict]):
        self.timings = timings
        self.parts = {}

    def __call__(self, name: str) -> Optional[dict]:
        if self.timings is None:
            return None
        return self.parts.setdefault(name, {})

    def merge(self):
        for name, t in self.parts.items():
            self.timings.update({f"{name}.{k}": v for k, v in t.items()})


def _int_bits(v: int, n: int) -> List[int]:
    return [(v >> i) & 1 for i in range(n)]


def constrain_bits_lt_const(pb: Protoboard, bits, c: int, prefix="ltc"):
    """Constrain the integer encoded by `bits` (LSB first, already
    boolean) to be STRICTLY less than the constant c: an MSB-first
    prefix-equality chain against C = c-1 enforcing v <= C.

    Returns a witness closure to call after the bits are set."""
    C = c - 1
    n = len(bits)
    eq = LC(1)
    eq_chain = []
    for j in range(n - 1, -1, -1):
        bj = LC._coerce(bits[j])
        if (C >> j) & 1:
            ne = PBVariable().allocate(pb, f"{prefix}_eq{j}")
            pb.add_r1cs_constraint(eq, bj, ne, f"{prefix}_step{j}")
            eq_chain.append((j, ne))
            eq = LC(ne)
        else:
            # prefix equal so far and C's bit is 0 => v's bit must be 0
            pb.add_r1cs_constraint(eq, bj, 0, f"{prefix}_force0_{j}")

    def witness():
        e = 1
        k = 0
        for j in range(n - 1, -1, -1):
            bjv = pb.lc_val(LC._coerce(bits[j]))
            if (C >> j) & 1:
                e = e & (bjv & 1)
                jj, var = eq_chain[k]
                assert jj == j
                pb.setval(var, e)
                k += 1
            # C bit 0: constraint is passive
    return witness


class _BitsOfCoords:
    """Bit-decompose a list of coordinate LCs (mod-p packing); exposes
    the flat bit list (LSB-first per coordinate, coordinates in order)."""

    def __init__(self, pb, coord_lcs, nbits, prefix):
        self.pb = pb
        self.packers = []
        self.bits = []
        for k, lc in enumerate(coord_lcs):
            arr = PBVariableArray().allocate(pb, nbits, f"{prefix}_{k}")
            self.packers.append(PackingGadget(pb, arr, lc,
                                              f"{prefix}_pack{k}"))
            self.bits.extend(arr)

    def generate_r1cs_constraints(self):
        for g in self.packers:
            g.generate_r1cs_constraints(True)

    def generate_r1cs_witness(self):
        for g in self.packers:
            g.generate_r1cs_witness_from_packed()


# --------------------------------------------------------------------------
# key / proof containers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CyclePCDProvingKey:
    """r1cs_sp_ppzkpcd_proving_key (tcc:48): Groth16 keypairs for both
    circuits + the translation vk that the compliance side witnesses."""
    kp_a: object            # compliance keypair (curve A)
    kp_b: object            # translation keypair (curve B)
    handler_cs: object      # predicate constraint system (splice shape)
    max_arity: int
    msg_size: int           # 1 + payload size
    # the unproven-slot convention (see build_compliance_circuit)
    base_case: str = "zero"


@dataclasses.dataclass
class CyclePCDVerificationKey:
    vk_b: object
    msg_size: int


@dataclasses.dataclass
class CyclePCDProof:
    """(message, translation proof) — constant size, any depth
    (r1cs_sp_ppzkpcd_proof)."""
    msg: PCDMessage
    translation_proof: object


# --------------------------------------------------------------------------
# the system
# --------------------------------------------------------------------------

class CycleSpPCD:
    """Single-predicate PCD over the MNT cycle with REAL device Groth16
    proofs on both curves (generator/prover/verifier mirroring
    r1cs_sp_ppzkpcd.tcc:149/213/271)."""

    def __init__(self, curve_a=None, curve_b=None, device="cuda"):
        from ..curves import get_curve
        self.A = curve_a or get_curve("mnt4")
        self.B = curve_b or get_curve("mnt6")
        assert self.A.q == self.B.r and self.A.r == self.B.q, \
            "curves must form a 2-cycle"
        from .groth16 import Groth16
        self.g16_a = Groth16(self.A, device=device)
        self.g16_b = Groth16(self.B, device=device)
        self.nbits = self.A.r.bit_length()
        # the generator's boards, re-witnessed by the prover: compliance by
        # (predicate system, arity, message size, base case), translation
        # by the compliance verification key
        self._boards = {}

    def compliance_board(self, handler_cs, max_arity: int, msg_size: int,
                         base_case: str = "zero"):
        """build_compliance_circuit's board for this shape, built once."""
        key = ("C", id(handler_cs), max_arity, msg_size, base_case)
        if key not in self._boards:
            self._boards[key] = (handler_cs, self.build_compliance_circuit(
                handler_cs, max_arity, msg_size, base_case))
        return self._boards[key][1]

    def translation_board(self, vk_a):
        """build_translation_circuit's board for vk_a, built once."""
        key = ("T", id(vk_a))
        if key not in self._boards:
            self._boards[key] = (vk_a, self.build_translation_circuit(vk_a))
        return self._boards[key][1]

    # -- compliance circuit (C_A over Fr(A)) -------------------------------
    def build_compliance_circuit(self, handler_cs, max_arity: int,
                                 msg_size: int, base_case: str = "zero"):
        """Deterministic construction (same R1CS at keygen and prove).

        base_case governs what an UNPROVEN (is_base) incoming slot must
        carry: "zero" forces the whole message block to 0 (the tally
        predicate's convention); "type0" forces only the message TYPE
        element to 0, leaving base-message validity to the predicate
        itself (the RAM predicate's convention -- its base message is
        the boot state, not zero; cf. ram_compliance_predicate's
        gen_initial_message vs the type-field dispatch in
        compliance_predicate.hpp)."""
        assert base_case in ("zero", "type0")
        A, B = self.A, self.B
        nbits = self.nbits
        pb = Protoboard(A.r)
        h_out = PBVariable().allocate(pb, "h_out")
        pb.set_input_sizes(1)

        out_block = PBVariableArray().allocate(pb, msg_size, "msg_out")
        arity_var = PBVariable().allocate(pb, "arity")
        in_blocks = [PBVariableArray().allocate(pb, msg_size, f"msg_in{i}")
                     for i in range(max_arity)]
        # remaining handler variables (local data + predicate aux) are
        # allocated fresh by the splice gadget
        pred = GadgetFromR1CS(
            pb, [list(out_block), [arity_var]] +
            [list(b) for b in in_blocks], handler_cs, "pred")
        pred.generate_r1cs_constraints()

        pg_b = make_pairing_gadgets(pb, B, "pairB")
        g1_b = G1Gadgets(pb, "g1B", a=int(getattr(B, "a", 0)))
        pvk = Groth16ProcessedVKVariable(pb, pg_b, g1_b, num_inputs=1)

        vk_bits = _BitsOfCoords(pb, pvk.coordinate_lcs(), nbits, "vkb")
        vk_bits.generate_r1cs_constraints()
        out_bits = _BitsOfCoords(pb, [LC(v) for v in out_block], nbits,
                                 "outb")
        out_bits.generate_r1cs_constraints()
        crh_out = KnapsackCRHFieldOutGadget(
            pb, vk_bits.bits + out_bits.bits, [h_out], 1, "crh_out")
        crh_out.generate_r1cs_constraints()

        per_in = []
        for i in range(max_arity):
            is_base = PBVariable().allocate(pb, f"is_base{i}")
            generate_boolean_r1cs_constraint(pb, is_base, f"isb{i}")
            in_bits = _BitsOfCoords(pb, [LC(v) for v in in_blocks[i]],
                                    nbits, f"inb{i}")
            in_bits.generate_r1cs_constraints()
            h_in = PBVariable().allocate(pb, f"h_in{i}")
            crh_in = KnapsackCRHFieldOutGadget(
                pb, vk_bits.bits + in_bits.bits, [h_in], 1, f"crh_in{i}")
            crh_in.generate_r1cs_constraints()
            hbits = PBVariableArray().allocate(pb, nbits, f"h_in_bits{i}")
            hpack = PackingGadget(pb, hbits, h_in, f"h_in_pack{i}")
            hpack.generate_r1cs_constraints(True)
            lt_wit = constrain_bits_lt_const(pb, list(hbits), A.r,
                                             f"hlt{i}")
            result = PBVariable().allocate(pb, f"vres{i}")
            soft = Groth16VerifierGadgetSoft(
                pb, B, pvk, [list(hbits)], result, f"sv{i}",
                enforce_bits=False)
            # non-base incoming messages must verify
            pb.add_r1cs_constraint(1 - LC(is_base), 1 - LC(result), 0,
                                   f"must_verify{i}")
            if base_case == "zero":
                # base (padding) slots carry the canonical zero message
                for k, v in enumerate(in_blocks[i]):
                    pb.add_r1cs_constraint(is_base, LC(v), 0,
                                           f"base_zero{i}_{k}")
            else:
                # base slots carry a TYPE-0 message; the predicate must
                # validate base-message contents itself (no proofs of
                # type-0 messages exist: every predicate pins a nonzero
                # outgoing type)
                pb.add_r1cs_constraint(is_base, LC(in_blocks[i][0]), 0,
                                       f"base_type0_{i}")
            per_in.append(dict(is_base=is_base, in_bits=in_bits,
                               h_in=h_in, hbits=hbits, hpack=hpack,
                               lt_wit=lt_wit, result=result, soft=soft,
                               crh_in=crh_in))
        # real slots come first; arity = number of non-base slots
        for i in range(max_arity - 1):
            pb.add_r1cs_constraint(per_in[i]["is_base"],
                                   1 - LC(per_in[i + 1]["is_base"]), 0,
                                   f"base_monotone{i}")
        s = LC(0)
        for d in per_in:
            s = s + LC(d["is_base"])
        pb.add_r1cs_constraint(1, LC(max_arity) - s, arity_var,
                               "arity_link")

        return dict(pb=pb, h_out=h_out, out_block=out_block,
                    arity=arity_var, in_blocks=in_blocks, pred=pred,
                    pg_b=pg_b, g1_b=g1_b, pvk=pvk, vk_bits=vk_bits,
                    out_bits=out_bits, crh_out=crh_out, per_in=per_in,
                    max_arity=max_arity)

    def witness_compliance(self, C, handler, vk_b, incoming_msgs,
                           incoming_proofs, local):
        """Fill the compliance circuit. incoming_proofs[i] is a Groth16
        proof over B (or None => base-case slot)."""
        pb = C["pb"]
        B = self.B
        handler.generate_r1cs_witness(incoming_msgs, local)
        full = (handler.pb.primary_input() + handler.pb.auxiliary_input())
        C["pred"].generate_r1cs_witness(full)
        C["pvk"].set_witness(vk_b, B)
        C["vk_bits"].generate_r1cs_witness()
        C["out_bits"].generate_r1cs_witness()
        C["crh_out"].generate_r1cs_witness()
        dummy = None
        for i, d in enumerate(C["per_in"]):
            proof = (incoming_proofs[i]
                     if i < len(incoming_proofs) else None)
            pb.setval(d["is_base"], 0 if proof is not None else 1)
            d["in_bits"].generate_r1cs_witness()
            d["crh_in"].generate_r1cs_witness()
            d["hpack"].generate_r1cs_witness_from_packed()
            d["lt_wit"]()
            if proof is None:
                if dummy is None:
                    from .groth16 import Groth16Proof
                    dummy = Groth16Proof(g_A=B.G1.one(), g_B=B.G2.one(),
                                         g_C=B.G1.one())
                proof = dummy
            d["soft"].set_proof_witness(proof)
        C["g1_b"].generate_witness()
        C["pg_b"].generate_witness()
        return pb

    # -- translation circuit (C_B over Fr(B)) ------------------------------
    def build_translation_circuit(self, vk_a):
        A, B = self.A, self.B
        nbits = self.nbits
        pb = Protoboard(B.r)
        h_packed = PBVariable().allocate(pb, "h")
        pb.set_input_sizes(1)
        hbits = PBVariableArray().allocate(pb, nbits, "h_bits")
        hpack = PackingGadget(pb, hbits, h_packed, "h_pack")
        hpack.generate_r1cs_constraints(True)
        lt_wit = constrain_bits_lt_const(pb, list(hbits), A.r, "hlt")
        ver = Groth16VerifierGadget(pb, A, vk_a, [list(hbits)], "va")
        return dict(pb=pb, h=h_packed, hbits=hbits, hpack=hpack,
                    lt_wit=lt_wit, ver=ver)

    def witness_translation(self, T, h_value: int, proof_a):
        pb = T["pb"]
        pb.setval(T["h"], h_value)
        T["hpack"].generate_r1cs_witness_from_packed()
        T["lt_wit"]()
        T["ver"].set_proof_witness(proof_a)
        T["ver"].generate_witness()
        return pb

    # -- statement hash ------------------------------------------------------
    def message_hash(self, vk_b, msg: PCDMessage) -> int:
        """h = KnapsackCRH(bits(pvk_B) || bits(type, payload...))."""
        r, nbits = self.A.r, self.nbits
        bits = []
        # curve-B coordinates live in Fq(B) = Fr(A)
        for c in processed_vk_host_coords(vk_b, self.B):
            bits += _int_bits(c % r, nbits)
        for c in [msg.type] + list(msg.payload):
            bits += _int_bits(c % r, nbits)
        return knapsack_crh_field_eval(r, bits, 1)[0]

    # -- generator -----------------------------------------------------------
    def generator(self, handler, seed=None, timings=None):
        """handler: CompliancePredicateHandler with constraints already
        generated. Returns (pk, vk). timings: optional dict that receives
        wall seconds of compliance_build, compliance_keygen,
        translation_build and translation_keygen, and each keygen's own
        phases as compliance.<phase> / translation.<phase>."""
        clock = PhaseClock(timings, self.g16_a.device)
        sub = _Sub(timings)
        handler_cs = handler.get_constraint_system()
        msg_size = len(handler.outgoing)
        assert all(len(b) == msg_size for b in handler.incoming), \
            "incoming/outgoing message shapes must match (chained hash)"
        max_arity = handler.max_arity
        base_case = getattr(handler, "base_case", "zero")
        C = self.compliance_board(handler_cs, max_arity, msg_size,
                                  base_case)
        clock.lap("compliance_build")
        kp_a = self.g16_a.generator(
            C["pb"].get_constraint_system(),
            seed=None if seed is None else seed + 1,
            timings=sub("compliance"))
        clock.lap("compliance_keygen")
        T = self.translation_board(kp_a.vk)
        clock.lap("translation_build")
        kp_b = self.g16_b.generator(
            T["pb"].get_constraint_system(),
            seed=None if seed is None else seed + 2,
            timings=sub("translation"))
        clock.lap("translation_keygen")
        sub.merge()
        pk = CyclePCDProvingKey(kp_a=kp_a, kp_b=kp_b,
                                handler_cs=handler_cs,
                                max_arity=max_arity, msg_size=msg_size,
                                base_case=base_case)
        vk = CyclePCDVerificationKey(vk_b=kp_b.vk, msg_size=msg_size)
        return pk, vk

    # -- prover --------------------------------------------------------------
    def prover(self, pk, handler, incoming: List[CyclePCDProof],
               local: PCDLocalData, seed=None,
               timings=None) -> CyclePCDProof:
        """One PCD step: compliance prove over A, then translation prove
        over B (r1cs_sp_ppzkpcd.tcc:213). `incoming` may be empty
        (base case). timings: optional dict that receives wall seconds of
        compliance_build, compliance_witness, compliance_check (on the
        device R1CS), compliance_prove and the same four of translation,
        and each prove's own phases as compliance.<phase> /
        translation.<phase>."""
        clock = PhaseClock(timings, self.g16_a.device)
        sub = _Sub(timings)
        msgs = [p.msg for p in incoming]
        proofs = [p.translation_proof for p in incoming]
        C = self.compliance_board(pk.handler_cs, pk.max_arity, pk.msg_size,
                                  pk.base_case)
        clock.lap("compliance_build")
        self.witness_compliance(C, handler, pk.kp_b.vk, msgs, proofs,
                                local)
        clock.lap("compliance_witness")
        bad = self.g16_a.first_unsatisfied(pk.kp_a.pk.r1cs_dev, C["pb"])
        assert bad is None, f"compliance circuit unsatisfied: {bad}"
        clock.lap("compliance_check")
        primary = C["pb"].primary_input()
        proof_a = self.g16_a.prover(pk.kp_a.pk, primary,
                                    C["pb"].auxiliary_input(), seed=seed,
                                    timings=sub("compliance"))
        clock.lap("compliance_prove")
        msg_out = PCDMessage(
            type=C["pb"].val(C["out_block"][0]),
            payload=[C["pb"].val(v) for v in C["out_block"][1:]])
        h_out = primary[0]
        T = self.translation_board(pk.kp_a.vk)
        clock.lap("translation_build")
        self.witness_translation(T, h_out, proof_a)
        clock.lap("translation_witness")
        bad = self.g16_b.first_unsatisfied(pk.kp_b.pk.r1cs_dev, T["pb"])
        assert bad is None, f"translation circuit unsatisfied: {bad}"
        clock.lap("translation_check")
        proof_b = self.g16_b.prover(
            pk.kp_b.pk, T["pb"].primary_input(),
            T["pb"].auxiliary_input(),
            seed=None if seed is None else seed + 7,
            timings=sub("translation"))
        clock.lap("translation_prove")
        sub.merge()
        return CyclePCDProof(msg=msg_out, translation_proof=proof_b)

    # -- verifier ------------------------------------------------------------
    def verifier(self, vk: CyclePCDVerificationKey, msg: PCDMessage,
                 proof: CyclePCDProof) -> bool:
        """One pairing-equation check over B (tcc:271)."""
        h = self.message_hash(vk.vk_b, msg)
        return self.g16_b.verifier_strong_IC(vk.vk_b, [h],
                                             proof.translation_proof)
