"""Unbounded multi-predicate PCD over the MNT cycle — the reference's
r1cs_mp_ppzkpcd (CTV15 "Cluster Computing in Zero Knowledge") re-built
on the CycleSpPCD substrate (reference r1cs_mp_ppzkpcd.tcc:246,401;
circuits mp_pcd_circuits.hpp:99-106).

What changes vs the single-predicate system (pcd_cycle.py):

  * MANY compliance predicates, each with its own compliance circuit
    over curve A and translation circuit over curve B (per-predicate
    Groth16 keypairs on both sides).
  * The statement no longer binds ONE translation vk; it binds the
    knapsack-Merkle SET COMMITMENT of all translation pvks:
        h = CRH(bits(set_root) || bits(msg)).
    Inside each compliance circuit every incoming slot witnesses its
    own PROCESSED translation vk, proves its membership in the
    committed set (leaf = CRH(bits(pvk)), check-read against the
    witnessed root), and soft-verifies the incoming translation proof
    under it. The root itself is hash-authenticated through h — the
    same circularity break as sp (circuits are generated before any
    vk exists).
  * A proof names the predicate that produced it
    (r1cs_mp_ppzkpcd_proof: compliance_predicate_idx + B-proof); the
    verifier checks ONE pairing equation under that predicate's
    translation vk.

Base-case slots witness predicate 0's (real, committed) vk and a dummy
proof: membership is enforced UNconditionally, only proof validity is
gated by is_base — simpler than conditional membership and equally
sound (a base slot claims nothing).

The port of libsnark_tpu/proof_systems/mp_pcd_cycle.py. Both Groth16
systems run on ``device`` ("cuda" unless the caller asks for the CPU); as
in CycleSpPCD the generator's boards are re-witnessed by the prover and
each board is checked on its proving key's device R1CS. generator and
prover take an optional ``timings`` dict.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .base import PhaseClock
from .compliance_predicate import PCDMessage, PCDLocalData
from .pcd_cycle import (_BitsOfCoords, _int_bits, _Sub,
                        constrain_bits_lt_const)
from ..gadgets.protoboard import Protoboard, PBVariable, PBVariableArray
from ..gadgets.basic import PackingGadget, generate_boolean_r1cs_constraint
from ..gadgets.gadget_from_r1cs import GadgetFromR1CS
from ..gadgets.hashes.knapsack import (
    KnapsackCRHFieldOutGadget, KnapsackCRHBitOutGadget,
    KnapsackTwoToOneHashGadget, knapsack_crh_field_eval,
    knapsack_crh_bit_eval)
from ..gadgets.hashes.sha256_gadget import DigestVariable
from ..gadgets.merkle_tree_gadgets import (
    MerkleAuthenticationPathVariable, MerkleTreeCheckReadGadget)
from ..gadgets.pairing_gadgets import G1Gadgets
from ..gadgets.mnt_pairing_gadgets import make_pairing_gadgets
from ..gadgets.verifier_gadgets import (
    Groth16ProcessedVKVariable, Groth16VerifierGadgetSoft,
    processed_vk_host_coords)
from ..common.set_commitment import SetCommitmentAccumulator
from ..relations.variable import LinearCombination as LC


@dataclasses.dataclass
class CycleMpPCDProvingKey:
    """r1cs_mp_ppzkpcd_proving_key: per-predicate keypairs on both
    curves + the translation-vk set commitment and membership proofs."""
    kp_a: list
    kp_b: list
    handler_cs: list
    arities: List[int]
    base_cases: List[str]
    msg_size: int
    depth: int
    set_root: List[int]          # digest bits of the vk commitment
    memberships: list            # SetMembershipProof per predicate


@dataclasses.dataclass
class CycleMpPCDVerificationKey:
    vk_b: list
    set_root: List[int]
    msg_size: int


@dataclasses.dataclass
class CycleMpPCDProof:
    """(predicate index, message, translation proof) — constant size at
    any depth (r1cs_mp_ppzkpcd_proof: compliance_predicate_idx +
    r1cs_proof over curve B)."""
    predicate_idx: int
    msg: PCDMessage
    translation_proof: object


class CycleMpPCD:
    """Generator / prover / verifier for multi-predicate PCD over the
    MNT cycle."""

    def __init__(self, curve_a=None, curve_b=None, device="cuda"):
        from ..curves import get_curve
        self.A = curve_a or get_curve("mnt4")
        self.B = curve_b or get_curve("mnt6")
        assert self.A.q == self.B.r and self.A.r == self.B.q, \
            "curves must form a 2-cycle"
        from .groth16 import Groth16
        from .pcd_cycle import CycleSpPCD
        self.g16_a = Groth16(self.A, device=device)
        self.g16_b = Groth16(self.B, device=device)
        self.nbits = self.A.r.bit_length()
        self.ds = self.nbits                 # knapsack digest bits
        # the translation circuits and their boards (CycleSpPCD's), and
        # the generator's compliance boards, re-witnessed by the prover
        self.sp = CycleSpPCD(self.A, self.B, device=device)
        self.sp.g16_a, self.sp.g16_b = self.g16_a, self.g16_b
        self._boards = {}

    def compliance_board(self, handler_cs, max_arity: int, msg_size: int,
                         depth: int, base_case: str = "zero"):
        """build_compliance_circuit's board for this shape, built once."""
        key = (id(handler_cs), max_arity, msg_size, depth, base_case)
        if key not in self._boards:
            self._boards[key] = (handler_cs, self.build_compliance_circuit(
                handler_cs, max_arity, msg_size, depth, base_case))
        return self._boards[key][1]

    # -- host-side vk set ---------------------------------------------------
    def _pvk_bits(self, vk_b) -> List[int]:
        r, nbits = self.A.r, self.nbits
        bits = []
        for c in processed_vk_host_coords(vk_b, self.B):
            bits += _int_bits(c % r, nbits)
        return bits

    def build_accumulator(self, max_vks: int) -> SetCommitmentAccumulator:
        p = self.A.r
        return SetCommitmentAccumulator(
            max_vks, 0,
            hash_fn=lambda bits: knapsack_crh_bit_eval(p, bits, 1),
            two_to_one_fn=KnapsackTwoToOneHashGadget.hash_fn(p),
            digest_size=self.ds)

    # -- statement hash -----------------------------------------------------
    def message_hash(self, set_root: List[int], msg: PCDMessage) -> int:
        """h = CRH(bits(set_root) || bits(type, payload...))."""
        r, nbits = self.A.r, self.nbits
        bits = list(set_root)
        for c in [msg.type] + list(msg.payload):
            bits += _int_bits(c % r, nbits)
        return knapsack_crh_field_eval(r, bits, 1)[0]

    # -- compliance circuit (per predicate, over Fr(A)) --------------------
    def build_compliance_circuit(self, handler_cs, max_arity: int,
                                 msg_size: int, depth: int,
                                 base_case: str = "zero"):
        """Deterministic construction; independent of every vk (the set
        root rides as hash-authenticated witness)."""
        assert base_case in ("zero", "type0")
        A, B = self.A, self.B
        nbits, ds = self.nbits, self.ds
        pb = Protoboard(A.r)
        h_out = PBVariable().allocate(pb, "h_out")
        pb.set_input_sizes(1)

        root = DigestVariable(pb, ds, "vkroot")
        root.generate_r1cs_constraints()

        out_block = PBVariableArray().allocate(pb, msg_size, "msg_out")
        arity_var = PBVariable().allocate(pb, "arity")
        in_blocks = [PBVariableArray().allocate(pb, msg_size, f"msg_in{i}")
                     for i in range(max_arity)]
        pred = GadgetFromR1CS(
            pb, [list(out_block), [arity_var]] +
            [list(b) for b in in_blocks], handler_cs, "pred")
        pred.generate_r1cs_constraints()

        pg_b = make_pairing_gadgets(pb, B, "pairB")
        g1_b = G1Gadgets(pb, "g1B", a=int(getattr(B, "a", 0)))

        out_bits = _BitsOfCoords(pb, [LC(v) for v in out_block], nbits,
                                 "outb")
        out_bits.generate_r1cs_constraints()
        crh_out = KnapsackCRHFieldOutGadget(
            pb, list(root.bits) + out_bits.bits, [h_out], 1, "crh_out")
        crh_out.generate_r1cs_constraints()

        per_in = []
        for i in range(max_arity):
            is_base = PBVariable().allocate(pb, f"is_base{i}")
            generate_boolean_r1cs_constraint(pb, is_base, f"isb{i}")
            # this slot's own processed translation vk (witness)
            pvk = Groth16ProcessedVKVariable(pb, pg_b, g1_b,
                                             num_inputs=1,
                                             prefix=f"pvk{i}")
            vk_bits = _BitsOfCoords(pb, pvk.coordinate_lcs(), nbits,
                                    f"vkb{i}")
            vk_bits.generate_r1cs_constraints()
            # membership: leaf = CRH(bits(pvk)); check-read vs root
            leaf = DigestVariable(pb, ds, f"leaf{i}")
            leaf_hash = KnapsackCRHBitOutGadget(
                pb, vk_bits.bits, list(leaf.bits), 1, f"lh{i}")
            leaf_hash.generate_r1cs_constraints()
            addr = PBVariableArray().allocate(pb, depth, f"addr{i}")
            for bvar in addr:
                generate_boolean_r1cs_constraint(pb, bvar, f"addrb{i}")
            path = MerkleAuthenticationPathVariable(
                pb, depth, f"path{i}", digest_size=ds)
            path.generate_r1cs_constraints()
            memb = MerkleTreeCheckReadGadget(
                pb, depth, list(addr), leaf, root, path, LC(1),
                f"memb{i}", hash_gadget_cls=KnapsackTwoToOneHashGadget)
            memb.generate_r1cs_constraints()
            # incoming statement under the SAME root
            in_bits = _BitsOfCoords(pb, [LC(v) for v in in_blocks[i]],
                                    nbits, f"inb{i}")
            in_bits.generate_r1cs_constraints()
            h_in = PBVariable().allocate(pb, f"h_in{i}")
            crh_in = KnapsackCRHFieldOutGadget(
                pb, list(root.bits) + in_bits.bits, [h_in], 1,
                f"crh_in{i}")
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
            pb.add_r1cs_constraint(1 - LC(is_base), 1 - LC(result), 0,
                                   f"must_verify{i}")
            if base_case == "zero":
                for k, v in enumerate(in_blocks[i]):
                    pb.add_r1cs_constraint(is_base, LC(v), 0,
                                           f"base_zero{i}_{k}")
            else:
                pb.add_r1cs_constraint(is_base, LC(in_blocks[i][0]), 0,
                                       f"base_type0_{i}")
            per_in.append(dict(is_base=is_base, pvk=pvk, vk_bits=vk_bits,
                               leaf=leaf, leaf_hash=leaf_hash, addr=addr,
                               path=path, memb=memb, in_bits=in_bits,
                               h_in=h_in, hbits=hbits, hpack=hpack,
                               lt_wit=lt_wit, result=result, soft=soft,
                               crh_in=crh_in))
        for i in range(max_arity - 1):
            pb.add_r1cs_constraint(per_in[i]["is_base"],
                                   1 - LC(per_in[i + 1]["is_base"]), 0,
                                   f"base_monotone{i}")
        s = LC(0)
        for d in per_in:
            s = s + LC(d["is_base"])
        pb.add_r1cs_constraint(1, LC(max_arity) - s, arity_var,
                               "arity_link")

        return dict(pb=pb, h_out=h_out, root=root, out_block=out_block,
                    arity=arity_var, in_blocks=in_blocks, pred=pred,
                    pg_b=pg_b, g1_b=g1_b, out_bits=out_bits,
                    crh_out=crh_out, per_in=per_in, max_arity=max_arity,
                    depth=depth)

    def witness_compliance(self, C, handler, set_root: List[int],
                           incoming_msgs, slot_entries, local):
        """slot_entries[i] is (vk_b, membership, proof_or_None); base
        slots (proof None) still carry a real committed vk +
        membership."""
        pb = C["pb"]
        B = self.B
        handler.generate_r1cs_witness(incoming_msgs, local)
        full = (handler.pb.primary_input() + handler.pb.auxiliary_input())
        C["pred"].generate_r1cs_witness(full)
        C["root"].generate_r1cs_witness(list(set_root))
        C["out_bits"].generate_r1cs_witness()
        C["crh_out"].generate_r1cs_witness()
        dummy = None
        for i, d in enumerate(C["per_in"]):
            vk_b, memb, proof = slot_entries[i]
            pb.setval(d["is_base"], 0 if proof is not None else 1)
            d["pvk"].set_witness(vk_b, B)
            d["vk_bits"].generate_r1cs_witness()
            d["leaf_hash"].generate_r1cs_witness()
            d["addr"].fill_with_bits_of_int(pb, memb.address)
            d["path"].generate_r1cs_witness(memb.address,
                                            memb.merkle_path)
            d["memb"].generate_r1cs_witness()
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
        # check-read recomputes into the root digest; re-pin
        C["root"].generate_r1cs_witness(list(set_root))
        C["g1_b"].generate_witness()
        C["pg_b"].generate_witness()
        return pb

    # -- generator -----------------------------------------------------------
    def generator(self, handlers: list, seed=None, timings=None):
        """handlers: CompliancePredicateHandler-likes with constraints
        already generated (r1cs_mp_ppzkpcd_generator, tcc:246). Returns
        (pk, vk). timings: optional dict that receives wall seconds of
        compliance_build, compliance_keygen, translation_build and
        translation_keygen (each summed over the predicates), and the
        keygens' own phases as compliance{idx}.<phase> /
        translation{idx}.<phase>."""
        assert handlers
        lap = {}
        clock = PhaseClock(None if timings is None else lap,
                           self.g16_a.device)
        spent = {}
        sub = _Sub(timings)

        def add(name):
            clock.lap(name)
            if timings is not None:
                spent[name] = spent.get(name, 0.0) + lap[name]

        msg_size = len(handlers[0].outgoing)
        assert all(len(h.outgoing) == msg_size for h in handlers), \
            "all predicates must share the message shape"
        depth = max(1, (len(handlers) - 1).bit_length())
        handler_cs, arities, base_cases, kp_a = [], [], [], []
        sp = self.sp
        for idx, h in enumerate(handlers):
            cs = h.get_constraint_system()
            bc = getattr(h, "base_case", "zero")
            C = self.compliance_board(cs, h.max_arity, msg_size, depth, bc)
            add("compliance_build")
            kp = self.g16_a.generator(
                C["pb"].get_constraint_system(),
                seed=None if seed is None else seed + 10 + idx,
                timings=sub(f"compliance{idx}"))
            add("compliance_keygen")
            handler_cs.append(cs)
            arities.append(h.max_arity)
            base_cases.append(bc)
            kp_a.append(kp)
        kp_b = []
        for idx, kp in enumerate(kp_a):
            T = sp.translation_board(kp.vk)
            add("translation_build")
            kp_b.append(self.g16_b.generator(
                T["pb"].get_constraint_system(),
                seed=None if seed is None else seed + 100 + idx,
                timings=sub(f"translation{idx}")))
            add("translation_keygen")
        if timings is not None:
            timings.update(spent)
        sub.merge()
        acc = self.build_accumulator(1 << depth)
        for kp in kp_b:
            acc.add(self._pvk_bits(kp.vk))
        set_root = acc.get_commitment()
        memberships = [acc.get_membership_proof(self._pvk_bits(kp.vk))
                       for kp in kp_b]
        pk = CycleMpPCDProvingKey(
            kp_a=kp_a, kp_b=kp_b, handler_cs=handler_cs,
            arities=arities, base_cases=base_cases, msg_size=msg_size,
            depth=depth, set_root=set_root, memberships=memberships)
        vk = CycleMpPCDVerificationKey(
            vk_b=[kp.vk for kp in kp_b], set_root=set_root,
            msg_size=msg_size)
        return pk, vk

    # -- prover --------------------------------------------------------------
    def prover(self, pk: CycleMpPCDProvingKey, predicate_idx: int,
               handler, incoming: List[CycleMpPCDProof],
               local: PCDLocalData, seed=None,
               timings=None) -> CycleMpPCDProof:
        """One PCD step under the named predicate; incoming proofs may
        come from ANY committed predicate (tcc:401). timings: optional dict
        that receives the phases of CycleSpPCD.prover (compliance_* and
        translation_*, the checks on the device R1CS) and each prove's own
        as compliance.<phase> / translation.<phase>."""
        clock = PhaseClock(timings, self.g16_a.device)
        sub = _Sub(timings)
        idx = predicate_idx
        C = self.compliance_board(
            pk.handler_cs[idx], pk.arities[idx], pk.msg_size, pk.depth,
            pk.base_cases[idx])
        clock.lap("compliance_build")
        msgs = [p.msg for p in incoming]
        entries = []
        for i in range(pk.arities[idx]):
            if i < len(incoming):
                src = incoming[i].predicate_idx
                entries.append((pk.kp_b[src].vk, pk.memberships[src],
                                incoming[i].translation_proof))
            else:
                entries.append((pk.kp_b[0].vk, pk.memberships[0], None))
        self.witness_compliance(C, handler, pk.set_root, msgs, entries,
                                local)
        clock.lap("compliance_witness")
        bad = self.g16_a.first_unsatisfied(pk.kp_a[idx].pk.r1cs_dev,
                                           C["pb"])
        assert bad is None, f"mp compliance circuit unsatisfied: {bad}"
        clock.lap("compliance_check")
        primary = C["pb"].primary_input()
        proof_a = self.g16_a.prover(pk.kp_a[idx].pk, primary,
                                    C["pb"].auxiliary_input(), seed=seed,
                                    timings=sub("compliance"))
        clock.lap("compliance_prove")
        msg_out = PCDMessage(
            type=C["pb"].val(C["out_block"][0]),
            payload=[C["pb"].val(v) for v in C["out_block"][1:]])
        sp = self.sp
        T = sp.translation_board(pk.kp_a[idx].vk)
        clock.lap("translation_build")
        sp.witness_translation(T, primary[0], proof_a)
        clock.lap("translation_witness")
        bad = self.g16_b.first_unsatisfied(pk.kp_b[idx].pk.r1cs_dev,
                                           T["pb"])
        assert bad is None, f"translation circuit unsatisfied: {bad}"
        clock.lap("translation_check")
        proof_b = self.g16_b.prover(
            pk.kp_b[idx].pk, T["pb"].primary_input(),
            T["pb"].auxiliary_input(),
            seed=None if seed is None else seed + 7,
            timings=sub("translation"))
        clock.lap("translation_prove")
        sub.merge()
        return CycleMpPCDProof(predicate_idx=idx, msg=msg_out,
                               translation_proof=proof_b)

    # -- verifier ------------------------------------------------------------
    def verifier(self, vk: CycleMpPCDVerificationKey, msg: PCDMessage,
                 proof: CycleMpPCDProof) -> bool:
        """ONE pairing check under the named predicate's translation vk
        (r1cs_mp_ppzkpcd_verifier)."""
        if not (0 <= proof.predicate_idx < len(vk.vk_b)):
            return False
        h = self.message_hash(vk.set_root, msg)
        return self.g16_b.verifier_strong_IC(
            vk.vk_b[proof.predicate_idx], [h], proof.translation_proof)
