"""Multi-predicate PCD over the one-layer BLS12-377 -> BW6-761 chain.

The reference's r1cs_mp_ppzkpcd (r1cs_mp_ppzkpcd.tcc:246,401) extends
sp-PCD to MANY compliance predicates: the proving side commits to the
SET of accepted inner verification keys, and the aggregation circuit
takes each step's vk as WITNESS, verifying (a) the step proof under
that vk with a variable-vk verifier gadget and (b) the vk's membership
in the committed set (mp_pcd_circuits.hpp:99-106). Only the set
commitment is public, so one aggregation key covers any predicate mix.

This module instantiates that pattern on the bounded one-layer chain
(the MNT-cycle scoping note in pcd.py applies):

  * one inner Groth16 keypair (BLS12-377) per compliance predicate,
  * vk set committed by a knapsack-CRH Merkle accumulator (digest =
    |Fr(BW6)| bits -- the same hash family ram_zksnark delegates memory
    with, so everything is native in the outer field),
  * outer circuit slots: Groth16VerifierGadgetVariableVK + full
    vk-coordinate bit decomposition + knapsack leaf hash + Merkle
    check-read against the PUBLIC set root,
  * outer proof: Groth16 over BW6-761 (same machinery as SpPCD).

All predicates must share the statement arity (the reference binds
message types through its own format; homogeneous arity is the bounded
variant's simplification, documented here).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..gadgets.protoboard import Protoboard, PBVariable, PBVariableArray
from ..gadgets.basic import PackingGadget
from ..gadgets.pairing_gadgets import PairingGadgets, G1Gadgets
from ..gadgets.mnt_pairing_gadgets import make_pairing_gadgets
from ..gadgets.verifier_gadgets import (
    Groth16VerificationKeyVariable, Groth16VerifierGadgetVariableVK)
from ..gadgets.merkle_tree_gadgets import (
    MerkleAuthenticationPathVariable, MerkleTreeCheckReadGadget)
from ..gadgets.hashes.sha256_gadget import DigestVariable
from ..gadgets.hashes.knapsack import (
    KnapsackCRHBitOutGadget, KnapsackTwoToOneHashGadget,
    knapsack_crh_bit_eval)
from ..common.set_commitment import SetCommitmentAccumulator
from ..relations.variable import LinearCombination


def vk_coordinate_ints(vk, g2_degree: int = 2) -> List[int]:
    """Canonical coordinate list (must match
    Groth16VerificationKeyVariable.coordinate_lcs order);
    degree-generic G2 coordinates (Fp2 or the MNT6 Fp3)."""
    def ext(c):
        if g2_degree == 2:
            return [int(c.c0), int(c.c1)]
        return [int(c.c0), int(c.c1), int(c.c2)]

    out = [int(vk.alpha_g1.x), int(vk.alpha_g1.y)]
    for pt in (vk.beta_g2, vk.gamma_g2, vk.delta_g2):
        out += ext(pt.x) + ext(pt.y)
    for pt in vk.gamma_ABC:
        out += [int(pt.x), int(pt.y)]
    return out


def vk_bits(vk, nbits: int, g2_degree: int = 2) -> List[int]:
    bits = []
    for v in vk_coordinate_ints(vk, g2_degree):
        bits += [(v >> i) & 1 for i in range(nbits)]
    return bits


@dataclasses.dataclass
class MpPCDProvingKey:
    inner_keypairs: Dict[str, object]     # name -> Groth16Keypair
    outer_keypair: object
    vk_root: list                          # committed set root bits
    accumulator: object                    # host-side accumulator
    num_proofs: int
    num_inputs: int
    num_input_bits: int


@dataclasses.dataclass
class MpPCDVerificationKey:
    outer_vk: object
    vk_root: list
    num_proofs: int
    num_inputs: int
    num_input_bits: int


@dataclasses.dataclass
class MpPCDProof:
    outer_proof: object


class MpPCD:
    """r1cs_mp_ppzkpcd re-designed for the one-layer chain."""

    def __init__(self, inner_curve, outer_curve, device="cuda"):
        assert outer_curve.r == inner_curve.q
        self.inner = inner_curve
        self.outer = outer_curve
        from .groth16 import Groth16
        self.g16_inner = Groth16(inner_curve, device=device)
        self.g16_outer = Groth16(outer_curve, device=device)
        self.digest_bits = outer_curve.r.bit_length()
        self.coord_bits = outer_curve.r.bit_length()
        self._g2_deg = getattr(inner_curve, "g2_field_degree", 2)

    # -- generator ----------------------------------------------------------
    def generator(self, handlers: Dict[str, object], num_proofs: int,
                  max_vks: int = 8, seed=None, host_keygen=False):
        """handlers: name -> CompliancePredicateHandler (constraints
        generated, primary input = the statement; all must share the
        statement arity)."""
        self.g16_inner.host_keygen = host_keygen
        self.g16_outer.host_keygen = host_keygen
        inner_keypairs = {}
        arities = set()
        for i, (name, h) in enumerate(sorted(handlers.items())):
            cs = h.pb.get_constraint_system()
            arities.add(cs.primary_input_size)
            inner_keypairs[name] = self.g16_inner.generator(
                cs, seed=None if seed is None else seed + 10 + i)
        assert len(arities) == 1, \
            "bounded mp-PCD requires homogeneous statement arity"
        n_inputs = arities.pop()
        nbits = self.inner.r.bit_length()

        acc = self._accumulator(max_vks)
        for name in sorted(inner_keypairs):
            acc.add(vk_bits(inner_keypairs[name].vk, self.coord_bits,
                            self._g2_deg))
        root = acc.get_commitment()

        pb, _ = self._build_outer(num_proofs, n_inputs, nbits, max_vks)
        okp = self.g16_outer.generator(
            pb.get_constraint_system(),
            seed=None if seed is None else seed + 1)
        pk = MpPCDProvingKey(
            inner_keypairs=inner_keypairs, outer_keypair=okp,
            vk_root=root, accumulator=acc, num_proofs=num_proofs,
            num_inputs=n_inputs, num_input_bits=nbits)
        vk = MpPCDVerificationKey(
            outer_vk=okp.vk, vk_root=root, num_proofs=num_proofs,
            num_inputs=n_inputs, num_input_bits=nbits)
        return pk, vk

    def _accumulator(self, max_vks: int):
        p = self.outer.r
        return SetCommitmentAccumulator(
            max_vks, 0,
            hash_fn=lambda bits: knapsack_crh_bit_eval(p, bits, 1),
            two_to_one_fn=KnapsackTwoToOneHashGadget.hash_fn(p),
            digest_size=self.digest_bits)

    # -- outer circuit ------------------------------------------------------
    def _build_outer(self, num_proofs, n_inputs, nbits, max_vks):
        """Deterministic aggregation circuit. Primary input layout:
        [set-root bits | per-slot statement bits]."""
        pb = Protoboard(self.outer.r)
        root = DigestVariable(pb, self.digest_bits, "vkroot")
        stmt_bits = []
        for i in range(num_proofs):
            per = [PBVariableArray().allocate(pb, nbits, f"st_{i}_{j}")
                   for j in range(n_inputs)]
            stmt_bits.append(per)
        pb.set_input_sizes(self.digest_bits
                           + num_proofs * n_inputs * nbits)

        depth = max(1, (max_vks - 1).bit_length())
        slots = []
        for i in range(num_proofs):
            pg = make_pairing_gadgets(pb, self.inner, f"pair{i}")
            g1 = G1Gadgets(pb, f"g1_{i}",
                           a=int(getattr(self.inner, "a", 0)))
            vk_var = Groth16VerificationKeyVariable(
                pb, pg, g1, n_inputs, f"vk{i}")
            verifier = Groth16VerifierGadgetVariableVK(
                pb, self.inner, vk_var,
                [list(b) for b in stmt_bits[i]], f"v{i}")
            # full vk-coordinate bit decomposition (binds the witness vk
            # to the committed leaf -- reference binds all vk bits too)
            coord_lcs = vk_var.coordinate_lcs()
            packs = []
            all_bits = []
            for ci, lc in enumerate(coord_lcs):
                cb = PBVariableArray().allocate(
                    pb, self.coord_bits, f"vkb{i}_{ci}")
                helper = PBVariable().allocate(pb, f"vkp{i}_{ci}")
                pg_c = PackingGadget(pb, cb, helper, f"vkpk{i}_{ci}")
                pg_c.generate_r1cs_constraints(True)
                pb.add_r1cs_constraint(1, lc - helper, 0,
                                       f"vkbind{i}_{ci}")
                packs.append((pg_c, lc, helper))
                all_bits += list(cb)
            leaf = DigestVariable(pb, self.digest_bits, f"leaf{i}")
            hash_g = KnapsackCRHBitOutGadget(
                pb, all_bits, list(leaf.bits), 1, f"vkhash{i}")
            hash_g.generate_r1cs_constraints()
            addr = PBVariableArray().allocate(pb, depth, f"addr{i}")
            path = MerkleAuthenticationPathVariable(
                pb, depth, f"path{i}", digest_size=self.digest_bits)
            memb = MerkleTreeCheckReadGadget(
                pb, depth, list(addr), leaf, root, path,
                LinearCombination(1), f"memb{i}",
                hash_gadget_cls=KnapsackTwoToOneHashGadget)
            path.generate_r1cs_constraints()
            memb.generate_r1cs_constraints()
            slots.append({"vk_var": vk_var, "verifier": verifier,
                          "packs": packs, "hash": hash_g, "addr": addr,
                          "path": path, "memb": memb, "leaf": leaf})
        return pb, {"root": root, "stmt_bits": stmt_bits, "slots": slots,
                    "depth": depth}

    # -- prover -------------------------------------------------------------
    def prover(self, pk: MpPCDProvingKey, steps, seed=None):
        """steps: list of (predicate_name, statement_list, inner_proof).
        Returns MpPCDProof (ONE outer Groth16 proof)."""
        assert len(steps) == pk.num_proofs
        pb, h = self._build_outer(pk.num_proofs, pk.num_inputs,
                                  pk.num_input_bits,
                                  1 << h_depth_of(pk))
        # fill public inputs
        h["root"].generate_r1cs_witness(pk.vk_root)
        for i, (name, stmt, proof) in enumerate(steps):
            for j, xval in enumerate(stmt):
                h["stmt_bits"][i][j].fill_with_bits_of_int(
                    pb, xval % self.inner.r)
        # fill slots
        for i, (name, stmt, proof) in enumerate(steps):
            slot = h["slots"][i]
            vk = pk.inner_keypairs[name].vk
            slot["vk_var"].set_witness(vk)
            slot["verifier"].set_proof_witness(proof)
            slot["verifier"].generate_witness()
            for pg_c, lc, helper in slot["packs"]:
                v = pb.lc_val(lc)
                pb.setval(helper, v)
                pg_c.generate_r1cs_witness_from_packed()
            slot["hash"].generate_r1cs_witness()
            memb = pk.accumulator.get_membership_proof(
                vk_bits(vk, self.coord_bits, self._g2_deg))
            slot["addr"].fill_with_bits_of_int(pb, memb.address)
            slot["path"].generate_r1cs_witness(memb.address,
                                               memb.merkle_path)
            slot["memb"].generate_r1cs_witness()
        # re-pin the public root (check-read recomputes into the digest)
        h["root"].generate_r1cs_witness(pk.vk_root)
        bad = self.g16_outer.first_unsatisfied(
            pk.outer_keypair.pk.r1cs_dev, pb)
        assert bad is None, f"mp aggregation unsatisfied: {bad}"
        outer_proof = self.g16_outer.prover(
            pk.outer_keypair.pk, pb.primary_input(),
            pb.auxiliary_input(), seed=seed)
        return MpPCDProof(outer_proof=outer_proof)

    # -- verifier -----------------------------------------------------------
    def verifier(self, vk: MpPCDVerificationKey,
                 statements: List[List[int]], proof: MpPCDProof) -> bool:
        primary = list(vk.vk_root)
        for stmt in statements:
            for xval in stmt:
                v = xval % self.inner.r
                primary += [(v >> b) & 1
                            for b in range(vk.num_input_bits)]
        return self.g16_outer.verifier_strong_IC(
            vk.outer_vk, primary, proof.outer_proof)


def h_depth_of(pk: MpPCDProvingKey) -> int:
    return pk.accumulator.depth
