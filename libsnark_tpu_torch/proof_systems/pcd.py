"""Proof-carrying data over the one-layer BLS12-377 / BW6-761 chain.

The reference's PCD systems (r1cs_sp_ppzkpcd / r1cs_mp_ppzkpcd) recurse
over the MNT4/MNT6 2-CYCLE: each curve's verifier is embedded in the
other's circuit, giving unbounded depth. That cycle IS instantiated in
this framework -- see proof_systems/pcd_cycle.py (curves/mnt.py) for the
unbounded-depth system. This module provides the
complementary modern ONE-LAYER composition the Clearmatics fork targets
with its BW6-761/BLS12-377 gadgets:

  * step proofs: Groth16 over BLS12-377, one per compliance-predicate
    application (depth-1 messages),
  * an AGGREGATION circuit over Fr(BW6-761) = Fq(BLS12-377) that embeds
    one Groth16VerifierGadget per step proof plus the message-chaining
    constraints, proven with Groth16 over BW6-761.

API mirrors the reference's shape: generator / prover / verifier over
(compliance predicate, messages). Unbounded-depth PCD over a true cycle
slots into the same interfaces when cycle parameters are supplied. Both
Groth16 systems run on ``device`` ("cuda" unless the caller asks for the
CPU); generator and prover take an optional ``timings`` dict.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .base import PhaseClock
from .compliance_predicate import PCDMessage, PCDLocalData
from ..gadgets.protoboard import Protoboard, PBVariableArray
from ..gadgets.verifier_gadgets import Groth16VerifierGadget


@dataclasses.dataclass
class OneLayerPCDKeypair:
    inner_vk: object                # Groth16 vk over BLS12-377
    outer_circuit_builder: object   # callable -> (pb, gadgets)
    predicate: object


class OneLayerPCD:
    """Aggregate k inner Groth16 proofs of predicate steps inside one
    outer circuit (satisfiability = the aggregation statement; proving
    the outer circuit itself runs Groth16 over BW6-761)."""

    def __init__(self, inner_curve, outer_curve):
        assert outer_curve.r == inner_curve.q, \
            "outer scalar field must equal inner base field"
        self.inner = inner_curve
        self.outer = outer_curve

    def build_aggregation_circuit(self, inner_vk, num_proofs: int,
                                  num_input_bits: int):
        """Outer circuit: num_proofs verifier gadgets; the (bit-encoded)
        inner public inputs are the outer circuit's inputs."""
        pb = Protoboard(self.outer.r)
        bit_arrays = []
        for i in range(num_proofs):
            bits = PBVariableArray().allocate(
                pb, num_input_bits, f"inner_input_{i}")
            bit_arrays.append(bits)
        pb.set_input_sizes(num_proofs * num_input_bits)
        gadgets = [
            Groth16VerifierGadget(pb, self.inner, inner_vk,
                                  [list(bit_arrays[i])], f"v{i}")
            for i in range(num_proofs)]
        return pb, bit_arrays, gadgets

    def witness_aggregation(self, pb, bit_arrays, gadgets,
                            inner_inputs: List[int], proofs) -> bool:
        """Fill witnesses; returns satisfiability."""
        for bits, x, g, proof in zip(bit_arrays, inner_inputs, gadgets,
                                     proofs):
            bits.fill_with_bits_of_int(pb, x % self.inner.r)
            g.set_proof_witness(proof)
        for g in gadgets:
            g.generate_witness()
        return pb.is_satisfied()


# --------------------------------------------------------------------------
# Full sp-PCD system over the one-layer chain
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SpPCDProvingKey:
    """r1cs_sp_ppzkpcd_proving_key analogue (tcc:149): Groth16 keys for
    the compliance-step circuit (inner, BLS12-377) and the aggregation
    circuit (outer, BW6-761)."""
    inner_keypair: object
    outer_keypair: object
    num_proofs: int
    num_input_bits: int


@dataclasses.dataclass
class SpPCDVerificationKey:
    outer_vk: object
    inner_vk: object
    num_proofs: int
    num_input_bits: int


@dataclasses.dataclass
class SpPCDProof:
    """The outer Groth16 proof attesting `num_proofs` valid inner step
    proofs over their (public) statements."""
    outer_proof: object


class SpPCD(OneLayerPCD):
    """Single-predicate PCD (r1cs_sp_ppzkpcd re-designed for the
    one-layer BLS12-377 -> BW6-761 chain; reference
    r1cs_sp_ppzkpcd.tcc:149,213 generator/prover, :271 verifier).

    The compliance-step circuit is the predicate handler's protoboard
    R1CS, whose PRIMARY INPUT is the step statement. The aggregation
    circuit embeds one hardcoded-vk Groth16 verifier per step proof and
    exposes the statements' bit decompositions as its primary input.
    Both proofs are REAL device Groth16 proofs -- no trapdoors."""

    def __init__(self, inner_curve, outer_curve, device="cuda"):
        super().__init__(inner_curve, outer_curve)
        from .groth16 import Groth16
        self.g16_inner = Groth16(inner_curve, device=device)
        self.g16_outer = Groth16(outer_curve, device=device)

    # -- generator ----------------------------------------------------------
    def generator(self, handler, num_proofs: int, seed=None,
                  host_keygen: bool = False,
                  timings: Optional[dict] = None):
        """handler: a CompliancePredicateHandler with constraints already
        generated and primary-input size set (the statement).
        timings: optional dict that receives wall seconds of inner_keygen,
        outer_build and outer_keygen, and the outer keygen's own phases
        as outer.<phase>."""
        clock = PhaseClock(timings, self.g16_outer.device)
        cs_inner = handler.pb.get_constraint_system()
        assert cs_inner.primary_input_size >= 1, \
            "step circuit must expose a statement as primary input"
        self.g16_inner.host_keygen = host_keygen
        self.g16_outer.host_keygen = host_keygen
        inner_kp = self.g16_inner.generator(
            cs_inner, seed=None if seed is None else seed + 1)
        clock.lap("inner_keygen")
        nbits = self.inner.r.bit_length()
        n_inputs = cs_inner.primary_input_size
        pb, bit_arrays, gadgets = self._build_outer(
            inner_kp.vk, num_proofs, n_inputs, nbits)
        cs_outer = pb.get_constraint_system()
        clock.lap("outer_build")
        outer_t = None if timings is None else {}
        outer_kp = self.g16_outer.generator(
            cs_outer, seed=None if seed is None else seed + 2,
            timings=outer_t)
        clock.lap("outer_keygen")
        if timings is not None:
            timings.update({f"outer.{k}": v for k, v in outer_t.items()})
        pk = SpPCDProvingKey(inner_keypair=inner_kp,
                             outer_keypair=outer_kp,
                             num_proofs=num_proofs,
                             num_input_bits=nbits)
        vk = SpPCDVerificationKey(outer_vk=outer_kp.vk,
                                  inner_vk=inner_kp.vk,
                                  num_proofs=num_proofs,
                                  num_input_bits=nbits)
        return pk, vk

    def _build_outer(self, inner_vk, num_proofs, n_inputs, nbits):
        """Aggregation circuit: per proof, one bit array per statement
        element + one verifier gadget (deterministic construction: the
        SAME R1CS at keygen and prove time)."""
        pb = Protoboard(self.outer.r)
        bit_arrays = []          # [proof][input] -> bits
        for i in range(num_proofs):
            per_proof = []
            for j in range(n_inputs):
                per_proof.append(PBVariableArray().allocate(
                    pb, nbits, f"in_{i}_{j}"))
            bit_arrays.append(per_proof)
        pb.set_input_sizes(num_proofs * n_inputs * nbits)
        gadgets = [
            Groth16VerifierGadget(pb, self.inner, inner_vk,
                                  [list(b) for b in bit_arrays[i]],
                                  f"v{i}")
            for i in range(num_proofs)]
        return pb, bit_arrays, gadgets

    # -- prover -------------------------------------------------------------
    def prove_step(self, pk, handler, incoming, local, seed=None):
        """Run the predicate, produce the statement + a REAL inner
        Groth16 proof of the step. Returns (statement_list, proof)."""
        handler.generate_r1cs_witness(incoming, local)
        assert handler.pb.is_satisfied(), "predicate unsatisfied"
        primary = handler.pb.primary_input()
        aux = handler.pb.auxiliary_input()
        proof = self.g16_inner.prover(pk.inner_keypair.pk, primary, aux,
                                      seed=seed)
        return primary, proof

    def prover(self, pk, statements: List[List[int]], inner_proofs,
               seed=None, timings: Optional[dict] = None):
        """Aggregate `num_proofs` inner proofs into ONE outer Groth16
        proof (the r1cs_sp_ppzkpcd prover's translation step).
        timings: optional dict that receives wall seconds of rebuild (the
        aggregation circuit), witness (the verifier gadgets' witnesses and
        the satisfaction check on the outer key's device R1CS) and
        outer_prove, and the outer prove's own
        phases as outer.<phase>."""
        clock = PhaseClock(timings, self.g16_outer.device)
        assert len(inner_proofs) == pk.num_proofs
        pb, _, _ = self.aggregation_witness(
            pk.inner_keypair.vk, pk.num_input_bits, statements,
            inner_proofs, clock)
        bad = self.g16_outer.first_unsatisfied(
            pk.outer_keypair.pk.r1cs_dev, pb)
        assert bad is None, f"aggregation circuit unsatisfied: {bad}"
        clock.lap("witness")
        outer_t = None if timings is None else {}
        outer_proof = self.g16_outer.prover(
            pk.outer_keypair.pk, pb.primary_input(),
            pb.auxiliary_input(), seed=seed, timings=outer_t)
        clock.lap("outer_prove")
        if timings is not None:
            timings.update({f"outer.{k}": v for k, v in outer_t.items()})
        return SpPCDProof(outer_proof=outer_proof)

    def aggregation_witness(self, inner_vk, nbits: int,
                            statements: List[List[int]], inner_proofs,
                            clock: Optional[PhaseClock] = None):
        """The aggregation circuit of len(inner_proofs) proofs (_build_outer)
        with its witness: the statements' bits and each verifier gadget's
        witness. Returns (pb, bit_arrays, gadgets); clock, if given, laps
        "rebuild" after the circuit is built."""
        pb, bit_arrays, gadgets = self._build_outer(
            inner_vk, len(inner_proofs), len(statements[0]), nbits)
        if clock is not None:
            clock.lap("rebuild")
        for i, (stmt, proof) in enumerate(zip(statements, inner_proofs)):
            for j, x in enumerate(stmt):
                bit_arrays[i][j].fill_with_bits_of_int(
                    pb, x % self.inner.r)
            gadgets[i].set_proof_witness(proof)
        for g in gadgets:
            g.generate_witness()
        return pb, bit_arrays, gadgets

    # -- verifier -----------------------------------------------------------
    def verifier(self, vk, statements: List[List[int]],
                 proof: SpPCDProof) -> bool:
        """Host verification of the outer proof against the statements'
        canonical bit encoding."""
        primary = []
        for stmt in statements:
            for x in stmt:
                v = x % self.inner.r
                primary += [(v >> b) & 1
                            for b in range(vk.num_input_bits)]
        return self.g16_outer.verifier_strong_IC(
            vk.outer_vk, primary, proof.outer_proof)
