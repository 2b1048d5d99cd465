"""RAM ppzkSNARK: TinyRAM universal circuit + BCTV14 (reference
zk_proof_systems/zksnark/ram_ppzksnark/ram_ppzksnark.tcc: keypair
generation runs ram_to_r1cs::instance_map then r1cs_ppzksnark_generator
(:139-153); the prover runs auxiliary_input_map (program execution +
routing) then r1cs_ppzksnark_prover (:174-197)).

The statement is the BOOT TRACE (program + primary input packed into
field elements); the witness is the execution trace + routing bits.
The universal circuit is built on the host by both the generator and the
prover; BCTV14 runs on the system's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .base import PhaseClock
from .bctv14 import BCTV14
from ..gadgets.ram_universal import ram_to_r1cs_instance_map
from ..relations.tinyram import TinyRAMParams, TinyRAMProgram


@dataclasses.dataclass
class RAMPpzksnarkKeypair:
    pk: "RAMPpzksnarkProvingKey"
    vk: object                       # BCTV14 verification key


@dataclasses.dataclass
class RAMPpzksnarkProvingKey:
    ap: TinyRAMParams
    boot_trace_size_bound: int
    time_bound: int
    r1cs_pk: object


class RAMPpzksnark(BCTV14):
    """ram_ppzksnark over a named curve."""

    def ram_generator(self, ap: TinyRAMParams, boot_trace_size_bound: int,
                      time_bound: int, seed: Optional[int] = None,
                      timings: Optional[dict] = None):
        """timings: optional dict that receives wall seconds of the
        universal circuit's host build (ram_build) and of the BCTV14
        generator's phases."""
        clock = PhaseClock(timings, self.device)
        pb, g = ram_to_r1cs_instance_map(
            self.curve.r, ap, boot_trace_size_bound, time_bound)
        cs = pb.get_constraint_system()
        clock.lap("ram_build")
        kp = self.generator(cs, seed=seed, timings=timings)
        return RAMPpzksnarkKeypair(
            pk=RAMPpzksnarkProvingKey(
                ap=ap, boot_trace_size_bound=boot_trace_size_bound,
                time_bound=time_bound, r1cs_pk=kp.pk),
            vk=kp.vk)

    def ram_prover(self, pk: RAMPpzksnarkProvingKey,
                   program: TinyRAMProgram, primary_input: List[int],
                   aux_tape: List[int], seed: Optional[int] = None,
                   timings: Optional[dict] = None):
        """Runs the program, routes the memory permutation, proves.
        timings: optional dict that receives wall seconds of ram_build,
        ram_witness (execution, routing and the satisfaction check on the
        proving key's device R1CS) and the BCTV14 prover's phases."""
        clock = PhaseClock(timings, self.device)
        pb, g = ram_to_r1cs_instance_map(
            self.curve.r, pk.ap, pk.boot_trace_size_bound, pk.time_bound)
        clock.lap("ram_build")
        answer, accepted = g.generate_r1cs_witness(
            program, primary_input, aux_tape)
        assert accepted, f"program did not accept (answer={answer})"
        bad = self.first_unsatisfied(pk.r1cs_pk.r1cs_dev, pb)
        assert bad is None, f"universal circuit unsatisfied: {bad}"
        clock.lap("ram_witness")
        proof = self.prover(pk.r1cs_pk, pb.primary_input(),
                            pb.auxiliary_input(), seed=seed,
                            timings=timings)
        return proof, pb.primary_input()

    def ram_verifier(self, vk, boot_primary_input: List[int],
                     proof) -> bool:
        return self.verifier_strong_IC(vk, boot_primary_input, proof)
