"""BACS ppzkSNARK: BCTV14 over the BACS->R1CS reduction.

Parity: zk_proof_systems/ppzksnark/bacs_ppzksnark/bacs_ppzksnark.tcc
(generator :51, prover :69, verifiers delegate to r1cs_ppzksnark).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .bctv14 import BCTV14
from ..reductions.bacs_to_r1cs import (
    bacs_to_r1cs_instance_map, bacs_to_r1cs_witness_map)


@dataclasses.dataclass
class BACSKeypair:
    pk: object      # holds the circuit + the underlying r1cs pk
    vk: object


@dataclasses.dataclass
class BACSProvingKey:
    circuit: object
    r1cs_pk: object


class BACSPpzksnark(BCTV14):
    """bacs_ppzksnark over a named curve."""

    def bacs_generator(self, circuit, seed: Optional[int] = None):
        cs = bacs_to_r1cs_instance_map(circuit)
        kp = self.generator(cs, seed=seed)
        return BACSKeypair(pk=BACSProvingKey(circuit=circuit, r1cs_pk=kp.pk),
                           vk=kp.vk)

    def bacs_prover(self, pk: BACSProvingKey, primary: list, auxiliary: list,
                    seed: Optional[int] = None):
        full = bacs_to_r1cs_witness_map(pk.circuit, primary, auxiliary)
        new_aux = full[pk.circuit.primary_input_size:]
        return self.prover(pk.r1cs_pk, primary, new_aux, seed=seed)

    # verifier_{weak,strong}_IC inherited from BCTV14 apply unchanged.
