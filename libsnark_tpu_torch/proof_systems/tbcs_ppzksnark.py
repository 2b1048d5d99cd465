"""TBCS ppzkSNARK: DFGK14 over the TBCS->USCS reduction.

Parity: zk_proof_systems/ppzksnark/tbcs_ppzksnark/tbcs_ppzksnark.tcc
(generator :51, prover :69, verifiers delegate to uscs_ppzksnark).
Primary input bits become 0/1 field elements.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .dfgk14 import DFGK14
from ..reductions.tbcs_to_uscs import (
    tbcs_to_uscs_instance_map, tbcs_to_uscs_witness_map)


@dataclasses.dataclass
class TBCSKeypair:
    pk: object
    vk: object


@dataclasses.dataclass
class TBCSProvingKey:
    circuit: object
    uscs_pk: object


class TBCSPpzksnark(DFGK14):
    """tbcs_ppzksnark over a named curve."""

    def tbcs_generator(self, circuit, seed: Optional[int] = None):
        cs = tbcs_to_uscs_instance_map(circuit, self.curve.r)
        kp = self.generator(cs, seed=seed)
        return TBCSKeypair(pk=TBCSProvingKey(circuit=circuit, uscs_pk=kp.pk),
                           vk=kp.vk)

    def tbcs_prover(self, pk: TBCSProvingKey, primary: list, auxiliary: list,
                    seed: Optional[int] = None):
        full = tbcs_to_uscs_witness_map(pk.circuit, primary, auxiliary)
        new_aux = full[pk.circuit.primary_input_size:]
        prim = [1 if b else 0 for b in primary]
        return self.prover(pk.uscs_pk, prim, new_aux, seed=seed)

    def tbcs_verifier_strong_IC(self, vk, primary: list, proof) -> bool:
        return self.verifier_strong_IC(
            vk, [1 if b else 0 for b in primary], proof)

    def tbcs_verifier_weak_IC(self, vk, primary: list, proof) -> bool:
        return self.verifier_weak_IC(
            vk, [1 if b else 0 for b in primary], proof)
