"""DFGK14 USCS SNARK (uscs_ppzksnark): the port of
libsnark_tpu/proof_systems/dfgk14.py (reference uscs_ppzksnark.tcc:
generator :214, prover :389, verifier :518-640), via the USCS -> SSP
reduction. Queries:
  V_g1_query       = [Vt[k+1..nv], Zt] * G             (G1)
  alpha_V_g1_query = alpha * same                      (G1)
  H_g1_query       = [t^0..t^degree] * G               (G1)
  V_g2_query       = [Vt[0..nv], Zt] * H               (G2)
vk = (tilde_g2, alpha_tilde_g2, Z_g2, accumulation of Xt = Vt[0..k]).
Proof = (V_g1, alpha_V_g1, H_g1, V_g2).

The queries come from device fixed-base batch exp; the prover runs the SSP
witness map and four MSMs on the device, then adds the d * Zt terms on the
host; the verifier is three host pairing checks. Seeded keys and proofs
equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .base import PairingSystem, PhaseClock
from ..common.sparse_vector import AccumulationVector
from ..ops.msm import default_window_bits
from ..reductions.uscs_to_ssp import (
    SSPDevice, ssp_domain, ssp_instance_map_with_evaluation, ssp_witness_map)

QUERIES = ("V_g1_query", "alpha_V_g1_query", "H_g1_query", "V_g2_query")


@dataclasses.dataclass
class DFGK14ProvingKey:
    V_g1_query: tuple          # device affine G1, len nv-k+1
    alpha_V_g1_query: tuple    # device affine G1, len nv-k+1
    H_g1_query: tuple          # device affine G1, len degree+1
    V_g2_query: tuple          # device affine G2, len nv+2
    ssp_dev: SSPDevice


@dataclasses.dataclass
class DFGK14VerificationKey:
    tilde_g2: object
    alpha_tilde_g2: object
    Z_g2: object
    encoded_IC_query: AccumulationVector


@dataclasses.dataclass
class DFGK14Keypair:
    pk: DFGK14ProvingKey
    vk: DFGK14VerificationKey


@dataclasses.dataclass
class DFGK14Proof:
    V_g1: object
    alpha_V_g1: object
    H_g1: object
    V_g2: object

    def is_well_formed(self):
        return (self.V_g1.is_well_formed()
                and self.alpha_V_g1.is_well_formed()
                and self.H_g1.is_well_formed()
                and self.V_g2.is_well_formed())


class DFGK14(PairingSystem):
    """uscs_ppzksnark over a named curve."""

    def generator(self, cs, seed: Optional[int] = None,
                  timings: Optional[dict] = None):
        """Trusted setup; timings: optional dict of wall seconds per phase."""
        rand = self._rng(seed)
        t, alpha, tilde = rand(), rand(), rand()
        return self.generator_from_secrets(cs, t, alpha, tilde,
                                           timings=timings)

    def generator_from_secrets(self, cs, t, alpha, tilde,
                               timings: Optional[dict] = None):
        clock = PhaseClock(timings, self.device)
        curve, r = self.curve, self.curve.r
        domain = self.domain_for(ssp_domain, cs)
        ssp = ssp_instance_map_with_evaluation(cs, domain, t)
        k, m = ssp.num_inputs, ssp.degree
        G1, G2 = curve.G1.one(), curve.G2.one()

        Vt_full = list(ssp.Vt) + [ssp.Zt]          # len nv + 2
        Xt = Vt_full[: k + 1]
        V_rest = Vt_full[k + 1:]
        alpha_V = [alpha * v % r for v in V_rest]
        clock.lap("keygen_host_ssp")

        queries = dict(
            V_g1_query=self.fixed_base_g1(G1, V_rest),
            alpha_V_g1_query=self.fixed_base_g1(G1, alpha_V),
            H_g1_query=self.fixed_base_g1(G1, ssp.Ht),
            V_g2_query=self.fixed_base_g2(G2, Vt_full))
        clock.lap("keygen_fixed_base")

        pk = DFGK14ProvingKey(ssp_dev=SSPDevice.build(cs, self.fr, m),
                              **queries)
        vk = DFGK14VerificationKey(
            tilde_g2=G2 * tilde,
            alpha_tilde_g2=G2 * (alpha * tilde % r),
            Z_g2=G2 * ssp.Zt,
            encoded_IC_query=AccumulationVector.from_values(
                G1 * Xt[0], [G1 * x for x in Xt[1:]]))
        clock.lap("keygen_host_rest")
        return DFGK14Keypair(pk=pk, vk=vk)

    # -- prover ------------------------------------------------------------
    def prover(self, pk, primary: list, auxiliary: list,
               seed: Optional[int] = None, timings: Optional[dict] = None):
        """Prove; timings: optional dict of wall seconds per phase (each
        ended by a device synchronize)."""
        clock = PhaseClock(timings, self.device)
        r = self.curve.r
        d = self._rng(seed)()
        dev = pk.ssp_dev
        domain = self.domain_for(ssp_domain, dev)
        nv, k = dev.num_variables, dev.num_inputs
        full = [1] + [v % r for v in primary] + [v % r for v in auxiliary]
        assignment_mont = self.fr.encode(full)
        d_m = self.fr.encode([d])
        msm_c = default_window_bits(nv + 2)
        clock.lap("prove_encode")

        H = ssp_witness_map(dev, domain, assignment_mont, d_m)
        H_plain = self.pad_to(self.fr.from_mont(H),
                              pk.H_g1_query[0].shape[-1])
        assign_plain = self.fr.from_mont(assignment_mont)
        # V_g1 / alpha_V_g1: variables k+1..nv; the trailing Zt lane (the
        # ZK patch) and the pad lanes take scalar zero
        wit_p = self.pad_to(assign_plain[..., k + 1:],
                            pk.V_g1_query[0].shape[-1])
        full_p = self.pad_to(assign_plain, pk.V_g2_query[0].shape[-1])
        clock.lap("witness_map")

        V1_a = self.msm_affine("g1", pk.V_g1_query, wit_p, msm_c)
        clock.lap("msm_V_g1")
        aV1_a = self.msm_affine("g1", pk.alpha_V_g1_query, wit_p, msm_c)
        clock.lap("msm_alpha_V_g1")
        H_a = self.msm_affine("g1", pk.H_g1_query, H_plain, msm_c)
        clock.lap("msm_H_g1")
        V2_a = self.msm_affine("g2", pk.V_g2_query, full_p, msm_c)
        clock.lap("msm_V_g2")

        # the Zt entries sit at the logical last lanes (queries are padded)
        dec1, dec2 = self.decode_g1, self.decode_g2
        proof = DFGK14Proof(
            V_g1=dec1(pk.V_g1_query, lane=nv - k) * d + dec1(V1_a),
            alpha_V_g1=(dec1(pk.alpha_V_g1_query, lane=nv - k) * d
                        + dec1(aV1_a)),
            H_g1=dec1(H_a),
            V_g2=dec2(pk.V_g2_query, lane=nv + 1) * d + dec2(V2_a))
        clock.lap("prove_host_combine")
        return proof

    # -- verifier ------------------------------------------------------------
    def verifier_strong_IC(self, vk, primary: list, proof) -> bool:
        if len(primary) != vk.encoded_IC_query.domain_size():
            return False
        return self.verifier_weak_IC(vk, primary, proof)

    def verifier_weak_IC(self, vk, primary: list, proof) -> bool:
        curve, r = self.curve, self.curve.r
        if len(primary) > vk.encoded_IC_query.domain_size():
            return False
        acc = vk.encoded_IC_query.accumulate_chunk(
            [x % r for x in primary], 0).first
        if not proof.is_well_formed():
            return False
        G1_one, G2_one = curve.G1.one(), curve.G2.one()
        V_with_acc = proof.V_g1 + acc
        # knowledge commitment: e(V_g1 + acc, H) = e(G, V_g2)
        ok1 = curve.pairing_check([
            (V_with_acc, G2_one),
            (-G1_one, proof.V_g2),
        ])
        # SSP divisibility: e(V, V) = e(H, Z) e(G, H2) -> V^2 = H Z + 1
        ok2 = curve.pairing_check([
            (-V_with_acc, proof.V_g2),
            (proof.H_g1, vk.Z_g2),
            (G1_one, G2_one),
        ])
        # same-coefficient check
        ok3 = curve.pairing_check([
            (proof.V_g1, vk.alpha_tilde_g2),
            (-proof.alpha_V_g1, vk.tilde_g2),
        ])
        return ok1 and ok2 and ok3
