"""GM17 simulation-extractable SNARK (r1cs_se_ppzksnark): the port of
libsnark_tpu/proof_systems/gm17.py (reference r1cs_se_ppzksnark.tcc:
generator :246, prover :438, verifier :561-692), via the R1CS -> SAP
reduction.

* generator: secrets and the SAP evaluation on the host, the five queries
  by device fixed-base batch exp over G = g_s * G1 and H = h_s * G2;
* prover: the SAP witness map on the device (``sap_extend_assignment``,
  ``sap_witness_map``) and five MSMs (A, B in G2, C_1, C_2, H), then the
  final sums on the host;
* verifier: host pairings (two checks).

Proof = (A in G1, B in G2, C in G1). Seeded keys and proofs equal the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .base import PairingSystem, PhaseClock
from ..ops.msm import default_window_bits
from ..reductions.r1cs_to_sap import (
    SAPDevice, sap_domain, sap_extend_assignment,
    sap_instance_map_with_evaluation, sap_witness_map)

QUERIES = ("A_query", "B_query", "C_query_1", "C_query_2", "G_gamma2_Z_t")


@dataclasses.dataclass
class GM17ProvingKey:
    A_query: tuple            # device affine G1, len nv_sap+1
    B_query: tuple            # device affine G2, len nv_sap+1
    C_query_1: tuple          # device affine G1, len nv_sap - k
    C_query_2: tuple          # device affine G1, len nv_sap+1
    G_gamma2_Z_t: tuple       # device affine G1, len degree+1
    G_gamma_Z: object         # host G1
    H_gamma_Z: object         # host G2
    G_ab_gamma_Z: object      # host G1
    G_gamma2_Z2: object       # host G1
    G_gamma2_Z_t0: object     # host G1 (= G_gamma2_Z_t[0], the d2 patch)
    sap_dev: SAPDevice


@dataclasses.dataclass
class GM17VerificationKey:
    H: object                 # host G2
    G_alpha: object           # host G1
    H_beta: object            # host G2
    G_gamma: object           # host G1
    H_gamma: object           # host G2
    query: list               # host G1, len num_inputs + 1


@dataclasses.dataclass
class GM17Keypair:
    pk: GM17ProvingKey
    vk: GM17VerificationKey


@dataclasses.dataclass
class GM17Proof:
    A: object   # host G1
    B: object   # host G2
    C: object   # host G1

    def is_well_formed(self):
        return (self.A.is_well_formed() and self.B.is_well_formed()
                and self.C.is_well_formed())


class GM17(PairingSystem):
    """r1cs_se_ppzksnark over a named curve."""

    def generator(self, cs, seed: Optional[int] = None,
                  timings: Optional[dict] = None):
        """Trusted setup; timings: optional dict of wall seconds per phase."""
        rand = self._rng(seed)
        t, alpha, beta, gamma, g_s, h_s = (rand() for _ in range(6))
        return self.generator_from_secrets(cs, t, alpha, beta, gamma,
                                           g_s, h_s, timings=timings)

    def generator_from_secrets(self, cs, t, alpha, beta, gamma,
                               g_scalar=1, h_scalar=1,
                               timings: Optional[dict] = None):
        clock = PhaseClock(timings, self.device)
        curve, r = self.curve, self.curve.r
        domain = self.domain_for(sap_domain, cs)
        sap = sap_instance_map_with_evaluation(cs, domain, t)
        nv, k, m = sap.num_variables, sap.num_inputs, sap.degree
        G = curve.G1.one() * g_scalar
        H = curve.G2.one() * h_scalar

        ab = (alpha + beta) % r
        query_s = [(gamma * sap.Ct[i] + ab * sap.At[i]) % r
                   for i in range(k + 1)]
        A_s = [gamma * a % r for a in sap.At]
        gz2 = gamma * gamma % r * sap.Zt % r
        C1_s = [gamma * (gamma * sap.Ct[i] + ab * sap.At[i]) % r
                for i in range(k + 1, nv + 1)]
        C2_s = [2 * gz2 * a % r for a in sap.At]
        Gz_t_s = [gz2 * sap.Ht[i] % r for i in range(m + 1)]
        clock.lap("keygen_host_sap")

        queries = dict(
            A_query=self.fixed_base_g1(G, A_s),
            B_query=self.fixed_base_g2(H, A_s),
            C_query_1=self.fixed_base_g1(G, C1_s),
            C_query_2=self.fixed_base_g1(G, C2_s),
            G_gamma2_Z_t=self.fixed_base_g1(G, Gz_t_s))
        clock.lap("keygen_fixed_base")

        G_gamma_Z = G * (gamma * sap.Zt % r)
        H_gamma_Z = H * (gamma * sap.Zt % r)
        pk = GM17ProvingKey(
            G_gamma_Z=G_gamma_Z, H_gamma_Z=H_gamma_Z,
            G_ab_gamma_Z=G_gamma_Z * ab,
            G_gamma2_Z2=G_gamma_Z * (sap.Zt * gamma % r),
            G_gamma2_Z_t0=G * Gz_t_s[0],
            sap_dev=SAPDevice.build(cs, self.fr), **queries)
        vk = GM17VerificationKey(
            H=H, G_alpha=G * alpha, H_beta=H * beta,
            G_gamma=G * gamma, H_gamma=H * gamma,
            query=[G * s for s in query_s])
        clock.lap("keygen_host_rest")
        return GM17Keypair(pk=pk, vk=vk)

    # -- prover ------------------------------------------------------------
    def prover(self, pk, primary: list, auxiliary: list,
               seed: Optional[int] = None, timings: Optional[dict] = None):
        """Prove; timings: optional dict of wall seconds per phase (each
        ended by a device synchronize)."""
        clock = PhaseClock(timings, self.device)
        r = self.curve.r
        rand = self._rng(seed)
        d1, d2, rnd_r = rand(), rand(), rand()

        dev = pk.sap_dev
        domain = self.domain_for(sap_domain, dev)
        k = dev.num_inputs
        full = [1] + [v % r for v in primary] + [v % r for v in auxiliary]
        assignment_mont = self.fr.encode(full)
        d_m = self.fr.encode([d1, d2])
        msm_c = default_window_bits(dev.sap_num_variables + 1)
        clock.lap("prove_encode")

        ext = sap_extend_assignment(dev, self.fr, assignment_mont)
        H = sap_witness_map(dev, domain, ext, d_m[:, 0:1], d_m[:, 1:2])
        H_plain = self.pad_to(self.fr.from_mont(H),
                              pk.G_gamma2_Z_t[0].shape[-1])
        ext_plain = self.fr.from_mont(ext)
        full_p = self.pad_to(ext_plain, pk.A_query[0].shape[-1])
        wit_p = self.pad_to(ext_plain[..., k + 1:], pk.C_query_1[0].shape[-1])
        clock.lap("witness_map")

        A_a = self.msm_affine("g1", pk.A_query, full_p, msm_c)
        clock.lap("msm_A")
        B_a = self.msm_affine("g2", pk.B_query, full_p, msm_c)
        clock.lap("msm_B")
        C1_a = self.msm_affine("g1", pk.C_query_1, wit_p, msm_c)
        clock.lap("msm_C_1")
        C2_a = self.msm_affine("g1", pk.C_query_2, full_p, msm_c)
        clock.lap("msm_C_2")
        H_a = self.msm_affine("g1", pk.G_gamma2_Z_t, H_plain, msm_c)
        clock.lap("msm_H")
        A_m, C1_m, C2_m, H_m = (self.decode_g1(A_a), self.decode_g1(C1_a),
                                self.decode_g1(C2_a), self.decode_g1(H_a))
        B_m = self.decode_g2(B_a)

        # final combination (tcc:487-560)
        A = pk.G_gamma_Z * ((rnd_r + d1) % r) + A_m
        B = pk.H_gamma_Z * ((rnd_r + d1) % r) + B_m
        C = (C1_m
             + pk.G_gamma2_Z2 * (rnd_r * rnd_r % r)
             + pk.G_ab_gamma_Z * ((rnd_r + d1) % r)
             + C2_m * rnd_r
             + pk.G_gamma2_Z2 * (2 * rnd_r * d1 % r)
             + pk.G_gamma2_Z_t0 * d2
             + H_m)
        clock.lap("prove_host_combine")
        return GM17Proof(A=A, B=B, C=C)

    # -- verifier ------------------------------------------------------------
    def verifier_process_vk(self, vk):
        return vk  # the host pairings are computed on demand

    def verifier_strong_IC(self, vk, primary: list, proof) -> bool:
        if len(primary) + 1 != len(vk.query):
            return False
        return self.verifier_weak_IC(vk, primary, proof)

    def verifier_weak_IC(self, vk, primary: list, proof) -> bool:
        curve, r = self.curve, self.curve.r
        if len(primary) + 1 > len(vk.query):
            return False
        if not proof.is_well_formed():
            return False
        G_psi = vk.query[0]
        for i, x in enumerate(primary):
            G_psi = G_psi + vk.query[i + 1] * (x % r)
        # test 1: e(A + G_alpha, B + H_beta)
        #         = e(G_alpha, H_beta) e(psi, H_gamma) e(C, H)
        ok1 = curve.pairing_check([
            (-(proof.A + vk.G_alpha), proof.B + vk.H_beta),
            (vk.G_alpha, vk.H_beta),
            (G_psi, vk.H_gamma),
            (proof.C, vk.H),
        ])
        # test 2: e(A, H_gamma) = e(G_gamma, B)
        ok2 = curve.pairing_check([
            (proof.A, vk.H_gamma),
            (-vk.G_gamma, proof.B),
        ])
        return ok1 and ok2
