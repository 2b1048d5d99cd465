"""BCTV14a PGHR-style SNARK (r1cs_ppzksnark): the port of
libsnark_tpu/proof_systems/bctv14.py (reference r1cs_ppzksnark.tcc:
generator :259, prover :507, verifiers :658-830).

Proof = 8 elements: knowledge commitments g_A = (G1, G1), g_B = (G2, G1),
g_C = (G1, G1) plus g_H, g_K in G1.

The reference's sparse knowledge-commitment vectors are dense device
affine queries whose zero entries are points at infinity, as in the JAX
package: the Pippenger kernels skip bucket 0, and the infinity-aware
additions cover the reference's zero-skip special cases.

* generator: secrets on the host, the QAP evaluated at t as the device
  R1CS's transposed products, the eight queries by device fixed-base
  batch exp (``madd_win`` over ``dbl_chain`` window tables);
* prover: the ZK-patched QAP witness map (``qap_witness_map_zk``) and
  eight MSMs (A.g, A.h, B.g in G2, B.h, C.g, C.h, H, K), then the d1, d2,
  d3 terms and the final sums on the host;
* verifiers: host pairings (five checks, twelve pairings).

Seeds drive ``random.Random`` exactly as in the JAX package, so a seeded
keypair and proof equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .base import PairingSystem, PhaseClock
from ..common.knowledge_commitment import KnowledgeCommitment
from ..common.sparse_vector import AccumulationVector
from ..ops.msm import default_window_bits
from ..reductions.r1cs_to_qap import (
    qap_domain, qap_instance_map_on_device, qap_witness_map_zk)

QUERIES = ("A_query_g", "A_query_h", "B_query_g", "B_query_h", "C_query_g",
           "C_query_h", "H_query", "K_query")


@dataclasses.dataclass
class BCTV14ProvingKey:
    A_query_g: tuple     # device affine G1, len nv+2 (with the Zt slot)
    A_query_h: tuple     # device affine G1 (alphaA shadow)
    B_query_g: tuple     # device affine G2
    B_query_h: tuple     # device affine G1
    C_query_g: tuple     # device affine G1
    C_query_h: tuple     # device affine G1
    H_query: tuple       # device affine G1, len m+1
    K_query: tuple       # device affine G1, len nv+4
    r1cs_dev: object


@dataclasses.dataclass
class BCTV14VerificationKey:
    alphaA_g2: object
    alphaB_g1: object
    alphaC_g2: object
    gamma_g2: object
    gamma_beta_g1: object
    gamma_beta_g2: object
    rC_Z_g2: object
    encoded_IC_query: AccumulationVector


@dataclasses.dataclass
class BCTV14Keypair:
    pk: BCTV14ProvingKey
    vk: BCTV14VerificationKey


@dataclasses.dataclass
class BCTV14Proof:
    g_A: KnowledgeCommitment
    g_B: KnowledgeCommitment
    g_C: KnowledgeCommitment
    g_H: object
    g_K: object

    def is_well_formed(self):
        return (self.g_A.is_well_formed() and self.g_B.is_well_formed()
                and self.g_C.is_well_formed()
                and self.g_H.is_well_formed()
                and self.g_K.is_well_formed())


class BCTV14(PairingSystem):
    """r1cs_ppzksnark over a named curve."""

    def generator(self, cs, seed: Optional[int] = None,
                  timings: Optional[dict] = None):
        """Trusted setup; timings: optional dict of wall seconds per phase."""
        rand = self._rng(seed)
        secrets_ = [rand() for _ in range(8)]
        return self.generator_from_secrets(cs, *secrets_, timings=timings)

    def generator_from_secrets(self, cs, t, alphaA, alphaB, alphaC,
                               rA, rB, beta, gamma,
                               timings: Optional[dict] = None):
        clock = PhaseClock(timings, self.device)
        curve, r = self.curve, self.curve.r
        cs.swap_AB_if_beneficial()
        domain = self.domain_for(qap_domain, cs)
        r1cs_dev = cs.to_device(self.fr)
        qap = qap_instance_map_on_device(r1cs_dev, domain, t)
        nv, k = qap.num_variables, qap.num_inputs
        rC = rA * rB % r
        G1, G2 = curve.G1.one(), curve.G2.one()

        At = list(qap.At) + [qap.Zt]
        Bt = list(qap.Bt) + [qap.Zt]
        Ct = list(qap.Ct) + [qap.Zt]
        # the K query takes At before its IC prefix is zeroed (tcc:332-341)
        Kt = [beta * (rA * At[i] + rB * Bt[i] + rC * Ct[i]) % r
              for i in range(nv + 1)]
        Kt += [beta * rA * qap.Zt % r, beta * rB * qap.Zt % r,
               beta * rC * qap.Zt % r]
        IC = At[: k + 1]
        At[: k + 1] = [0] * (k + 1)
        clock.lap("keygen_host_qap")

        fb1, fb2 = self.fixed_base_g1, self.fixed_base_g2
        queries = dict(
            A_query_g=fb1(G1, [rA * a % r for a in At]),
            A_query_h=fb1(G1, [rA * alphaA * a % r for a in At]),
            B_query_g=fb2(G2, [rB * b % r for b in Bt]),
            B_query_h=fb1(G1, [rB * alphaB * b % r for b in Bt]),
            C_query_g=fb1(G1, [rC * c % r for c in Ct]),
            C_query_h=fb1(G1, [rC * alphaC * c % r for c in Ct]),
            H_query=fb1(G1, qap.Ht),
            K_query=fb1(G1, Kt))
        clock.lap("keygen_fixed_base")

        pk = BCTV14ProvingKey(r1cs_dev=r1cs_dev,
                              **queries)
        vk = BCTV14VerificationKey(
            alphaA_g2=G2 * alphaA, alphaB_g1=G1 * alphaB,
            alphaC_g2=G2 * alphaC, gamma_g2=G2 * gamma,
            gamma_beta_g1=G1 * (gamma * beta % r),
            gamma_beta_g2=G2 * (gamma * beta % r),
            rC_Z_g2=G2 * (rC * qap.Zt % r),
            encoded_IC_query=AccumulationVector.from_values(
                G1 * (rA * IC[0] % r),
                [G1 * (rA * v % r) for v in IC[1:]]))
        clock.lap("keygen_host_rest")
        return BCTV14Keypair(pk=pk, vk=vk)

    # -- prover ------------------------------------------------------------
    def prover(self, pk, primary: list, auxiliary: list,
               seed: Optional[int] = None, timings: Optional[dict] = None):
        """Prove; timings: optional dict of wall seconds per phase (each
        ended by a device synchronize)."""
        clock = PhaseClock(timings, self.device)
        curve, r = self.curve, self.curve.r
        rand = self._rng(seed)
        d1, d2, d3 = rand(), rand(), rand()

        dev = pk.r1cs_dev
        domain = self.domain_for(qap_domain, dev)
        nv = dev.num_variables
        full = [1] + [v % r for v in primary] + [v % r for v in auxiliary]
        assignment_mont = self.fr.encode(full)
        d_m = self.fr.encode([d1, d2, d3])
        msm_c = default_window_bits(nv + 1)
        clock.lap("prove_encode")

        H = qap_witness_map_zk(dev, domain, assignment_mont, d_m[:, 0:1],
                               d_m[:, 1:2], d_m[:, 2:3])
        H_plain = self.pad_to(self.fr.from_mont(H), pk.H_query[0].shape[-1])
        assign_plain = self.fr.from_mont(assignment_mont)
        # lanes past nv (the Zt slots and the bucket padding) take scalar
        # zero; the d_i * Zt terms are added on the host
        full_p = self.pad_to(assign_plain, pk.A_query_g[0].shape[-1])
        kfull_p = self.pad_to(assign_plain, pk.K_query[0].shape[-1])
        clock.lap("witness_map")

        msm = {}
        for name, which, sc in (
                ("A_query_g", "g1", full_p), ("A_query_h", "g1", full_p),
                ("B_query_g", "g2", full_p), ("B_query_h", "g1", full_p),
                ("C_query_g", "g1", full_p), ("C_query_h", "g1", full_p),
                ("H_query", "g1", H_plain), ("K_query", "g1", kfull_p)):
            msm[name] = self.msm_affine(which, getattr(pk, name), sc, msm_c)
            clock.lap("msm_" + name.replace("_query", ""))

        dec1, dec2 = self.decode_g1, self.decode_g2
        zt = nv + 1   # the Zt lane of the A/B/C queries (they are padded)
        g_A = KnowledgeCommitment(
            dec1(msm["A_query_g"]) + dec1(pk.A_query_g, lane=zt) * d1,
            dec1(msm["A_query_h"]) + dec1(pk.A_query_h, lane=zt) * d1)
        g_B = KnowledgeCommitment(
            dec2(msm["B_query_g"]) + dec2(pk.B_query_g, lane=zt) * d2,
            dec1(msm["B_query_h"]) + dec1(pk.B_query_h, lane=zt) * d2)
        g_C = KnowledgeCommitment(
            dec1(msm["C_query_g"]) + dec1(pk.C_query_g, lane=zt) * d3,
            dec1(msm["C_query_h"]) + dec1(pk.C_query_h, lane=zt) * d3)
        # the K query's ZK terms sit at lanes nv+1, nv+2, nv+3
        g_K = dec1(msm["K_query"])
        for i, d in enumerate((d1, d2, d3)):
            g_K = g_K + dec1(pk.K_query, lane=nv + 1 + i) * d
        proof = BCTV14Proof(g_A=g_A, g_B=g_B, g_C=g_C,
                            g_H=dec1(msm["H_query"]), g_K=g_K)
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
        G2_one = curve.G2.one()
        # knowledge commitment checks (tcc:707-768)
        kc_A = curve.pairing_check([
            (proof.g_A.g, vk.alphaA_g2), (-proof.g_A.h, G2_one)])
        kc_B = curve.pairing_check([
            (vk.alphaB_g1, proof.g_B.g), (-proof.g_B.h, G2_one)])
        kc_C = curve.pairing_check([
            (proof.g_C.g, vk.alphaC_g2), (-proof.g_C.h, G2_one)])
        # QAP divisibility: e(A+acc, B) = e(H, rC_Z) e(C, 1)
        qap_ok = curve.pairing_check([
            (proof.g_A.g + acc, proof.g_B.g),
            (-proof.g_H, vk.rC_Z_g2),
            (-proof.g_C.g, G2_one)])
        # same coefficients: e(K, gamma) = e(A+acc+C, gamma*beta)
        # e(gamma*beta, B)
        k_ok = curve.pairing_check([
            (proof.g_K, vk.gamma_g2),
            (-(proof.g_A.g + acc + proof.g_C.g), vk.gamma_beta_g2),
            (-vk.gamma_beta_g1, proof.g_B.g)])
        return kc_A and kc_B and kc_C and qap_ok and k_ok
