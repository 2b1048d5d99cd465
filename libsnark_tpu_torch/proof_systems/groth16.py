"""Groth16 (r1cs_gg_ppzksnark): generator / prover / verifier (the port of
libsnark_tpu/proof_systems/groth16.py; reference r1cs_gg_ppzksnark.tcc:
generator :226/:430, prover :464, verifiers :605-745).

* generator: secrets + QAP evaluation on the host (once per circuit), all
  query exponentiations as device fixed-base batch exp over window tables
  built on the device;
* prover: QAP witness map on the device (mont_mul kernel under the NTT and
  the mat-vecs), the A / B1 / H / L G1 MSMs and the B G2 MSM (bucket
  accumulation by ``msm_strategy``, then the Horner kernel), then a few
  host point operations;
* verifier: host pairings.

Seeds drive ``random.Random`` exactly as in the JAX package, so a seeded
keypair and proof equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
import random
import secrets
from typing import Optional

from .base import PairingSystem, PhaseClock
from ..ops.msm import default_window_bits
from ..reductions.r1cs_to_qap import (
    qap_domain, qap_instance_map_with_evaluation, qap_witness_map)


@dataclasses.dataclass
class Groth16ProvingKey:
    alpha_g1: object
    beta_g1: object
    beta_g2: object
    delta_g1: object
    delta_g2: object
    A_query: tuple          # device affine (x, y, inf) G1, len nv+1
    B_query_g2: tuple       # device affine G2, len nv+1
    B_query_g1: tuple       # device affine G1, len nv+1
    H_query: tuple          # device affine G1, len m-1
    L_query: tuple          # device affine G1, len nv - num_inputs
    r1cs_dev: object

    def size_summary(self):
        nv = self.r1cs_dev.num_variables
        return dict(A=nv + 1, B=nv + 1, H=self.H_query[0].shape[-1],
                    L=self.L_query[0].shape[-1])


@dataclasses.dataclass
class Groth16VerificationKey:
    alpha_g1: object
    beta_g2: object
    gamma_g2: object
    delta_g2: object
    gamma_ABC: list          # host G1 points, len num_inputs + 1


@dataclasses.dataclass
class Groth16ProcessedVK:
    """Online-verification state (r1cs_gg_ppzksnark_processed_verification_key,
    tcc:605-621): e(alpha, beta) and the G2 Miller-loop embeddings."""
    alpha_beta_gt: object
    gamma_g2_precomp: object
    delta_g2_precomp: object
    gamma_ABC: list


@dataclasses.dataclass
class Groth16Keypair:
    pk: Groth16ProvingKey
    vk: Groth16VerificationKey


@dataclasses.dataclass
class Groth16Proof:
    g_A: object   # host G1
    g_B: object   # host G2
    g_C: object   # host G1

    def __eq__(self, o):
        return (self.g_A, self.g_B, self.g_C) == (o.g_A, o.g_B, o.g_C)


class Groth16(PairingSystem):
    """Groth16 over a named curve; holds the device kernel bundle.

    Queries are device affine tensors padded to power-of-two buckets; pad
    lanes are infinity points / zero scalars."""

    # -- generator ----------------------------------------------------------------
    def generator(self, cs, seed: Optional[int] = None,
                  timings: Optional[dict] = None):
        """Trusted setup. seed=None -> secure randomness; otherwise
        deterministic (generator_from_secrets-style parity path).
        timings: optional dict that receives wall seconds per phase."""
        rand = self._rng(seed)
        t, alpha, beta, gamma, delta = (rand() for _ in range(5))
        return self.generator_from_secrets(cs, t, alpha, beta, gamma, delta,
                                           timings)

    def generator_from_secrets(self, cs, t, alpha, beta, gamma, delta,
                               timings: Optional[dict] = None):
        clock = PhaseClock(timings, self.device)
        curve, r = self.curve, self.curve.r
        cs.swap_AB_if_beneficial()
        domain = self.domain_for(qap_domain, cs)
        qap = qap_instance_map_with_evaluation(cs, domain, t)
        m, nv, k = qap.degree, qap.num_variables, qap.num_inputs

        gamma_inv = pow(gamma, -1, r)
        delta_inv = pow(delta, -1, r)
        ABC = [(beta * qap.At[i] + alpha * qap.Bt[i] + qap.Ct[i]) % r
               for i in range(nv + 1)]
        gamma_ABC_s = [v * gamma_inv % r for v in ABC[: k + 1]]
        L_s = [v * delta_inv % r for v in ABC[k + 1:]]
        H_s = [qap.Ht[i] * qap.Zt % r * delta_inv % r for i in range(m - 1)]
        clock.lap("keygen_host_qap")

        G1, G2 = curve.G1.one(), curve.G2.one()
        A_query = self.fixed_base_g1(G1, qap.At)
        B_query_g2 = self.fixed_base_g2(G2, qap.Bt)
        B_query_g1 = self.fixed_base_g1(G1, qap.Bt)
        H_query = self.fixed_base_g1(G1, H_s)
        L_query = self.fixed_base_g1(G1, L_s)
        clock.lap("keygen_fixed_base")
        gamma_ABC = [G1 * s for s in gamma_ABC_s]

        pk = Groth16ProvingKey(
            alpha_g1=G1 * alpha, beta_g1=G1 * beta, beta_g2=G2 * beta,
            delta_g1=G1 * delta, delta_g2=G2 * delta,
            A_query=A_query, B_query_g2=B_query_g2, B_query_g1=B_query_g1,
            H_query=H_query, L_query=L_query,
            r1cs_dev=cs.to_device(self.fr))
        vk = Groth16VerificationKey(
            alpha_g1=G1 * alpha, beta_g2=G2 * beta, gamma_g2=G2 * gamma,
            delta_g2=G2 * delta, gamma_ABC=gamma_ABC)
        clock.lap("keygen_host_rest")
        return Groth16Keypair(pk=pk, vk=vk)

    # -- prover ----------------------------------------------------------------------
    def prover(self, pk, primary: list, auxiliary: list,
               seed: Optional[int] = None, timings: Optional[dict] = None):
        """Prove. timings: optional dict that receives wall seconds per
        phase (each phase ends with a device synchronize)."""
        clock = PhaseClock(timings, self.device)
        curve, r = self.curve, self.curve.r
        if seed is None:
            rnd_r = secrets.randbelow(r)
            rnd_s = secrets.randbelow(r)
        else:
            rng = random.Random(seed)
            rnd_r, rnd_s = rng.randrange(r), rng.randrange(r)

        dev = pk.r1cs_dev
        domain = self.domain_for(qap_domain, dev)
        full = [1] + [v % r for v in primary] + [v % r for v in auxiliary]
        assignment_mont = self.fr.encode(full)
        msm_c = default_window_bits(dev.num_variables + 1)
        clock.lap("prove_encode")

        H = qap_witness_map(dev, domain, assignment_mont)       # (N, m)
        H_plain = self.pad_to(self.fr.from_mont(H)[..., : domain.m - 1],
                              pk.H_query[0].shape[-1])
        assign_plain = self.fr.from_mont(assignment_mont)
        full_p = self.pad_to(assign_plain, pk.A_query[0].shape[-1])
        aux_plain = self.pad_to(assign_plain[..., dev.num_inputs + 1:],
                                pk.L_query[0].shape[-1])
        clock.lap("witness_map")

        At_a = self.msm_affine("g1", pk.A_query, full_p, msm_c)
        clock.lap("msm_A")
        Bt2_a = self.msm_affine("g2", pk.B_query_g2, full_p, msm_c)
        clock.lap("msm_B_g2")
        Bt1_a = self.msm_affine("g1", pk.B_query_g1, full_p, msm_c)
        clock.lap("msm_B_g1")
        Ht_a = self.msm_affine("g1", pk.H_query, H_plain, msm_c)
        clock.lap("msm_H")
        Lt_a = self.msm_affine("g1", pk.L_query, aux_plain, msm_c)
        clock.lap("msm_L")

        dec1, dec2 = self.decode_g1, self.decode_g2
        At, Bt1, Ht, Lt = dec1(At_a), dec1(Bt1_a), dec1(Ht_a), dec1(Lt_a)
        Bt2 = dec2(Bt2_a)

        # final combination (a handful of host ops, tcc:583-592)
        g_A = pk.alpha_g1 + At + pk.delta_g1 * rnd_r
        g_B = pk.beta_g2 + Bt2 + pk.delta_g2 * rnd_s
        g_B1 = pk.beta_g1 + Bt1 + pk.delta_g1 * rnd_s
        g_C = (Ht + Lt + g_A * rnd_s + g_B1 * rnd_r
               - pk.delta_g1 * (rnd_r * rnd_s % r))
        clock.lap("prove_host_combine")
        return Groth16Proof(g_A=g_A, g_B=g_B, g_C=g_C)

    # -- verifier -------------------------------------------------------------------------
    def verifier_strong_IC(self, vk, primary: list, proof) -> bool:
        if len(primary) + 1 != len(vk.gamma_ABC):
            return False
        return self.verifier_weak_IC(vk, primary, proof)

    def verifier_weak_IC(self, vk, primary: list, proof) -> bool:
        curve, r = self.curve, self.curve.r
        if len(primary) + 1 > len(vk.gamma_ABC):
            return False
        acc = vk.gamma_ABC[0]
        for i, x in enumerate(primary):
            acc = acc + vk.gamma_ABC[i + 1] * (x % r)
        if not (proof.g_A.is_well_formed() and proof.g_B.is_well_formed()
                and proof.g_C.is_well_formed()):
            return False
        # e(A, B) = e(alpha, beta) e(acc, gamma) e(C, delta)
        return curve.pairing_check([
            (proof.g_A, proof.g_B),
            (-vk.alpha_g1, vk.beta_g2),
            (-acc, vk.gamma_g2),
            (-proof.g_C, vk.delta_g2),
        ])

    # -- processed vk + online verifiers -----------------------------------------
    # (r1cs_gg_ppzksnark_verifier_process_vk / online_verifier_*_IC,
    # tcc:605-745: the e(alpha, beta) pairing and the G2 Miller-loop
    # embeddings leave the per-proof work)
    def verifier_process_vk(self, vk):
        eng = self.curve.pairing_engine
        return Groth16ProcessedVK(
            alpha_beta_gt=self.curve.pairing(vk.alpha_g1, vk.beta_g2),
            gamma_g2_precomp=eng.embed_g2(vk.gamma_g2),
            delta_g2_precomp=eng.embed_g2(vk.delta_g2),
            gamma_ABC=vk.gamma_ABC)

    def online_verifier_strong_IC(self, pvk, primary: list, proof) -> bool:
        if len(primary) + 1 != len(pvk.gamma_ABC):
            return False
        return self.online_verifier_weak_IC(pvk, primary, proof)

    def online_verifier_weak_IC(self, pvk, primary: list, proof) -> bool:
        r = self.curve.r
        eng = self.curve.pairing_engine
        if len(primary) + 1 > len(pvk.gamma_ABC):
            return False
        if not (proof.g_A.is_well_formed() and proof.g_B.is_well_formed()
                and proof.g_C.is_well_formed()):
            return False
        acc = pvk.gamma_ABC[0]
        for i, x in enumerate(primary):
            acc = acc + pvk.gamma_ABC[i + 1] * (x % r)
        # e(A, B) / (e(acc, gamma) e(C, delta)) == e(alpha, beta)
        f = eng.miller_loop(eng.embed_g2(proof.g_B), eng.embed_g1(proof.g_A))
        if not acc.is_zero():
            f = f * eng.miller_loop(pvk.gamma_g2_precomp,
                                    eng.embed_g1(-acc))
        if not proof.g_C.is_zero():
            f = f * eng.miller_loop(pvk.delta_g2_precomp,
                                    eng.embed_g1(-proof.g_C))
        return eng.final_exponentiation(f) == pvk.alpha_beta_gt

    def verifier_affine(self, vk, primary: list, proof) -> bool:
        """Affine-ate verifier (tcc:748-816). The host engine's Miller loop
        already works on affine embeddings, so this is the same
        computation, kept as its own entry point."""
        return self.verifier_strong_IC(vk, primary, proof)
