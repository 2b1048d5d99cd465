"""ADSNARK (BBFR15), proofs over authenticated data: the port of
libsnark_tpu/proof_systems/adsnark.py (reference zk_proof_systems/
ppzkadsnark/r1cs_ppzkadsnark/r1cs_ppzkadsnark.tcc: auth_generator :404,
auth_sign :420, auth_verify :447/:469, generator :490, prover :747,
verifiers :992/:1199).

A data authority MACs labelled data values (mu = PRF(label) + i * x,
Lambda = PRF(label) * G2, plus a signature on (label, Lambda) for PUBLIC
verifiability); the prover shows an R1CS holds over the authenticated
inputs without revealing them. Proof = BCTV14's 8 elements + the
knowledge commitment g_Aau over the authenticated inputs + muA.

Signatures (reference r1cs_ppzkadsnark_signature.hpp): Schnorr over the
SNARK curve's G1 with SHA-256 (the default), or RFC 8032 Ed25519
(``common/ed25519.py``) via ``ADSNARK(curve, sig_scheme="ed25519")``.
Both hash ``str()`` of host points, so the host points print exactly as
the JAX package's do.

On the card: the QAP evaluated at t (the device R1CS's transposed
products) and the eight queries by device fixed-base batch exp at keygen
(``madd_win`` over ``dbl_chain`` window tables), and at prove time the
ZK-patched QAP witness map and ten MSMs (BCTV14's eight plus A.g and A.h
over the input-only assignment). The authentication layer, muA, the final
sums and the verifiers (host pairings) run on the host. Seeds drive
``random.Random`` exactly as in the JAX package, so seeded keys, signatures
and proofs equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import List, Optional

import torch

from .base import PairingSystem, PhaseClock
from ..common.knowledge_commitment import KnowledgeCommitment
from ..ops.msm import default_window_bits
from ..reductions.r1cs_to_qap import (
    qap_domain, qap_instance_map_on_device, qap_witness_map_zk)

QUERIES = ("A_query_g", "A_query_h", "B_query_g", "B_query_h", "C_query_g",
           "C_query_h", "H_query", "K_query")


# ------------------------------------------------------------ signatures

class SchnorrSignature:
    """sigGen/sigSign/sigVerif/sigBatchVerif over curve.G1."""

    def __init__(self, curve):
        self.curve = curve

    def _hash(self, R, label: bytes, Lambda) -> int:
        h = hashlib.sha256()
        h.update(b"adsnark.schnorr")
        h.update(str(R).encode())
        h.update(label)
        h.update(str(Lambda).encode())
        return int.from_bytes(h.digest() + hashlib.sha256(
            h.digest()).digest(), "big") % self.curve.r

    def gen(self, rng):
        sk = rng.randrange(1, self.curve.r)
        return sk, self.curve.G1.one() * sk

    def sign(self, sk: int, label: bytes, Lambda, rng):
        r = self.curve.r
        k = rng.randrange(1, r)
        R = self.curve.G1.one() * k
        e = self._hash(R, label, Lambda)
        s = (k + e * sk) % r
        return (R, s)

    def verify(self, vk_pt, label: bytes, Lambda, sig) -> bool:
        R, s = sig
        e = self._hash(R, label, Lambda)
        return self.curve.G1.one() * s == R + vk_pt * e

    def batch_verify(self, vk_pt, labels, Lambdas, sigs) -> bool:
        return all(self.verify(vk_pt, l, L, s)
                   for l, L, s in zip(labels, Lambdas, sigs))


def prf_compute(seed: bytes, label: bytes, r: int) -> int:
    buf = b""
    i = 0
    nbytes = (r.bit_length() + 7) // 8 + 16
    while len(buf) < nbytes:
        buf += hashlib.sha256(b"adsnark.prf" + seed
                              + i.to_bytes(4, "big") + label).digest()
        i += 1
    return int.from_bytes(buf[:nbytes], "big") % r


# ------------------------------------------------------------ auth keys

@dataclasses.dataclass
class PubAuthPrms:
    I1: object                      # i * G1


@dataclasses.dataclass
class PubAuthKey:
    minusI2: object                 # -i * G2
    vkp: object                     # signature verification key


@dataclasses.dataclass
class SecAuthKey:
    i: int
    skp: int                        # signature signing key
    S: bytes                        # prf seed


@dataclasses.dataclass
class AuthKeys:
    pap: PubAuthPrms
    pak: PubAuthKey
    sak: SecAuthKey


@dataclasses.dataclass
class AuthData:
    mu: int
    Lambda: object                  # G2
    sigma: object


# ------------------------------------------------------------ key/proof

@dataclasses.dataclass
class ADSNARKProvingKey:
    A_query_g: tuple     # device affine G1, len nv+2 (with the Zt slot)
    A_query_h: tuple     # device affine G1 (alphaA shadow)
    B_query_g: tuple     # device affine G2
    B_query_h: tuple     # device affine G1
    C_query_g: tuple     # device affine G1
    C_query_h: tuple     # device affine G1
    H_query: tuple       # device affine G1, len m+1
    K_query: tuple       # device affine G1, len nv+4
    rA_i_Z_g1: object    # rA * Zt * I1 (host)
    r1cs_dev: object


@dataclasses.dataclass
class ADSNARKVerificationKey:
    alphaA_g2: object
    alphaB_g1: object
    alphaC_g2: object
    gamma_g2: object
    gamma_beta_g1: object
    gamma_beta_g2: object
    rC_Z_g2: object
    A0: object                      # rA * At[0] * G1
    Ain: list                       # rA * At[i] * G1 for inputs


@dataclasses.dataclass
class ADSNARKKeypair:
    pk: ADSNARKProvingKey
    vk: ADSNARKVerificationKey


@dataclasses.dataclass
class ADSNARKProof:
    g_A: KnowledgeCommitment
    g_B: KnowledgeCommitment
    g_C: KnowledgeCommitment
    g_H: object
    g_K: object
    g_Aau: KnowledgeCommitment
    muA: object

    def is_well_formed(self):
        return all(x.is_well_formed() for x in
                   (self.g_A, self.g_B, self.g_C, self.g_Aau)) \
            and self.g_H.is_well_formed() and self.g_K.is_well_formed() \
            and self.muA.is_well_formed()


class ADSNARK(PairingSystem):
    """r1cs_ppzkadsnark over a named curve."""

    def __init__(self, curve, device="cuda", msm_strategy="segments",
                 sig_scheme: str = "schnorr"):
        super().__init__(curve, device=device, msm_strategy=msm_strategy)
        if sig_scheme == "ed25519":
            from ..common.ed25519 import Ed25519Signature
            self.sig = Ed25519Signature(curve)
        else:
            self.sig = SchnorrSignature(curve)

    # -- authentication authority ------------------------------------------
    def auth_generator(self, seed: Optional[int] = None) -> AuthKeys:
        rng = random.Random(seed)
        sk_sig, vk_sig = self.sig.gen(rng)
        prf_seed = rng.getrandbits(256).to_bytes(32, "big")
        i = rng.randrange(1, self.curve.r)
        return AuthKeys(
            pap=PubAuthPrms(I1=self.curve.G1.one() * i),
            pak=PubAuthKey(minusI2=-(self.curve.G2.one() * i), vkp=vk_sig),
            sak=SecAuthKey(i=i, skp=sk_sig, S=prf_seed))

    def auth_sign(self, ins: List[int], sak: SecAuthKey,
                  labels: List[bytes], seed: Optional[int] = None):
        rng = random.Random(seed)
        r = self.curve.r
        out = []
        for x, label in zip(ins, labels):
            lam = prf_compute(sak.S, label, r)
            Lambda = self.curve.G2.one() * lam
            sigma = self.sig.sign(sak.skp, label, Lambda, rng)
            out.append(AuthData(mu=(lam + sak.i * x) % r, Lambda=Lambda,
                                sigma=sigma))
        return out

    def auth_verify_sec(self, data, auth_data, sak, labels) -> bool:
        r = self.curve.r
        return all(
            ad.mu == (prf_compute(sak.S, l, r) + sak.i * x) % r
            for x, ad, l in zip(data, auth_data, labels))

    def auth_verify_pub(self, data, auth_data, pak, labels) -> bool:
        G2 = self.curve.G2.one()
        for x, ad, l in zip(data, auth_data, labels):
            if G2 * ad.mu != ad.Lambda - pak.minusI2 * (x % self.curve.r):
                return False
            if not self.sig.verify(pak.vkp, l, ad.Lambda, ad.sigma):
                return False
        return True

    # -- generator ------------------------------------------------------------
    def generator(self, cs, prms: PubAuthPrms, seed: Optional[int] = None,
                  timings: Optional[dict] = None):
        """Trusted setup; timings: optional dict of wall seconds per phase."""
        rand = self._rng(seed)
        return self.generator_from_secrets(
            cs, prms, *[rand() for _ in range(8)], timings=timings)

    def generator_from_secrets(self, cs, prms, t, alphaA, alphaB, alphaC,
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
        Kt = [beta * (rA * At[i] + rB * Bt[i] + rC * Ct[i]) % r
              for i in range(nv + 1)]
        Kt += [beta * rA * qap.Zt % r, beta * rB * qap.Zt % r,
               beta * rC * qap.Zt % r]
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

        pk = ADSNARKProvingKey(rA_i_Z_g1=prms.I1 * (rA * qap.Zt % r),
                               r1cs_dev=r1cs_dev,
                               **queries)
        vk = ADSNARKVerificationKey(
            alphaA_g2=G2 * alphaA, alphaB_g1=G1 * alphaB,
            alphaC_g2=G2 * alphaC, gamma_g2=G2 * gamma,
            gamma_beta_g1=G1 * (gamma * beta % r),
            gamma_beta_g2=G2 * (gamma * beta % r),
            rC_Z_g2=G2 * (rC * qap.Zt % r),
            A0=G1 * (rA * At[0] % r),
            Ain=[G1 * (rA * At[1 + i] % r) for i in range(k)])
        clock.lap("keygen_host_rest")
        return ADSNARKKeypair(pk=pk, vk=vk)

    # -- prover ------------------------------------------------------------------
    def prover(self, pk, primary: list, auxiliary: list,
               auth_data: List[AuthData], seed: Optional[int] = None,
               timings: Optional[dict] = None):
        """Prove over the authenticated inputs ``primary``; timings:
        optional dict of wall seconds per phase (each ended by a device
        synchronize)."""
        clock = PhaseClock(timings, self.device)
        curve, r = self.curve, self.curve.r
        rand = self._rng(seed)
        d1, d2, d3, dauth = rand(), rand(), rand(), rand()

        dev = pk.r1cs_dev
        domain = self.domain_for(qap_domain, dev)
        nv, k = dev.num_variables, dev.num_inputs
        full = [1] + [v % r for v in primary] + [v % r for v in auxiliary]
        assignment_mont = self.fr.encode(full)
        # the A shift of the witness map is the full d1 + dauth
        d_m = self.fr.encode([(d1 + dauth) % r, d2, d3])
        msm_c = default_window_bits(nv + 1)
        clock.lap("prove_encode")

        H = qap_witness_map_zk(dev, domain, assignment_mont, d_m[:, 0:1],
                               d_m[:, 1:2], d_m[:, 2:3])
        H_plain = self.pad_to(self.fr.from_mont(H), pk.H_query[0].shape[-1])
        assign_plain = self.fr.from_mont(assignment_mont)
        # three copies of the assignment, each a new tensor: aux-only (A),
        # input-only without the constant (A over the inputs), full (B, C,
        # K); lanes past nv take scalar zero
        N = assign_plain.shape[0]
        zeros = lambda n: assign_plain.new_zeros((N, n))
        aux_only = torch.cat([zeros(k + 1), assign_plain[:, k + 1:]], dim=-1)
        in_only = torch.cat([zeros(1), assign_plain[:, 1:k + 1],
                             zeros(nv - k)], dim=-1)
        w = pk.A_query_g[0].shape[-1]
        full_p, aux_p, in_p = (self.pad_to(a, w) for a in
                               (assign_plain, aux_only, in_only))
        kfull_p = self.pad_to(assign_plain, pk.K_query[0].shape[-1])
        clock.lap("witness_map")

        msm = {}
        for name, query, which, sc in (
                ("A_g", "A_query_g", "g1", aux_p),
                ("A_h", "A_query_h", "g1", aux_p),
                ("Ain_g", "A_query_g", "g1", in_p),
                ("Ain_h", "A_query_h", "g1", in_p),
                ("B_g", "B_query_g", "g2", full_p),
                ("B_h", "B_query_h", "g1", full_p),
                ("C_g", "C_query_g", "g1", full_p),
                ("C_h", "C_query_h", "g1", full_p),
                ("H", "H_query", "g1", H_plain),
                ("K", "K_query", "g1", kfull_p)):
            msm[name] = self.msm_affine(which, getattr(pk, query), sc, msm_c)
            clock.lap("msm_" + name)

        dec1, dec2 = self.decode_g1, self.decode_g2
        zt = nv + 1   # the Zt lane of the A/B/C queries (they are padded)
        g_A = KnowledgeCommitment(
            dec1(msm["A_g"]) + dec1(pk.A_query_g, lane=zt) * d1,
            dec1(msm["A_h"]) + dec1(pk.A_query_h, lane=zt) * d1)
        g_Aau = KnowledgeCommitment(
            dec1(msm["Ain_g"]) + dec1(pk.A_query_g, lane=zt) * dauth,
            dec1(msm["Ain_h"]) + dec1(pk.A_query_h, lane=zt) * dauth)
        g_B = KnowledgeCommitment(
            dec2(msm["B_g"]) + dec2(pk.B_query_g, lane=zt) * d2,
            dec1(msm["B_h"]) + dec1(pk.B_query_h, lane=zt) * d2)
        g_C = KnowledgeCommitment(
            dec1(msm["C_g"]) + dec1(pk.C_query_g, lane=zt) * d3,
            dec1(msm["C_h"]) + dec1(pk.C_query_h, lane=zt) * d3)
        # the K query's ZK terms sit at lanes nv+1, nv+2, nv+3; its A slot
        # carries the FULL A shift d1 + dauth, as the witness map does
        # (reference tcc:788-791)
        g_K = dec1(msm["K"])
        for i, d in enumerate(((d1 + dauth) % r, d2, d3)):
            g_K = g_K + dec1(pk.K_query, lane=zt + i) * d

        # muA = dauth * rA_i_Z_g1 + sum mu_i * Ain_i (host, k terms)
        muA = pk.rA_i_Z_g1 * dauth
        for i, ad in enumerate(auth_data[:k]):
            muA = muA + dec1(pk.A_query_g, lane=1 + i) * ad.mu
        proof = ADSNARKProof(g_A=g_A, g_B=g_B, g_C=g_C, g_H=dec1(msm["H"]),
                             g_K=g_K, g_Aau=g_Aau, muA=muA)
        clock.lap("prove_host_combine")
        return proof

    # -- verifiers -------------------------------------------------------------
    def _kc_and_qap_checks(self, vk, proof) -> bool:
        curve = self.curve
        G2_one = curve.G2.one()
        checks = [
            curve.pairing_check([(proof.g_Aau.g, vk.alphaA_g2),
                                 (-proof.g_Aau.h, G2_one)]),
            curve.pairing_check([(proof.g_A.g, vk.alphaA_g2),
                                 (-proof.g_A.h, G2_one)]),
            curve.pairing_check([(vk.alphaB_g1, proof.g_B.g),
                                 (-proof.g_B.h, G2_one)]),
            curve.pairing_check([(proof.g_C.g, vk.alphaC_g2),
                                 (-proof.g_C.h, G2_one)]),
        ]
        Aacc = vk.A0 + proof.g_Aau.g + proof.g_A.g
        checks.append(curve.pairing_check([
            (Aacc, proof.g_B.g),
            (-proof.g_H, vk.rC_Z_g2),
            (-proof.g_C.g, G2_one)]))
        checks.append(curve.pairing_check([
            (proof.g_K, vk.gamma_g2),
            (-(Aacc + proof.g_C.g), vk.gamma_beta_g2),
            (-vk.gamma_beta_g1, proof.g_B.g)]))
        return all(checks)

    def verifier_sec(self, vk, proof, sak: SecAuthKey,
                     labels: List[bytes]) -> bool:
        """Symmetric (designated-verifier) verification (tcc:992)."""
        r = self.curve.r
        if not proof.is_well_formed():
            return False
        lambdas = [prf_compute(sak.S, l, r) for l in labels]
        prodA = proof.g_Aau.g * sak.i
        for lam, P in zip(lambdas, vk.Ain):
            prodA = prodA + P * lam
        if prodA != proof.muA:
            return False
        return self._kc_and_qap_checks(vk, proof)

    def verifier_pub(self, vk, auth_data: List[AuthData], proof,
                     pak: PubAuthKey, labels: List[bytes]) -> bool:
        """Public verification (tcc:1199)."""
        curve = self.curve
        if not proof.is_well_formed():
            return False
        if not self.sig.batch_verify(pak.vkp, labels,
                                     [a.Lambda for a in auth_data],
                                     [a.sigma for a in auth_data]):
            return False
        # prod e(Ain_i, Lambda_i) = e(muA, G2) * e(Aau.g, -I2)
        pairs = [(P, ad.Lambda) for P, ad in zip(vk.Ain, auth_data)]
        pairs += [(-proof.muA, curve.G2.one()),
                  (-proof.g_Aau.g, pak.minusI2)]
        if not curve.pairing_check(pairs):
            return False
        return self._kc_and_qap_checks(vk, proof)
