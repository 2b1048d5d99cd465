"""In-circuit BCTV14 verifier (reference gadgetlib1/gadgets/verifiers/
r1cs_ppzksnark_verifier_gadget.hpp:35-244 -- the original recursion
enabler; hardcoded-vk variant).

Verifies a BLS12-377 BCTV14 proof inside a circuit over
Fq(BLS12-377) = Fr(BW6-761). Five pairing checks
(r1cs_ppzksnark.tcc:707-814): knowledge commitments for A/B/C, QAP
divisibility, same-coefficient K check. vk elements are constants;
e-terms with constant G2 run the cheap constant-Q Miller loop; the
B-side terms (variable G2) and e(A+acc, B) run the symbolic loop.
"""
from __future__ import annotations

from typing import List

from .protoboard import Protoboard
from .basic import generate_boolean_r1cs_constraint
from .pairing_gadgets import G1Gadgets, PairingGadgets


class BCTV14VerifierGadget:
    """Hardcoded-vk r1cs_ppzksnark verifier over the inner curve."""

    def __init__(self, pb: Protoboard, inner_curve, vk,
                 input_bits: List[list], prefix="bctv14v"):
        """vk: proof_systems.bctv14.BCTV14VerificationKey (host points);
        input_bits[i]: LSB-first bit array of public input i. Proof
        variables are allocated here; fill with set_proof_witness()."""
        self.pb = pb
        self.curve = inner_curve
        self.vk = vk
        self.pg = PairingGadgets(pb, inner_curve, prefix + ".pair")
        self.g1 = G1Gadgets(pb, prefix + ".g1")
        self.input_bits = input_bits

        g1, pg = self.g1, self.pg
        self.A_g = g1.alloc()
        self.A_h = g1.alloc()
        self.C_g = g1.alloc()
        self.C_h = g1.alloc()
        self.B_h = g1.alloc()
        self.H = g1.alloc()
        self.K = g1.alloc()
        Bx, self._Bx_vars = pg.fp2.alloc_input()
        By, self._By_vars = pg.fp2.alloc_input()
        self.B_g = (Bx, By)
        self._build()

    def _build(self):
        pb, g1, pg = self.pb, self.g1, self.pg
        f12 = pg.fp12
        vk, curve = self.vk, self.curve
        G2_one = curve.G2.one()

        for bits in self.input_bits:
            for b in bits:
                generate_boolean_r1cs_constraint(pb, b, "bctv14v_bit")

        # proof-point well-formedness (reference
        # r1cs_ppzksnark_verifier_gadget.hpp:52-53: G1_checker on the 7
        # G1 proof points, G2_checker on g_B)
        from .verifier_gadgets import check_proof_points_on_curve
        check_proof_points_on_curve(
            pg, g1, curve,
            [self.A_g, self.A_h, self.C_g, self.C_h, self.B_h,
             self.H, self.K],
            [self.B_g], "bctv14v_proof")

        # acc: IC accumulation over input bits with constant tables
        # (encoded_IC_query base + rest)
        base = vk.encoded_IC_query.first
        rest = vk.encoded_IC_query.rest
        acc = g1.const(base)
        for i, bits in enumerate(self.input_bits):
            T = rest.values[i]
            for b in bits:
                acc = g1.conditional_add_const(acc, b, T)
                T = T + T
        self.acc = acc

        embB = pg.embed_g2(self.B_g)

        def check(pairs_const_q, pairs_sym, ann):
            """FE(prod MLs) == 1; pairs_const_q: (P_sym, Q_host);
            pairs_sym: (P_sym_or_const_embP, embQ_sym)."""
            f = None
            for P, Q_host in pairs_const_q:
                ml = pg.miller_loop_const_q(Q_host, pg.embed_g1(P))
                f = ml if f is None else f12.mul(f, ml)
            for embP, embQ in pairs_sym:
                ml = pg.miller_loop(embQ, embP)
                f = ml if f is None else f12.mul(f, ml)
            out = pg.final_exp(f)
            f12.assert_eq(out, f12.one(), ann)

        # 1. kc_A: e(A.g, alphaA_2) e(-A.h, 1_2) = 1
        check([(self.A_g, vk.alphaA_g2), (g1.neg(self.A_h), G2_one)], [],
              "kc_A")
        # 2. kc_B: e(alphaB_1, B.g) e(-B.h, 1_2) = 1
        check([(g1.neg(self.B_h), G2_one)],
              [(pg.embed_g1(g1.const(vk.alphaB_g1)), embB)], "kc_B")
        # 3. kc_C
        check([(self.C_g, vk.alphaC_g2), (g1.neg(self.C_h), G2_one)], [],
              "kc_C")
        # 4. QAP: e(A.g + acc, B.g) e(-H, rC_Z_2) e(-C.g, 1_2) = 1
        A_acc = g1.add(self.A_g, acc)
        check([(g1.neg(self.H), vk.rC_Z_g2),
               (g1.neg(self.C_g), G2_one)],
              [(pg.embed_g1(A_acc), embB)], "qap")
        # 5. K: e(K, gamma_2) e(-(A.g+acc+C.g), gamma_beta_2)
        #       e(-gamma_beta_1, B.g) = 1
        A_acc_C = g1.add(A_acc, self.C_g)
        check([(self.K, vk.gamma_g2),
               (g1.neg(A_acc_C), vk.gamma_beta_g2)],
              [(pg.embed_g1(g1.const(-vk.gamma_beta_g1)), embB)], "kcheck")

    def set_proof_witness(self, proof):
        pb = self.pb
        for lc_pair, pt in ((self.A_g, proof.g_A.g), (self.A_h, proof.g_A.h),
                            (self.C_g, proof.g_C.g), (self.C_h, proof.g_C.h),
                            (self.B_h, proof.g_B.h), (self.H, proof.g_H),
                            (self.K, proof.g_K)):
            pb._values[lc_pair[0].terms[0].index] = int(pt.x) % pb.p
            pb._values[lc_pair[1].terms[0].index] = int(pt.y) % pb.p
        pb.setval(self._Bx_vars[0], int(proof.g_B.g.x.c0))
        pb.setval(self._Bx_vars[1], int(proof.g_B.g.x.c1))
        pb.setval(self._By_vars[0], int(proof.g_B.g.y.c0))
        pb.setval(self._By_vars[1], int(proof.g_B.g.y.c1))

    def generate_witness(self):
        self.g1.generate_witness()
        self.pg.generate_witness()
