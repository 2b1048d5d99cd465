"""In-circuit Groth16 verifier (reference gadgetlib1/gadgets/verifiers/
r1cs_gg_ppzksnark_verifier_gadget.hpp:30-176, the recursion enabler).

Verifies a BLS12-377 Groth16 proof inside a circuit over
Fq(BLS12-377) = Fr(BW6-761): the "hardcoded vk" variant (vk elements
are circuit constants; the reference ships both variable-vk and
hardcoded-vk verifier gadgets -- the hardcoded one is what one-layer
composition uses).

Check: e(A, B) = e(alpha, beta) * e(acc, gamma) * e(C, delta)
  * e(alpha, beta): a constant GT factor folded in linearly
  * e(acc, gamma), e(C, delta): constant-Q Miller loops (linear lines)
  * e(A, B): the one fully-symbolic Miller loop
  * acc: IC accumulation over the public-input BITS with precomputed
    2^j * IC_i constant tables
"""
from __future__ import annotations

from typing import List

from .protoboard import Gadget, Protoboard, PBVariable, PBVariableArray
from .basic import generate_boolean_r1cs_constraint
from .fields_gadgets import _lc
from .pairing_gadgets import G1Gadgets, PairingGadgets
from .mnt_pairing_gadgets import make_pairing_gadgets


def check_proof_points_on_curve(pg, g1, curve, g1_points, g2_points,
                                ann="proofchk"):
    """On-curve constraints for allocated proof points (reference
    r1cs_gg_ppzksnark_proof_variable::generate_r1cs_constraints,
    r1cs_gg_ppzksnark_verifier_gadget.tcc:54-61: a G1_checker per G1
    proof point + a G2_checker on g_B; likewise
    r1cs_ppzksnark_verifier_gadget.hpp:52-53 for BCTV14's 7+1 points).
    A proof point off its curve makes the circuit UNSATISFIABLE -- the
    soundness precondition for the incomplete (witnessed-slope) adders
    and Miller-loop line functions downstream, which are only total on
    curve points."""
    from .curve_scalar_mul import G1Ops
    ops = G1Ops(g1, curve)
    for k, P in enumerate(g1_points):
        ops.checker(P, f"{ann}_g1_{k}")
    f = getattr(pg, "fpk", None) or pg.fp2
    for k, Q in enumerate(g2_points):
        # y^2 = x^3 + a2*x + b2 over the G2 coordinate field (degree-
        # generic: Fp2 for BLS12-377/MNT4, Fp3 for MNT6; a2 != 0 on the
        # MNT twists)
        rhs = f.add(f.mul(f.sqr(Q[0]), Q[0]), f.const(curve.b2))
        a2 = getattr(curve, "a2", None)
        if a2 is not None and not a2.is_zero():
            rhs = f.add(rhs, f.mul(f.const(a2), Q[0]))
        f.assert_eq(f.sqr(Q[1]), rhs, f"{ann}_g2_{k}")


class Groth16VerifierGadget:
    """Hardcoded-vk Groth16 verifier over the inner curve (any family
    with in-circuit pairing gadgets: BLS12-377-in-BW6-761 or either MNT
    cycle direction)."""

    def __init__(self, pb: Protoboard, inner_curve, vk,
                 input_bits: List[list], prefix="g16v"):
        """vk: proof_systems.groth16.Groth16VerificationKey (host points);
        input_bits[i] = bit array (LSB first) of public input i.
        Proof variables are allocated here; fill them with
        set_proof_witness(proof) before generate_witness()."""
        self.pb = pb
        self.curve = inner_curve
        self.vk = vk
        self.pg = make_pairing_gadgets(pb, inner_curve, prefix + ".pair")
        self.g1 = G1Gadgets(pb, prefix + ".g1",
                            a=int(getattr(inner_curve, "a", 0)))
        self.input_bits = input_bits
        self.proof_A = self.g1.alloc()
        self.proof_C = self.g1.alloc()
        self.proof_B, self._B_vars = self.pg.alloc_g2_point()
        self._build()

    def set_proof_witness(self, proof):
        pb = self.pb
        # proof_A/C are single-variable LCs
        for (lc_pair, pt) in ((self.proof_A, proof.g_A),
                              (self.proof_C, proof.g_C)):
            pb._values[lc_pair[0].terms[0].index] = int(pt.x) % pb.p
            pb._values[lc_pair[1].terms[0].index] = int(pt.y) % pb.p
        self.pg.set_g2_witness(self._B_vars, proof.g_B)

    def _build(self):
        pg, g1, pb = self.pg, self.g1, self.pb
        f12 = pg.fp12
        vk = self.vk
        curve = self.curve
        eng = curve.pairing_engine

        for bits in self.input_bits:
            for b in bits:
                generate_boolean_r1cs_constraint(pb, b, "g16v_input_bit")

        check_proof_points_on_curve(
            pg, g1, curve, [self.proof_A, self.proof_C], [self.proof_B],
            "g16v_proof")

        # ---- acc = IC[0] + sum_i sum_j bit_{i,j} 2^j IC[i+1] ---------------
        acc = g1.const(vk.gamma_ABC[0])
        for i, bits in enumerate(self.input_bits):
            base = vk.gamma_ABC[i + 1]
            T = base
            for j, bit in enumerate(bits):
                acc = g1.conditional_add_const(acc, bit, T)
                T = T + T
        self.acc = acc

        # ---- pairing product -------------------------------------------------
        # f = ML(B, A) * [const e_ml(-alpha, beta)] * ML_gamma(-acc)
        #     * ML_delta(-C); FE(f) == 1
        embA = pg.embed_g1(self.proof_A)
        embB = pg.embed_g2(self.proof_B)
        f = pg.miller_loop(embB, embA)
        const_ml = eng.miller_loop(eng.embed_g2(vk.beta_g2),
                                   eng.embed_g1(-vk.alpha_g1))
        f = pg.mul_const12(f, const_ml)
        f = f12.mul(f, pg.miller_loop_const_q(
            vk.gamma_g2, pg.embed_g1(g1.neg(acc))))
        f = f12.mul(f, pg.miller_loop_const_q(
            vk.delta_g2, pg.embed_g1(g1.neg(self.proof_C))))
        out = pg.final_exp(f)
        f12.assert_eq(out, f12.one(), "g16v_check")

    def generate_witness(self):
        """Run after set_proof_witness() and input bits are set."""
        self.g1.generate_witness()
        self.pg.generate_witness()


class Groth16VerificationKeyVariable:
    """vk as circuit VARIABLES (reference
    r1cs_ppzksnark_verifier_gadget.hpp:35-107
    r1cs_ppzksnark_verification_key_variable): alpha/beta/gamma/delta and
    the IC points are witness values, so one verifier circuit checks
    proofs under any vk -- the prerequisite for multi-predicate PCD,
    where the vk is fed in and its membership in a committed vk set is
    proven separately (mp_pcd_circuits.hpp:99-106).

    ``coordinate_lcs()`` exposes every field coordinate as an LC in a
    canonical order, for binding the vk to a hash / set-commitment leaf.
    """

    def __init__(self, pb, pg: "PairingGadgets", g1: "G1Gadgets",
                 num_inputs: int, prefix="vkvar"):
        self.pb = pb
        self.pg, self.g1 = pg, g1
        self.num_inputs = num_inputs
        self.alpha_g1 = g1.alloc()
        self._g2_vars = []
        self.beta_g2 = self._alloc_g2()
        self.gamma_g2 = self._alloc_g2()
        self.delta_g2 = self._alloc_g2()
        self.gamma_ABC = [g1.alloc() for _ in range(num_inputs + 1)]

    def _alloc_g2(self):
        pt, vars_ = self.pg.alloc_g2_point()
        self._g2_vars.append(vars_)
        return pt

    def set_witness(self, vk):
        pb = self.pb
        for (lc_pair, pt) in [(self.alpha_g1, vk.alpha_g1)] + list(
                zip(self.gamma_ABC, vk.gamma_ABC)):
            pb._values[lc_pair[0].terms[0].index] = int(pt.x) % pb.p
            pb._values[lc_pair[1].terms[0].index] = int(pt.y) % pb.p
        for vars_, pt in zip(self._g2_vars,
                             (vk.beta_g2, vk.gamma_g2, vk.delta_g2)):
            self.pg.set_g2_witness(vars_, pt)

    def coordinate_lcs(self):
        """All vk field coordinates as LCs, canonical order (G1 points
        as x,y; G2 points as x coords then y coords, degree-generic)."""
        out = [self.alpha_g1[0], self.alpha_g1[1]]
        for (x, y) in (self.beta_g2, self.gamma_g2, self.delta_g2):
            out += list(x) + list(y)
        for (x, y) in self.gamma_ABC:
            out += [x, y]
        return out


class Groth16VerifierGadgetVariableVK:
    """Groth16 verifier with the vk as witness (reference
    r1cs_ppzksnark_verifier_gadget.hpp:110-244). All four pairings run
    fully symbolic Miller loops; the IC accumulation doubles variable
    base points in-circuit.

    Check: ML(B, A) * ML(beta, -alpha) * ML(gamma, -acc) * ML(delta, -C)
    final-exponentiates to one."""

    def __init__(self, pb: Protoboard, inner_curve,
                 vk_var: Groth16VerificationKeyVariable,
                 input_bits: List[list], prefix="g16vv"):
        self.pb = pb
        self.curve = inner_curve
        self.vk = vk_var
        self.pg = vk_var.pg
        self.g1 = vk_var.g1
        self.input_bits = input_bits
        assert len(input_bits) == vk_var.num_inputs
        self.proof_A = self.g1.alloc()
        self.proof_C = self.g1.alloc()
        self.proof_B, self._B_vars = self.pg.alloc_g2_point()
        self._build()

    def set_proof_witness(self, proof):
        pb = self.pb
        for (lc_pair, pt) in ((self.proof_A, proof.g_A),
                              (self.proof_C, proof.g_C)):
            pb._values[lc_pair[0].terms[0].index] = int(pt.x) % pb.p
            pb._values[lc_pair[1].terms[0].index] = int(pt.y) % pb.p
        self.pg.set_g2_witness(self._B_vars, proof.g_B)

    def _build(self):
        pg, g1, pb = self.pg, self.g1, self.pb
        f12 = pg.fp12
        vk = self.vk

        for bits in self.input_bits:
            for b in bits:
                generate_boolean_r1cs_constraint(pb, b, "g16vv_input_bit")

        check_proof_points_on_curve(
            pg, g1, self.curve, [self.proof_A, self.proof_C],
            [self.proof_B], "g16vv_proof")

        # acc = IC[0] + sum_i sum_j bit_{i,j} * 2^j * IC[i+1]
        # (variable bases: in-circuit doubling ladder per input)
        acc = vk.gamma_ABC[0]
        for i, bits in enumerate(self.input_bits):
            T = vk.gamma_ABC[i + 1]
            for j, bit in enumerate(bits):
                acc = g1.conditional_add(acc, bit, T)
                if j + 1 < len(bits):
                    T = g1.dbl(T)
        self.acc = acc

        f = pg.miller_loop(pg.embed_g2(self.proof_B),
                           pg.embed_g1(self.proof_A))
        f = f12.mul(f, pg.miller_loop(
            pg.embed_g2(vk.beta_g2), pg.embed_g1(g1.neg(vk.alpha_g1))))
        f = f12.mul(f, pg.miller_loop(
            pg.embed_g2(vk.gamma_g2), pg.embed_g1(g1.neg(acc))))
        f = f12.mul(f, pg.miller_loop(
            pg.embed_g2(vk.delta_g2), pg.embed_g1(g1.neg(self.proof_C))))
        out = pg.final_exp(f)
        f12.assert_eq(out, f12.one(), "g16vv_check")

    def generate_witness(self):
        self.g1.generate_witness()
        self.pg.generate_witness()


# ---------------------------------------------------------------------------
# Processed-vk-variable verifier with a soft result bit (the MNT-cycle
# PCD's inner verifier: reference r1cs_sp_ppzkpcd compliance-step
# circuit, sp_pcd_circuits.tcc, where the translation vk is witness and
# verification yields a BIT so base-case incoming messages can skip it).
# ---------------------------------------------------------------------------

def processed_vk_host_coords(vk, curve):
    """Canonical flat ints of the PROCESSED vk: e(alpha,beta) GT coords,
    gamma_g2, delta_g2, gamma_ABC points (the host-side mirror of
    Groth16ProcessedVKVariable.coordinate_lcs, for statement hashing)."""
    eng = curve.pairing_engine
    e_ab = eng.pairing(vk.alpha_g1, vk.beta_g2)
    deg = getattr(curve, "g2_field_degree", 2)

    def ext_coords(c):
        if deg == 2:
            return [int(c.c0), int(c.c1)]
        return [int(c.c0), int(c.c1), int(c.c2)]

    out = []
    for half in (e_ab.c0, e_ab.c1):
        out += ext_coords(half)
    for pt in (vk.gamma_g2, vk.delta_g2):
        out += ext_coords(pt.x) + ext_coords(pt.y)
    for pt in vk.gamma_ABC:
        out += [int(pt.x), int(pt.y)]
    return out


class Groth16ProcessedVKVariable:
    """Processed vk as circuit VARIABLES: e(alpha,beta) in GT plus
    gamma/delta G2 and the IC points (the in-circuit analogue of
    verifier_process_vk, r1cs_gg_ppzksnark.tcc:605-621, shaped for
    vk-as-witness recursion)."""

    def __init__(self, pb, pg, g1, num_inputs: int, prefix="pvk"):
        self.pb, self.pg, self.g1 = pb, pg, g1
        self.num_inputs = num_inputs
        self.e_ab, self._eab_vars = pg.alloc_gt()
        self.gamma_g2, self._g_vars = pg.alloc_g2_point()
        self.delta_g2, self._d_vars = pg.alloc_g2_point()
        self.gamma_ABC = [g1.alloc() for _ in range(num_inputs + 1)]

    def set_witness(self, vk, curve):
        eng = curve.pairing_engine
        self.pg.set_gt_witness(self._eab_vars,
                               eng.pairing(vk.alpha_g1, vk.beta_g2))
        self.pg.set_g2_witness(self._g_vars, vk.gamma_g2)
        self.pg.set_g2_witness(self._d_vars, vk.delta_g2)
        for lc_pair, pt in zip(self.gamma_ABC, vk.gamma_ABC):
            self.pb._values[lc_pair[0].terms[0].index] = \
                int(pt.x) % self.pb.p
            self.pb._values[lc_pair[1].terms[0].index] = \
                int(pt.y) % self.pb.p

    def coordinate_lcs(self):
        """Flat coordinate LCs, canonical order matching
        processed_vk_host_coords."""
        out = list(self.pg.gt_coord_lcs(self.e_ab))
        for (x, y) in (self.gamma_g2, self.delta_g2):
            out += list(x) + list(y)
        for (x, y) in self.gamma_ABC:
            out += [x, y]
        return out


class Groth16VerifierGadgetSoft:
    """Verifier over a Groth16ProcessedVKVariable producing a RESULT BIT
    instead of asserting: result = [FE(ML(B,A) * ML(gamma,-acc) *
    ML(delta,-C)) == e_ab]. The PCD compliance circuit combines this
    with the base-case flag ((1-is_base)*(1-result) = 0)."""

    def __init__(self, pb: Protoboard, inner_curve, pvk, input_bits,
                 result, prefix="g16s", enforce_bits=True):
        self.pb = pb
        self.curve = inner_curve
        self.pvk = pvk
        self.pg, self.g1 = pvk.pg, pvk.g1
        self.result = result
        self.input_bits = input_bits
        assert len(input_bits) == pvk.num_inputs
        self.proof_A = self.g1.alloc()
        self.proof_C = self.g1.alloc()
        self.proof_B, self._B_vars = self.pg.alloc_g2_point()
        self._build(enforce_bits)

    def set_proof_witness(self, proof):
        pb = self.pb
        for (lc_pair, pt) in ((self.proof_A, proof.g_A),
                              (self.proof_C, proof.g_C)):
            pb._values[lc_pair[0].terms[0].index] = int(pt.x) % pb.p
            pb._values[lc_pair[1].terms[0].index] = int(pt.y) % pb.p
        self.pg.set_g2_witness(self._B_vars, proof.g_B)

    def _build(self, enforce_bits):
        pg, g1, pb = self.pg, self.g1, self.pb
        f12 = pg.fp12
        pvk = self.pvk

        if enforce_bits:
            for bits in self.input_bits:
                for b in bits:
                    generate_boolean_r1cs_constraint(pb, b, "g16s_bit")

        # proof points are HARD-constrained on-curve even though the
        # verification result is soft: base-case slots witness dummy
        # proofs made of generator points (reference proof_variable
        # checkers are likewise unconditional in the PCD compliance
        # circuits)
        check_proof_points_on_curve(
            pg, g1, self.curve, [self.proof_A, self.proof_C],
            [self.proof_B], "g16s_proof")

        # acc over VARIABLE IC bases (doubling ladder per input)
        acc = pvk.gamma_ABC[0]
        for i, bits in enumerate(self.input_bits):
            T = pvk.gamma_ABC[i + 1]
            for j, bit in enumerate(bits):
                acc = g1.conditional_add(acc, bit, T)
                if j + 1 < len(bits):
                    T = g1.dbl(T)
        self.acc = acc

        f = pg.miller_loop(pg.embed_g2(self.proof_B),
                           pg.embed_g1(self.proof_A))
        f = f12.mul(f, pg.miller_loop(
            pg.embed_g2(pvk.gamma_g2), pg.embed_g1(g1.neg(acc))))
        f = f12.mul(f, pg.miller_loop(
            pg.embed_g2(pvk.delta_g2), pg.embed_g1(g1.neg(self.proof_C))))
        out = pg.final_exp(f)
        self._soft_eq_gt(out, pvk.e_ab, self.result)

    def _soft_eq_gt(self, a, b, result):
        """result = [a == b] coordinate-wise: per-coordinate forced
        nonzero flags, then a forced is-zero bit on their sum."""
        pb, pg = self.pb, self.pg
        fpk = pg.fpk if hasattr(pg, "fpk") else pg.fp2
        a_lcs = pg.gt_coord_lcs(a)
        b_lcs = pg.gt_coord_lcs(b)
        from ..relations.variable import LinearCombination as LC
        nz_flags = []
        for k, (ai, bi) in enumerate(zip(a_lcs, b_lcs)):
            diff = ai - bi
            aux = fpk._var(f"seq_aux{k}")
            nz = fpk._var(f"seq_nz{k}")
            # diff*aux = nz ; diff*(1-nz) = 0  => nz forced to [diff!=0]
            pb.add_r1cs_constraint(diff, LC(aux), LC(nz), "seq_nz_a")
            pb.add_r1cs_constraint(diff, 1 - LC(nz), 0, "seq_nz_b")

            def wit(diff=diff, aux=aux, nz=nz):
                d = pb.lc_val(diff)
                if d == 0:
                    pb.setval(aux, 0)
                    pb.setval(nz, 0)
                else:
                    pb.setval(aux, pow(d, -1, pb.p))
                    pb.setval(nz, 1)
            fpk._wq.append(wit)
            nz_flags.append(nz)
        total = LC()
        for nz in nz_flags:
            total = total + LC(nz)
        aux2 = fpk._var("seq_aux_tot")
        # total*result = 0 ; total*aux2 = 1-result  => result = [total==0]
        pb.add_r1cs_constraint(total, LC._coerce(result), 0, "seq_res_a")
        pb.add_r1cs_constraint(total, LC(aux2),
                               1 - LC._coerce(result), "seq_res_b")

        def wit_total(total=total, aux2=aux2, result=result):
            t = pb.lc_val(total)
            if t == 0:
                pb.setval(aux2, 0)
                pb.setval(result, 1)
            else:
                pb.setval(aux2, pow(t, -1, pb.p))
                pb.setval(result, 0)
        fpk._wq.append(wit_total)

    def generate_witness(self):
        self.g1.generate_witness()
        self.pg.generate_witness()
