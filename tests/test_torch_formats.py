"""The port's host formats (serialization.Codec with its cycle-proof and
RAM-message codecs, libsnark_compat.LibsnarkCompatCodec,
compat_spec_decoder.SpecDecoder) and default_types against the JAX
package's, bytes for bytes, on the CPU; and the host checks that the
recursion gadgets mirror (kzg10_verifier_gadget, bctv14_verifier_gadget):
their natively checked trapdoor cases.

Every key, proof and point is built from integers on the host (scalar
multiples of the generators, trapdoor proofs), in both packages alike: no
prover runs, so no XLA compile lands here. RUN_SLOW=1 adds the two
verifier gadgets' boards (BLS12-377 inside Fr(BW6-761)) against the JAX
package's. Tolerance: zero.
"""
import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import compat_spec_decoder as jax_decoder
from libsnark_tpu import default_types as jax_default_types
from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu import libsnark_compat as jax_compat
from libsnark_tpu import serialization as jax_ser
from libsnark_tpu.common import knowledge_commitment as jax_kc
from libsnark_tpu.common import sparse_vector as jax_sv
from libsnark_tpu.proof_systems import bctv14 as jax_bctv14
from libsnark_tpu.proof_systems import compliance_predicate as jax_cp
from libsnark_tpu.proof_systems import groth16 as jax_groth16
from libsnark_tpu.proof_systems import pcd_cycle as jax_pcd_cycle
from libsnark_tpu.proof_systems import ram_zksnark as jax_rz
from libsnark_tpu.relations import examples as jax_examples

from libsnark_tpu_torch import compat_spec_decoder, default_types
from libsnark_tpu_torch import get_curve, libsnark_compat, serialization
from libsnark_tpu_torch.common import knowledge_commitment, sparse_vector
from libsnark_tpu_torch.proof_systems import (
    bctv14, compliance_predicate, groth16, pcd_cycle, ram_zksnark)
from libsnark_tpu_torch.relations import examples

from _torch_port import coords

CURVES = ("alt_bn128", "bls12_377", "bw6_761", "mnt4", "mnt6", "edwards")
# the libsnark text grammar writes G2 over Fq2 only
COMPAT_CURVES = ("alt_bn128", "bls12_377", "mnt4")
MODES = [(mode, mont, comp) for mode in ("text", "binary")
         for mont in (False, True) for comp in (False, True)]
PORT = dict(ser=serialization, compat=libsnark_compat, g16=groth16,
            bctv14=bctv14, kc=knowledge_commitment, sv=sparse_vector,
            cp=compliance_predicate, pcd_cycle=pcd_cycle, rz=ram_zksnark,
            examples=examples, decoder=compat_spec_decoder,
            get_curve=get_curve)
JAX = dict(ser=jax_ser, compat=jax_compat, g16=jax_groth16,
           bctv14=jax_bctv14, kc=jax_kc, sv=jax_sv, cp=jax_cp,
           pcd_cycle=jax_pcd_cycle, rz=jax_rz, examples=jax_examples,
           decoder=jax_decoder, get_curve=jax_get_curve)


def objects(pkg: dict, name: str):
    """Host objects of one curve built from integers alike in either
    package: G1 / G2 points (infinity among them), a Groth16 vk (gamma =
    1, the libsnark grammar's) and proof, a BCTV14 vk and proof, a
    constraint system."""
    c = pkg["get_curve"](name)
    G1, G2 = c.G1.one(), c.G2.one()
    g16, bc, kc, sv = pkg["g16"], pkg["bctv14"], pkg["kc"], pkg["sv"]
    vk = g16.Groth16VerificationKey(
        alpha_g1=G1 * 3, beta_g2=G2 * 5, gamma_g2=G2, delta_g2=G2 * 7,
        gamma_ABC=[G1 * 11, G1 * 13, c.G1.zero()])
    proof = g16.Groth16Proof(g_A=G1 * 17, g_B=G2 * 19, g_C=G1 * 23)
    bvk = bc.BCTV14VerificationKey(
        alphaA_g2=G2 * 3, alphaB_g1=G1 * 5, alphaC_g2=G2 * 7,
        gamma_g2=G2 * 11, gamma_beta_g1=G1 * 13, gamma_beta_g2=G2 * 17,
        rC_Z_g2=G2 * 19,
        encoded_IC_query=sv.AccumulationVector(
            first=G1 * 23, rest=sv.SparseVector([0, 2], [G1 * 29, G1 * 31],
                                                3)))
    bproof = bc.BCTV14Proof(
        g_A=kc.KnowledgeCommitment(G1 * 2, G1 * 4),
        g_B=kc.KnowledgeCommitment(G2 * 6, G1 * 8),
        g_C=kc.KnowledgeCommitment(G1 * 10, G1 * 12),
        g_H=G1 * 14, g_K=c.G1.zero())
    cs, _, _ = pkg["examples"].generate_r1cs_example(c.r, 5, 2)
    return dict(curve=c, g1=[c.G1.zero(), G1, G1 * 12345],
                g2=[c.G2.zero(), G2, G2 * 777], vk=vk, proof=proof,
                bvk=bvk, bproof=bproof, cs=cs)


def both(name):
    return objects(PORT, name), objects(JAX, name)


def dump(codec, write, obj):
    return codec.dumps(write, obj)


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("mode,mont,compress", MODES)
def test_codec_bytes_equal_jax(name, mode, mont, compress):
    """serialization.Codec on every curve and mode: the bytes of points,
    scalars, a Groth16 vk and proof, a BCTV14 vk and proof and a
    constraint system equal the JAX package's; reading them back gives
    the same integers."""
    port, jax = both(name)
    c = serialization.Codec(port["curve"], mode=mode, montgomery=mont,
                            compress=compress)
    jc = jax_ser.Codec(jax["curve"], mode=mode, montgomery=mont,
                       compress=compress)
    for kind, write, read in (("g1", "write_g1", "read_g1"),
                              ("g2", "write_g2", "read_g2")):
        for P, jP in zip(port[kind], jax[kind]):
            data = dump(c, getattr(c, write), P)
            assert data == dump(jc, getattr(jc, write), jP)
            assert coords(c.loads(getattr(c, read), data)) == coords(P)
    r = port["curve"].r
    vs = [0, 1, r - 1, 123456789]
    data = dump(c, c.write_fr_vector, vs)
    assert data == dump(jc, jc.write_fr_vector, vs)
    assert c.loads(c.read_fr_vector, data) == vs
    for kind, write, read in (("vk", "write_groth16_vk", "read_groth16_vk"),
                              ("proof", "write_groth16_proof",
                               "read_groth16_proof"),
                              ("bvk", "write_bctv14_vk", "read_bctv14_vk"),
                              ("bproof", "write_bctv14_proof",
                               "read_bctv14_proof")):
        data = dump(c, getattr(c, write), port[kind])
        assert data == dump(jc, getattr(jc, write), jax[kind])
        assert coords(c.loads(getattr(c, read), data)) == coords(port[kind])
    data = dump(c, c.write_r1cs, port["cs"])
    assert data == dump(jc, jc.write_r1cs, jax["cs"])
    assert c.loads(c.read_r1cs, data) == port["cs"]


@pytest.mark.parametrize("mode", ["text", "binary"])
def test_cycle_pcd_proof_and_ram_message_codecs(mode):
    """The two-curve composites: a cycle PCD proof (the message over
    MNT4's r, the translation proof over MNT6) and a RAM PCD message
    written by both packages' codecs give equal bytes and read back
    equal."""
    A, B = get_curve("mnt4"), get_curve("mnt6")
    jA, jB = jax_get_curve("mnt4"), jax_get_curve("mnt6")
    ca, cb = (serialization.Codec(x, mode=mode) for x in (A, B))
    jca, jcb = (jax_ser.Codec(x, mode=mode) for x in (jA, jB))
    payload = [15, 2, A.r - 1]
    proof = pcd_cycle.CyclePCDProof(
        msg=compliance_predicate.PCDMessage(1, payload),
        translation_proof=groth16.Groth16Proof(
            g_A=B.G1.one() * 3, g_B=B.G2.one() * 5, g_C=B.G1.one() * 7))
    jproof = jax_pcd_cycle.CyclePCDProof(
        msg=jax_cp.PCDMessage(1, payload),
        translation_proof=jax_groth16.Groth16Proof(
            g_A=jB.G1.one() * 3, g_B=jB.G2.one() * 5, g_C=jB.G1.one() * 7))

    def dump_cycle(write, c1, c2, obj):
        import io
        buf = io.BytesIO()
        write(c1, c2, buf, obj)
        return buf.getvalue()

    data = dump_cycle(serialization.write_cycle_pcd_proof, ca, cb, proof)
    assert data == dump_cycle(jax_ser.write_cycle_pcd_proof, jca, jcb,
                              jproof)
    import io
    back = serialization.read_cycle_pcd_proof(ca, cb, io.BytesIO(data))
    assert isinstance(back, pcd_cycle.CyclePCDProof)
    assert (back.msg.type, back.msg.payload) == (1, payload)
    assert coords(back.translation_proof) == coords(proof.translation_proof)

    rng = random.Random(5)
    fields = dict(timestamp=7, pc_addr=3, flag=1, has_accepted=1,
                  pc_addr_initial=0, flag_initial=0, regs=[1, 2, 3, 4],
                  regs_initial=[0, 0, 0, 0],
                  root=[rng.randrange(2) for _ in range(298)],
                  root_initial=[rng.randrange(2) for _ in range(298)])
    msg = ram_zksnark.RamPCDMessage(**fields)
    jmsg = jax_rz.RamPCDMessage(**fields)
    buf, jbuf = io.BytesIO(), io.BytesIO()
    serialization.write_ram_pcd_message(ca, buf, msg)
    jax_ser.write_ram_pcd_message(jca, jbuf, jmsg)
    assert buf.getvalue() == jbuf.getvalue()
    assert serialization.read_ram_pcd_message(
        ca, io.BytesIO(buf.getvalue())) == msg


@pytest.mark.parametrize("name", COMPAT_CURVES)
def test_libsnark_compat_bytes_equal_jax(name):
    """LibsnarkCompatCodec: the libsnark text grammar of G1 / G2 points, a
    gamma = 1 Groth16 vk, a proof and a constraint system equals the JAX
    package's and reads back; a vk with gamma != 1 is refused alike."""
    port, jax = both(name)
    c = libsnark_compat.LibsnarkCompatCodec(port["curve"])
    jc = jax_compat.LibsnarkCompatCodec(jax["curve"])
    for kind, write, read in (("g1", "write_g1", "read_g1"),
                              ("g2", "write_g2", "read_g2")):
        for P, jP in zip(port[kind], jax[kind]):
            data = c.dumps(getattr(c, write), P)
            assert data == jc.dumps(getattr(jc, write), jP)
            assert coords(c.loads(getattr(c, read), data)) == coords(P)
    for kind, write, read in (("vk", "write_groth16_vk", "read_groth16_vk"),
                              ("proof", "write_groth16_proof",
                               "read_groth16_proof")):
        data = c.dumps(getattr(c, write), port[kind])
        assert data == jc.dumps(getattr(jc, write), jax[kind])
        assert coords(c.loads(getattr(c, read), data)) == coords(port[kind])
    data = c.dumps(c.write_r1cs, port["cs"])
    assert data == jc.dumps(jc.write_r1cs, jax["cs"])
    assert c.dumps(c.write_r1cs, c.loads(c.read_r1cs, data)) == data
    bad = dataclasses.replace(port["vk"],
                              gamma_g2=port["curve"].G2.one() * 7)
    with pytest.raises(ValueError):
        c.dumps(c.write_groth16_vk, bad)


def test_golden_vectors_and_spec_decoder():
    """The committed golden files (tests/golden, the JAX package's
    grammar) come out of the port's codec byte for byte from the same
    trapdoor vk and proof (gamma = 1) over alt_bn128, and the port's
    from-spec decoder reads them into the same objects as the JAX
    package's; the decoded proof verifies under the decoded vk."""
    import os
    golden = os.path.join(os.path.dirname(__file__), "golden")
    curve = get_curve("alt_bn128")
    cs, primary, aux = examples.generate_r1cs_example(curve.r, 5, 2)
    vk, proof = trapdoor_gamma1(curve, cs, primary, aux)
    c = libsnark_compat.LibsnarkCompatCodec(curve)
    blobs = {"groth16_vk.txt": c.dumps(c.write_groth16_vk, vk),
             "groth16_proof.txt": c.dumps(c.write_groth16_proof, proof),
             "r1cs.txt": c.dumps(c.write_r1cs, cs)}
    for name, data in blobs.items():
        with open(os.path.join(golden, name)) as f:
            assert f.read() == data, name
    dec, jdec = compat_spec_decoder.SpecDecoder(), jax_decoder.SpecDecoder()
    for name, fn in (("groth16_vk.txt", "verification_key"),
                     ("groth16_proof.txt", "proof"),
                     ("r1cs.txt", "constraint_system")):
        got = getattr(dec, fn)(compat_spec_decoder.SpecStream(blobs[name]))
        want = getattr(jdec, fn)(jax_decoder.SpecStream(blobs[name]))
        assert plain_spec(got) == plain_spec(want)
    vk_s = dec.verification_key(compat_spec_decoder.SpecStream(
        blobs["groth16_vk.txt"]))
    pr_s = dec.proof(compat_spec_decoder.SpecStream(
        blobs["groth16_proof.txt"]))
    vk2 = c.loads(c.read_groth16_vk, blobs["groth16_vk.txt"])
    assert plain_spec(vk_s.alpha_g1) == (False, int(vk2.alpha_g1.x),
                                         int(vk2.alpha_g1.y))
    g16 = groth16.Groth16(curve, device="cpu")
    proof2 = c.loads(c.read_groth16_proof, blobs["groth16_proof.txt"])
    assert plain_spec(pr_s.g_A)[1:] == (int(proof2.g_A.x),
                                        int(proof2.g_A.y))
    assert g16.verifier_strong_IC(vk2, primary, proof2)
    assert not g16.verifier_strong_IC(vk2, [primary[0] + 1, primary[1]],
                                      proof2)


def plain_spec(x):
    """The decoder's dataclasses as plain tuples (both packages define
    their own classes)."""
    if dataclasses.is_dataclass(x):
        return tuple(plain_spec(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(plain_spec(v) for v in x)
    return x


def trapdoor_gamma1(curve, cs, primary, aux, seed=1234):
    """tests/test_serialization_compat.py's _trapdoor_gamma1 on the port's
    QAP code: a host (vk, proof) with gamma = 1."""
    from libsnark_tpu_torch.ops.fp import FpKernel
    from libsnark_tpu_torch.reductions.r1cs_to_qap import (
        qap_domain, qap_instance_map_with_evaluation)
    rng = random.Random(seed)
    r = curve.r
    t, alpha, beta, delta, rr, ss = (rng.randrange(1, r) for _ in range(6))
    fr = FpKernel(curve.fr_params, "cpu")
    domain = qap_domain(fr, curve.fr_params, cs)
    qap = qap_instance_map_with_evaluation(cs, domain, t)
    full = [1] + [v % r for v in primary] + [v % r for v in aux]
    k = cs.num_inputs
    A_e = (alpha + sum(s * a for s, a in zip(full, qap.At)) + rr * delta) % r
    B_e = (beta + sum(s * b for s, b in zip(full, qap.Bt)) + ss * delta) % r
    pub_e = sum(full[i] * (beta * qap.At[i] + alpha * qap.Bt[i] + qap.Ct[i])
                for i in range(k + 1)) % r
    C_e = (A_e * B_e - alpha * beta - pub_e) * pow(delta, -1, r) % r
    G1, G2 = curve.G1.one(), curve.G2.one()
    vk = groth16.Groth16VerificationKey(
        alpha_g1=G1 * alpha, beta_g2=G2 * beta, gamma_g2=G2,
        delta_g2=G2 * delta,
        gamma_ABC=[G1 * ((beta * qap.At[i] + alpha * qap.Bt[i] + qap.Ct[i])
                         % r) for i in range(k + 1)])
    proof = groth16.Groth16Proof(g_A=G1 * A_e, g_B=G2 * B_e, g_C=G1 * C_e)
    return vk, proof


def test_default_types_equal_jax():
    """default_types' bundles name the same curves and scalar fields as
    the JAX package's: the PCD cycle MNT4 -> MNT6 (Fr swapped across it),
    the RAM bundles, the per-system defaults."""
    cyc, jcyc = (m.default_r1cs_ppzkpcd_pp() for m in (default_types,
                                                       jax_default_types))
    assert (cyc.curve_A.name, cyc.curve_B.name) == (
        jcyc.curve_A.name, jcyc.curve_B.name) == ("mnt4", "mnt6")
    assert cyc.scalar_field_A == jcyc.scalar_field_A == cyc.curve_B.q
    assert cyc.scalar_field_B == jcyc.scalar_field_B == cyc.curve_A.q
    for fn in ("default_ram_ppzksnark_pp", "default_ram_zksnark_pp",
               "default_tinyram_ppzksnark_pp", "default_tinyram_zksnark_pp"):
        b, jb = getattr(default_types, fn)(), getattr(jax_default_types,
                                                      fn)()
        assert (b.machine_field, b.snark_curve.name) == (
            jb.machine_field, jb.snark_curve.name)
        assert (b.cycle is None) == (jb.cycle is None)
    for fn in ("default_ec_pp", "default_r1cs_gg_ppzksnark_pp",
               "default_r1cs_ppzksnark_pp", "default_r1cs_se_ppzksnark_pp",
               "default_uscs_ppzksnark_pp", "default_bacs_ppzksnark_pp",
               "default_tbcs_ppzksnark_pp", "default_r1cs_ppzkadsnark_pp"):
        assert getattr(default_types, fn)().name == getattr(
            jax_default_types, fn)().name == "alt_bn128"


# ------------------------------------------- the recursion gadgets' checks

def trapdoor_bctv14(mod, curve, cs, primary, aux, seed=77):
    """tests/test_bctv14_verifier_gadget.py's _trapdoor_bctv14 over either
    package's classes (mod: PORT or JAX) on the port's QAP code (cs: the
    port's system): the same integers, so the same points."""
    from libsnark_tpu_torch.ops.fp import FpKernel
    from libsnark_tpu_torch.reductions.r1cs_to_qap import (
        qap_domain, qap_instance_map_with_evaluation)
    rng = random.Random(seed)
    r = curve.r
    t, aA, aB, aC, rA, rB, beta, gamma = (rng.randrange(1, r)
                                          for _ in range(8))
    rC = rA * rB % r
    pcurve = get_curve(curve.name)
    fr = FpKernel(pcurve.fr_params, "cpu")
    domain = qap_domain(fr, pcurve.fr_params, cs)
    qap = qap_instance_map_with_evaluation(cs, domain, t)
    k, nv = cs.num_inputs, cs.num_variables
    full = [1] + [v % r for v in primary] + [v % r for v in aux]
    G1, G2 = curve.G1.one(), curve.G2.one()
    a_aux = sum(full[i] * qap.At[i] for i in range(k + 1, nv + 1)) % r
    a_full = sum(full[i] * qap.At[i] for i in range(nv + 1)) % r
    b_e = sum(full[i] * qap.Bt[i] for i in range(nv + 1)) % r
    c_e = sum(full[i] * qap.Ct[i] for i in range(nv + 1)) % r
    h_e = (a_full * b_e - c_e) * pow(qap.Zt, -1, r) % r
    k_e = beta * (rA * a_full + rB * b_e + rC * c_e) % r
    KC = mod["kc"].KnowledgeCommitment
    proof = mod["bctv14"].BCTV14Proof(
        g_A=KC(G1 * (rA * a_aux % r), G1 * (rA * aA * a_aux % r)),
        g_B=KC(G2 * (rB * b_e % r), G1 * (rB * aB * b_e % r)),
        g_C=KC(G1 * (rC * c_e % r), G1 * (rC * aC * c_e % r)),
        g_H=G1 * h_e, g_K=G1 * k_e)
    vk = mod["bctv14"].BCTV14VerificationKey(
        alphaA_g2=G2 * aA, alphaB_g1=G1 * aB, alphaC_g2=G2 * aC,
        gamma_g2=G2 * gamma, gamma_beta_g1=G1 * (gamma * beta % r),
        gamma_beta_g2=G2 * (gamma * beta % r),
        rC_Z_g2=G2 * (rC * qap.Zt % r),
        encoded_IC_query=mod["sv"].AccumulationVector.from_values(
            G1 * (rA * qap.At[0] % r),
            [G1 * (rA * qap.At[i] % r) for i in range(1, k + 1)]))
    return vk, proof


def test_trapdoor_bctv14_verifies_natively():
    """tests/test_bctv14_verifier_gadget.py:54 on the port: the trapdoor
    BCTV14 (vk, proof) over BLS12-377 that the verifier gadget takes
    equals the JAX package's point for point; the port's BCTV14 verifier
    accepts it and rejects a changed input."""
    bls = get_curve("bls12_377")
    cs, primary, aux = examples.generate_r1cs_example(bls.r, 4, 1)
    vk, proof = trapdoor_bctv14(PORT, bls, cs, primary, aux)
    jvk, jproof = trapdoor_bctv14(JAX, jax_get_curve("bls12_377"), cs,
                                  primary, aux)
    assert coords(vk) == coords(jvk) and coords(proof) == coords(jproof)
    ps = bctv14.BCTV14(bls, device="cpu")
    assert ps.verifier_strong_IC(vk, primary, proof)
    assert not ps.verifier_strong_IC(vk, [(primary[0] + 1) % bls.r], proof)


def trapdoor_kzg(curve, coeffs, z, alpha):
    """tests/test_kzg_verifier_gadget.py's _trapdoor_kzg: (C, v, W) from a
    known alpha."""
    from libsnark_tpu_torch.polynomial_commitments.polynomial_ops import (
        poly_eval)
    r = curve.r
    phi_alpha = poly_eval(coeffs, alpha, r)
    v = poly_eval(coeffs, z, r)
    w_scalar = (phi_alpha - v) * pow(alpha - z, -1, r) % r
    return (curve.G1.one() * phi_alpha, v, curve.G1.one() * w_scalar)


def test_trapdoor_kzg_opening_verifies_natively():
    """tests/test_kzg_verifier_gadget.py:26 on the port: the trapdoor KZG10
    opening over BLS12-377 that the verifier gadget takes passes the
    pairing check e(C - [v], [1]_2) = e(W, [alpha - z]_2), and a wrong
    value does not."""
    bls = get_curve("bls12_377")
    alpha, z = 0xA11CE, 0x5E1EC7
    C, v, W = trapdoor_kzg(bls, [5, 7, 11, 13], z, alpha)
    S = bls.G2.one() * ((alpha - z) % bls.r)
    G1 = bls.G1.one()
    assert bls.pairing_check([(C - G1 * v, -bls.G2.one()), (W, S)])
    assert not bls.pairing_check([(C - G1 * (v + 1), -bls.G2.one()),
                                  (W, S)])


@pytest.mark.slow
def test_bctv14_verifier_gadget_board_equals_jax():
    """tests/test_bctv14_verifier_gadget.py:64 in both packages: the
    hardcoded-vk BCTV14 verifier over Fr(BW6-761) with the trapdoor proof,
    boards equal and satisfied; a flipped input bit refused alike."""
    from libsnark_tpu.gadgets.bctv14_verifier_gadget import (
        BCTV14VerifierGadget as JaxGadget)
    from libsnark_tpu.gadgets.protoboard import (
        Protoboard as JaxProtoboard, PBVariableArray as JaxArray)
    from libsnark_tpu_torch.gadgets.bctv14_verifier_gadget import (
        BCTV14VerifierGadget)
    from libsnark_tpu_torch.gadgets.protoboard import (
        Protoboard, PBVariableArray)
    from _torch_port import assert_same_board
    boards = []
    for mod, pb_cls, arr_cls, gadget_cls in (
            (PORT, Protoboard, PBVariableArray, BCTV14VerifierGadget),
            (JAX, JaxProtoboard, JaxArray, JaxGadget)):
        bls = mod["get_curve"]("bls12_377")
        cs, primary, aux = examples.generate_r1cs_example(bls.r, 4, 1)
        vk, proof = trapdoor_bctv14(mod, bls, cs, primary, aux)
        pb = pb_cls(bls.q)
        bits = arr_cls().allocate(pb, bls.r.bit_length(), "input_bits")
        g = gadget_cls(pb, bls, vk, [list(bits)])
        bits.fill_with_bits_of_int(pb, primary[0] % bls.r)
        g.set_proof_witness(proof)
        g.generate_witness()
        assert pb.first_unsatisfied() is None
        boards.append((pb, bits, g))
    assert_same_board(boards[0][0], boards[1][0])
    verdicts = []
    for pb, bits, g in boards:
        pb.setval(bits[1], 1 - pb.val(bits[1]))
        g.generate_witness()
        verdicts.append(pb.first_unsatisfied())
    assert verdicts[0] is not None and verdicts[0] == verdicts[1]


@pytest.mark.slow
@pytest.mark.parametrize("zero_eval", [False, True])
def test_kzg10_verifier_gadget_board_equals_jax(zero_eval):
    """tests/test_kzg_verifier_gadget.py:36 and :72 in both packages: the
    KZG10 verifier over Fr(BW6-761), boards equal and satisfied; result 1
    for a true opening (and a wrong value refused alike), result 0 for a
    zero evaluation."""
    from libsnark_tpu.gadgets.kzg10_verifier_gadget import (
        KZG10VerifierGadget as JaxGadget)
    from libsnark_tpu.gadgets.pairing_gadgets import G1Gadgets as JaxG1
    from libsnark_tpu.gadgets.protoboard import (
        Protoboard as JaxProtoboard, PBVariableArray as JaxArray)
    from libsnark_tpu_torch.gadgets.kzg10_verifier_gadget import (
        KZG10VerifierGadget)
    from libsnark_tpu_torch.gadgets.pairing_gadgets import G1Gadgets
    from libsnark_tpu_torch.gadgets.protoboard import (
        Protoboard, PBVariableArray)
    from _torch_port import assert_same_board
    alpha, z = 0xA11CE, 0x5E1EC7
    boards = []
    for mod, pb_cls, arr_cls, g1_cls, gadget_cls in (
            (PORT, Protoboard, PBVariableArray, G1Gadgets,
             KZG10VerifierGadget),
            (JAX, JaxProtoboard, JaxArray, JaxG1, JaxGadget)):
        bls = mod["get_curve"]("bls12_377")
        r = bls.r
        coeffs = ([(-z * 3) % r, (3 - z) % r, 1] if zero_eval
                  else [5, 7, 11, 13])
        C, v, W = trapdoor_kzg(bls, coeffs, z, alpha)
        pb = pb_cls(bls.q)
        g1 = g1_cls(pb, "in")
        C_var, W_var = g1.alloc(C), g1.alloc(W)
        nbits = r.bit_length()
        z_bits = arr_cls().allocate(pb, nbits, "z")
        v_bits = arr_cls().allocate(pb, nbits, "v")
        g = gadget_cls(pb, bls, bls.G2.one() * alpha, C_var, W_var,
                       list(z_bits), list(v_bits))
        if not zero_eval:
            g.assert_accept()
        z_bits.fill_with_bits_of_int(pb, z)
        v_bits.fill_with_bits_of_int(pb, v)
        g1.generate_witness()
        g.generate_witness()
        assert pb.first_unsatisfied() is None
        assert pb.lc_val(g.result) == (0 if zero_eval else 1)
        boards.append((pb, v_bits, g1, g, v))
    assert_same_board(boards[0][0], boards[1][0])
    if not zero_eval:
        verdicts = []
        for pb, v_bits, g1, g, v in boards:
            v_bits.fill_with_bits_of_int(pb, v + 1)
            g1.generate_witness()
            g.generate_witness()
            verdicts.append(pb.first_unsatisfied())
        assert verdicts[0] is not None and verdicts[0] == verdicts[1]
