"""The port's MNT-cycle PCD against the JAX package's, bit for bit, on
the CPU: the translation circuit (a hardcoded-vk MNT4 verifier over the
bits of the statement, 28,305 constraints) and its re-witnessing, the
cycle message hashes and the verifier on a JAX proof, and CycleMpPCD's
accumulator. tests/test_torch_pcd_cycle.py holds the compliance circuit
and the rest of the cycle PCD. Proofs are made from the trusted-setup
trapdoor on the host (tests/_torch_port.py's ``trapdoor_groth16``), never
by a prover. Tolerance: zero.
"""
import gc

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu.proof_systems import compliance_predicate as jax_cp
from libsnark_tpu.proof_systems import mp_pcd_cycle as jax_mp_cycle
from libsnark_tpu.proof_systems import pcd_cycle as jax_pcd_cycle

from libsnark_tpu_torch.interop import (
    cycle_pcd_proof_from_ints, cycle_pcd_verification_key_from_ints)
from libsnark_tpu_torch.proof_systems.compliance_predicate import PCDMessage
from libsnark_tpu_torch.proof_systems.mp_pcd_cycle import CycleMpPCD
from libsnark_tpu_torch.proof_systems.pcd_cycle import (
    CyclePCDProof, CycleSpPCD)

from _torch_port import (assert_same_board, carry_vk, carry_vk_and_proof,
                         coords, dummy_vk)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    """The port's CycleSpPCD on the CPU and the JAX package's, MNT4 ->
    MNT6."""
    return CycleSpPCD(device="cpu"), jax_pcd_cycle.CycleSpPCD()


@pytest.fixture(scope="module")
def translation(systems):
    """The translation circuit (a hardcoded-vk MNT4 verifier over bits of
    the statement) in both packages, witnessed with a trapdoor MNT4 proof
    of h (the port's, carried to the JAX package as integers)."""
    pcd, jpcd = systems
    h = 0x1234567890ABCDEF
    vk_a, pi_a = dummy_vk(pcd.A, h, seed=11)
    jvk_a, jpi_a = carry_vk_and_proof(jpcd.A, vk_a, pi_a)
    gc.disable()
    try:
        T = pcd.translation_board(vk_a)
        pcd.witness_translation(T, h, pi_a)
        jT = jpcd.build_translation_circuit(jvk_a)
        jpcd.witness_translation(jT, h, jpi_a)
    finally:
        gc.enable()
    return dict(pcd=pcd, jpcd=jpcd, h=h, pi_a=pi_a, jpi_a=jpi_a, T=T, jT=jT,
                vk_a=vk_a, jvk_a=jvk_a)


def test_translation_circuit_equals_jax(translation):
    """tests/test_pcd_cycle.py:56: the translation circuit and its witness
    equal the JAX package's, term for term and value for value, and
    both are satisfied."""
    T, jT = translation["T"], translation["jT"]
    assert (T["pb"].num_constraints, T["pb"].num_inputs) == (28305, 1)
    assert_same_board(T["pb"], jT["pb"])
    assert T["pb"].first_unsatisfied() is None
    assert jT["pb"].first_unsatisfied() is None


def test_translation_changed_statement_then_rewitnessed(translation):
    """h + 1 under the same proof leaves both packages' boards unsatisfied
    at the same constraint; the port's board witnessed again for h (the
    prover re-witnesses the generator's board) equals a fresh JAX board
    for h."""
    t = translation
    pcd, jpcd, T, h = t["pcd"], t["jpcd"], t["T"], t["h"]
    pcd.witness_translation(T, h + 1, t["pi_a"])
    jT2 = jpcd.build_translation_circuit(t["jvk_a"])
    jpcd.witness_translation(jT2, h + 1, t["jpi_a"])
    bad = T["pb"].first_unsatisfied()
    assert bad is not None and bad == jT2["pb"].first_unsatisfied()
    assert pcd.translation_board(t["vk_a"]) is T
    pcd.witness_translation(T, h, t["pi_a"])
    assert T["pb"]._values == t["jT"]["pb"]._values


def test_message_hash_and_verifier_on_a_jax_proof(systems):
    """A trapdoor translation proof made by the JAX package's test helper
    for h = message_hash(vk_b, msg), carried into the port by interop as
    integers: the port's message hash equals the JAX package's, its
    verifier accepts the proof and rejects it under a changed payload
    element, as the JAX verifier does."""
    from test_verifier_gadget import _trapdoor_groth16
    from libsnark_tpu.relations.r1cs import R1CSConstraintSystem as JaxR1CS
    from libsnark_tpu.relations.variable import Variable as JaxVariable
    pcd, jpcd = systems
    B, jB = pcd.B, jpcd.B

    def jax_dummy(statement, seed):
        cs = JaxR1CS(jB.r, 1, 1)
        w = JaxVariable(2)
        cs.add_constraint(w * 1, w * 1, w * 1, "w_bool")
        return _trapdoor_groth16(jB, cs, [statement % jB.r], [0], seed=seed)

    jvk_b, _ = jax_dummy(0, 5)
    jmsg = jax_cp.PCDMessage(1, [15, 2])
    jh = jpcd.message_hash(jvk_b, jmsg)
    _, jpi = jax_dummy(jh, 5)
    jvk = jax_pcd_cycle.CyclePCDVerificationKey(vk_b=jvk_b, msg_size=3)
    jproof = jax_pcd_cycle.CyclePCDProof(msg=jmsg, translation_proof=jpi)

    vkc = coords(jvk_b)
    vk = cycle_pcd_verification_key_from_ints(B, vkc, 3)
    pic = coords(jpi)
    proof = cycle_pcd_proof_from_ints(B, 1, [15, 2], pic)
    assert coords(vk.vk_b) == vkc and coords(proof.translation_proof) == pic
    assert pcd.message_hash(vk.vk_b, proof.msg) == jh
    bad = PCDMessage(1, [16, 2])
    jbad = jax_cp.PCDMessage(1, [16, 2])
    verdicts = [pcd.verifier(vk, proof.msg, proof),
                pcd.verifier(vk, bad, CyclePCDProof(
                    msg=bad, translation_proof=proof.translation_proof))]
    assert verdicts == [True, False]
    assert [jpcd.verifier(jvk, jmsg, jproof),
            jpcd.verifier(jvk, jbad, jproof)] == verdicts


def test_mp_accumulator_and_hash_equal_jax():
    """tests/test_mp_pcd_cycle.py:35 in both packages: the processed
    translation vks' bits, the knapsack-Merkle set commitment, each
    membership proof and the message hash equal; the hash depends on the
    root."""
    mp, jmp = CycleMpPCD(device="cpu"), jax_mp_cycle.CycleMpPCD()
    vks = [dummy_vk(mp.B, 1, seed=21)[0], dummy_vk(mp.B, 2, seed=22)[0]]
    jvks = [carry_vk(jmp.B, vk) for vk in vks]
    bits = [mp._pvk_bits(vk) for vk in vks]
    assert bits == [jmp._pvk_bits(jvk) for jvk in jvks]
    acc, jacc = mp.build_accumulator(2), jmp.build_accumulator(2)
    for b in bits:
        acc.add(b)
        jacc.add(b)
    root = acc.get_commitment()
    assert root == jacc.get_commitment()
    memb = [acc.get_membership_proof(b) for b in bits]
    jmemb = [jacc.get_membership_proof(b) for b in bits]
    assert [(m.address, m.merkle_path) for m in memb] == [
        (m.address, m.merkle_path) for m in jmemb]
    assert memb[0].address != memb[1].address
    h = mp.message_hash(root, PCDMessage(1, [3, 4]))
    assert 0 <= h < mp.A.r
    assert h == jmp.message_hash(root, jax_cp.PCDMessage(1, [3, 4]))
    acc2 = mp.build_accumulator(2)
    acc2.add(bits[1])
    assert mp.message_hash(acc2.get_commitment(),
                           PCDMessage(1, [3, 4])) != h
