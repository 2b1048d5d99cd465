"""The port's MNT-cycle PCD (CycleSpPCD, CycleMpPCD, GadgetFromR1CS, the
cycle message hashes) against the JAX package's, bit for bit, on the CPU.

The circuits are host Python in both packages, so every comparison is
exact: the constraints (the (index, coeff) terms of a, b and c in order,
and the annotations), the witnesses, the hashes, the verdicts. Proofs are
made from the trusted-setup trapdoor on the host (tests/_torch_port.py's
``trapdoor_groth16``), never by a prover: the compliance circuit has
110,298 constraints and ~1.8e8 linear terms, and its Groth16 proof on the
plain versions would take hours (tests/test_torch_gpu.py proves it on the
card). tests/test_torch_pcd_cycle_translation.py holds the translation
circuit, the message hashes and CycleMpPCD's accumulator. Tolerance: zero.

RUN_SLOW=1 adds what the JAX package marks slow: the depth-1 compliance
step with a trapdoor translation proof (and a wrong-statement proof
refused), the multi-predicate membership case, and MpPCD's MNT instance;
and the device satisfaction check (PairingSystem.first_unsatisfied) on the
plain versions over SpPCD's one-proof aggregation circuit of the MNT
instance (an MNT4 proof verified over Fr(MNT6): ~6e6 merged nonzeros at
19 limbs, ~7 minutes here; tests/test_torch_ram_cycle.py holds the check
on the RAM predicate in tier-1, tests/test_torch_gpu.py on the card).
"""
import gc

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.gadgets.gadget_from_r1cs import (
    GadgetFromR1CS as JaxGadgetFromR1CS)
from libsnark_tpu.gadgets.protoboard import (
    Protoboard as JaxProtoboard, PBVariableArray as JaxPBVariableArray)
from libsnark_tpu.proof_systems import compliance_predicate as jax_cp
from libsnark_tpu.proof_systems import mp_pcd_cycle as jax_mp_cycle
from libsnark_tpu.proof_systems import pcd_cycle as jax_pcd_cycle
from libsnark_tpu.relations.examples import (
    generate_r1cs_example as jax_generate_r1cs_example)

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.gadgets.gadget_from_r1cs import GadgetFromR1CS
from libsnark_tpu_torch.gadgets.protoboard import (
    Protoboard, PBVariableArray)
from libsnark_tpu_torch.proof_systems import compliance_predicate as cp
from libsnark_tpu_torch.proof_systems.compliance_predicate import (
    PCDLocalData, PCDMessage)
from libsnark_tpu_torch.proof_systems.mp_pcd_cycle import CycleMpPCD
from libsnark_tpu_torch.proof_systems.pcd_cycle import (
    CycleSpPCD, constrain_bits_lt_const)
from libsnark_tpu_torch.relations.examples import generate_r1cs_example
from libsnark_tpu_torch.relations.r1cs import R1CSConstraintSystem
from libsnark_tpu_torch.relations.variable import Variable

from _torch_port import (assert_same_board, carry_vk, carry_vk_and_proof,
                         dummy_vk, trapdoor_groth16)

BN_R = int("21888242871839275222246405745257275088"
           "548364400416034343698204186575808495617")
LT_PRIME = (1 << 61) - 1
LT_CONST = 0b1011010


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


def tally(cp_module, r):
    h = cp_module.TallyCompliancePredicate(r, max_arity=1)
    h.generate_r1cs_constraints()
    return h


@pytest.mark.parametrize("v", [0, 1, LT_CONST - 1, LT_CONST, LT_CONST + 1,
                               100])
def test_lt_const_gadget(v):
    """tests/test_pcd_cycle.py:41 in both packages: bits < c holds exactly
    when v < c; the constraints and witnesses are equal."""
    boards = []
    for pb_cls, arr_cls, lt in (
            (Protoboard, PBVariableArray, constrain_bits_lt_const),
            (JaxProtoboard, JaxPBVariableArray,
             jax_pcd_cycle.constrain_bits_lt_const)):
        pb = pb_cls(LT_PRIME)
        bits = arr_cls().allocate(pb, 7, "b")
        for j, b in enumerate(bits):
            pb.setval(b, (v >> j) & 1)
        lt(pb, list(bits), LT_CONST)()
        assert (pb.first_unsatisfied() is None) == (v < LT_CONST)
        boards.append(pb)
    assert_same_board(*boards)


def test_gadget_from_r1cs():
    """tests/test_gadgets_basic.py:170 in both packages: a compiled R1CS
    spliced into a board (its first two variables onto a block),
    satisfied; the constraints and witness equal; a changed block value
    unsatisfies both alike."""
    boards = []
    for pb_cls, arr_cls, gadget, example in (
            (Protoboard, PBVariableArray, GadgetFromR1CS,
             generate_r1cs_example),
            (JaxProtoboard, JaxPBVariableArray, JaxGadgetFromR1CS,
             jax_generate_r1cs_example)):
        cs, primary, aux = example(BN_R, 6, 2)
        pb = pb_cls(BN_R)
        block = arr_cls().allocate(pb, 2, "pub")
        g = gadget(pb, [block], cs, "wrap")
        g.generate_r1cs_constraints()
        g.generate_r1cs_witness(primary + aux)
        assert pb.is_satisfied()
        boards.append((pb, block))
    assert_same_board(boards[0][0], boards[1][0])
    for pb, block in boards:
        pb.setval(block[0], pb.val(block[0]) + 1)
    verdicts = [pb.first_unsatisfied() for pb, _ in boards]
    assert verdicts[0] is not None and verdicts[0] == verdicts[1]


def test_compliance_circuit_depth0_equals_jax(systems):
    """The compliance circuit of the tally predicate (arity 1) at depth 0
    (no incoming proof, local 5) in both packages: 110,298 constraints
    equal term for term (annotations too) and the witness equal; the
    outgoing payload [5, 1] and h_out = message_hash(vk_b, msg) in both."""
    pcd, jpcd = systems
    vk_b, _ = dummy_vk(pcd.B, 123)
    jvk_b = carry_vk(jpcd.B, vk_b)
    h, jh = tally(cp, pcd.A.r), tally(jax_cp, jpcd.A.r)
    gc.disable()
    try:
        C = pcd.build_compliance_circuit(h.get_constraint_system(), 1,
                                         len(h.outgoing))
        pcd.witness_compliance(C, h, vk_b, [], [], PCDLocalData([5]))
        jC = jpcd.build_compliance_circuit(jh.get_constraint_system(), 1,
                                           len(jh.outgoing))
        jpcd.witness_compliance(jC, jh, jvk_b, [], [],
                                jax_cp.PCDLocalData(values=[5]))
        pb, jpb = C["pb"], jC["pb"]
        assert (pb.num_constraints, pb.num_inputs) == (110298, 1)
        assert_same_board(pb, jpb)
        msg = PCDMessage(1, [pb.val(v) for v in C["out_block"][1:]])
        assert msg.payload == [5, 1]
        h_out = pb.primary_input()[0]
        assert h_out == pcd.message_hash(vk_b, msg) == jpcd.message_hash(
            jvk_b, jax_cp.PCDMessage(1, [5, 1]))
    finally:
        C = jC = pb = jpb = None
        gc.enable()
        gc.collect()


@pytest.fixture(scope="module")
def mnt_aggregation():
    """SpPCD's one-proof aggregation circuit of the MNT instance (an MNT4
    Groth16 verifier over Fr(MNT6): the outer circuit of MpPCD(mnt4, mnt6)
    too) with a trapdoor proof's witness, and its device R1CS on the CPU
    (the form a proving key holds, without the keygen)."""
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.proof_systems.pcd import SpPCD
    mnt4, mnt6 = get_curve("mnt4"), get_curve("mnt6")
    sp = SpPCD(mnt4, mnt6, device="cpu")
    stmt = [1, 35, 4, 2]
    cs = R1CSConstraintSystem(mnt4.r, 4, 1)
    w = Variable(5)
    cs.add_constraint(w * 1, w * 1, w * 1, "w_bool")
    vk, proof = trapdoor_groth16(mnt4, cs, stmt, [0], seed=9)
    gc.disable()
    try:
        pb, bits, gadgets = sp.aggregation_witness(
            vk, mnt4.r.bit_length(), [stmt], [proof])
        g16 = Groth16(mnt6, device="cpu")
        dev = pb.get_constraint_system().to_device(g16.fr)
    finally:
        gc.enable()
    return dict(pb=pb, bits=bits, gadgets=gadgets, g16=g16, dev=dev)


@pytest.mark.slow
def test_device_check_on_the_mnt_aggregation_circuit(mnt_aggregation):
    """The device check (the three mat-vecs of the witness map, a product
    and a subtraction, on the plain versions here) returns exactly
    Protoboard.first_unsatisfied()'s verdict and message: None on the
    satisfied board; then one statement bit flipped with the verifier
    gadget's witness made again (the pairing check fails), and one
    auxiliary value changed alone."""
    a = mnt_aggregation
    pb, g16, dev = a["pb"], a["g16"], a["dev"]
    assert pb.first_unsatisfied() is None
    assert g16.first_unsatisfied(dev, pb) is None
    b = a["bits"][0][1][0]
    pb.setval(b, 1 - pb.val(b))
    a["gadgets"][0].generate_witness()
    bad = pb.first_unsatisfied()
    assert bad is not None and g16.first_unsatisfied(dev, pb) == bad
    pb.setval(b, 1 - pb.val(b))
    a["gadgets"][0].generate_witness()
    i = pb.num_variables // 2
    pb._values[i] = (pb._values[i] + 1) % pb.p
    bad = pb.first_unsatisfied()
    assert bad is not None and g16.first_unsatisfied(dev, pb) == bad


def test_device_check_refuses_another_board():
    """A device R1CS of another board's size is refused, not read."""
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    mnt6 = get_curve("mnt6")
    g16 = Groth16(mnt6, device="cpu")
    cs, _, _ = generate_r1cs_example(mnt6.r, 6, 2)
    dev = cs.to_device(g16.fr)
    other = Protoboard(mnt6.r)
    PBVariableArray().allocate(other, 3, "x")
    with pytest.raises(ValueError):
        g16.first_unsatisfied(dev, other)


@pytest.mark.slow
def test_compliance_chain_with_trapdoor_translation(systems):
    """tests/test_pcd_cycle.py:68 on the port, each board against the JAX
    package's: depth 0, depth 1 consuming a trapdoor translation proof of
    h_out0 (payload 15), a wrong-statement proof refused alike; the
    depth-1 board is the depth-0 board witnessed again (as the prover
    does) and equals a fresh JAX board."""
    pcd, jpcd = systems
    vk_b, _ = dummy_vk(pcd.B, 123)
    jvk_b = carry_vk(jpcd.B, vk_b)
    h = tally(cp, pcd.A.r)
    cs = h.get_constraint_system()
    C = pcd.compliance_board(cs, 1, len(h.outgoing))
    pcd.witness_compliance(C, h, vk_b, [], [], PCDLocalData([5]))
    assert C["pb"].first_unsatisfied() is None
    msg0 = PCDMessage(1, [C["pb"].val(v) for v in C["out_block"][1:]])
    h_out0 = C["pb"].primary_input()[0]
    assert h_out0 == pcd.message_hash(vk_b, msg0)
    _, pi_b0 = dummy_vk(pcd.B, h_out0)
    jpi_b0 = carry_vk_and_proof(jpcd.B, vk_b, pi_b0)[1]
    pcd.witness_compliance(C, tally(cp, pcd.A.r), vk_b, [msg0], [pi_b0],
                           PCDLocalData([10]))
    assert C["pb"].first_unsatisfied() is None
    assert C["pb"].val(C["out_block"][1]) == 15
    jh = tally(jax_cp, jpcd.A.r)
    jC = jpcd.build_compliance_circuit(jh.get_constraint_system(), 1,
                                       len(jh.outgoing))
    jpcd.witness_compliance(jC, jh, jvk_b, [jax_cp.PCDMessage(1, [5, 1])],
                            [jpi_b0], jax_cp.PCDLocalData(values=[10]))
    assert_same_board(C["pb"], jC["pb"])
    _, pi_bad = dummy_vk(pcd.B, h_out0 + 1)
    pcd.witness_compliance(C, tally(cp, pcd.A.r), vk_b, [msg0], [pi_bad],
                           PCDLocalData([10]))
    assert C["pb"].first_unsatisfied() is not None


@pytest.mark.slow
def test_mp_cycle_compliance_with_membership():
    """tests/test_mp_pcd_cycle.py:53 on the port: base and successor steps
    with the vk-set commitment satisfied, the base board equal to the JAX
    package's; a wrong-statement proof and a valid proof under a
    non-member vk refused."""
    mp, jmp = CycleMpPCD(device="cpu"), jax_mp_cycle.CycleMpPCD()
    vk0, _ = dummy_vk(mp.B, 0, seed=31)
    vk1, _ = dummy_vk(mp.B, 0, seed=32)
    acc = mp.build_accumulator(2)
    acc.add(mp._pvk_bits(vk0))
    acc.add(mp._pvk_bits(vk1))
    root = acc.get_commitment()
    memb0 = acc.get_membership_proof(mp._pvk_bits(vk0))
    h0 = tally(cp, mp.A.r)
    cs = h0.get_constraint_system()
    C = mp.compliance_board(cs, 1, len(h0.outgoing), 1)
    mp.witness_compliance(C, h0, root, [], [(vk0, memb0, None)],
                          PCDLocalData([5]))
    assert C["pb"].first_unsatisfied() is None
    jh0 = tally(jax_cp, jmp.A.r)
    jC = jmp.build_compliance_circuit(jh0.get_constraint_system(), 1,
                                      len(jh0.outgoing), depth=1)
    jacc = jmp.build_accumulator(2)
    jvk0 = carry_vk(jmp.B, vk0)
    jacc.add(jmp._pvk_bits(jvk0))
    jacc.add(jmp._pvk_bits(carry_vk(jmp.B, vk1)))
    jmp.witness_compliance(jC, jh0, jacc.get_commitment(), [],
                           [(jvk0, jacc.get_membership_proof(
                               jmp._pvk_bits(jvk0)), None)],
                           jax_cp.PCDLocalData(values=[5]))
    assert_same_board(C["pb"], jC["pb"])
    jC = None
    msg0 = PCDMessage(1, [C["pb"].val(v) for v in C["out_block"][1:]])
    h_out0 = C["pb"].primary_input()[0]
    assert h_out0 == mp.message_hash(root, msg0)
    _, pi0 = dummy_vk(mp.B, h_out0, seed=31)
    mp.witness_compliance(C, tally(cp, mp.A.r), root, [msg0],
                          [(vk0, memb0, pi0)], PCDLocalData([10]))
    assert C["pb"].first_unsatisfied() is None
    assert C["pb"].val(C["out_block"][1]) == 15
    _, pi_bad = dummy_vk(mp.B, h_out0 + 1, seed=31)
    mp.witness_compliance(C, tally(cp, mp.A.r), root, [msg0],
                          [(vk0, memb0, pi_bad)], PCDLocalData([10]))
    assert C["pb"].first_unsatisfied() is not None
    vk_evil, _ = dummy_vk(mp.B, 0, seed=66)
    acc_evil = mp.build_accumulator(2)
    acc_evil.add(mp._pvk_bits(vk_evil))
    memb_evil = acc_evil.get_membership_proof(mp._pvk_bits(vk_evil))
    _, pi_evil = dummy_vk(mp.B, mp.message_hash(root, msg0), seed=66)
    mp.witness_compliance(C, tally(cp, mp.A.r), root, [msg0],
                          [(vk_evil, memb_evil, pi_evil)],
                          PCDLocalData([10]))
    assert C["pb"].first_unsatisfied() is not None


@pytest.mark.slow
def test_mp_pcd_mnt_instance_equals_jax():
    """tests/test_mp_pcd.py:81's instance in both packages: MpPCD(mnt4,
    mnt6), an inner MNT4 proof verified in the aggregation circuit over
    Fr(MNT6) with its vk witnessed and proved a member of the committed
    set; the circuit and its witness equal the JAX package's, satisfied;
    a vk outside the set refused alike."""
    from libsnark_tpu.proof_systems.mp_pcd import (
        MpPCD as JaxMpPCD, vk_bits as jax_vk_bits)
    from libsnark_tpu_torch.proof_systems.mp_pcd import MpPCD, vk_bits
    mnt4, mnt6 = get_curve("mnt4"), get_curve("mnt6")
    r = mnt4.r
    cs = R1CSConstraintSystem(r, 1, 2)
    x, a, b = Variable(1), Variable(2), Variable(3)
    cs.add_constraint(a, a, b)
    cs.add_constraint(a, b, x)
    prim, aux = [27], [3, 9]
    made = [trapdoor_groth16(mnt4, cs, prim, aux, seed=s)
            for s in (31, 32, 33)]
    boards, verdicts = [], []
    for pkg in ("port", "jax"):
        if pkg == "port":
            mp, bits_of = MpPCD(mnt4, mnt6, device="cpu"), vk_bits
            vks = made
        else:
            jmnt4 = jax_get_curve("mnt4")
            mp = JaxMpPCD(jmnt4, jax_get_curve("mnt6"))
            bits_of = jax_vk_bits
            vks = [carry_vk_and_proof(jmnt4, vk, pi) for vk, pi in made]
        acc = mp._accumulator(4)
        for vk, _ in vks[:2]:
            acc.add(bits_of(vk, mp.coord_bits))
        root = acc.get_commitment()
        pb, h = mp._build_outer(1, 1, 8, 4)

        def fill(vk, proof, memb, pb=pb, h=h, root=root):
            h["root"].generate_r1cs_witness(root)
            h["stmt_bits"][0][0].fill_with_bits_of_int(pb, prim[0])
            slot = h["slots"][0]
            slot["vk_var"].set_witness(vk)
            slot["verifier"].set_proof_witness(proof)
            slot["verifier"].generate_witness()
            for pg_c, lc, helper in slot["packs"]:
                pb.setval(helper, pb.lc_val(lc))
                pg_c.generate_r1cs_witness_from_packed()
            slot["hash"].generate_r1cs_witness()
            slot["addr"].fill_with_bits_of_int(pb, memb.address)
            slot["path"].generate_r1cs_witness(memb.address,
                                               memb.merkle_path)
            slot["memb"].generate_r1cs_witness()
            h["root"].generate_r1cs_witness(root)

        memb1 = acc.get_membership_proof(bits_of(vks[0][0], mp.coord_bits))
        fill(*vks[0], memb1)
        assert pb.first_unsatisfied() is None
        boards.append((pb, fill, vks[2], memb1))
    assert_same_board(boards[0][0], boards[1][0])
    for pb, fill, (vk3, proof3), memb1 in boards:
        fill(vk3, proof3, memb1)
        verdicts.append(pb.first_unsatisfied())
    assert verdicts[0] is not None and verdicts[0] == verdicts[1]
