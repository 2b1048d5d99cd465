"""The port's one-layer PCD (SpPCD, MpPCD over BLS12-377 -> BW6-761)
against the JAX package's, bit for bit, on the CPU.

One module-scoped fixture makes a real inner step proof with the port
(SpPCD.prove_step of the tally predicate, keys from the host fixed-base
path) and builds the one-proof aggregation circuit (69,527 constraints)
with its witness once in each package, the JAX one from the port's vk and
proof carried across as integer coordinates. The constraint systems (the
(index, coeff) terms of every a, b and c in order, and the annotations),
the witnesses and the variable annotations must be equal, and both
satisfied. No outer Groth16 prove runs here: on a domain of 73,728 over
48 limbs the plain versions would take hours; tests/test_torch_gpu.py
runs it on the card. Tolerance: zero.
"""
import gc

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.proof_systems import compliance_predicate as jax_cp
from libsnark_tpu.proof_systems.mp_pcd import (
    MpPCD as JaxMpPCD, vk_bits as jax_vk_bits)
from libsnark_tpu.proof_systems.pcd import (
    OneLayerPCD as JaxOneLayerPCD, SpPCD as JaxSpPCD)

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.proof_systems.compliance_predicate import (
    PCDLocalData, PCDMessage, TallyCompliancePredicate)
from libsnark_tpu_torch.proof_systems.mp_pcd import MpPCD, vk_bits
from libsnark_tpu_torch.proof_systems.pcd import SpPCD, SpPCDProvingKey

from _torch_port import (assert_same_board, carry_vk, carry_vk_and_proof,
                         trapdoor_groth16)

BN_R = int("21888242871839275222246405745257275088"
           "548364400416034343698204186575808495617")
# the tally step of tests/test_pcd.py: incoming [10, 1] and [20, 2], local 5
INCOMING = ([1, [10, 1]], [1, [20, 2]])
LOCAL = [5]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def curves():
    return (get_curve("bls12_377"), get_curve("bw6_761"),
            jax_get_curve("bls12_377"), jax_get_curve("bw6_761"))


@pytest.fixture(scope="module")
def aggregation(curves):
    """The port's real inner step proof (host fixed-base keys, seed 78 =
    the generator's seed 77 + 1), verified natively; then the one-proof
    aggregation circuit with its witness in both packages."""
    bls, bw6, jbls, jbw6 = curves
    cp = TallyCompliancePredicate(bls.r, max_arity=2)
    cp.generate_r1cs_constraints()
    pcd = SpPCD(bls, bw6, device="cpu")
    pcd.g16_inner.host_keygen = True
    inner_kp = pcd.g16_inner.generator(cp.get_constraint_system(), seed=78)
    nbits = bls.r.bit_length()
    pk = SpPCDProvingKey(inner_keypair=inner_kp, outer_keypair=None,
                         num_proofs=1, num_input_bits=nbits)
    stmt, proof = pcd.prove_step(
        pk, cp, [PCDMessage(t, list(p)) for t, p in INCOMING],
        PCDLocalData(LOCAL), seed=5)
    verified = pcd.g16_inner.verifier_strong_IC(inner_kp.vk, stmt, proof)
    jvk, jproof = carry_vk_and_proof(jbls, inner_kp.vk, proof)
    # ~10^8 small objects: the collector's full passes over them would
    # take longer than building and reading them; frozen until the module
    # is done
    gc.disable()
    try:
        pb, bits, gadgets = pcd.aggregation_witness(inner_kp.vk, nbits,
                                                    [stmt], [proof])
        jpb, jbits, jgadgets = JaxSpPCD._build_outer(
            JaxOneLayerPCD(jbls, jbw6), jvk, 1, len(stmt), nbits)
        for j, x in enumerate(stmt):                 # as JaxSpPCD.prover
            jbits[0][j].fill_with_bits_of_int(jpb, x % jbls.r)
        jgadgets[0].set_proof_witness(jproof)
        jgadgets[0].generate_witness()
    finally:
        gc.freeze()
        gc.enable()
    yield dict(pcd=pcd, stmt=stmt, proof=proof, verified=verified,
               inner_kp=inner_kp, jvk=jvk, jproof=jproof, pb=pb, bits=bits,
               gadgets=gadgets, jpb=jpb)
    gc.unfreeze()


def test_inner_step_proof_is_real_and_verifies(aggregation):
    """The tally step's statement [type, sum, count, arity], and its inner
    Groth16 proof (the port's CPU prover) verifies natively."""
    assert aggregation["stmt"] == [1, 35, 4, 2]
    assert aggregation["verified"]


def test_aggregation_circuit_and_witness_equal_jax(aggregation):
    """The outer R1CS (69,527 constraints, 1,012 inputs) and its witness
    equal the JAX package's, term for term and value for value, and both
    are satisfied."""
    pb, jpb = aggregation["pb"], aggregation["jpb"]
    assert (pb.num_constraints, pb.num_inputs) == (69527, 1012)
    assert_same_board(pb, jpb)
    assert pb.first_unsatisfied() is None
    assert jpb.first_unsatisfied() is None
    cs = pb.get_constraint_system()
    assert (cs.num_constraints, cs.primary_input_size) == (69527, 1012)


def test_changed_statement_bit_leaves_the_circuit_unsatisfied(aggregation):
    """One statement bit flipped, the verifier gadget's witness made again
    (after the tests that read the satisfied witness): the pairing check
    at the circuit's end cannot hold. The constraints are scanned from the
    last, where it fails."""
    pb, bits, gadgets = (aggregation[k] for k in ("pb", "bits", "gadgets"))
    b = bits[0][1][0]
    pb.setval(b, 1 - pb.val(b))
    gadgets[0].generate_witness()
    p, vals = pb.p, pb.full_assignment()
    failed = next(ann for a, b, c, ann in reversed(pb.constraints)
                  if (a.evaluate(vals, p) * b.evaluate(vals, p)
                      - c.evaluate(vals, p)) % p)
    assert failed.startswith("g16v_check")


def test_tally_predicate():
    """tests/test_pcd.py:13 in both packages: the step's outgoing payload
    [35, 4], satisfied as a protoboard and as an R1CS; the step circuits
    and witnesses equal."""
    boards = []
    for m in (jax_cp, None):
        if m is None:
            cp = TallyCompliancePredicate(BN_R, max_arity=2)
            msgs = [PCDMessage(t, list(p)) for t, p in INCOMING]
            local = PCDLocalData(LOCAL)
        else:
            cp = m.TallyCompliancePredicate(BN_R, max_arity=2)
            msgs = [m.PCDMessage(t, list(p)) for t, p in INCOMING]
            local = m.PCDLocalData(LOCAL)
        cp.generate_r1cs_constraints()
        out = cp.generate_r1cs_witness(msgs, local)
        assert out.payload == [35, 4]
        assert cp.is_satisfied()
        cs = cp.get_constraint_system()
        assert cs.is_satisfied(cp.pb.primary_input(),
                               cp.pb.auxiliary_input())
        boards.append(cp.pb)
    assert_same_board(boards[1], boards[0])


def _mp_inner(curve, seed):
    """tests/test_mp_pcd.py's step circuit: x = a^3, one input."""
    from libsnark_tpu_torch.relations.r1cs import R1CSConstraintSystem
    from libsnark_tpu_torch.relations.variable import Variable
    r = curve.r
    cs = R1CSConstraintSystem(r, 1, 2)
    x, a, b = Variable(1), Variable(2), Variable(3)
    cs.add_constraint(a, a, b)
    cs.add_constraint(a, b, x)
    a_val = 3 + seed
    return cs, [pow(a_val, 3, r)], [a_val, a_val * a_val % r]


def test_mp_pcd_vk_set_equals_jax(curves):
    """MpPCD's committed vk set at the size of tests/test_mp_pcd.py:27: the
    vks' bits, the knapsack accumulator's root and each membership proof
    equal the JAX package's."""
    bls, bw6, jbls, jbw6 = curves
    mp = MpPCD(bls, bw6, device="cpu")
    jmp = JaxMpPCD(jbls, jbw6)
    assert (mp.digest_bits, mp.coord_bits) == (jmp.digest_bits,
                                               jmp.coord_bits)
    vks = []
    for seed, tseed in ((0, 21), (1, 22)):
        cs, prim, aux = _mp_inner(bls, seed)
        vks.append(trapdoor_groth16(bls, cs, prim, aux, seed=tseed)[0])
    jvks = [carry_vk(jbls, vk) for vk in vks]
    acc, jacc = mp._accumulator(4), jmp._accumulator(4)
    for vk, jvk in zip(vks, jvks):
        bits = vk_bits(vk, mp.coord_bits)
        assert bits == jax_vk_bits(jvk, jmp.coord_bits)
        acc.add(bits)
        jacc.add(bits)
    assert acc.get_commitment() == jacc.get_commitment()
    for vk in vks:
        bits = vk_bits(vk, mp.coord_bits)
        m, jm = acc.get_membership_proof(bits), jacc.get_membership_proof(
            bits)
        assert (m.address, m.merkle_path) == (jm.address, jm.merkle_path)
    assert not acc.is_in_set(vk_bits(trapdoor_groth16(
        bls, *_mp_inner(bls, 0), seed=23)[0], mp.coord_bits))


@pytest.mark.slow
def test_mp_aggregation_circuit_equals_jax(curves):
    """tests/test_mp_pcd.py:27 in both packages (two proofs, statements of
    8 bits, max_vks 4): the aggregation circuit and its witness equal, and
    satisfied; a vk outside the set with a stale membership proof leaves
    it unsatisfied in both."""
    bls, bw6, jbls, jbw6 = curves
    mp = MpPCD(bls, bw6, device="cpu")
    jmp = JaxMpPCD(jbls, jbw6)
    steps = []
    for seed, tseed in ((0, 21), (1, 22), (0, 23)):
        cs, prim, aux = _mp_inner(bls, seed)
        vk, proof = trapdoor_groth16(bls, cs, prim, aux, seed=tseed)
        steps.append((prim, vk, proof) + carry_vk_and_proof(jbls, vk, proof))
    boards = []
    for m, jax_side in ((mp, False), (jmp, True)):
        vk_of = (lambda s: s[3]) if jax_side else (lambda s: s[1])
        proof_of = (lambda s: s[4]) if jax_side else (lambda s: s[2])
        acc = m._accumulator(4)
        for s in steps[:2]:
            acc.add((jax_vk_bits if jax_side else vk_bits)(
                vk_of(s), m.coord_bits))
        root = acc.get_commitment()
        pb, h = m._build_outer(2, 1, 8, 4)
        h["root"].generate_r1cs_witness(root)
        for i in range(2):
            h["stmt_bits"][i][0].fill_with_bits_of_int(pb, steps[i][0][0])

        def fill_slot(i, s, memb):
            slot = h["slots"][i]
            slot["vk_var"].set_witness(vk_of(s))
            slot["verifier"].set_proof_witness(proof_of(s))
            slot["verifier"].generate_witness()
            for pg_c, lc, helper in slot["packs"]:
                pb.setval(helper, pb.lc_val(lc))
                pg_c.generate_r1cs_witness_from_packed()
            slot["hash"].generate_r1cs_witness()
            slot["addr"].fill_with_bits_of_int(pb, memb.address)
            slot["path"].generate_r1cs_witness(memb.address,
                                               memb.merkle_path)
            slot["memb"].generate_r1cs_witness()

        membs = [acc.get_membership_proof(
            (jax_vk_bits if jax_side else vk_bits)(vk_of(s), m.coord_bits))
            for s in steps[:2]]
        fill_slot(0, steps[0], membs[0])
        fill_slot(1, steps[1], membs[1])
        h["root"].generate_r1cs_witness(root)
        assert pb.first_unsatisfied() is None
        boards.append((pb, list(pb._values)))
        fill_slot(0, steps[2], membs[0])
        h["root"].generate_r1cs_witness(root)
        assert pb.first_unsatisfied() is not None
    (pb, good), (jpb, jgood) = boards
    assert good == jgood
    assert_same_board(pb, jpb)
