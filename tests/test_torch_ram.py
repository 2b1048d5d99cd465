"""The port's RAM systems against the JAX package's, bit for bit, on the
CPU: the TinyRAM universal circuit (ram_to_r1cs_instance_map), the RAM
ppzkSNARK over BCTV14 (alt_bn128), and the one-layer RAM zkSNARK's
compliance predicate, transcript verifier and aggregation circuit
(BLS12-377 -> BW6-761).

* The universal circuit's R1CS (variable indices, coefficients and
  annotations, in order) at (w, k, B, T) = (16, 4, 5, 5), 4,765
  constraints, and (32, 16, 12, 4); its primary input (the boot trace) and
  witness for the programs of tests/test_ram_universal.py.
* RAMPpzksnark at 4,765 constraints: the port's keys (host fixed base)
  equal the JAX package's; a CPU proof (the plain versions) verifies and
  is rejected with one boot-input element changed; the unsatisfiable
  example is refused. The proof against the JAX package's proof, and the
  JAX key carried across by ``interop``, is the slow test below.
* RamCompliancePredicate at w = 16, k = 4, depth 7 (18,838 constraints):
  R1CS, the message chain with the board after the last step, the
  statement hash against the circuit's primary input, and the tampering
  cases of tests/test_ram_zksnark.py; verify_transcript with trapdoor
  Groth16 proofs of the port (tests/_torch_port.trapdoor_groth16).
* build_outer_circuit at T = 1, depth 4: the R1CS equals the JAX
  package's (one Groth16 verifier gadget, ~69.5k constraints).

Tolerance: zero.
"""
import dataclasses
import gc
import types

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.gadgets.ram_universal import (
    ram_to_r1cs_instance_map as jax_instance_map)
from libsnark_tpu.proof_systems import ram_zksnark as jax_rz
from libsnark_tpu.proof_systems.ram_ppzksnark import (
    RAMPpzksnark as JaxRAMPpzksnark)
from libsnark_tpu.relations import tinyram as jax_tinyram

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.gadgets.ram_universal import ram_to_r1cs_instance_map
from libsnark_tpu_torch.interop import ram_ppzksnark_keypair_from_numpy
from libsnark_tpu_torch.proof_systems import ram_zksnark as rz
from libsnark_tpu_torch.proof_systems.bctv14 import QUERIES
from libsnark_tpu_torch.proof_systems.ram_ppzksnark import RAMPpzksnark
from libsnark_tpu_torch.relations import tinyram

from _torch_port import (assert_keys_equal, assert_same_board, board,
                         carry_vk, coords, numpy_matrices, numpy_queries,
                         plain, trapdoor_groth16)

BN_R = int("21888242871839275222246405745257275088"
           "548364400416034343698204186575808495617")
PACKAGES = {"jax": (jax_tinyram, jax_instance_map),
            "torch": (tinyram, ram_to_r1cs_instance_map)}
# the programs of tests/test_ram_universal.py and tests/test_ram_zksnark.py
PROGRAMS = {
    "arith": [("MOV", True, 0, 0, 9), ("ADD", True, 0, 0, 33),
              ("SUB", True, 0, 0, 42), ("ANSWER", False, 0, 0, 0)],
    "memory": [("MOV", True, 0, 0, 55), ("STOREW", True, 0, 0, 100),
               ("LOADW", True, 1, 0, 100), ("SUB", False, 2, 0, 1),
               ("ANSWER", False, 0, 0, 2)],
    "wrong_answer": [("MOV", True, 0, 0, 1), ("ANSWER", False, 0, 0, 0)],
    "accept_now": [("ANSWER", True, 0, 0, 0)],
}
GEN_SEED, PROVE_SEED = 123, 321


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def program(tr, name):
    prog = tr.TinyRAMProgram()
    for op, imm, des, a1, a2 in PROGRAMS[name]:
        prog.add(tr.Opcode[op], imm, des, a1, a2)
    return prog


# ------------------------------------------------------ universal circuit

@pytest.mark.parametrize("w,k,B,T,n", [(16, 4, 5, 5, 4765),
                                       (32, 16, 12, 4, 7971)])
def test_universal_circuit_r1cs_equals_jax(w, k, B, T, n):
    pb, _ = ram_to_r1cs_instance_map(BN_R, tinyram.TinyRAMParams(w, k), B, T)
    jpb, _ = jax_instance_map(BN_R, jax_tinyram.TinyRAMParams(w, k), B, T)
    assert pb.num_constraints == n
    assert board(pb) == board(jpb)
    cs, jcs = pb.get_constraint_system(), jpb.get_constraint_system()
    assert (cs.num_constraints, cs.num_inputs, cs.num_variables) == \
        (jcs.num_constraints, jcs.num_inputs, jcs.num_variables)


def _witnessed(pkg, name, w, k, B, T):
    tr, instance_map = PACKAGES[pkg]
    prog = program(tr, name)
    B = B or prog.size + 1
    pb, g = instance_map(BN_R, tr.TinyRAMParams(w, k), B, T)
    answer, accepted = g.generate_r1cs_witness(prog, [], [])
    return pb, g, answer, accepted


@pytest.mark.parametrize("name,w,k,B,T", [
    ("arith", 16, 4, None, 5), ("memory", 16, 4, None, 6),
    ("arith", 32, 16, 12, 4), ("memory", 32, 16, 12, 6)])
def test_universal_primary_input_and_witness_equal_jax(name, w, k, B, T):
    pb, g, answer, accepted = _witnessed("torch", name, w, k, B, T)
    jpb, jg, janswer, jaccepted = _witnessed("jax", name, w, k, B, T)
    assert (answer, accepted) == (janswer, jaccepted) == (0, True)
    assert pb.first_unsatisfied() is None
    assert pb.primary_input() == jpb.primary_input()
    assert pb.auxiliary_input() == jpb.auxiliary_input()
    assert board(pb) == board(jpb)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_universal_rejects_wrong_answer(pkg):
    pb, g, answer, accepted = _witnessed(pkg, "wrong_answer", 16, 4, None, 3)
    assert not accepted
    assert pb.first_unsatisfied() is not None


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_universal_tampered_memory_rejected(pkg):
    pb, g, answer, accepted = _witnessed(pkg, "memory", 16, 4, None, 6)
    assert accepted and pb.first_unsatisfied() is None
    pb.setval(g.mem_out[2], 99)          # the LOADW step's loaded value
    assert pb.first_unsatisfied() is not None


# ------------------------------------------------------- RAM ppzkSNARK

@pytest.fixture(scope="module")
def ram_keys():
    """The port's and the JAX package's keys for (16, 4, 5, 5) from their
    host fixed-base paths, seed 123."""
    ap = tinyram.TinyRAMParams(w=16, k=4)
    rs = RAMPpzksnark(get_curve("alt_bn128"), device="cpu")
    rs.host_keygen = True
    kp = rs.ram_generator(ap, 5, 5, seed=GEN_SEED)
    jrs = JaxRAMPpzksnark(jax_get_curve("alt_bn128"))
    jrs.host_keygen = True
    jkp = jrs.ram_generator(jax_tinyram.TinyRAMParams(w=16, k=4), 5, 5,
                            seed=GEN_SEED)
    return rs, kp, jrs, jkp


def _bctv14(kp):
    return types.SimpleNamespace(pk=kp.pk.r1cs_pk, vk=kp.vk)


def test_ram_keys_equal_jax(ram_keys):
    rs, kp, jrs, jkp = ram_keys
    assert kp.pk.r1cs_pk.r1cs_dev.num_constraints == 4765
    assert (kp.pk.boot_trace_size_bound, kp.pk.time_bound) == (5, 5)
    assert_keys_equal(_bctv14(kp), _bctv14(jkp), QUERIES, "r1cs_dev",
                      ("A", "B", "C"))


def test_ram_proof_verifies_and_rejects_changed_boot_input(ram_keys):
    """The port's CPU proof (plain versions of every kernel): accepted;
    rejected with one boot-input element changed or one fewer; the
    unsatisfiable example refused by the prover."""
    rs, kp, _, _ = ram_keys
    prog = program(tinyram, "arith")
    proof, boot = rs.ram_prover(kp.pk, prog, [], [], seed=PROVE_SEED)
    assert len(boot) == 5
    assert rs.ram_verifier(kp.vk, boot, proof)
    assert not rs.ram_verifier(kp.vk, [boot[0] + 1] + boot[1:], proof)
    assert not rs.ram_verifier(kp.vk, boot[:-1], proof)
    with pytest.raises(AssertionError, match="did not accept"):
        rs.ram_prover(kp.pk, program(tinyram, "wrong_answer"), [], [],
                      seed=PROVE_SEED)


@pytest.mark.slow
def test_ram_proof_equals_jax(ram_keys):
    """The port's proof from its own key and from the JAX key carried
    across by interop equal the JAX package's proof (its prover compiles
    and runs on the CPU: minutes), and both packages' verdicts agree."""
    rs, kp, jrs, jkp = ram_keys
    prog, jprog = program(tinyram, "arith"), program(jax_tinyram, "arith")
    jproof, jboot = jrs.ram_prover(jkp.pk, jprog, [], [], seed=PROVE_SEED)
    proof, boot = rs.ram_prover(kp.pk, prog, [], [], seed=PROVE_SEED)
    assert boot == jboot
    assert coords(proof) == coords(jproof)
    jdev = jkp.pk.r1cs_pk.r1cs_dev
    jvk = jkp.vk
    vk_points = {n: coords(getattr(jvk, n)) for n in (
        "alphaA_g2", "alphaB_g1", "alphaC_g2", "gamma_g2", "gamma_beta_g1",
        "gamma_beta_g2", "rC_Z_g2")}
    vk_points["IC"] = [coords(jvk.encoded_IC_query.first)] + \
        coords(jvk.encoded_IC_query.rest.values)
    carried = ram_ppzksnark_keypair_from_numpy(
        rs, 16, 4, 5, 5, numpy_queries(jkp.pk.r1cs_pk, QUERIES),
        numpy_matrices(jdev, ("A", "B", "C")), vk_points,
        jdev.num_constraints, jdev.num_inputs, jdev.num_variables)
    assert coords(carried.vk) == coords(kp.vk)
    proof2, _ = rs.ram_prover(carried.pk, prog, [], [], seed=PROVE_SEED)
    assert coords(proof2) == coords(jproof)
    bad = [boot[0] + 1] + boot[1:]
    assert rs.ram_verifier(carried.vk, boot, proof2) == \
        jrs.ram_verifier(jkp.vk, jboot, jproof) is True
    assert rs.ram_verifier(carried.vk, bad, proof2) == \
        jrs.ram_verifier(jkp.vk, bad, jproof) is False


# --------------------------------------------------------- RAM zkSNARK

@pytest.fixture(scope="module")
def bls():
    return get_curve("bls12_377"), jax_get_curve("bls12_377")


def _arch(m, tr, depth=7):
    return m.RamZkSnarkArchParams(ap=tr.TinyRAMParams(w=16, k=4),
                                  tree_depth=depth)


def _chain(which, curve, name, T, depth=7):
    m, tr = (rz, tinyram) if which == "torch" else (jax_rz, jax_tinyram)
    arch = _arch(m, tr, depth)
    rs = (m.RamZkSnark(curve, device="cpu") if which == "torch"
          else m.RamZkSnark(curve))
    pred, msgs, _ = rs.run_and_chain(arch, program(tr, name), [], [], T,
                                     check=True)
    return rs, arch, pred, msgs


def test_ram_predicate_r1cs_equals_jax(bls):
    curve, jcurve = bls
    pred = rz.RamCompliancePredicate(curve.r, _arch(rz, tinyram))
    jpred = jax_rz.RamCompliancePredicate(jcurve.r, _arch(jax_rz,
                                                          jax_tinyram))
    assert pred.pb.num_constraints == 18838
    assert board(pred.pb) == board(jpred.pb)


@pytest.mark.parametrize("name,T", [("memory", 6), ("wrong_answer", 2)])
def test_ram_message_chain_equals_jax(bls, name, T):
    """Every message of the chain and the board after the last step (its
    witness) equal the JAX package's; each step satisfied."""
    curve, jcurve = bls
    _, _, pred, msgs = _chain("torch", curve, name, T)
    _, _, jpred, jmsgs = _chain("jax", jcurve, name, T)
    assert plain(msgs) == plain(jmsgs)
    assert board(pred.pb) == board(jpred.pb)
    assert msgs[-1].has_accepted == (name == "memory")


def test_ram_compliance_predicate_memory_chain(bls):
    """tests/test_ram_zksnark.py's store/load chain on the port."""
    curve, _ = bls
    T = 6
    rs, arch, pred, msgs = _chain("torch", curve, "memory", T)
    assert len(msgs) == T + 1
    final = msgs[-1]
    assert final.has_accepted == 1 and final.timestamp == T
    assert final.root_initial == msgs[0].root
    assert msgs[2].root != msgs[0].root      # the STOREW moved the root
    prog = program(tinyram, "memory")
    kp = rs.generator(arch, _keygen=False)
    assert rs.check_final_message(kp.vk, prog, [], T, msgs[0], final)
    assert not rs.check_final_message(kp.vk, prog, [], T + 1, msgs[0], final)
    pred.pb.setval(pred.msg_out.regs[0], 1234)
    assert pred.pb.first_unsatisfied() is not None


def test_ram_compliance_predicate_rejects_tampering(bls):
    """A forged instruction word or a flipped fetch-path digest bit breaks
    the circuit; restored, it holds again."""
    curve, _ = bls
    rs, arch, pred, msgs = _chain("torch", curve, "wrong_answer", 2)
    assert msgs[-1].has_accepted == 0
    prog = program(tinyram, "wrong_answer")
    pb = pred.pb
    forged = dataclasses.replace(prog.instructions[1], arg2idx_or_imm=0,
                                 arg2_is_imm=True)
    pb.setval(pred.instruction, forged.as_dword(arch.ap))
    pred.cpu.unpack_instr.generate_r1cs_witness_from_packed()
    assert pb.first_unsatisfied() is not None
    pb.setval(pred.instruction, prog.instructions[1].as_dword(arch.ap))
    pred.cpu.unpack_instr.generate_r1cs_witness_from_packed()
    assert pb.first_unsatisfied() is None
    b = pred.fetch_path.left_digests[0].bits[0]
    pb.setval(b, 1 - pb.val(b))
    assert pb.first_unsatisfied() is not None


def test_statement_hash_matches_circuit(bls):
    curve, jcurve = bls
    _, arch, pred, msgs = _chain("torch", curve, "accept_now", 1, depth=4)
    h = rz.statement_hash(curve.r, arch, msgs[0], msgs[1])
    assert pred.pb.primary_input() == h
    _, jarch, _, jmsgs = _chain("jax", jcurve, "accept_now", 1, depth=4)
    assert h == jax_rz.statement_hash(jcurve.r, jarch, jmsgs[0], jmsgs[1])
    assert rz.message_hash(curve.r, arch, msgs[1]) == h[1]


@pytest.fixture(scope="module")
def transcript(bls):
    """tests/test_ram_zksnark.py's transcript: the accept-now program at
    T = 2, depth 4, each step's inner proof a trapdoor Groth16 proof of
    the port over that step's assignment."""
    curve, _ = bls
    T = 2
    rs, arch, pred, msgs = _chain("torch", curve, "accept_now", T, depth=4)
    cs = pred.pb.get_constraint_system()
    mem, trace = rs._trace(arch, program(tinyram, "accept_now"), [], [], T)
    cur, vk, proofs, statements = msgs[0], None, [], []
    for step in trace:
        cur = pred.witness_step(cur, step, mem)
        primary = pred.pb.primary_input()
        statements.append(primary)
        vk, proof = trapdoor_groth16(curve, cs, primary,
                                     pred.pb.auxiliary_input())
        proofs.append(proof)
    kp = rs.generator(arch, _keygen=False)
    kp.vk.inner_vk = vk
    zkp = rz.RamZkSnarkProof(messages=[msgs[0], msgs[-1]],
                             inner_proofs=proofs)
    return dict(rs=rs, arch=arch, T=T, msgs=msgs, kp=kp, zkp=zkp,
                statements=statements, pred=pred)


def test_verify_transcript_with_trapdoor_proofs(transcript):
    rs, kp, zkp, msgs, T = (transcript[k] for k in ("rs", "kp", "zkp",
                                                    "msgs", "T"))
    prog = program(tinyram, "accept_now")
    assert msgs[-1].has_accepted == 1
    assert [rz.message_hash(rs.p, kp.vk.arch, m) for m in msgs[:2]] == \
        transcript["statements"][0]
    assert rs.verify_transcript(kp.vk, prog, [], T, zkp, all_messages=msgs)
    bad = list(msgs)
    bad[1] = dataclasses.replace(bad[1], pc_addr=bad[1].pc_addr + 1)
    assert not rs.verify_transcript(kp.vk, prog, [], T, zkp,
                                    all_messages=bad)
    bad2 = list(msgs)
    bad2[-1] = dataclasses.replace(bad2[-1], has_accepted=0)
    assert not rs.verify_transcript(kp.vk, prog, [], T, zkp,
                                    all_messages=bad2)
    swapped = rz.RamZkSnarkProof(messages=zkp.messages,
                                 inner_proofs=zkp.inner_proofs[::-1])
    assert not rs.verify_transcript(kp.vk, prog, [], T, swapped,
                                    all_messages=msgs)
    assert not rs.verify_transcript(kp.vk, prog, [], T, zkp,
                                    all_messages=msgs[:-1])


def test_outer_circuit_r1cs_equals_jax(bls, transcript):
    """build_outer_circuit at T = 1, depth 4 over the transcript's inner vk
    (carried to the JAX package as integer coordinates): the constraints,
    in order, equal the JAX package's."""
    curve, jcurve = bls
    bw6, jbw6 = get_curve("bw6_761"), jax_get_curve("bw6_761")
    vk = transcript["kp"].vk.inner_vk
    arch = transcript["arch"]
    jarch = _arch(jax_rz, jax_tinyram, depth=4)
    gc.disable()
    try:
        pb, blocks, gadgets = transcript["rs"].build_outer_circuit(
            bw6, vk, arch, 1)
        jrs = jax_rz.RamZkSnark(jcurve)
        jpb, jblocks, _ = jrs.build_outer_circuit(jbw6, carry_vk(jcurve, vk),
                                                  jarch, 1)
        assert (pb.num_inputs, len(blocks)) == (2 * curve.r.bit_length(), 2)
        assert_same_board(pb, jpb)
        print(f"outer circuit at T = 1: {pb.num_constraints} constraints")
    finally:
        gc.enable()


def test_ram_entry_points_need_a_card_unless_cpu_is_asked(bls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RAMPpzksnark(get_curve("alt_bn128"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rz.RamZkSnark(bls[0])
