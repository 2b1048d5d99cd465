"""The port's cycle half of the RAM zkSNARK (the payload codec,
RamCycleCompliancePredicate, RamZkSnarkCycle's trace) against the JAX
package's, bit for bit, on the CPU; and the device satisfaction check
(PairingSystem.first_unsatisfied: the device R1CS's three mat-vecs, a
product and a subtraction, on the plain versions here) against
Protoboard.first_unsatisfied on the RAM predicate's boards.

TinyRAM w = 16, k = 4 with a delegated tree of depth 7 (tests/
test_ram_zksnark.py's _arch) over MNT4's r: a predicate of 21,981
constraints. RUN_SLOW=1 adds the predicate spliced into the cycle
compliance circuit (base_case "type0") with a trapdoor translation proof
(tests/test_ram_zksnark.py:203), each step's board against the JAX
package's. Tolerance: zero.
"""
import copy

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.proof_systems import compliance_predicate as jax_cp
from libsnark_tpu.proof_systems import ram_zksnark as jax_rz
from libsnark_tpu.relations import tinyram as jax_tinyram

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.proof_systems import ram_zksnark as rz
from libsnark_tpu_torch.proof_systems.compliance_predicate import (
    PCDLocalData, PCDMessage)
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.relations import tinyram

from _torch_port import assert_same_board, plain

T = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arch_of(rz_module, tr_module, w=16, k=4, depth=7):
    return rz_module.RamZkSnarkArchParams(
        ap=tr_module.TinyRAMParams(w=w, k=k), tree_depth=depth)


def program(tr_module):
    """tests/test_ram_zksnark.py:165's store / load program."""
    Op = tr_module.Opcode
    prog = tr_module.TinyRAMProgram()
    prog.add(Op.MOV, True, 0, 0, 55)
    prog.add(Op.STOREW, True, 0, 0, 100)
    prog.add(Op.LOADW, True, 1, 0, 100)
    prog.add(Op.SUB, False, 2, 0, 1)
    prog.add(Op.ANSWER, False, 0, 0, 2)
    return prog


def trace_of(rz_module, tr_module, p):
    """RamZkSnarkCycle._trace without a PCD system (as the JAX test
    does): (arch, delegated memory, the execution padded to T steps)."""
    arch = arch_of(rz_module, tr_module)
    rsc = rz_module.RamZkSnarkCycle.__new__(rz_module.RamZkSnarkCycle)
    rsc.pcd, rsc.p = None, p
    mem, trace = rz_module.RamZkSnarkCycle._trace(
        rsc, arch, program(tr_module), [], [], T)
    return arch, mem, trace


def predicate(rz_module, p, arch):
    h = rz_module.RamCycleCompliancePredicate(p, arch)
    h.generate_r1cs_constraints()
    return h


@pytest.fixture(scope="module")
def chains():
    """tests/test_ram_zksnark.py:155's chain in both packages: a fresh
    predicate a step, each satisfied; the boards, the outgoing PCD
    messages and the decoded RAM messages of every step."""
    out = {}
    for pkg, rz_m, tr_m, cp_m, p in (
            ("port", rz, tinyram, None, get_curve("mnt4").r),
            ("jax", jax_rz, jax_tinyram, jax_cp, jax_get_curve("mnt4").r)):
        arch, mem, trace = trace_of(rz_m, tr_m, p)
        msg = rz_m.RamPCDMessage.initial(arch, mem.get_root())
        local = (PCDLocalData(values=[]) if cp_m is None
                 else cp_m.PCDLocalData(values=[]))
        cur, steps = None, []
        for step in trace:
            h = predicate(rz_m, p, arch)
            h.set_step_context(msg, step, mem)
            pcd_msg = h.generate_r1cs_witness([] if cur is None else [cur],
                                              local)
            assert h.pb.first_unsatisfied() is None
            steps.append((h, pcd_msg, h.last_msg_out))
            msg, cur = h.last_msg_out, pcd_msg
        out[pkg] = dict(arch=arch, p=p, steps=steps, trace=trace)
    return out


def test_ram_cycle_predicate_chain_equals_jax(chains):
    """Every step's predicate board (21,981 constraints, annotations and
    witness) equals the JAX package's; the payloads, the decoded messages
    and the execution are equal; the chain ends accepted at T."""
    port, jax = chains["port"], chains["jax"]
    assert plain(port["trace"]) == plain(jax["trace"])
    assert port["steps"][0][0].pb.num_constraints == 21981
    for (h, m, ram), (jh, jm, jram) in zip(port["steps"], jax["steps"]):
        assert_same_board(h.pb, jh.pb)
        assert (m.type, m.payload) == (jm.type, jm.payload)
        assert plain(ram) == plain(jram)
    last = port["steps"][-1][2]
    assert last.has_accepted == 1 and last.timestamp == T


def test_ram_cycle_payload_codec_round_trip(chains):
    """ram_cycle_payload / payload_to_ram_msg: every step's payload decodes
    to its message in both packages, and the encodings are equal."""
    port, jax = chains["port"], chains["jax"]
    ds = port["p"].bit_length()
    assert rz.ram_cycle_payload_size(port["arch"]) == \
        jax_rz.ram_cycle_payload_size(jax["arch"]) == 2 * 4 + 10
    for (_, m, ram), (_, jm, jram) in zip(port["steps"], jax["steps"]):
        assert rz.payload_to_ram_msg(ds, port["arch"], m.payload) == ram
        assert jax_rz.payload_to_ram_msg(ds, jax["arch"],
                                         jm.payload) == jram
        assert rz.ram_cycle_payload(ds, port["arch"], ram) == \
            jax_rz.ram_cycle_payload(ds, jax["arch"], jram) == m.payload


def test_base_claim_mid_chain_rejected_alike():
    """A type-0 (base) claim with a nonzero timestamp is refused by both
    packages at the same constraint."""
    verdicts = []
    for rz_m, tr_m, local, p in (
            (rz, tinyram, PCDLocalData(values=[]), get_curve("mnt4").r),
            (jax_rz, jax_tinyram, jax_cp.PCDLocalData(values=[]),
             jax_get_curve("mnt4").r)):
        arch, mem, trace = trace_of(rz_m, tr_m, p)
        h = predicate(rz_m, p, arch)
        h.set_step_context(rz_m.RamPCDMessage.initial(arch, mem.get_root()),
                           trace[0], mem)
        h.generate_r1cs_witness([], local)
        h.pb.setval(h.msg_in.ts, 5)
        verdicts.append(h.pb.first_unsatisfied())
    assert verdicts[0] is not None and verdicts[0] == verdicts[1]


@pytest.fixture(scope="module")
def device_r1cs(chains):
    """The predicate's device R1CS on the CPU (the form a proving key
    holds, without the keygen) and the system that checks on it."""
    g16 = Groth16(get_curve("mnt4"), device="cpu")
    pb = chains["port"]["steps"][0][0].pb
    return g16, pb.get_constraint_system().to_device(g16.fr)


def tamper(pb, where: str):
    """Change one witness value of the board: the first primary input, a
    middle auxiliary value or the last variable."""
    i = {"primary": 1, "middle": pb.num_variables // 2,
         "last": pb.num_variables}[where]
    pb._values[i] = (pb._values[i] + 1) % pb.p


@pytest.mark.parametrize("step", [0, 1, T - 1])
def test_device_check_on_satisfied_boards(chains, device_r1cs, step):
    """Satisfied boards of the chain (the base step, the next, the last):
    the device check's verdict is None, as the host check's."""
    g16, dev = device_r1cs
    pb = chains["port"]["steps"][step][0].pb
    assert pb.first_unsatisfied() is None
    assert g16.first_unsatisfied(dev, pb) is None


@pytest.mark.parametrize("where", ["primary", "middle", "last",
                                   "base_claim"])
def test_device_check_on_tampered_boards(chains, device_r1cs, where):
    """One witness value changed on a satisfied board (or the base claim
    with a nonzero timestamp): the device check returns exactly
    Protoboard.first_unsatisfied()'s verdict and message."""
    g16, dev = device_r1cs
    port = chains["port"]
    h = predicate(rz, port["p"], port["arch"])
    arch, mem, trace = trace_of(rz, tinyram, port["p"])
    h.set_step_context(rz.RamPCDMessage.initial(arch, mem.get_root()),
                       trace[0], mem)
    h.generate_r1cs_witness([], PCDLocalData(values=[]))
    if where == "base_claim":
        h.pb.setval(h.msg_in.ts, 5)
    else:
        tamper(h.pb, where)
    bad = h.pb.first_unsatisfied()
    assert bad is not None
    assert g16.first_unsatisfied(dev, h.pb) == bad


def test_qap_on_device_equals_host_qap(chains, device_r1cs):
    """Groth16's keygen evaluates the QAP at t as the device R1CS's
    transposed products (qap_instance_map_on_device): A_i(t), B_i(t),
    C_i(t), t^i and Z(t) equal the host evaluation's on the predicate's
    system (a TwoPartDomain of 24,576)."""
    from libsnark_tpu_torch.reductions.r1cs_to_qap import (
        qap_domain, qap_instance_map_on_device,
        qap_instance_map_with_evaluation)
    g16, dev = device_r1cs
    cs = chains["port"]["steps"][0][0].pb.get_constraint_system()
    domain = qap_domain(g16.fr, g16.curve.fr_params, cs)
    t = 0x5EED ** 7 % g16.curve.r
    host = qap_instance_map_with_evaluation(cs, domain, t)
    assert qap_instance_map_on_device(dev, domain, t) == host


@pytest.mark.slow
def test_ram_cycle_compliance_splice_with_trapdoor_translation():
    """tests/test_ram_zksnark.py:203 on the port: the RAM predicate
    (w = 16, k = 2, depth 4) spliced into the cycle compliance circuit
    (base_case "type0"), base and successor steps satisfied with a
    trapdoor translation proof, the hash chain equal to message_hash, the
    base step's board equal to the JAX package's, and a wrong-statement
    proof refused."""
    from libsnark_tpu.proof_systems.pcd_cycle import CycleSpPCD as JaxCycle
    from libsnark_tpu_torch.proof_systems.pcd_cycle import CycleSpPCD
    from libsnark_tpu_torch.relations.r1cs import R1CSConstraintSystem
    from libsnark_tpu_torch.relations.variable import Variable
    from _torch_port import carry_vk, trapdoor_groth16

    pcd, jpcd = CycleSpPCD(device="cpu"), JaxCycle()
    A, B = pcd.A, pcd.B

    def dummy_vk(statement, seed=7):
        cs = R1CSConstraintSystem(B.r, 1, 1)
        w = Variable(2)
        cs.add_constraint(w * 1, w * 1, w * 1, "w_bool")
        return trapdoor_groth16(B, cs, [statement % B.r], [0], seed=seed)

    vk_b, _ = dummy_vk(123)
    boards = []
    for pkg in ("port", "jax"):
        rz_m, tr_m = (rz, tinyram) if pkg == "port" else (jax_rz,
                                                          jax_tinyram)
        arch = arch_of(rz_m, tr_m, k=2, depth=4)
        Op = tr_m.Opcode
        prog = tr_m.TinyRAMProgram()
        prog.add(Op.MOV, True, 0, 0, 7)
        prog.add(Op.STOREW, True, 0, 0, 5)
        prog.add(Op.ANSWER, True, 0, 0, 0)
        cyc = pcd if pkg == "port" else jpcd
        rsc = rz_m.RamZkSnarkCycle(cyc)
        h0 = rsc.predicate(arch)
        mem, trace = rsc._trace(arch, prog, [], [], 2)
        msg = rz_m.RamPCDMessage.initial(arch, mem.get_root())
        h = rsc.predicate(arch)
        h.set_step_context(msg, trace[0], mem)
        C = cyc.build_compliance_circuit(h0.get_constraint_system(), 1,
                                         len(h0.outgoing),
                                         base_case="type0")
        local = (PCDLocalData(values=[]) if pkg == "port"
                 else jax_cp.PCDLocalData(values=[]))
        cyc.witness_compliance(C, h, vk_b if pkg == "port"
                               else carry_vk(jpcd.B, vk_b), [], [], local)
        boards.append(C["pb"])
        if pkg == "jax":
            assert_same_board(*boards)
            break
        assert C["pb"].first_unsatisfied() is None
        out = PCDMessage(C["pb"].val(C["out_block"][0]),
                         [C["pb"].val(v) for v in C["out_block"][1:]])
        h_prev = C["pb"].primary_input()[0]
        assert h_prev == pcd.message_hash(vk_b, out)
        mem_bad = copy.deepcopy(mem)         # the memory after step 0
        h1 = rsc.predicate(arch)
        h1.set_step_context(h.last_msg_out, trace[1], mem)
        _, pi = dummy_vk(h_prev)
        C1 = pcd.build_compliance_circuit(h0.get_constraint_system(), 1,
                                          len(h0.outgoing),
                                          base_case="type0")
        pcd.witness_compliance(C1, h1, vk_b, [out], [pi],
                               PCDLocalData(values=[]))
        assert C1["pb"].first_unsatisfied() is None
        final = rz.payload_to_ram_msg(A.r.bit_length(), arch, [
            C1["pb"].val(v) for v in C1["out_block"][1:]])
        # two steps run MOV and STOREW: the ANSWER is the third (the JAX
        # test asserts has_accepted == 1 here, which its own trace does
        # not reach)
        assert final == h1.last_msg_out
        assert final.timestamp == 2 and final.has_accepted == 0
        _, pi_bad = dummy_vk(h_prev + 1)
        h2 = rsc.predicate(arch)
        h2.set_step_context(h.last_msg_out, trace[1], mem_bad)
        pcd.witness_compliance(C1, h2, vk_b, [out], [pi_bad],
                               PCDLocalData(values=[]))
        assert C1["pb"].first_unsatisfied() is not None
        del C1
