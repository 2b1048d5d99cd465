"""The port's TinyRAM layer against the JAX package's, bit for bit, on the
CPU: the ISA and its encoding, the executors' traces, boot traces and the
memory interfaces (delegated-memory roots and paths), FOORAM and its
checker gadget, integer permutations and their seeded draws, Benes and
AS-Waksman routing, both routing gadgets (R1CS and witness) and the RAM
example samplers.

Every case of tests/test_tinyram.py, tests/test_routing.py and
tests/test_routing_gadgets.py runs here once per package (the ``pkg``
fixture: "jax" and "torch"), and beside it a test that the two packages'
outputs for the same seeded inputs are equal: ints, bits, traces, routing
settings in their order, constraints (terms, coefficients, annotations)
and witnesses. All of it is host Python. Tolerance: zero.
"""
import importlib
import random
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from _torch_port import board, plain

P = int("21888242871839275222246405745257275088"
        "548364400416034343698204186575808495617")
PKGS = {"jax": "libsnark_tpu", "torch": "libsnark_tpu_torch"}
MODULES = {
    "tinyram": "relations.tinyram", "memory": "relations.memory",
    "fooram": "relations.fooram", "examples": "relations.examples",
    "perm": "common.integer_permutation", "routing": "common.routing",
    "pbd": "gadgets.protoboard", "fooram_checker": "gadgets.fooram_checker",
    "routing_gadgets": "gadgets.routing_gadgets",
    "sha256_host": "gadgets.hashes.sha256_host",
    "knapsack": "gadgets.hashes.knapsack",
    "ram_universal": "gadgets.ram_universal"}


def _ns(root: str):
    return SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{m}") for k, m in MODULES.items()})


BOTH = {name: _ns(root) for name, root in PKGS.items()}
J, T = BOTH["jax"], BOTH["torch"]


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return BOTH[request.param]


# ------------------------------------------------------------------- programs
# the programs of tests/test_tinyram.py: (w, k, [(opcode, imm, des, a1, a2)],
# primary tape)
PROGRAMS = {
    "arithmetic": (16, 4, [("MOV", True, 0, 0, 7), ("MOV", True, 1, 0, 5),
                           ("ADD", False, 2, 0, 1), ("MULL", True, 2, 2, 3),
                           ("SUB", True, 2, 2, 36),
                           ("ANSWER", False, 0, 0, 2)], []),
    "memory_and_tape": (16, 4, [("READ", True, 0, 0, 0),
                                ("STOREW", True, 0, 0, 64),
                                ("LOADW", True, 1, 0, 64),
                                ("SUB", False, 2, 0, 1),
                                ("ANSWER", False, 0, 0, 2)], [21]),
    "byte_semantics": (16, 8, [("MOV", True, 0, 0, 0xABCD),
                               ("STOREW", True, 0, 0, 100),
                               ("MOV", True, 1, 0, 0x7777),
                               ("STOREB", True, 1, 0, 101),
                               ("LOADW", True, 2, 0, 100),
                               ("LOADB", True, 3, 0, 100),
                               ("LOADB", True, 4, 0, 101),
                               ("STOREW", True, 0, 0, 102),
                               ("LOADB", True, 5, 0, 103),
                               ("ANSWER", True, 0, 0, 0)], []),
    "control_flow": (16, 4, [("MOV", True, 0, 0, 5), ("SUB", True, 0, 0, 1),
                             ("CMPE", True, 0, 0, 0),
                             ("CNJMP", True, 0, 0, 1),
                             ("ANSWER", False, 0, 0, 0)], []),
    # every arithmetic opcode once, 32-bit words, signed and unsigned
    "alu_w32": (32, 16, [("MOV", True, 1, 0, 0xFFFFFFF0),
                         ("MOV", True, 2, 0, 7), ("AND", False, 3, 1, 2),
                         ("OR", False, 4, 1, 2), ("XOR", False, 5, 1, 2),
                         ("NOT", False, 6, 0, 1), ("UMULH", False, 7, 1, 1),
                         ("SMULH", False, 8, 1, 2), ("UDIV", False, 9, 1, 2),
                         ("UMOD", False, 10, 1, 2), ("SHL", True, 11, 2, 30),
                         ("SHR", True, 12, 1, 3), ("CMPA", False, 0, 1, 2),
                         ("CMOV", False, 13, 0, 2), ("CMPG", False, 0, 1, 2),
                         ("CMPAE", False, 0, 2, 2), ("CMPGE", False, 0, 1, 1),
                         ("CJMP", True, 0, 0, 19), ("ANSWER", True, 0, 0, 1),
                         ("SUB", False, 14, 2, 2),
                         ("ANSWER", False, 0, 0, 14)], []),
}


def program(ns, name):
    w, k, instrs, tape = PROGRAMS[name]
    prog = ns.tinyram.TinyRAMProgram()
    for op, imm, des, a1, a2 in instrs:
        prog.add(ns.tinyram.Opcode[op], imm, des, a1, a2)
    return ns.tinyram.TinyRAMParams(w=w, k=k), prog, tape


# ---------------------------------------------------- ISA and the executor

def test_opcodes_and_params_equal_jax():
    assert [(o.name, int(o)) for o in T.tinyram.Opcode] == \
        [(o.name, int(o)) for o in J.tinyram.Opcode]
    for name in ("REGISTER_OPCODES", "CONTROL_FLOW_OPCODES", "STALL_OPCODES"):
        assert sorted(map(int, getattr(T.tinyram, name))) == \
            sorted(map(int, getattr(J.tinyram, name))), name
    props = ("address_size", "value_size", "opcode_width", "reg_arg_width",
             "reg_arg_or_imm_width", "instruction_padding_width",
             "dwaddr_len", "bytes_in_word", "subaddr_len")
    for w, k in ((8, 2), (16, 4), (16, 16), (32, 16), (64, 32)):
        a, b = T.tinyram.TinyRAMParams(w, k), J.tinyram.TinyRAMParams(w, k)
        assert [getattr(a, p) for p in props] == \
            [getattr(b, p) for p in props], (w, k)


def test_instruction_encoding_roundtrip(pkg):
    ap = pkg.tinyram.TinyRAMParams(w=16, k=16)
    Op, Ins = pkg.tinyram.Opcode, pkg.tinyram.TinyRAMInstruction
    for ins in [Ins(Op.ADD, True, 3, 5, 1234), Ins(Op.LOADW, False, 7, 0, 9),
                pkg.tinyram.DEFAULT_INSTRUCTION]:
        dw = ins.as_dword(ap)
        assert dw < (1 << (2 * ap.w))
        assert Ins.from_dword(ap, dw) == ins


@pytest.mark.parametrize("w,k", [(16, 4), (16, 16), (32, 16)])
def test_instruction_dwords_equal_jax(w, k):
    rng = random.Random(w * k)
    aps = [ns.tinyram.TinyRAMParams(w=w, k=k) for ns in (T, J)]
    for _ in range(500):
        fields = (rng.randrange(32), bool(rng.getrandbits(1)),
                  rng.randrange(1 << aps[0].reg_arg_width),
                  rng.randrange(1 << aps[0].reg_arg_width),
                  rng.randrange(1 << aps[0].reg_arg_or_imm_width))
        dws = [ns.tinyram.TinyRAMInstruction(
            ns.tinyram.Opcode(fields[0]), *fields[1:]).as_dword(ap)
            for ns, ap in zip((T, J), aps)]
        assert dws[0] == dws[1]
        assert plain(T.tinyram.TinyRAMInstruction.from_dword(
            aps[0], dws[0])) == plain(J.tinyram.TinyRAMInstruction.from_dword(
                aps[1], dws[1]))


def test_executor_arithmetic_and_answer(pkg):
    ap, prog, tape = program(pkg, "arithmetic")
    answer, accepted, trace = pkg.tinyram.TinyRAMExecutor(ap, prog).run(
        tape, [])
    assert answer == 0 and accepted
    assert trace[-1].instruction.opcode == pkg.tinyram.Opcode.ANSWER


def test_executor_memory_and_tape(pkg):
    ap, prog, tape = program(pkg, "memory_and_tape")
    answer, accepted, trace = pkg.tinyram.TinyRAMExecutor(ap, prog).run(
        tape, [])
    assert accepted
    # byte address 64 -> dword cell 16 (subaddr_len=2), lower word
    assert [s.mem_op for s in trace if s.mem_op] == \
        [("w", 16, 0, 21), ("r", 16, 21, 21)]


def test_executor_byte_semantics(pkg):
    ap, prog, tape = program(pkg, "byte_semantics")
    assert ap.subaddr_len == 2                 # 4 bytes per dword
    answer, accepted, trace = pkg.tinyram.TinyRAMExecutor(ap, prog).run(
        tape, [])
    assert accepted
    final_regs = trace[-1].regs_before
    assert final_regs[2] == 0x77CD             # byte 1 replaced by 0x77
    assert final_regs[3] == 0xCD               # low byte of stored word
    assert final_regs[4] == 0x77               # the STOREB byte
    assert final_regs[5] == 0xAB               # high byte of word 1


def test_executor_control_flow(pkg):
    ap, prog, tape = program(pkg, "control_flow")
    answer, accepted, trace = pkg.tinyram.TinyRAMExecutor(ap, prog).run(
        tape, [])
    assert accepted
    # 1 mov + 5*(sub,cmpe,cnjmp) + answer
    assert len(trace) == 1 + 15 + 1


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_executor_traces_equal_jax(name):
    """Both executors (from the tapes and from the boot trace) give the
    same answer, acceptance and trace, step for step."""
    outs = []
    for ns in (T, J):
        ap, prog, tape = program(ns, name)
        run = ns.tinyram.TinyRAMExecutor(ap, prog).run(tape, [5, 6])
        boot = ns.tinyram.tinyram_boot_trace(ap, prog, tape)
        unified = ns.tinyram.TinyRAMUnifiedExecutor(ap, prog).run_from_boot(
            boot, tape, [5, 6], max_steps=40)
        outs.append(plain((run, boot, unified)))
    assert outs[0] == outs[1]


def test_boot_trace_layout(pkg):
    ap = pkg.tinyram.TinyRAMParams(w=16, k=4)
    prog = pkg.tinyram.TinyRAMProgram()
    prog.add(pkg.tinyram.Opcode.ANSWER, True, 0, 0, 0)
    contents = pkg.tinyram.tinyram_boot_trace(ap, prog, [42, 43])
    assert contents[0] == prog.instructions[0].as_dword(ap)
    assert contents[1] == 42 and contents[2] == 43


def test_memory_interfaces(pkg):
    m = pkg.memory.RAMemory(256, 16, {3: 99})
    assert m.get_value(3) == 99 and m.get_value(5) == 0
    m.set_value(5, 7)
    assert m.get_value(5) == 7
    t = pkg.memory.MemoryStoreTrace()
    t.set_trace_entry(1, (10, 100))
    t.set_trace_entry(2, (20, 200))
    assert t.get_trace_entry(1) == (10, 100)
    assert t.as_memory_contents() == {10: 100, 20: 200}


def test_delegated_memory_root_changes(pkg):
    m = pkg.memory.DelegatedRAMemory(
        8, 16, pkg.sha256_host.sha256_two_to_one_hash_bits, {0: 5})
    r1 = m.get_root()
    m.set_value(3, 77)
    assert m.get_root() != r1
    assert m.get_value(3) == 77
    assert len(m.get_path(3)) == 3


@pytest.mark.parametrize("hash_name", ["sha256", "knapsack"])
def test_delegated_memory_roots_and_paths_equal_jax(hash_name):
    """Roots and authentication paths after a run of seeded stores, under
    the SHA-256 compression and under the knapsack CRH over BLS12-377's r
    (the RAM zkSNARK's tree)."""
    r = int("8444461749428370424248824938781546531375899335154063827935233"
            "455917409239041")
    rng = random.Random(7)
    stores = [(rng.randrange(64), rng.randrange(1 << 32)) for _ in range(12)]
    outs = []
    for ns in (T, J):
        if hash_name == "sha256":
            m = ns.memory.DelegatedRAMemory(
                64, 32, ns.sha256_host.sha256_two_to_one_hash_bits,
                {0: 5, 9: 1 << 31})
        else:
            m = ns.memory.DelegatedRAMemory(
                64, 32, ns.knapsack.KnapsackTwoToOneHashGadget.hash_fn(r),
                {0: 5, 9: 1 << 31}, digest_size=r.bit_length())
        seen = [m.get_root()]
        for addr, v in stores:
            m.set_value(addr, v)
            seen.append((m.get_root(), m.get_path(addr), m.get_value(addr)))
        outs.append(plain(seen))
    assert outs[0] == outs[1]


# ------------------------------------------------------------------ FOORAM

def test_fooram(pkg):
    ex = pkg.fooram.FooRAMExecutor(pkg.fooram.FooRAMParams(w=8),
                                   {0: 3, 3: 5, 8: 2})
    acc, trace = ex.run(3)
    # acc: 0+3=3 -> pc 3; 3+5=8 -> pc 8; 8+2=10
    assert acc == 10 and len(trace) == 3


def _fooram_boards(ns):
    """The checker gadget over each step of a FOORAM run: its boards."""
    ap = ns.fooram.FooRAMParams(w=8)
    acc, trace = ns.fooram.FooRAMExecutor(ap, {0: 3, 3: 250, 8: 2}).run(2)
    state_acc, state_pc, boards = 0, 0, []
    for ts, pc_after, acc_after, v in trace:
        pb = ns.pbd.Protoboard(P)
        a0, p0, mv, a1, p1 = (ns.pbd.PBVariable().allocate(pb, n)
                              for n in ("a0", "p0", "mv", "a1", "p1"))
        g = ns.fooram_checker.FooRAMCPUChecker(pb, 8, a0, p0, mv, a1, p1)
        g.generate_r1cs_constraints()
        pb.setval(a0, state_acc)
        pb.setval(p0, state_pc)
        pb.setval(mv, v)
        g.generate_r1cs_witness()
        assert pb.val(a1) == acc_after and pb.val(p1) == pc_after
        assert pb.is_satisfied()
        state_acc, state_pc = acc_after, pc_after
        boards.append(board(pb))
    return plain(trace), boards


def test_fooram_cpu_checker_gadget(pkg):
    _fooram_boards(pkg)


def test_fooram_checker_equals_jax():
    assert _fooram_boards(T) == _fooram_boards(J)


# ----------------------------------------------- permutations and routing

def test_integer_permutation_basics(pkg):
    IP = pkg.perm.IntegerPermutation
    p = IP(5)
    assert p.is_valid()
    p.random_shuffle(random.Random(1))
    assert p.is_valid()
    inv = p.inverse()
    for i in range(5):
        assert inv.get(p.get(i)) == i
    assert IP([2, 0, 1]).is_valid()
    assert not IP([0, 0, 2]).is_valid()


def test_integer_permutation_draws_equal_jax():
    """The same seeded shuffles, slices, inverses and lexicographic steps."""
    outs = []
    for ns in (T, J):
        rng, seen = random.Random(11), []
        for n in (1, 2, 5, 17, 64):
            p = ns.perm.IntegerPermutation(n, min_element=3)
            p.random_shuffle(rng)
            q = p.inverse()
            s = p.slice(4, 3 + n // 2) if n > 2 else p
            nxt = ns.perm.IntegerPermutation(list(p.contents))
            steps = [nxt.next_permutation() for _ in range(3)]
            seen.append((p.contents, q.contents, s.contents, s.min_element,
                         nxt.contents, steps))
        outs.append(seen)
    assert outs[0] == outs[1]


BENES_N = [2, 4, 8, 16, 32]
AS_WAKSMAN_N = [2, 3, 4, 5, 6, 7, 8, 9, 13, 16, 33]


def _route_all(ns, cls_name, n, seed):
    """10 seeded permutations through the network: settings (in their
    order) and simulated outputs; each output checked."""
    rng = random.Random(seed)
    net = getattr(ns.routing, cls_name)(n)
    out = []
    for _ in range(10):
        perm = ns.perm.IntegerPermutation(n)
        perm.random_shuffle(rng)
        settings = net.route(perm)
        sim = net.simulate(settings, list(range(n)))
        assert all(sim[perm.get(i)] == i for i in range(n)), perm.contents
        out.append((perm.contents, list(settings.items()), sim))
    return out


@pytest.mark.parametrize("n", BENES_N)
def test_benes_routes_all(pkg, n):
    _route_all(pkg, "BenesNetwork", n, n)


@pytest.mark.parametrize("n", AS_WAKSMAN_N)
def test_as_waksman_routes_all(pkg, n):
    _route_all(pkg, "ASWaksmanNetwork", n, 100 + n)


@pytest.mark.parametrize("kind,n", [("BenesNetwork", n) for n in BENES_N]
                         + [("ASWaksmanNetwork", n) for n in AS_WAKSMAN_N])
def test_routing_bits_equal_jax(kind, n):
    seed = n if kind == "BenesNetwork" else 100 + n
    assert _route_all(T, kind, n, seed) == _route_all(J, kind, n, seed)
    if kind == "BenesNetwork":
        assert T.routing.benes_num_columns(n) == \
            J.routing.benes_num_columns(n)


def test_identity_and_reverse(pkg):
    for n in (4, 7, 8):
        net = pkg.routing.ASWaksmanNetwork(n)
        ident = pkg.perm.IntegerPermutation(n)
        assert net.simulate(net.route(ident), list(range(n))) == \
            list(range(n))
        rev = pkg.perm.IntegerPermutation(list(reversed(range(n))))
        out = net.simulate(net.route(rev), list(range(n)))
        assert all(out[rev.get(i)] == i for i in range(n))


def _routing_gadget(ns, cls_name, n, words=2, seed=5):
    """tests/test_routing_gadgets.py's run: the board after the witness,
    and the board's verdict with one switch bit flipped."""
    rng = random.Random(seed)
    pb = ns.pbd.Protoboard(P)
    ins = [ns.pbd.PBVariableArray().allocate(pb, words, f"in_{i}")
           for i in range(n)]
    outs = [ns.pbd.PBVariableArray().allocate(pb, words, f"out_{i}")
            for i in range(n)]
    g = getattr(ns.routing_gadgets, cls_name)(pb, ins, outs, "net")
    g.generate_r1cs_constraints()
    perm = ns.perm.IntegerPermutation(n)
    perm.random_shuffle(rng)
    vals = [[rng.randrange(P) for _ in range(words)] for _ in range(n)]
    for pkt, v in zip(ins, vals):
        for var, x in zip(pkt, v):
            pb.setval(var, x)
    g.generate_r1cs_witness(perm)
    assert pb.is_satisfied()
    for i in range(n):
        assert [pb.val(v) for v in outs[perm.get(i)]] == vals[i], i
    witnessed = board(pb)
    some_bit = next(iter(g.switch_bits.values()))
    pb.setval(some_bit, 1 - pb.val(some_bit))
    assert not pb.is_satisfied()
    return witnessed, list(g.switch_bits)


GADGETS = [("BenesRoutingGadget", n) for n in (2, 4, 8)] + \
    [("ASWaksmanRoutingGadget", n) for n in (2, 3, 5, 8, 9)]


@pytest.mark.parametrize("kind,n", GADGETS)
def test_routing_gadget(pkg, kind, n):
    _routing_gadget(pkg, kind, n)


@pytest.mark.parametrize("kind,n", GADGETS + [("ASWaksmanRoutingGadget", 33)])
def test_routing_gadget_r1cs_and_witness_equal_jax(kind, n):
    assert _routing_gadget(T, kind, n, words=3) == \
        _routing_gadget(J, kind, n, words=3)


# ---------------------------------------------------------- RAM samplers

def test_gen_ram_example_simple(pkg):
    ap = pkg.tinyram.TinyRAMParams(w=16, k=4)
    for sat in (True, False):
        prog, primary, aux, T_ = pkg.examples.gen_ram_example_simple(
            ap, 16, 8, sat, seed=3)
        assert prog.size == 8 and len(primary) == 8
        boot = pkg.tinyram.tinyram_boot_trace(ap, prog, primary)
        _, accepted, _ = pkg.tinyram.TinyRAMUnifiedExecutor(
            ap, prog).run_from_boot(boot, primary, aux, T_)
        assert accepted == sat


def test_gen_ram_example_complex(pkg):
    ap = pkg.tinyram.TinyRAMParams(w=16, k=4)
    for sat in (True, False):
        prog, primary, aux, T_ = pkg.examples.gen_ram_example_complex(
            ap, 16, 8, sat, seed=5)
        boot = pkg.tinyram.tinyram_boot_trace(ap, prog, primary)
        _, accepted, _ = pkg.tinyram.TinyRAMUnifiedExecutor(
            ap, prog).run_from_boot(boot, primary, aux, T_)
        assert accepted == sat


@pytest.mark.parametrize("sampler", ["gen_ram_example_simple",
                                     "gen_ram_example_complex"])
@pytest.mark.parametrize("w,k,B,T_", [(16, 4, 16, 8), (32, 16, 102, 128),
                                      (32, 16, 12, 8)])
def test_ram_samplers_equal_jax(sampler, w, k, B, T_):
    outs = []
    for ns in (T, J):
        ap = ns.tinyram.TinyRAMParams(w=w, k=k)
        runs = []
        for sat in (True, False):
            prog, primary, aux, tb = getattr(ns.examples, sampler)(
                ap, B, T_, sat, seed=B + T_)
            runs.append((plain(prog.instructions), primary, aux, tb))
        outs.append(runs)
    assert outs[0] == outs[1]


def _complex_in_circuit(ns):
    ap = ns.tinyram.TinyRAMParams(w=16, k=4)
    prog, primary, aux, _ = ns.examples.gen_ram_example_complex(
        ap, 12, 6, True, seed=9)
    pb, g = ns.ram_universal.ram_to_r1cs_instance_map(P, ap, 12, 6)
    answer, accepted = g.generate_r1cs_witness(prog, primary, aux)
    assert accepted
    assert pb.first_unsatisfied() is None
    return board(pb)


def test_gen_ram_example_complex_in_circuit(pkg):
    _complex_in_circuit(pkg)


def test_complex_example_circuit_equals_jax():
    assert _complex_in_circuit(T) == _complex_in_circuit(J)
