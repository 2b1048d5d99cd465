"""The port's gadgetlib2 (libsnark_tpu_torch/gadgetlib2.py) against the
JAX package's, bit for bit, on the CPU.

The five cases of tests/test_gadgetlib2.py run once per package (the
``gl2`` fixture: "jax" and "torch"). Beside them: each gadget's constraints
and witness, and the adapter's core R1CS (terms, coefficients,
annotations, sizes) and full assignment, equal the JAX package's; and the
x^3 circuit of the adapter case, proved with the port's Groth16 over
alt_bn128 on the CPU (plain versions of every kernel, seeds 5 and 6),
verifies, rejects a wrong input and equals the JAX package's proof.
Tolerance: zero.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.proof_systems.groth16 import Groth16 as JaxGroth16

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.proof_systems.groth16 import Groth16

from _torch_port import coords

P = int("21888242871839275222246405745257275088"
        "548364400416034343698204186575808495617")
MODULES = {"jax": importlib.import_module("libsnark_tpu.gadgetlib2"),
           "torch": importlib.import_module("libsnark_tpu_torch.gadgetlib2")}


@pytest.fixture(params=list(MODULES))
def gl2(request):
    return MODULES[request.param]


def gl2_board(pb):
    """A gadgetlib2 board as plain data: each constraint's (variable name,
    coefficient) terms and constant for a, b and c, with its annotation;
    then the values by variable name. Names stand for the variables, whose
    ids count per package."""
    def lc(x):
        return (sorted((x._vars[v].name, c) for v, c in x.terms.items()),
                x.const)
    vals = sorted((v.name, pb.val(v)) for a, b, c, _ in pb.constraints
                  for x in (a, b, c) for v in x._vars.values())
    return ([(lc(a), lc(b), lc(c), ann) for a, b, c, ann in pb.constraints],
            vals)


# ------------------------------------------------ tests/test_gadgetlib2.py

def _and_or(m):
    pb = m.GL2Protoboard.create(P)
    xs = m.GL2VariableArray(3, "x")
    out_and, out_or = m.GL2Variable("and"), m.GL2Variable("or")
    g1 = m.ANDGadget(pb, xs, out_and)
    g2 = m.ORGadget(pb, xs, out_or)
    g1.generateConstraints()
    g2.generateConstraints()
    seen = []
    for vals, ea, eo in [((1, 1, 1), 1, 1), ((1, 0, 1), 0, 1),
                         ((0, 0, 0), 0, 0)]:
        for v, x in zip(xs, vals):
            pb.setval(v, x)
        g1.generateWitness()
        g2.generateWitness()
        assert pb.val(out_and) == ea and pb.val(out_or) == eo
        assert pb.is_satisfied()
        seen.append(gl2_board(pb))
    return seen


def _packing_and_mux(m):
    pb = m.GL2Protoboard.create(P)
    bits = m.GL2VariableArray(8, "b")
    packed = m.GL2Variable("packed")
    g = m.CompressionPackingGadget(pb, bits, packed)
    g.generateConstraints()
    pb.setval(packed, 0xB7)
    g.generateWitnessFromPacked()
    assert pb.is_satisfied()
    arr = m.GL2VariableArray(4, "arr")
    idx, res, ok = (m.GL2Variable("i"), m.GL2Variable("r"),
                    m.GL2Variable("ok"))
    mux = m.LooseMUXGadget(pb, arr, idx, res, ok)
    mux.generateConstraints()
    for i, v in enumerate([10, 20, 30, 40]):
        pb.setval(arr[i], v)
    pb.setval(idx, 2)
    mux.generateWitness()
    assert pb.val(res) == 30 and pb.val(ok) == 1
    assert pb.is_satisfied()
    return gl2_board(pb)


def _adapter(m, r=P):
    """The x^3 circuit through the adapter: (core cs, primary, aux, the
    adapter's variable order)."""
    pb = m.GL2Protoboard.create(r)
    x, y, x2 = m.GL2Variable("x"), m.GL2Variable("y"), m.GL2Variable("x2")
    pb.set_public([x])
    pb.add_rank1_constraint(x, x, x2, "x*x")
    pb.add_rank1_constraint(x2, x, y, "x2*x")   # y = x^3
    pb.setval(x, 4)
    pb.setval(x2, 16)
    pb.setval(y, 64)
    assert pb.is_satisfied()
    cs, ordered = m.get_constraint_system_from_gadgetlib2(pb)
    full = m.get_variable_assignment_from_gadgetlib2(pb, ordered)
    primary, aux = full[:1], full[1:]
    assert cs.is_satisfied(primary, aux)
    return cs, primary, aux, [v.name for v in ordered]


def _r1p_specializations(m):
    seen = []
    pb = m.GL2Protoboard.create(P)
    x, y = m.GL2Variable("x"), m.GL2Variable("y")
    a, o = m.GL2Variable("a"), m.GL2Variable("o")
    g_and = m.create_and_gadget(pb, [x, y], a)
    g_or = m.create_or_gadget(pb, [x, y], o)
    assert isinstance(g_and, m.BinaryANDGadget)
    assert isinstance(g_or, m.BinaryORGadget)
    g_and.generateConstraints()
    g_or.generateConstraints()
    for vx, vy in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        pb.setval(x, vx)
        pb.setval(y, vy)
        g_and.generateWitness()
        g_or.generateWitness()
        assert pb.val(a) == (vx & vy) and pb.val(o) == (vx | vy)
        assert pb.is_satisfied()
        seen.append(gl2_board(pb))

    pb2 = m.GL2Protoboard.create(P)
    bits = m.GL2VariableArray(6, "b")
    packed = m.GL2Variable("p")
    gp = m.IntegerPackingGadget(pb2, bits, packed)
    gp.generateConstraints()
    for i in range(6):
        pb2.setval(bits[i], (0x2D >> i) & 1)
    gp.generateWitness()
    assert pb2.val(packed) == 0x2D and pb2.is_satisfied()
    seen.append(gl2_board(pb2))

    pb3 = m.GL2Protoboard.create(P)
    inp, res = m.GL2Variable("i"), m.GL2Variable("r")
    ge = m.EqualsConstGadget(pb3, inp, 7, res)
    ge.generateConstraints()
    for v, want in [(7, 1), (9, 0)]:
        pb3.setval(inp, v)
        ge.generateWitness()
        assert pb3.val(res) == want and pb3.is_satisfied()
        seen.append(gl2_board(pb3))

    pb4 = m.GL2Protoboard.create(P)
    t, z, one, out = (m.GL2Variable("t"), m.GL2Variable("z"),
                      m.GL2Variable("o1"), m.GL2Variable("out"))
    gt = m.ToggleGadget(pb4, t, z, one, out)
    gt.generateConstraints()
    pb4.setval(z, 11)
    pb4.setval(one, 22)
    for tv, want in [(0, 11), (1, 22)]:
        pb4.setval(t, tv)
        gt.generateWitness()
        assert pb4.val(out) == want and pb4.is_satisfied()
        seen.append(gl2_board(pb4))

    pb5 = m.GL2Protoboard.create(P)
    c, f = m.GL2Variable("c"), m.GL2Variable("f")
    gc = m.ConditionalFlagGadget(pb5, c, f)
    gc.generateConstraints()
    for cv, want in [(0, 0), (5, 1)]:
        pb5.setval(c, cv)
        gc.generateWitness()
        assert pb5.val(f) == want and pb5.is_satisfied()
        seen.append(gl2_board(pb5))

    pb6 = m.GL2Protoboard.create(P)
    c6, f6 = m.GL2Variable("c"), m.GL2Variable("f")
    gi = m.LogicImplicationGadget(pb6, c6, f6)
    gi.generateConstraints()
    pb6.setval(c6, 3)
    gi.generateWitness()
    assert pb6.val(f6) == 1 and pb6.is_satisfied()
    pb6.setval(c6, 0)
    pb6.setval(f6, 0)
    gi.generateWitness()
    assert pb6.is_satisfied()
    seen.append(gl2_board(pb6))

    pb7 = m.GL2Protoboard.create(P)
    lhs, rhs = m.GL2Variable("a"), m.GL2Variable("b")
    less, leq = m.GL2Variable("lt"), m.GL2Variable("le")
    gcmp = m.ComparisonGadget(pb7, 8, lhs, rhs, less, leq)
    gcmp.generateConstraints()
    for av, bv in [(3, 200), (200, 3), (42, 42)]:
        pb7.setval(lhs, av)
        pb7.setval(rhs, bv)
        gcmp.generateWitness()
        assert pb7.val(less) == int(av < bv)
        assert pb7.val(leq) == int(av <= bv)
        assert pb7.is_satisfied()
        seen.append(gl2_board(pb7))
    return seen


def _dual_word(m):
    pb = m.GL2Protoboard.create(P)
    dw = m.DualWordGadget(pb, 8, "w")
    dw.generateConstraints()
    dw.generateWitness(0xA5)
    assert [pb.val(b) for b in dw.bits] == [(0xA5 >> i) & 1
                                            for i in range(8)]
    assert pb.is_satisfied()
    dwa = m.DualWordArrayGadget(pb, 3, 8, "wa")
    dwa.generateConstraints()
    dwa.generateWitness([1, 2, 3])
    assert pb.val(dwa.words[2].packed) == 3
    assert pb.is_satisfied()
    return gl2_board(pb)


CASES = {"and_or": _and_or, "packing_and_mux": _packing_and_mux,
         "r1p_specializations": _r1p_specializations,
         "dual_word": _dual_word}


@pytest.mark.parametrize("case", list(CASES))
def test_gadgetlib2_case(gl2, case):
    CASES[case](gl2)


@pytest.mark.parametrize("case", list(CASES))
def test_gadgetlib2_case_equals_jax(case):
    assert CASES[case](MODULES["torch"]) == CASES[case](MODULES["jax"])


def core_terms(cs):
    """A core R1CS's constraints as (index, coeff) terms of a, b and c and
    the annotation."""
    return [tuple(tuple((t.index, t.coeff) for t in lc.terms)
                  for lc in (con.a, con.b, con.c)) + (con.annotation,)
            for con in cs.constraints]


def test_adapter_r1cs_and_assignment_equal_jax():
    cs, primary, aux, names = _adapter(MODULES["torch"])
    jcs, jprimary, jaux, jnames = _adapter(MODULES["jax"])
    assert (primary, aux, names) == (jprimary, jaux, jnames)
    assert (cs.num_constraints, cs.num_inputs, cs.num_variables) == \
        (jcs.num_constraints, jcs.num_inputs, jcs.num_variables)
    assert core_terms(cs) == core_terms(jcs)


@pytest.fixture(scope="module")
def adapter_proofs():
    curve, jcurve = get_curve("alt_bn128"), jax_get_curve("alt_bn128")
    cs, primary, aux, _ = _adapter(MODULES["torch"], curve.r)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        g16 = Groth16(curve, device="cpu")
        kp = g16.generator(cs, seed=5)
        proof = g16.prover(kp.pk, primary, aux, seed=6)
    finally:
        torch.set_num_threads(n)
    jcs, jprimary, jaux, _ = _adapter(MODULES["jax"], jcurve.r)
    jg16 = JaxGroth16(jcurve)
    # the JAX package's host fixed base: the affine points of its device
    # path, without that path's compile
    jg16.host_keygen = True
    jkp = jg16.generator(jcs, seed=5)
    jproof = jg16.prover(jkp.pk, jprimary, jaux, seed=6)
    assert jg16.verifier_strong_IC(jkp.vk, jprimary, jproof)
    return g16, kp, proof, primary, jkp, jproof


def test_adapter_circuit_port_proof_verifies(adapter_proofs):
    g16, kp, proof, primary, _, _ = adapter_proofs
    assert g16.verifier_strong_IC(kp.vk, primary, proof)
    assert not g16.verifier_strong_IC(kp.vk, [primary[0] + 1], proof)


def test_adapter_circuit_port_proof_equals_jax(adapter_proofs):
    _, kp, proof, _, jkp, jproof = adapter_proofs
    assert coords(kp.vk) == coords(jkp.vk)
    assert coords(proof) == coords(jproof)
