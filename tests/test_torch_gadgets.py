"""The port's gadget layer (libsnark_tpu_torch/gadgets, common/merkle_tree,
common/set_commitment) against the JAX package's, bit for bit.

Each case builds the same circuit in both packages, from the same seeded
inputs, at the sizes of the JAX package's own tests
(tests/test_gadgets_basic.py, test_fields_gadgets.py,
test_pairing_gadgets.py, test_curve_scalar_mul.py, test_sha256.py,
test_merkle.py, test_set_commitment.py; the cases of their slow tests, the
Miller loop and the SHA-256 Merkle gadgets, in a slow test here), and
returns everything as plain integers and strings: each protoboard's
constraints (the (index, coeff) terms of a, b and c, in order, with their
annotations), its variable values (the witness) and annotations, and the
host outputs (hashes, accumulator roots, field elements). The two
packages' results must be equal; each case also checks in both packages
what the JAX test checks (satisfied, the host oracle's value). Also the
linear-combination merging and evaluation the PCD keygen and prover read,
and the port's trapdoor Groth16 helper (tests/_torch_port.py). Tolerance:
zero.
"""
import hashlib
import importlib
import io
import random

import pytest

pytest.importorskip("torch")

from _torch_port import board, coords, trapdoor_groth16
from libsnark_tpu.relations.examples import (
    generate_r1cs_example as jax_generate_r1cs_example)
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.relations.examples import generate_r1cs_example
from test_verifier_gadget import _trapdoor_groth16 as jax_trapdoor

PACKAGES = ("libsnark_tpu", "libsnark_tpu_torch")
BN_R = int("21888242871839275222246405745257275088"
           "548364400416034343698204186575808495617")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def curve(pkg, name):
    return importlib.import_module(pkg).get_curve(name)


def ints(x):
    """A host field element (any tower) or point as nested integers."""
    if hasattr(x, "is_zero") and hasattr(x, "x") and hasattr(x, "y"):
        return None if x.is_zero() else (ints(x.x), ints(x.y))
    for names in (("c0", "c1", "c2"), ("c0", "c1")):
        if all(hasattr(x, n) for n in names):
            return tuple(ints(getattr(x, n)) for n in names)
    return int(x)


def pbmods(pkg):
    pbm = mod(pkg, "gadgets.protoboard")
    return pbm.Protoboard, pbm.PBVariable, pbm.PBVariableArray


# ------------------------------------------------------------ basic gadgets

def case_packing(pkg):
    Protoboard, PBVariable, PBVariableArray = pbmods(pkg)
    basic = mod(pkg, "gadgets.basic")
    pb = Protoboard(BN_R)
    bits = PBVariableArray().allocate(pb, 8, "bits")
    packed = PBVariable().allocate(pb, "packed")
    g = basic.PackingGadget(pb, bits, packed, "pack")
    g.generate_r1cs_constraints(True)
    pb.setval(packed, 0xA7)
    g.generate_r1cs_witness_from_packed()
    assert pb.is_satisfied() and bits.get_int_from_bits(pb) == 0xA7
    first = board(pb)
    bits.fill_with_bits_of_int(pb, 0x5C)
    g.generate_r1cs_witness_from_bits()
    assert pb.val(packed) == 0x5C and pb.is_satisfied()
    pb.setval(bits[0], 2)
    assert not pb.is_satisfied()
    return first, board(pb)


def case_multipacking(pkg):
    Protoboard, PBVariable, PBVariableArray = pbmods(pkg)
    basic = mod(pkg, "gadgets.basic")
    pb = Protoboard(BN_R)
    chunk = basic.field_capacity(BN_R)
    nchunks = basic.multipacking_num_chunks(BN_R, 600)
    bits = PBVariableArray().allocate(pb, 600, "bits")
    packed = PBVariableArray().allocate(pb, nchunks, "packed")
    g = basic.MultipackingGadget(pb, bits, packed, chunk, "mp")
    g.generate_r1cs_constraints(True)
    bits.fill_with_bits_of_int(pb, (1 << 599) | 0xDEADBEEF)
    g.generate_r1cs_witness_from_bits()
    assert pb.is_satisfied()
    return chunk, nchunks, board(pb)


def case_dual_variable(pkg):
    Protoboard, _, _ = pbmods(pkg)
    basic = mod(pkg, "gadgets.basic")
    pb = Protoboard(BN_R)
    g = basic.DualVariableGadget(pb, 16, "dual")
    g.generate_r1cs_constraints(True)
    pb.setval(g.packed, 0xBEEF)
    g.generate_r1cs_witness_from_packed()
    assert pb.is_satisfied() and g.bits.get_int_from_bits(pb) == 0xBEEF
    return board(pb)


def case_logic_and_comparison(pkg):
    """Disjunction and conjunction on three inputs, comparison on 4 bits,
    inner product of 5, loose multiplexing in and out of range: every
    parameter set of the JAX tests."""
    Protoboard, PBVariable, PBVariableArray = pbmods(pkg)
    basic = mod(pkg, "gadgets.basic")
    out = []
    for vals in ([0, 0, 0], [0, 1, 0], [1, 1, 1]):
        pb = Protoboard(BN_R)
        ins = PBVariableArray().allocate(pb, len(vals), "in")
        o_or = PBVariable().allocate(pb, "or")
        o_and = PBVariable().allocate(pb, "and")
        g1 = basic.DisjunctionGadget(pb, ins, o_or, "disj")
        g2 = basic.ConjunctionGadget(pb, ins, o_and, "conj")
        g1.generate_r1cs_constraints()
        g2.generate_r1cs_constraints()
        for v, x in zip(ins, vals):
            pb.setval(v, x)
        g1.generate_r1cs_witness()
        g2.generate_r1cs_witness()
        assert pb.val(o_or) == int(any(vals))
        assert pb.val(o_and) == int(all(vals)) and pb.is_satisfied()
        out.append(board(pb))
    for a, b in ((3, 5), (5, 5), (7, 5), (0, 0)):
        pb = Protoboard(BN_R)
        A, B, lt, le = (PBVariable().allocate(pb, n)
                        for n in ("A", "B", "less", "leq"))
        g = basic.ComparisonGadget(pb, 4, A, B, lt, le, "cmp")
        g.generate_r1cs_constraints()
        pb.setval(A, a)
        pb.setval(B, b)
        g.generate_r1cs_witness()
        assert (pb.val(lt), pb.val(le)) == (int(a < b), int(a <= b))
        assert pb.is_satisfied()
        out.append(board(pb))
    pb = Protoboard(BN_R)
    A = PBVariableArray().allocate(pb, 5, "A")
    B = PBVariableArray().allocate(pb, 5, "B")
    res = PBVariable().allocate(pb, "res")
    g = basic.InnerProductGadget(pb, A, B, res, "ip")
    g.generate_r1cs_constraints()
    for x, v in zip(A + B, [3, 1, 4, 1, 5, 2, 7, 1, 8, 2]):
        pb.setval(x, v)
    g.generate_r1cs_witness()
    assert pb.val(res) == 6 + 7 + 4 + 8 + 10 and pb.is_satisfied()
    out.append(board(pb))
    for idx, ok in ((2, 1), (9, 0)):
        pb = Protoboard(BN_R)
        arr = PBVariableArray().allocate(pb, 5, "arr")
        index, result, flag = (PBVariable().allocate(pb, n)
                               for n in ("idx", "res", "flag"))
        g = basic.LooseMultiplexingGadget(pb, arr, index, result, flag, "mux")
        g.generate_r1cs_constraints()
        for v, x in zip(arr, [10, 20, 30, 40, 50]):
            pb.setval(v, x)
        pb.setval(index, idx)
        g.generate_r1cs_witness()
        assert pb.val(flag) == ok and pb.is_satisfied()
        out.append(board(pb))
    return out


def case_protoboard_to_r1cs(pkg):
    """A protoboard circuit lowers to the package's own
    R1CSConstraintSystem (the port's: what its Groth16 takes), satisfied by
    the protoboard's inputs; the constraint profiler's report."""
    Protoboard, PBVariable, PBVariableArray = pbmods(pkg)
    LC = mod(pkg, "relations.variable").LinearCombination
    pb = Protoboard(BN_R)
    x, y, sq, cb = (PBVariable().allocate(pb, n)
                    for n in ("x", "y", "x2", "x3"))
    pb.set_input_sizes(1)
    pb.add_r1cs_constraint(x, x, sq, "x*x")
    pb.add_r1cs_constraint(sq, x, cb, "x2*x")
    pb.add_r1cs_constraint(1, LC(cb) + x + 5, y, "sum")
    for v, val in ((x, 3), (sq, 9), (cb, 27), (y, 35)):
        pb.setval(v, val)
    assert pb.is_satisfied()
    cs = pb.get_constraint_system()
    assert isinstance(cs, mod(pkg, "relations.r1cs").R1CSConstraintSystem)
    assert cs.is_satisfied(pb.primary_input(), pb.auxiliary_input())
    terms = [[(t.index, t.coeff) for lc in (c.a, c.b, c.c) for t in lc.terms]
             + [c.annotation] for c in cs.constraints]
    prof_pb = Protoboard(BN_R)
    prof = mod(pkg, "gadgets.protoboard").ConstraintProfiler(prof_pb)
    bits = PBVariableArray().allocate(prof_pb, 8, "bits")
    packed = PBVariable().allocate(prof_pb, "packed")
    with prof.scope("packing"):
        mod(pkg, "gadgets.basic").PackingGadget(
            prof_pb, bits, packed, "p").generate_r1cs_constraints(True)
    buf = io.StringIO()
    prof.print_profiling(buf)
    assert "packing: 9 constraints" in buf.getvalue()
    return (terms, cs.primary_input_size, cs.auxiliary_input_size,
            board(pb), buf.getvalue())


# ------------------------------------------------------------ field towers

def rand2(F2, rng):
    return F2(rng.randrange(F2.modulus), rng.randrange(F2.modulus))


def rand12(F12, rng):
    F6 = F12.base_field
    F2 = F6.base_field
    return F12(F6(*[rand2(F2, rng) for _ in range(3)]),
               F6(*[rand2(F2, rng) for _ in range(3)]))


def case_fp2_fp12(pkg):
    """test_fields_gadgets' Fp2 ops, Fp12 mul / sqr / inv / Frobenius and
    the cyclotomic exponentiation, over BLS12-377's tower."""
    c = curve(pkg, "bls12_377")
    fg = mod(pkg, "gadgets.fields_gadgets")
    rng = random.Random(0xC0FFEE)
    Protoboard = pbmods(pkg)[0]
    pb = Protoboard(c.q)
    fp2 = fg.Fp2Gadgets(pb, int(c.Fq2.NON_RESIDUE))
    fp6 = fg.Fp6Gadgets(fp2, c.xi)
    fp12 = fg.Fp12Gadgets(fp6, c.Fq12)
    F2, F12 = c.Fq2, c.Fq12
    a2, b2 = rand2(F2, rng), rand2(F2, rng)
    a, _ = fp2.alloc_input(a2)
    b, _ = fp2.alloc_input(b2)
    m, s, i = fp2.mul(a, b), fp2.sqr(a), fp2.inv(b)
    a12, b12 = rand12(F12, rng), rand12(F12, rng)
    A = fp12.const(a12)
    bvars = [[fp2.alloc_input(None) for _ in range(3)] for _ in range(2)]
    B = tuple(tuple(bv[0] for bv in half) for half in bvars)
    for h, half in enumerate((b12.c0, b12.c1)):
        for j, coord in enumerate((half.c0, half.c1, half.c2)):
            pb.setval(bvars[h][j][1][0], int(coord.c0))
            pb.setval(bvars[h][j][1][1], int(coord.c1))
    outs12 = [fp12.mul(A, B), fp12.sqr(B), fp12.inv(B),
              fp12.frobenius(B, 1), fp12.frobenius(B, 6),
              fp12.cyclotomic_exp(A, 0b110101)]
    fp2.generate_witness()
    got2 = [fp2.eval(v, F2) for v in (m, s, i)]
    assert got2 == [a2 * b2, a2.squared(), b2.inverse()]
    got12 = [fp12.eval(v) for v in outs12]
    assert got12 == [a12 * b12, b12.squared(), b12.inverse(),
                     b12.frobenius(1), b12.frobenius(6), a12 ** 0b110101]
    assert pb.is_satisfied()
    return [ints(v) for v in got2 + got12], board(pb)


def case_fp3_fp6(pkg):
    """Fp3 and Fp6 (2 over 3) over BW6-761's host tower (MNT6's shape)."""
    bw6 = curve(pkg, "bw6_761")
    fg = mod(pkg, "gadgets.fields_gadgets")
    rng = random.Random(0xC0FFEE)
    Protoboard = pbmods(pkg)[0]
    F3, F6 = bw6.Fq3, bw6.Fq6
    rand3 = lambda: F3(*[rng.randrange(bw6.q) for _ in range(3)])
    pb = Protoboard(bw6.q)
    fp3 = fg.Fp3Gadgets(pb, int(F3.NON_RESIDUE))
    a3, b3 = rand3(), rand3()
    a, _ = fp3.alloc_input(a3)
    b, _ = fp3.alloc_input(b3)
    outs3 = [fp3.mul(a, b), fp3.sqr(a), fp3.inv(b), fp3.mul_by_v(a)]
    fp3.generate_witness()
    got3 = [fp3.eval(v, F3) for v in outs3]
    assert got3 == [a3 * b3, a3.squared(), b3.inverse(), a3 * F3(0, 1, 0)]
    assert pb.is_satisfied()
    pb6 = Protoboard(bw6.q)
    fp3b = fg.Fp3Gadgets(pb6, int(F3.NON_RESIDUE))
    fp6 = fg.Fp6_2over3Gadgets(fp3b, F6)
    a6, b6 = F6(rand3(), rand3()), F6(rand3(), rand3())
    a, _ = fp6.alloc_input(a6)
    b, _ = fp6.alloc_input(b6)
    outs6 = [fp6.mul(a, b), fp6.sqr(a), fp6.inv(b), fp6.conjugate(a)]
    fp3b.generate_witness()
    got6 = [fp6.eval(v, F6) for v in outs6]
    assert got6 == [a6 * b6, a6.squared(), b6.inverse(),
                    F6(a6.c0, -a6.c1)]
    assert pb6.is_satisfied()
    return ([ints(v) for v in got3], [[ints(x) for x in (v.c0, v.c1)]
                                      for v in got6], board(pb), board(pb6))


def case_fp4(pkg):
    """Fp4 over alt_bn128's Fq2 with xi = 9 + u (MNT4's Fq4 shape)."""
    bn = curve(pkg, "alt_bn128")
    fg = mod(pkg, "gadgets.fields_gadgets")
    F2 = bn.Fq2
    F4 = mod(pkg, "fields").make_quadratic_ext(F2, bn.xi, "test.Fq4")
    rng = random.Random(0xC0FFEE)
    pb = pbmods(pkg)[0](bn.q)
    fp2 = fg.Fp2Gadgets(pb, int(F2.NON_RESIDUE))
    fp4 = fg.Fp4Gadgets(fp2, bn.xi, F4)
    a4 = F4(rand2(F2, rng), rand2(F2, rng))
    b4 = F4(rand2(F2, rng), rand2(F2, rng))
    a, _ = fp4.alloc_input(a4)
    b, _ = fp4.alloc_input(b4)
    outs = [fp4.mul(a, b), fp4.sqr(a), fp4.inv(b)]
    fp2.generate_witness()
    got = [fp4.eval(v, F4) for v in outs]
    assert got == [a4 * b4, a4.squared(), b4.inverse()]
    assert pb.is_satisfied()
    return [[ints(x) for x in (v.c0, v.c1)] for v in got], board(pb)


# ------------------------------------------------------------ curve gadgets

def case_g1_arithmetic(pkg):
    """test_pairing_gadgets.py:9: G1 add, double and a conditional
    constant add in-circuit against the host points."""
    c = curve(pkg, "bls12_377")
    pg = mod(pkg, "gadgets.pairing_gadgets")
    Protoboard, PBVariable, _ = pbmods(pkg)
    pb = Protoboard(c.q)
    g1 = pg.G1Gadgets(pb)
    P_host, Q_host = c.G1.one() * 5, c.G1.one() * 9
    P, Q = g1.alloc(P_host), g1.alloc(Q_host)
    S = g1.add(P, Q)
    D = g1.dbl(P)
    bit = PBVariable().allocate(pb, "bit")
    pb.setval(bit, 1)
    C = g1.conditional_add_const(S, bit, c.G1.one() * 3)
    g1.generate_witness()
    assert pb.is_satisfied()
    want = [P_host + Q_host, P_host + P_host, P_host + Q_host + c.G1.one() * 3]
    got = [(pb.lc_val(X[0]), pb.lc_val(X[1])) for X in (S, D, C)]
    assert got == [(int(W.x), int(W.y)) for W in want]
    return got, board(pb)


SCALAR_BITS = 16


def case_scalar_mul(pkg):
    """test_curve_scalar_mul.py: G1 mul_by_scalar on 16 bits for every k of
    the JAX test, mul_by_const_scalar, G2 mul_by_scalar of a constant
    base."""
    c = curve(pkg, "bls12_377")
    pg = mod(pkg, "gadgets.pairing_gadgets")
    fg = mod(pkg, "gadgets.fields_gadgets")
    csm = mod(pkg, "gadgets.curve_scalar_mul")
    Protoboard, _, PBVariableArray = pbmods(pkg)
    out = []
    P_host = c.G1.one() * 7
    for k in (0, 1, 2, 3, 5, 0x89AB, (1 << SCALAR_BITS) - 1):
        pb = Protoboard(c.q)
        g1 = pg.G1Gadgets(pb, "g1")
        sm = csm.ScalarMulGadgets(csm.G1Ops(g1, c))
        P = g1.alloc(P_host)
        bits = PBVariableArray().allocate(pb, SCALAR_BITS, "k")
        res = sm.mul_by_scalar(list(bits), P)
        bits.fill_with_bits_of_int(pb, k)
        g1.generate_witness()
        assert pb.first_unsatisfied() is None
        assert pb.lc_val(res.is_id) == int(k == 0)
        if k:
            want = P_host * k
            assert (pb.lc_val(res.pt[0]), pb.lc_val(res.pt[1])) == (
                int(want.x), int(want.y))
        out.append(board(pb))
    pb = Protoboard(c.q)
    g1 = pg.G1Gadgets(pb, "g1")
    sm = csm.ScalarMulGadgets(csm.G1Ops(g1, c))
    o = sm.mul_by_const_scalar(0x1D3, g1.alloc(c.G1.one() * 11))
    g1.generate_witness()
    want = c.G1.one() * 11 * 0x1D3
    assert pb.first_unsatisfied() is None
    assert (pb.lc_val(o[0]), pb.lc_val(o[1])) == (int(want.x), int(want.y))
    out.append(board(pb))
    Q_host = c.G2.one() * 9
    pb = Protoboard(c.q)
    fp2 = fg.Fp2Gadgets(pb, int(c.Fq2.NON_RESIDUE), "fp2")
    ops = csm.G2Ops(pg.G2Gadgets(fp2, "g2"), c)
    sm = csm.ScalarMulGadgets(ops)
    bits = PBVariableArray().allocate(pb, SCALAR_BITS, "k")
    res = sm.mul_by_scalar(list(bits), ops.const(Q_host))
    bits.fill_with_bits_of_int(pb, 0x2B7)
    fp2.generate_witness()
    assert pb.first_unsatisfied() is None
    want = Q_host * 0x2B7
    got = [pb.lc_val(v) for xy in res.pt for v in xy]
    assert got == [int(want.x.c0), int(want.x.c1), int(want.y.c0),
                   int(want.y.c1)]
    out.append(board(pb))
    return out


def case_membership(pkg):
    """G1 membership check (right and wrong preimage), G2 membership of a
    constant subgroup point, and psi on the host (multiplication by q on
    G2)."""
    c = curve(pkg, "bls12_377")
    pg = mod(pkg, "gadgets.pairing_gadgets")
    fg = mod(pkg, "gadgets.fields_gadgets")
    csm = mod(pkg, "gadgets.curve_scalar_mul")
    mg = mod(pkg, "gadgets.membership_gadgets")
    Protoboard = pbmods(pkg)[0]
    Q = c.G2.one() * 5
    psiQ = mg.psi_host(c, Q)
    assert psiQ == Q * (c.q % c.r)
    out = [ints(psiQ), [ints(k) for k in mg.psi_constants(c)]]
    P_host = c.G1.one() * 0xDEED
    for pre, ok in ((P_host, True), (P_host + c.G1.one(), False)):
        pb = Protoboard(c.q)
        g1 = pg.G1Gadgets(pb, "g1")
        gadget = mg.G1MembershipCheckGadget(pb, c, g1, g1.alloc(P_host))
        gadget.generate_witness(pre)
        g1.generate_witness()
        assert (pb.first_unsatisfied() is None) == ok
        out.append(board(pb))
    pb = Protoboard(c.q)
    fp2 = fg.Fp2Gadgets(pb, int(c.Fq2.NON_RESIDUE), "fp2")
    g2 = pg.G2Gadgets(fp2, "g2")
    mg.G2MembershipCheckGadget(pb, c, g2,
                               csm.G2Ops(g2, c).const(c.G2.one() * 0xFEED))
    fp2.generate_witness()
    assert pb.first_unsatisfied() is None
    out.append(board(pb))
    return out


# ------------------------------------------------------------ hashes

def sha256_full(pkg, msg: bytes) -> bytes:
    """Padded SHA-256 on the package's sha256_compress."""
    sh = mod(pkg, "gadgets.hashes.sha256_host")
    ml = len(msg) * 8
    msg = msg + b"\x80"
    while len(msg) % 64 != 56:
        msg += b"\x00"
    msg += ml.to_bytes(8, "big")
    state = list(sh.SHA256_H)
    for off in range(0, len(msg), 64):
        state = sh.sha256_compress(state, [
            int.from_bytes(msg[off + 4 * i: off + 4 * i + 4], "big")
            for i in range(16)])
    return b"".join(w.to_bytes(4, "big") for w in state)


def case_sha256(pkg):
    """The host compression against hashlib, the bit codec, and the
    two-to-one hash gadget against the host hash (a flipped output bit
    breaks it)."""
    sh = mod(pkg, "gadgets.hashes.sha256_host")
    sg = mod(pkg, "gadgets.hashes.sha256_gadget")
    for data in (b"", b"abc", b"a" * 55, b"b" * 64, b"c" * 130):
        assert sha256_full(pkg, data) == hashlib.sha256(data).digest()
    words = [0x01234567, 0x89ABCDEF] * 4
    assert sh.bits_to_words(sh.words_to_bits(words)) == words
    pb = pbmods(pkg)[0](BN_R)
    left, right, output = (sg.DigestVariable(pb, 256, n)
                           for n in ("left", "right", "output"))
    g = sg.SHA256TwoToOneHashGadget(pb, left, right, output, "h")
    g.generate_r1cs_constraints()
    lbits = [(i * 7) % 2 for i in range(256)]
    rbits = [(i * 5 + 1) % 2 for i in range(256)]
    left.generate_r1cs_witness(lbits)
    right.generate_r1cs_witness(rbits)
    g.generate_r1cs_witness()
    digest = sh.sha256_two_to_one_hash_bits(lbits, rbits)
    assert output.get_digest() == digest and pb.is_satisfied()
    out = (digest, sh.words_to_bits(words), board(pb))
    pb.setval(output.bits[3], 1 - pb.val(output.bits[3]))
    assert not pb.is_satisfied()
    return out


def case_knapsack(pkg):
    """test_set_commitment.py:56: the knapsack CRH gadgets (field and bit
    output) on 64 bits against the host evaluation."""
    kn = mod(pkg, "gadgets.hashes.knapsack")
    Protoboard, _, PBVariableArray = pbmods(pkg)
    data = [(i * 3) % 2 for i in range(64)]
    pb = Protoboard(BN_R)
    bits = PBVariableArray().allocate(pb, 64, "in")
    o = PBVariableArray().allocate(pb, 1, "out")
    g = kn.KnapsackCRHFieldOutGadget(pb, bits, o, 1, "crh")
    g.generate_r1cs_constraints()
    bits.fill_with_bits(pb, data)
    g.generate_r1cs_witness()
    field_out = kn.knapsack_crh_field_eval(BN_R, data, 1)
    assert pb.val(o[0]) == field_out[0] and pb.is_satisfied()
    pb2 = Protoboard(BN_R)
    bits2 = PBVariableArray().allocate(pb2, 64, "in")
    obits = PBVariableArray().allocate(pb2, BN_R.bit_length(), "ob")
    g2 = kn.KnapsackCRHBitOutGadget(pb2, bits2, obits, 1, "crh2")
    g2.generate_r1cs_constraints()
    bits2.fill_with_bits(pb2, data)
    g2.generate_r1cs_witness()
    bit_out = kn.knapsack_crh_bit_eval(BN_R, data, 1)
    assert [pb2.val(b) for b in obits] == bit_out and pb2.is_satisfied()
    return field_out, bit_out, board(pb), board(pb2)


def leaf(i):
    return [(i * 37 + j * 11 + 1) % 2 for j in range(256)]


def case_merkle_host(pkg):
    """test_merkle.py:23: a depth-3 SHA-256 tree's root, and each path
    recomputes it."""
    sh = mod(pkg, "gadgets.hashes.sha256_host")
    h = sh.sha256_two_to_one_hash_bits
    t = mod(pkg, "common.merkle_tree").MerkleTree(3, 256, h)
    for a in (0, 3, 5):
        t.set_value(a, leaf(a))
    root = t.get_root()
    paths = []
    for address in (0, 3, 5, 6):
        path = t.get_path(address)
        cur = t._pad(t.get_value(address))
        for layer in range(3, 0, -1):
            sib = path[layer - 1]
            cur = (h(sib, cur) if (address >> (3 - layer)) & 1
                   else h(cur, sib))
        assert cur == root
        paths.append(path)
    return root, paths


def elt(i):
    return [(i >> (j % 8)) & 1 ^ (j * (i + 1) // 7) % 2 for j in range(128)]


def case_set_commitment_host(pkg):
    """test_set_commitment.py:22: the SHA-256 accumulator's commitment and
    a membership proof."""
    sh = mod(pkg, "gadgets.hashes.sha256_host")
    scg = mod(pkg, "gadgets.set_commitment_gadget")
    acc = mod(pkg, "common.set_commitment").SetCommitmentAccumulator(
        8, 128, scg.sha256_element_hash_bits, sh.sha256_two_to_one_hash_bits)
    for i in range(5):
        acc.add(elt(i))
    assert acc.is_in_set(elt(3)) and not acc.is_in_set(elt(7))
    proof = acc.get_membership_proof(elt(3))
    assert proof.address == 3 and len(proof.merkle_path) == acc.depth
    return acc.get_commitment(), proof.address, proof.merkle_path


def case_merkle_gadgets(pkg):
    """test_merkle.py's check-read (depth 2, address 2, a wrong root
    fails) and check-update (address 1) gadgets over SHA-256."""
    sh = mod(pkg, "gadgets.hashes.sha256_host")
    sg = mod(pkg, "gadgets.hashes.sha256_gadget")
    mtg = mod(pkg, "gadgets.merkle_tree_gadgets")
    LC = mod(pkg, "relations.variable").LinearCombination
    Protoboard, _, PBVariableArray = pbmods(pkg)
    MerkleTree = mod(pkg, "common.merkle_tree").MerkleTree
    t = MerkleTree(2, 256, sh.sha256_two_to_one_hash_bits)
    for a in range(4):
        t.set_value(a, leaf(a))
    pb = Protoboard(BN_R)
    addr = PBVariableArray().allocate(pb, 2, "addr")
    lf = sg.DigestVariable(pb, 256, "leaf")
    root = sg.DigestVariable(pb, 256, "root")
    path = mtg.MerkleAuthenticationPathVariable(pb, 2, "path")
    g = mtg.MerkleTreeCheckReadGadget(pb, 2, addr, lf, root, path, LC(1),
                                      "read")
    path.generate_r1cs_constraints()
    g.generate_r1cs_constraints()
    addr.fill_with_bits_of_int(pb, 2)
    lf.generate_r1cs_witness(t._pad(t.get_value(2)))
    root.generate_r1cs_witness(t.get_root())
    path.generate_r1cs_witness(2, t.get_path(2))
    g.generate_r1cs_witness()
    assert pb.is_satisfied()
    read = board(pb)
    bad = list(t.get_root())
    bad[0] ^= 1
    root.generate_r1cs_witness(bad)
    assert not pb.is_satisfied()

    prev_root, prev_leaf, prev_path = (
        t.get_root(), t._pad(t.get_value(1)), t.get_path(1))
    t.set_value(1, leaf(99))
    pb = Protoboard(BN_R)
    addr = PBVariableArray().allocate(pb, 2, "addr")
    vs = [sg.DigestVariable(pb, 256, n) for n in ("prev_leaf", "prev_root")]
    pp = mtg.MerkleAuthenticationPathVariable(pb, 2, "prev_path")
    ws = [sg.DigestVariable(pb, 256, n) for n in ("next_leaf", "next_root")]
    npth = mtg.MerkleAuthenticationPathVariable(pb, 2, "next_path")
    g = mtg.MerkleTreeCheckUpdateGadget(pb, 2, addr, vs[0], vs[1], pp,
                                        ws[0], ws[1], npth, LC(1), "upd")
    g.generate_r1cs_constraints()
    addr.fill_with_bits_of_int(pb, 1)
    vs[0].generate_r1cs_witness(prev_leaf)
    vs[1].generate_r1cs_witness(prev_root)
    pp.generate_r1cs_witness(1, prev_path)
    ws[0].generate_r1cs_witness(t._pad(leaf(99)))
    ws[1].generate_r1cs_witness(t.get_root())
    npth.generate_r1cs_witness(1, t.get_path(1))
    g.generate_r1cs_witness()
    assert pb.is_satisfied()
    return read, board(pb)


def case_set_commitment_gadget(pkg):
    """test_set_commitment.py's gadget: membership of the third of three
    elements under a set of 4 (a wrong root fails)."""
    sh = mod(pkg, "gadgets.hashes.sha256_host")
    sg = mod(pkg, "gadgets.hashes.sha256_gadget")
    scg = mod(pkg, "gadgets.set_commitment_gadget")
    LC = mod(pkg, "relations.variable").LinearCombination
    Protoboard, _, PBVariableArray = pbmods(pkg)
    acc = mod(pkg, "common.set_commitment").SetCommitmentAccumulator(
        4, 128, scg.sha256_element_hash_bits, sh.sha256_two_to_one_hash_bits)
    for i in range(3):
        acc.add(elt(i))
    pb = Protoboard(BN_R)
    e = PBVariableArray().allocate(pb, 128, "elt")
    root = sg.DigestVariable(pb, 256, "root")
    g = scg.SetCommitmentGadget(pb, 4, e, root, LC(1), "sc")
    g.generate_r1cs_constraints()
    e.fill_with_bits(pb, elt(2))
    root.generate_r1cs_witness(acc.get_commitment())
    g.generate_r1cs_witness(acc.get_membership_proof(elt(2)))
    assert pb.is_satisfied()
    out = acc.get_commitment(), board(pb)
    bad = list(acc.get_commitment())
    bad[5] ^= 1
    root.generate_r1cs_witness(bad)
    assert not pb.is_satisfied()
    return out


def case_pairing(pkg):
    """test_pairing_gadgets.py's Miller loop of (7 G1, 11 G2) against the
    host engine, and the product check e(2 G1, 3 G2) e(-6 G1, G2) == 1."""
    c = curve(pkg, "bls12_377")
    pgm = mod(pkg, "gadgets.pairing_gadgets")
    Protoboard = pbmods(pkg)[0]
    pb = Protoboard(c.q)
    pg = pgm.PairingGadgets(pb, c)
    g1 = pgm.G1Gadgets(pb)
    P_host, Q_host = c.G1.one() * 7, c.G2.one() * 11
    Qx, _ = pg.fp2.alloc_input(Q_host.x)
    Qy, _ = pg.fp2.alloc_input(Q_host.y)
    f = pg.miller_loop(pg.embed_g2((Qx, Qy)), pg.embed_g1(g1.alloc(P_host)))
    pg.generate_witness()
    g1.generate_witness()
    eng = c.pairing_engine
    want = eng.miller_loop(eng.embed_g2(Q_host), eng.embed_g1(P_host))
    assert pg.fp12.eval(f) == want and pb.is_satisfied()
    out = [ints(want.c0), ints(want.c1), board(pb)]
    pb = Protoboard(c.q)
    pg = pgm.PairingGadgets(pb, c)
    g1 = pgm.G1Gadgets(pb)
    const = lambda Q: pg.embed_g2((pg.fp2.const(Q.x), pg.fp2.const(Q.y)))
    pg.assert_pairing_product_one([
        (g1.alloc(c.G1.one() * 2), const(c.G2.one() * 3)),
        (g1.alloc(-(c.G1.one() * 6)), const(c.G2.one()))])
    pg.generate_witness()
    g1.generate_witness()
    assert pb.first_unsatisfied() is None
    return out + [board(pb)]


CASES = {f.__name__[5:]: f for f in (
    case_packing, case_multipacking, case_dual_variable,
    case_logic_and_comparison, case_protoboard_to_r1cs, case_fp2_fp12,
    case_fp3_fp6, case_fp4, case_g1_arithmetic, case_scalar_mul,
    case_membership, case_sha256, case_knapsack, case_merkle_host,
    case_set_commitment_host, case_set_commitment_gadget)}
# the cases of the JAX package's slow tests (minutes on one core)
SLOW_CASES = {f.__name__[5:]: f for f in (case_pairing,
                                           case_merkle_gadgets)}


@pytest.mark.parametrize("name", list(CASES))
def test_gadget_equals_jax(name):
    """The port's circuit, witness and host outputs == the JAX package's."""
    jax_out, port_out = (CASES[name](pkg) for pkg in PACKAGES)
    assert port_out == jax_out


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SLOW_CASES))
def test_slow_gadget_equals_jax(name):
    """As test_gadget_equals_jax, for the Miller loop and the pairing
    product check (test_pairing_gadgets.py's slow tests) and the SHA-256
    Merkle check-read and check-update gadgets (test_merkle.py's)."""
    jax_out, port_out = (SLOW_CASES[name](pkg) for pkg in PACKAGES)
    assert port_out == jax_out


def test_trapdoor_helper_equals_jax():
    """tests/_torch_port.trapdoor_groth16 (on the port's QAP code) gives the
    JAX helper's (vk, proof), point for point; the port verifies it."""
    bls = curve("libsnark_tpu_torch", "bls12_377")
    jbls = curve("libsnark_tpu", "bls12_377")
    cs, primary, aux = generate_r1cs_example(bls.r, 4, 1)
    jcs, jprimary, jaux = jax_generate_r1cs_example(jbls.r, 4, 1)
    assert (primary, aux) == (jprimary, jaux)
    vk, proof = trapdoor_groth16(bls, cs, primary, aux, seed=31)
    jvk, jproof = jax_trapdoor(jbls, jcs, jprimary, jaux, seed=31)
    assert coords(vk) == coords(jvk)
    assert coords(proof) == coords(jproof)
    g16 = Groth16(bls, device="cpu")
    assert g16.verifier_strong_IC(vk, primary, proof)


def test_compaction_and_evaluation_equal_jax():
    """What the outer keygen and the prover read of a circuit: compact()
    (duplicate indices merged, coefficients reduced mod p, zeros dropped,
    in index order), R1CSConstraintSystem.compacted() (the matrices as flat
    rows, cols and coefficients) and evaluate() on
    linear combinations of 1 to 300 terms with repeated indices, negative,
    zero and unreduced coefficients, against the JAX package's."""
    from libsnark_tpu.relations.r1cs import (
        R1CSConstraintSystem as JaxR1CS)
    from libsnark_tpu.relations.variable import (
        LinearCombination as JaxLC, LinearTerm as JaxTerm)
    from libsnark_tpu_torch.relations.r1cs import R1CSConstraintSystem
    from libsnark_tpu_torch.relations.variable import (
        LinearCombination, LinearTerm)
    rng = random.Random(12)
    p = BN_R
    values = [1] + [rng.randrange(p) for _ in range(40)]
    lcs, jlcs = [], []
    for n in [1, 2, 3, 15, 16, 17, 64, 300] * 3:
        terms = [(rng.randrange(41), rng.choice(
            [0, 1, -1, p, -p, p - 1, rng.randrange(-p, 3 * p)]))
            for _ in range(n)]
        lc, jlc = LinearCombination(), JaxLC()
        lc.terms = [LinearTerm(i, c) for i, c in terms]
        jlc.terms = [JaxTerm(i, c) for i, c in terms]
        want = [(t.index, t.coeff) for t in jlc.compact(p).terms]
        assert [(t.index, t.coeff) for t in lc.compact(p).terms] == want
        assert lc.evaluate(values, p) == jlc.evaluate(values, p)
        lcs.append(lc)
        jlcs.append(jlc)
    cs, jcs = R1CSConstraintSystem(p, 10, 30), JaxR1CS(p, 10, 30)
    for k in range(0, len(lcs) - 2, 3):
        cs.add_constraint(*lcs[k:k + 3])
        jcs.add_constraint(*jlcs[k:k + 3])

    want = tuple(([], [], []) for _ in range(3))
    for j, c in enumerate(jcs.constraints):
        for (rows, cols, coeffs), jlc in zip(want, (c.a, c.b, c.c)):
            for t in jlc.compact(p).terms:
                rows.append(j)
                cols.append(t.index)
                coeffs.append(t.coeff)
    assert cs.compacted() == want
