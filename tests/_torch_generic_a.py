"""Tests shared by tests/test_torch_mnt.py (MNT4-298, MNT6-298) and
tests/test_torch_edwards.py (edwards): the port over curves with an
a-coefficient (19-limb and 12-limb fields, G2 over Fq2 or Fq3) against the
JAX package and the host oracle, bit for bit (tolerance 0: all arithmetic
is exact and every value canonical).

Each importing file defines the module fixture ``name`` (the curve, one
parameter each) and imports these tests, so that every test runs for each
of its curves.

The curve's parameters, generators and field constants; the kernels'
width tables at 19 and 12 limbs; the base field's operations (the
mont_mul kernel's plain version, in its Python-integer form and in its
limb-column form), the extension field's (Fq2 for MNT4,
Fq3 for MNT6 and edwards) and the limb encoding against the JAX kernels;
dbl / add / madd / aadd of G1 and G2 (the generic-a formulas over the
product) with planted infinity, P == Q and P == -Q lanes against the host;
scalar_mul_const; a small MSM of each group under both strategy names,
the device window table and batch exp, none of them reaching a group
kernel's wrapper (a = 0 only); to_affine's batched inversion against the
JAX to_affine with planted Z = 0 lanes; and a seeded 8-constraint Groth16:
the keypair (host fixed-base paths of both packages), the witness map over
Fr and the port's proof from the carried JAX key against a host
recomputation, verified on the host; the whole proof against the JAX
prover is marked slow. On CPU tensors the port runs the plain versions.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.domains import TwoPartDomain as JaxTwoPart
from libsnark_tpu.ops.ec import CurveKernel as JaxCurve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.fp2 import Fp2Kernel as JaxFp2
from libsnark_tpu.ops.fp3 import Fp3Kernel as JaxFp3
from libsnark_tpu.proof_systems.groth16 import Groth16 as JaxGroth16
from libsnark_tpu.reductions.r1cs_to_qap import (
    qap_domain as jax_qap_domain, qap_witness_map as jax_wmap)
from libsnark_tpu.relations.examples import generate_r1cs_example as jax_example

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import QUERIES, proving_key_from_numpy
from libsnark_tpu_torch.ops import cuda_ec, cuda_fp, cuda_lib, msm as msm_mod
from libsnark_tpu_torch.ops.domains import TwoPartDomain
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.limbs import from_torch, ints_to_limbs, to_torch
from libsnark_tpu_torch.ops.msm import MSMKernel
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.reductions.r1cs_to_qap import (
    qap_domain, qap_witness_map)
from libsnark_tpu_torch.relations.examples import generate_r1cs_example

from _torch_port import coords, host_point

L = 12   # lanes: 0 P=inf, 1 Q=inf, 2 both, 3-4 P==Q, 5-6 P==-Q, rest random
N_CONSTRAINTS, GEN_SEED, PROVE_SEED = 8, 5, 9
# limbs of Fq and Fr, Fr's two-adicity, G2's coordinate field degree
SHAPES = {"mnt4": (19, 19, 34, 2), "mnt6": (19, 19, 17, 3),
          "edwards": (12, 12, 31, 3)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def curves(name):
    return jax_get_curve(name), get_curve(name)


@pytest.fixture(scope="module")
def system(curves):
    """The port's CPU system: G1 and G2 kernels with their a maps."""
    return Groth16(curves[1], device="cpu")


@pytest.fixture(scope="module")
def jax_fields(curves):
    """The JAX package's Fq, Fr and G2 coordinate field kernels."""
    jc, _ = curves
    jfq, jfr = JaxFp(jc.fq_params), JaxFp(jc.fr_params)
    if jc.g2_field_degree == 2:
        jext = JaxFp2(jfq, int(jc.Fq2.NON_RESIDUE))
    else:
        jext = JaxFp3(jfq, int(jc.Fq3.NON_RESIDUE))
    return {"fq": jfq, "fr": jfr, "ext": jext}


def _ints(p, n, seed, nonzero=False):
    rng = random.Random(seed)
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]
    return [x or 1 for x in xs] if nonzero else xs


def _a2_consts(curve):
    return tuple(int(getattr(curve.a2, f"c{i}"))
                 for i in range(curve.g2_field_degree))


# ------------------------------------------------------------ the curve

def test_curve_parameters_and_generators_equal_jax(curves):
    jc, tc = curves
    for attr in ("q", "r", "trace", "twist_type", "g1_cofactor",
                 "g2_cofactor", "g2_field_degree", "family"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    assert (int(tc.a), int(tc.b)) == (int(jc.a), int(jc.b))
    assert tc.a != 0
    assert _a2_consts(tc) == _a2_consts(jc) and any(_a2_consts(tc))
    assert str(tc.b2) == str(jc.b2)
    for group in ("G1", "G2"):
        G, jG = getattr(tc, group).one(), getattr(jc, group).one()
        assert str(G) == str(jG), group
        assert G.mul_unreduced(tc.r).is_zero()
    for f in ("fq_params", "fr_params"):
        tp, jp = getattr(tc, f), getattr(jc, f)
        assert (tp.p, tp.num_limbs, tp.R, tp.R2, tp.n0inv, tp.two_adicity,
                tp.root_of_unity, tp.multiplicative_generator) == \
            (jp.p, jp.num_limbs, jp.R, jp.R2, jp.n0inv, jp.two_adicity,
             jp.root_of_unity, jp.multiplicative_generator), f
    nq, nr, adicity, deg = SHAPES[tc.name]
    assert (tc.fq_params.num_limbs, tc.fr_params.num_limbs,
            tc.fr_params.two_adicity, tc.g2_field_degree) == \
        (nq, nr, adicity, deg)


def test_kernel_widths_accept_the_field_and_refuse_unbuilt_ones(system):
    """The product kernel takes the field's limbs (19 in 10 words, the top
    half-word zero; 12 in 6), make_mod's one is 2^(16 N) mod p, and a width
    that csrc builds no kernel for is refused. No group kernel exists at
    these widths or over Fp3: the a-coefficient keeps the group law off
    them."""
    fq, fr = system.fq, system.fr
    for fk in (fq, fr):
        N = fk.N
        assert fk.nw == cuda_lib.words_of(N) == (N + 1) // 2
        one = sum(int(w) << (32 * k) for k, w in enumerate(fk.mod.one))
        assert one == (1 << (16 * N)) % fk.p == fk.params.R
        assert fk.mod.n0inv == (-pow(fk.p, -1, 1 << 32)) % (1 << 32)
        assert fk.mod.n0inv & 0xFFFF == fk.params.n0inv   # the half round's
        assert f"mont_mul_n{N}" in cuda_fp.LAUNCHES
        with pytest.raises(ValueError, match="degree 1"):
            cuda_ec.width_args(fk)
    with pytest.raises(ValueError, match=f"degree {system.fq2.ext_degree}"):
        cuda_ec.width_args(system.fq2)
    for n in (17, 20):
        with pytest.raises(ValueError, match=f"no kernels built for {n}"):
            cuda_lib.words_of(n)
    assert system.g1.mul_by_a is not None and system.g2.mul_by_a is not None


# ------------------------------------------------------------ the fields

FP_OPS = ("mul", "sqr", "add", "sub", "neg", "double", "mul_small", "inv",
          "to_mont", "from_mont")
UNARY = {"sqr", "neg", "double", "inv", "to_mont", "from_mont"}


def _fp_call(fk, op, args):
    if op == "mul_small":
        return fk.mul_small(args[0], 11)
    return getattr(fk, op)(*args)


@pytest.fixture(scope="module", params=["fq", "fr"])
def fp_case(request, system, jax_fields):
    """Every field op of FP_OPS on 64 lanes with 0, 1 and p - 1 planted
    (inv: nonzero lanes) in both packages, the JAX ones in one jit."""
    field = request.param
    jfk, tfk = jax_fields[field], getattr(system, field)
    a = jfk.encode(_ints(jfk.p, 64, 1))
    a_nz = jfk.encode(_ints(jfk.p, 64, 1, nonzero=True))
    b = jfk.encode(_ints(jfk.p, 64, 2)[::-1])
    args = {op: (a_nz,) if op == "inv" else (a,) if op in UNARY else (a, b)
            for op in FP_OPS}
    want = jax.jit(lambda xs: {op: _fp_call(jfk, op, x)
                               for op, x in xs.items()})(
        {op: tuple(jnp.asarray(v) for v in x) for op, x in args.items()})
    ins = {op: [to_torch(v, "cpu") for v in x] for op, x in args.items()}
    got = {op: _fp_call(tfk, op, x) for op, x in ins.items()}
    # the limb-column forms (int64 columns, then REDC over N limbs): what
    # the card's kernels are held against, taken here at every lane count
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cuda_fp, "SMALL_LANES", 0)
        columns = {op: _fp_call(tfk, op, x) for op, x in ins.items()}
    return dict(N=tfk.N, want=want, got=got, columns=columns)


@pytest.mark.parametrize("op", FP_OPS)
def test_fp_op_matches_jax(fp_case, op):
    """The field ops on the CPU at 64 lanes: mont_mul's plain version in
    its Python-integer form (up to cuda_fp.SMALL_LANES lanes)."""
    got = fp_case["got"][op]
    assert got.dtype == torch.int32 and got.shape[0] == fp_case["N"]
    np.testing.assert_array_equal(from_torch(got),
                                  np.asarray(fp_case["want"][op]))


@pytest.mark.parametrize("op", FP_OPS)
def test_fp_limb_columns_match_jax(fp_case, op):
    """The same ops through the limb-column forms of the plain versions
    (SMALL_LANES 0): the schoolbook columns and redc at 19 or 12 limbs."""
    got = fp_case["columns"][op]
    assert got.dtype == torch.int32 and got.shape[0] == fp_case["N"]
    np.testing.assert_array_equal(from_torch(got),
                                  np.asarray(fp_case["want"][op]))


@pytest.mark.parametrize("field", ["fq", "fr"])
def test_encode_decode_matches_jax(system, jax_fields, field):
    jfk, tfk = jax_fields[field], getattr(system, field)
    xs = _ints(jfk.p, 64, 3) + [jfk.p, 2 * jfk.p + 5]     # reduced mod p
    for mont in (True, False):
        got = tfk.encode(xs, mont)
        np.testing.assert_array_equal(from_torch(got), jfk.encode(xs, mont))
        assert tfk.decode(got, mont) == [x % jfk.p for x in xs]


def _ext_call(fk, op, args, consts):
    if op == "mul_by_const":
        return fk.mul_by_const(args[0], *consts)
    if op == "mul_small":
        return fk.mul_small(args[0], 7)
    if op == "mul_by_nonresidue":
        return fk._unflat(fk.mul_by_nonresidue(fk._flat(args[0])))
    return getattr(fk, op)(*args)


EXT_OPS = ("mul", "sqr", "add", "sub", "neg", "inv", "mul_small",
           "mul_by_const", "mul_by_nonresidue")


@pytest.fixture(scope="module")
def ext_case(curves, system, jax_fields):
    """Every op of EXT_OPS on 16 elements (1, v or s, 0 planted; inv:
    nonzero ones) of the G2 coordinate field in both packages, the JAX ones
    in one jit."""
    jc, tc = curves
    jfk, tfk = jax_fields["ext"], system.fq2
    deg = tc.g2_field_degree
    F = tc.Fq2 if deg == 2 else tc.Fq3
    rng = random.Random(5)
    els = [F(*[rng.randrange(tc.q) for _ in range(deg)]) for _ in range(16)]
    els[0], els[1] = F.one(), F(*([0] * (deg - 1) + [1]))
    nonzero = list(els)
    els[2] = F.zero()
    a, a_nz = (tfk.encode(e, device="cpu") for e in (els, nonzero))
    b = tfk.encode(els[::-1], device="cpu")
    np.testing.assert_array_equal(from_torch(a), jfk.encode(els))
    args = {op: (a_nz,) if op == "inv" else (a,) if op in (
        "sqr", "neg", "mul_small", "mul_by_const", "mul_by_nonresidue")
        else (a, b) for op in EXT_OPS}
    consts = _a2_consts(tc)
    want = jax.jit(lambda xs: {op: _ext_call(jfk, op, x, consts)
                               for op, x in xs.items()})(
        {op: tuple(jnp.asarray(from_torch(v)) for v in x)
         for op, x in args.items()})
    got = {op: _ext_call(tfk, op, x, consts) for op, x in args.items()}
    return dict(F=F, els=els, tfk=tfk, want=want, got=got)


@pytest.mark.parametrize("op", EXT_OPS)
def test_ext_op_matches_jax(ext_case, op):
    """The G2 coordinate field (Fq2 with beta = 17 for MNT4, Fq3 with beta =
    5 for MNT6 and 61 for edwards): every operation the group law and the
    encoding use, mul_by_const on the twist's a-coefficient."""
    got = ext_case["got"][op]
    np.testing.assert_array_equal(from_torch(got),
                                  np.asarray(ext_case["want"][op]))
    if op == "mul":
        F, els = ext_case["F"], ext_case["els"]
        assert [F(*c) for c in zip(*ext_case["tfk"].decode(got))] == [
            x * y for x, y in zip(els, els[::-1])]


# ------------------------------------------------------------ the groups

def _points(host_group, r, seed):
    rng = random.Random(seed)
    G = host_group.one()
    P = [G * rng.randrange(1, r) for _ in range(L)]
    Q = [G * rng.randrange(1, r) for _ in range(L)]
    P[0] = host_group.zero()
    Q[1] = host_group.zero()
    P[2], Q[2] = host_group.zero(), host_group.zero()
    Q[3], Q[4] = P[3], P[4]
    Q[5], Q[6] = -P[5], -P[6]
    return P, Q


def _rescale(ck, P, seed):
    """Jacobian P with a random non-trivial Z per lane (X Z^2, Y Z^3, Z);
    Z = 0 where P is infinity."""
    fk = ck.fk
    rng = random.Random(seed)
    n = P[2].shape[-1]
    if hasattr(fk, "fp"):
        F = [rng.randrange(1, fk.fp.p) for _ in range(n * fk.ext_degree)]
        Z = fk.fp.encode(F, device="cpu").reshape(
            fk.fp.N, fk.ext_degree, n).movedim(1, 0).contiguous()
    else:
        Z = fk.encode([rng.randrange(1, fk.p) for _ in range(n)],
                      device="cpu")
    Z = fk.select(ck.is_zero(P), torch.zeros_like(Z), Z)
    Z2 = fk.sqr(Z)
    return (fk.mul(P[0], Z2), fk.mul(P[1], fk.mul(Z2, Z)), Z)


@pytest.fixture(scope="module", params=["G1", "G2"])
def group_case(request, curves, system):
    """dbl / add / madd / aadd (the generic-a formulas) on the planted
    lanes of one group."""
    group = request.param
    _, tc = curves
    ck = system.g1 if group == "G1" else system.g2
    host = getattr(tc, group)
    Ph, Qh = _points(host, tc.r, 11 if group == "G1" else 12)
    P = _rescale(ck, ck.encode_points(Ph, device="cpu"), 21)
    Q = _rescale(ck, ck.encode_points(Qh, device="cpu"), 22)
    Paff = ck.encode_points(Ph, jacobian=False, device="cpu")
    Qaff = ck.encode_points(Qh, jacobian=False, device="cpu")
    valid = torch.ones(L, dtype=torch.bool)
    valid[-1] = False
    got = {"dbl": ck.dbl(P), "add": ck.add(P, Q),
           "madd": ck.madd(P, Qaff, valid), "aadd": ck.aadd(Paff, Qaff)}
    return dict(ck=ck, host=host, Ph=Ph, Qh=Qh, valid=valid, got=got)


@pytest.mark.parametrize("op", ["dbl", "add", "madd", "aadd"])
def test_group_op_matches_host(group_case, op):
    case = group_case
    ck, host, Ph, Qh = case["ck"], case["host"], case["Ph"], case["Qh"]
    got = ck.decode_points(case["got"][op], host)
    if op == "dbl":
        want = [P + P for P in Ph]
    elif op == "madd":
        want = [P + Q if v else P
                for P, Q, v in zip(Ph, Qh, case["valid"].tolist())]
    else:
        want = [P + Q for P, Q in zip(Ph, Qh)]
    assert got == want


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_scalar_mul_const_matches_host(curves, system, group):
    """The counterpart of tests/test_mnt_device.py's scalar multiples, on
    two lanes (the generator and a point at infinity)."""
    _, tc = curves
    ck = system.g1 if group == "G1" else system.g2
    host = getattr(tc, group)
    G = host.one()
    P = ck.encode_points([G, host.zero()], device="cpu")
    for k in (0, 1, 37, 91, tc.r - 1):
        assert ck.decode_points(ck.scalar_mul_const(P, k), host) == [
            G * k, host.zero()]


@pytest.fixture
def no_group_kernel(monkeypatch):
    """Every group kernel's wrapper raises if reached: for a != 0 the MSM,
    the window table and batch exp route around them."""
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"{name} reached for a curve with an "
                                 "a-coefficient")
        return f
    for mod, names in ((msm_mod, ("bucket_reduce", "horner_combine",
                                  "aadd_rows", "madd_windows", "dbl_chain")),
                       (cuda_ec, ("dbl", "add", "madd", "aadd",
                                  "aadd_rows", "madd_windows"))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse(f"{mod.__name__}.{n}"))


@pytest.mark.parametrize("strategy", ["segments", "dense"])
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_small_msm_matches_host_under_both_strategies(
        curves, system, group, strategy, no_group_kernel):
    """16 points (two infinity, three equal) and 64-bit scalars (one zero,
    one 2^64 - 1, two equal): the dense layout and the Horner loop under
    either strategy name, the host's sum."""
    _, tc = curves
    ck = system.g1 if group == "G1" else system.g2
    host = getattr(tc, group)
    rng = random.Random(31 if group == "G1" else 32)
    pts = [host.one() * rng.randrange(1, tc.r) for _ in range(16)]
    pts[3] = pts[4] = pts[5]
    pts[6] = pts[7] = host.zero()
    sc = [rng.randrange(1 << 64) for _ in range(16)]
    sc[8], sc[9] = 0, (1 << 64) - 1
    sc[4] = sc[5]
    aff = ck.encode_points(pts, jacobian=False, device="cpu")
    limbs = torch.from_numpy(ints_to_limbs(sc, 4).astype("int32"))
    got = ck.to_affine(MSMKernel(ck, 64, strategy).msm(aff, limbs, 4))
    total = host.zero()
    for P, s in zip(pts, sc):
        total = total + P * s
    assert ck.decode_affine(got, host) == [total]


@pytest.mark.parametrize("group,c", [("G1", 4), ("G2", 3)])
def test_device_fixed_base_equals_host_multiples(curves, system, group, c,
                                                 no_group_kernel):
    """The keygen's device path for a != 0 (the window bases by the dbl_n
    loop, the table's prefix adds, to_affine, the per-window madd scan) on
    planted 64-bit scalars: the host's multiples."""
    _, tc = curves
    ck = system.g1 if group == "G1" else system.g2
    mk = MSMKernel(ck, 64)
    rng = random.Random(41 if group == "G1" else 42)
    sc = [0, 1, (1 << 64) - 1, 1 << 63] + [rng.randrange(1 << 64)
                                          for _ in range(4)]
    base = getattr(tc, group).one()
    baff = ck.encode_points([base], jacobian=False, device="cpu")
    taff = ck.to_affine(mk.window_table((baff[0], baff[1]), c, -(-64 // c)))
    P = mk.batch_exp(taff, torch.from_numpy(ints_to_limbs(sc, 4).astype(
        "int32")), c)
    assert ck.decode_points(P, getattr(tc, group)) == [base * s for s in sc]


def to_affine_case(jck, tck, host, r, seed):
    """to_affine of both packages on 13 Jacobian lanes with random Z, three
    of them Z = 0 (infinity; lane 12 alone in the product tree's last
    pair): equal limbs, and the host's points."""
    rng = random.Random(seed)
    G = host.one()
    pts = [G * rng.randrange(1, r) for _ in range(13)]
    for j in (0, 5, 12):
        pts[j] = host.zero()
    P = _rescale(tck, tck.encode_points(pts, device="cpu"), seed)
    got = tck.to_affine(P)
    want = jax.jit(jck.to_affine)(tuple(jnp.asarray(from_torch(a))
                                        for a in P))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(from_torch(g), np.asarray(w))
    assert tck.decode_affine(got, host) == pts


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_batched_to_affine_matches_jax(curves, system, jax_fields, group):
    jc, tc = curves
    tck = system.g1 if group == "G1" else system.g2
    jfk = jax_fields["fq"] if group == "G1" else jax_fields["ext"]
    to_affine_case(JaxCurve(jfk, group), tck, getattr(tc, group), tc.r, 51)


# ------------------------------------------------------------ Groth16

@pytest.fixture(scope="module")
def jax_run(curves):
    """The JAX keypair on its host fixed-base path."""
    jc, _ = curves
    cs, primary, aux = jax_example(jc.r, N_CONSTRAINTS, 2)
    g16 = JaxGroth16(jc)
    g16.host_keygen = True
    kp = g16.generator(cs, seed=GEN_SEED)
    return dict(system=g16, kp=kp, primary=primary, aux=aux, cs=cs)


def test_own_keypair_equals_jax(curves, jax_run):
    """The port's host fixed-base keygen: every query's limbs (G2 rows of
    2 or 3 coefficients) and every host point of both keys."""
    _, tc = curves
    ps = Groth16(tc, device="cpu")
    ps.host_keygen = True
    cs, _, _ = generate_r1cs_example(tc.r, N_CONSTRAINTS, 2)
    kp = ps.generator(cs, seed=GEN_SEED)
    jpk = jax_run["kp"].pk
    assert jpk.B_query_g2[0].shape[:2] == (tc.g2_field_degree,
                                           tc.fq_params.num_limbs)
    for q in QUERIES:
        for got, want in zip(getattr(kp.pk, q), getattr(jpk, q)):
            np.testing.assert_array_equal(from_torch(got), np.asarray(want),
                                          err_msg=q)
    for attr in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2"):
        assert coords(getattr(kp.pk, attr)) == coords(getattr(jpk, attr))
    assert coords(kp.vk) == coords(jax_run["kp"].vk)


def test_witness_map_over_fr_matches_jax(curves, system, jax_run):
    """qap_witness_map over Fr on the same Montgomery inputs. MNT6's Fr has
    two-adicity 17, so its domains of 2^18 are extended ones (two cosets of
    2^17): checked at 16 = 2 x 8 on a circuit of 13 constraints and 2
    inputs, m exactly 16; the others on the 8-constraint circuit's domain
    (a step domain of 8 + 4)."""
    jc, tc = curves
    jsys = jax_run["system"]
    if tc.name == "mnt6":
        cs, primary, aux = generate_r1cs_example(tc.r, 13, 2)
        jcs, _, _ = jax_example(jc.r, 13, 2)
        jcs.swap_AB_if_beneficial()
        domain = TwoPartDomain(system.fr, tc.fr_params, 3, 3)
        jdomain = JaxTwoPart(jsys.fr, jc.fr_params, 3, 3)
        assert domain.kind == jdomain.kind == "extended"
        assert cs.num_constraints + cs.num_inputs + 1 == 16 == domain.m
        cs.swap_AB_if_beneficial()
        dev = cs.to_device(system.fr, cs.compacted())
        jdev = jcs.to_device(jsys.fr)
    else:
        cs, primary, aux = generate_r1cs_example(tc.r, N_CONSTRAINTS, 2)
        jcs = jax_run["cs"]                 # as the JAX generator left it
        cs.swap_AB_if_beneficial()          # as the generators do
        dev = cs.to_device(system.fr, cs.compacted())
        domain = system.domain_for(qap_domain, dev)
        jdomain = jax_qap_domain(jsys.fr, jsys.fr.params, jcs)
        jdev = jax_run["kp"].pk.r1cs_dev
    assert domain.m == jdomain.m >= cs.num_constraints + cs.num_inputs + 1
    full = [1] + primary + aux
    H = qap_witness_map(dev, domain, system.fr.encode(full))
    jH = jax_wmap(jdev, jdomain, jnp.asarray(jsys.fr.encode(full)))
    assert H.shape[0] == tc.fr_params.num_limbs
    np.testing.assert_array_equal(from_torch(H), np.asarray(jH))


def _carried_pk(ps, jpk):
    dev = jpk.r1cs_dev
    queries = {q: tuple(np.asarray(a) for a in getattr(jpk, q))
               for q in QUERIES}
    points = {n: coords(getattr(jpk, n)) for n in (
        "alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2")}
    matrices = {k: (m.rows, m.cols, m.coeffs)
                for k, m in (("A", dev.A), ("B", dev.B), ("C", dev.C))}
    return proving_key_from_numpy(ps, queries, points, matrices,
                                  dev.num_constraints, dev.num_inputs,
                                  dev.num_variables)


@pytest.fixture(scope="module")
def carried_proof(curves, system, jax_run):
    pk = _carried_pk(system, jax_run["kp"].pk)
    return pk, system.prover(pk, jax_run["primary"], jax_run["aux"],
                             seed=PROVE_SEED)


def test_proof_from_carried_key_equals_host_recomputation(curves, system,
                                                          jax_run,
                                                          carried_proof):
    """A = alpha + sum a_i A_i + r delta, B = beta + sum a_i B_i + s delta
    (G2), C = sum_aux a_i L_i + sum h_i H_i + s A + r (beta + sum a_i B1_i
    + s delta) - r s delta, from the key's query points decoded on the host,
    the witness map's H and the seeded r, s."""
    _, tc = curves
    ps = system
    pk, proof = carried_proof
    r = tc.r
    rng = random.Random(PROVE_SEED)
    rr, ss = rng.randrange(r), rng.randrange(r)
    a = [1] + jax_run["primary"] + jax_run["aux"]
    k = len(jax_run["primary"])
    dev = pk.r1cs_dev
    domain = ps.domain_for(qap_domain, dev)
    h = ps.fr.decode(qap_witness_map(dev, domain, ps.fr.encode(a)))
    h = h[:domain.m - 1]

    def msm(q, group, scalars):
        ck = ps.g1 if group is tc.G1 else ps.g2
        acc = group.zero()
        for P, s in zip(ck.decode_affine(q, group), scalars):
            acc = acc + P * s
        return acc

    A = pk.alpha_g1 + msm(pk.A_query, tc.G1, a) + pk.delta_g1 * rr
    B = pk.beta_g2 + msm(pk.B_query_g2, tc.G2, a) + pk.delta_g2 * ss
    B1 = pk.beta_g1 + msm(pk.B_query_g1, tc.G1, a) + pk.delta_g1 * ss
    C = (msm(pk.L_query, tc.G1, a[k + 1:]) + msm(pk.H_query, tc.G1, h)
         + A * ss + B1 * rr - pk.delta_g1 * (rr * ss % r))
    assert coords(proof) == coords(type(proof)(g_A=A, g_B=B, g_C=C))


def test_carried_proof_verifies_on_the_host(curves, system, jax_run,
                                            carried_proof):
    """The port's verifier (host pairing) on the JAX key's verification key,
    carried across as integer coordinates."""
    from libsnark_tpu_torch.proof_systems.groth16 import (
        Groth16VerificationKey)
    _, tc = curves
    _, proof = carried_proof
    jvk, primary = jax_run["kp"].vk, jax_run["primary"]
    g1 = lambda P: host_point(tc, tc.G1, coords(P))
    g2 = lambda P: host_point(tc, tc.G2, coords(P))
    vk = Groth16VerificationKey(
        alpha_g1=g1(jvk.alpha_g1), beta_g2=g2(jvk.beta_g2),
        gamma_g2=g2(jvk.gamma_g2), delta_g2=g2(jvk.delta_g2),
        gamma_ABC=[g1(P) for P in jvk.gamma_ABC])
    assert system.verifier_strong_IC(vk, primary, proof)
    bad = [(primary[0] + 1) % tc.r] + primary[1:]
    assert not system.verifier_strong_IC(vk, bad, proof)


@pytest.mark.slow
def test_whole_proof_equals_the_jax_prover(jax_run, carried_proof):
    """The JAX package's own prover (its MSMs at 19 / 12 limbs compile for
    minutes on a CPU) on the same key and seed."""
    proof = jax_run["system"].prover(jax_run["kp"].pk, jax_run["primary"],
                                     jax_run["aux"], seed=PROVE_SEED)
    assert coords(carried_proof[1]) == coords(proof)
