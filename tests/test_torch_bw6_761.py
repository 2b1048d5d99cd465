"""The port over BW6-761 (48-limb Fq, 24-limb Fr = BLS12-377's Fq, G1 and
G2 both over Fq with a = 0) vs the JAX package and the host oracle, bit for
bit (tolerance 0: all arithmetic is exact and every value canonical).

The curve's parameters and generators; the 48-limb Montgomery product and
field ops; dbl / add / madd / aadd of G1 and G2 with planted infinity,
P == Q and P == -Q lanes; a small MSM per group; the window table and
batch exp of the device fixed-base path on a few scalars against host
scalar multiples; a seeded 8-constraint Groth16 keypair; the witness map
over Fr; and the port's proof from the JAX key carried by ``interop``
against a host recomputation of Groth16's three elements, verified by the
host pairing. On CPU tensors the port runs the kernels' plain versions.
The JAX keys come from its host fixed-base path (the same affine points as
its device path); the JAX prover at 48 limbs compiles for many minutes on
a CPU, so the comparison of whole proofs is one test marked slow.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.ec import CurveKernel as JaxCurve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.limbs import ints_to_limbs as jax_ints_to_limbs
from libsnark_tpu.ops.msm import MSMKernel as JaxMSM
from libsnark_tpu.proof_systems.groth16 import Groth16 as JaxGroth16
from libsnark_tpu.reductions.r1cs_to_qap import (
    qap_domain as jax_qap_domain, qap_witness_map as jax_wmap)
from libsnark_tpu.relations.examples import generate_r1cs_example as jax_example

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import QUERIES, proving_key_from_numpy
from libsnark_tpu_torch.ops import cuda_ec, cuda_lib
from libsnark_tpu_torch.ops.ec import CurveKernel
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.fp2 import Fp2Kernel
from libsnark_tpu_torch.ops.limbs import from_torch, ints_to_limbs, to_torch
from libsnark_tpu_torch.ops.msm import MSMKernel
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.reductions.r1cs_to_qap import (
    qap_domain, qap_witness_map)
from libsnark_tpu_torch.relations.examples import generate_r1cs_example

from _torch_port import coords

BW6 = "bw6_761"
L = 12   # lanes: 0 P=inf, 1 Q=inf, 2 both, 3-4 P==Q, 5-6 P==-Q, rest random
N_CONSTRAINTS, GEN_SEED, PROVE_SEED = 8, 5, 9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def curves():
    return jax_get_curve(BW6), get_curve(BW6)


@pytest.fixture(scope="module")
def fq(curves):
    jc, tc = curves
    return JaxFp(jc.fq_params), FpKernel(tc.fq_params, device="cpu")


def _ints(p, n, seed, nonzero=False):
    rng = random.Random(seed)
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]
    return [x or 1 for x in xs] if nonzero else xs


# ------------------------------------------------------------ the curve

def test_curve_parameters_and_generators_equal_jax(curves):
    jc, tc = curves
    for name in ("q", "r", "trace", "xi", "twist_type", "g1_cofactor",
                 "g2_cofactor", "g2_field_degree"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert (int(tc.b), int(tc.b2)) == (int(jc.b), int(jc.b2))
    assert tc.q.bit_length() == 761 and tc.g2_field_degree == 1
    assert tc.r == get_curve("bls12_377").q     # Fr is BLS12-377's Fq
    for group in ("G1", "G2"):
        G, jG = getattr(tc, group).one(), getattr(jc, group).one()
        assert (int(G.x), int(G.y)) == (int(jG.x), int(jG.y)), group
        assert str(G) == str(jG)
        assert G.mul_unreduced(tc.r).is_zero()
    for f in ("fq_params", "fr_params"):
        tp, jp = getattr(tc, f), getattr(jc, f)
        assert (tp.p, tp.num_limbs, tp.R, tp.two_adicity) == \
            (jp.p, jp.num_limbs, jp.R, jp.two_adicity), f
    assert (tc.fq_params.num_limbs, tc.fr_params.num_limbs) == (48, 24)


def test_48_limbs_are_24_words_and_fp2_there_is_refused(curves):
    """Fq's 48 limbs pair into 24 words, built for G1 and G2 over Fp; an Fp2
    over it lies on no path and has no kernels: refused."""
    _, tc = curves
    assert cuda_lib.words_of(48) == 24
    fq = FpKernel(tc.fq_params, device="cpu")
    assert fq.nw == 24
    assert fq.mod.n0inv == (-pow(tc.q, -1, 1 << 32)) % (1 << 32)
    one = sum(int(w) << (32 * k) for k, w in enumerate(fq.mod.one))
    assert one == (1 << 768) % tc.q == tc.fq_params.R
    assert tc.q < 1 << 767                      # the carry-chain product
    assert cuda_ec.width_args(fq) == (24, 1)
    bls_fq = FpKernel(get_curve("bls12_377").fq_params, device="cpu")
    assert cuda_ec.width_args(Fp2Kernel(bls_fq, -5)) == (12, 2)
    with pytest.raises(ValueError, match="degree 2 at 24"):
        cuda_ec.width_args(Fp2Kernel(fq, -4))
    assert "add_fp_n48" in cuda_ec.LAUNCHES
    assert "add_fp2_n48" not in cuda_ec.LAUNCHES
    system = Groth16(tc, device="cpu")
    assert system.fq2 is None and system.g2.fk is system.fq
    assert system.scalar_limbs == 24


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg"])
def test_fq_op_matches_jax(fq, op):
    """mont_mul (the kernel's plain version) and the field ops at N = 48."""
    jfk, tfk = fq
    a = jfk.encode(_ints(jfk.p, 24, 1))
    b = jfk.encode(_ints(jfk.p, 24, 2)[::-1])
    args = (a,) if op in ("sqr", "neg") else (a, b)
    want = jax.jit(lambda *x: getattr(jfk, op)(*x))(
        *[jnp.asarray(x) for x in args])
    got = getattr(tfk, op)(*[to_torch(x, "cpu") for x in args])
    assert got.dtype == torch.int32 and got.shape[0] == 48
    np.testing.assert_array_equal(from_torch(got), np.asarray(want))


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


def _rescale(tck, P, seed):
    """Jacobian P with a random non-trivial Z per lane (X Z^2, Y Z^3, Z)."""
    fk = tck.fk
    rng = random.Random(seed)
    Z = fk.encode([rng.randrange(1, fk.p) for _ in range(L)], device="cpu")
    Z = fk.select(tck.is_zero(P), torch.zeros_like(Z), Z)
    Z2 = fk.sqr(Z)
    return (fk.mul(P[0], Z2), fk.mul(P[1], fk.mul(Z2, Z)), Z)


OPS = ("dbl", "add", "madd", "aadd")


@pytest.fixture(scope="module", params=["G1", "G2"])
def group_case(request, curves, fq):
    """Both packages' dbl / add / madd / aadd on the planted lanes of one
    group, the JAX ones in one jit (they share its 48-limb formulas)."""
    group = request.param
    _, tc = curves
    jfk, tfk = fq
    jck, tck = JaxCurve(jfk, group), CurveKernel(tfk, group)
    host = getattr(tc, group)
    Ph, Qh = _points(host, tc.r, 11 if group == "G1" else 12)
    P = _rescale(tck, tck.encode_points(Ph, device="cpu"), 21)
    Q = _rescale(tck, tck.encode_points(Qh, device="cpu"), 22)
    Paff = tck.encode_points(Ph, jacobian=False, device="cpu")
    Qaff = tck.encode_points(Qh, jacobian=False, device="cpu")
    valid = torch.ones(L, dtype=torch.bool)
    valid[-1] = False
    j = lambda T: tuple(jnp.asarray(from_torch(a)) for a in T)
    want = jax.jit(lambda P, Q, Pa, Qa, v: (
        jck.dbl(P), jck.add(P, Q), jck.madd(P, Qa, v), jck.aadd(Pa, Qa)))(
        j(P), j(Q), j(Paff), j(Qaff), jnp.asarray(valid.numpy()))
    got = (tck.dbl(P), tck.add(P, Q), tck.madd(P, Qaff, valid),
           tck.aadd(Paff, Qaff))
    return dict(tck=tck, host=host, Ph=Ph, Qh=Qh, valid=valid,
                want=dict(zip(OPS, want)), got=dict(zip(OPS, got)))


@pytest.mark.parametrize("op", OPS)
def test_group_op_matches_jax_and_host(group_case, op):
    """Jacobian limbs equal the JAX package's; affine points the oracle's."""
    case = group_case
    for g, w in zip(case["got"][op], case["want"][op]):
        np.testing.assert_array_equal(from_torch(g), np.asarray(w))
    tck, host, Ph, Qh = case["tck"], case["host"], case["Ph"], case["Qh"]
    got = tck.decode_points(case["got"][op], host)
    if op == "dbl":
        want = [P + P for P in Ph]
    elif op == "madd":
        want = [P + Q if v else P
                for P, Q, v in zip(Ph, Qh, case["valid"].tolist())]
    else:
        want = [P + Q for P, Q in zip(Ph, Qh)]
    assert got == want


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_small_msm_matches_jax_and_host(curves, fq, group):
    """16 points (two infinity, three equal, one zero and one r - 1
    scalar): the port's MSM (bucket_reduce, add, horner_combine plain) and
    the JAX MSMKernel give the same affine limbs, and the host's sum."""
    jc, tc = curves
    jfk, tfk = fq
    host = getattr(tc, group)
    rng = random.Random(31 if group == "G1" else 32)
    pts = [host.one() * rng.randrange(1, tc.r) for _ in range(16)]
    pts[3] = pts[4] = pts[5]
    pts[6] = pts[7] = host.zero()
    sc = [rng.randrange(tc.r) for _ in range(16)]
    sc[8], sc[9] = 0, tc.r - 1
    sc[4] = sc[5]
    tck = CurveKernel(tfk, group)
    aff = tck.encode_points(pts, jacobian=False, device="cpu")
    limbs = ints_to_limbs(sc, 24).astype("int32")
    got = tck.to_affine(MSMKernel(tck, tc.r.bit_length()).msm(
        aff, torch.from_numpy(limbs), 4))
    jck = JaxCurve(jfk, group)
    jaff = tuple(jnp.asarray(from_torch(a)) for a in aff)
    want = jax.jit(lambda a, s: jck.to_affine(
        JaxMSM(jck, jc.r.bit_length()).msm(a, s, 4)))(
        jaff, jnp.asarray(jax_ints_to_limbs(sc, 24).astype("int32")))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(from_torch(g).reshape(-1),
                                      np.asarray(w).reshape(-1))
    total = host.zero()
    for P, s in zip(pts, sc):
        total = total + P * s
    assert tck.decode_affine(got, host)[0] == total


@pytest.mark.parametrize("group,c", [("G1", 4), ("G2", 3)])
def test_device_fixed_base_equals_host_multiples(curves, group, c):
    """The keygen's device path (dbl_chain window table, madd_windows batch
    exp, to_affine: their plain versions at 48 limbs) on planted 64-bit
    scalars (a 64-bit scan keeps the table's Fermat inversions short on a
    CPU; the card's check runs full scalars): the host's multiples."""
    _, tc = curves
    ps = Groth16(tc, device="cpu")
    ck = ps.g1 if group == "G1" else ps.g2
    mk = MSMKernel(ck, 64)
    rng = random.Random(41 if group == "G1" else 42)
    sc = [0, 1, (1 << 64) - 1, 1 << 63] + [rng.randrange(1 << 64)
                                          for _ in range(4)]
    base = getattr(tc, group).one()
    baff = ck.encode_points([base], jacobian=False, device="cpu")
    W = -(-64 // c)
    taff = ck.to_affine(mk.window_table((baff[0], baff[1]), c, W))
    P = mk.batch_exp(taff, torch.from_numpy(ints_to_limbs(sc, 24).astype(
        "int32")), c, mk.fixed_base_rows(taff))
    assert ck.decode_points(P, getattr(tc, group)) == [base * s for s in sc]


# ------------------------------------------------------------ Groth16

@pytest.fixture(scope="module")
def jax_run(curves):
    """The JAX keypair over BW6-761 on its host fixed-base path."""
    jc, _ = curves
    cs, primary, aux = jax_example(jc.r, N_CONSTRAINTS, 2)
    g16 = JaxGroth16(jc)
    g16.host_keygen = True
    kp = g16.generator(cs, seed=GEN_SEED)
    return dict(system=g16, kp=kp, primary=primary, aux=aux, cs=cs)


@pytest.fixture(scope="module")
def port_own(curves):
    _, tc = curves
    ps = Groth16(tc, device="cpu")
    ps.host_keygen = True
    cs, primary, aux = generate_r1cs_example(tc.r, N_CONSTRAINTS, 2)
    return ps, ps.generator(cs, seed=GEN_SEED), primary, aux


def test_own_keypair_equals_jax(port_own, jax_run):
    """Every query's limbs (G2 rows of 48 limbs: G2 lies over Fq) and every
    host point of both keys."""
    _, kp, _, _ = port_own
    jpk = jax_run["kp"].pk
    assert jpk.B_query_g2[0].shape[0] == 48
    for q in QUERIES:
        for got, want in zip(getattr(kp.pk, q), getattr(jpk, q)):
            np.testing.assert_array_equal(from_torch(got), np.asarray(want),
                                          err_msg=q)
    for name in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2"):
        assert coords(getattr(kp.pk, name)) == coords(getattr(jpk, name))
    jvk = jax_run["kp"].vk
    for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2"):
        assert coords(getattr(kp.vk, name)) == coords(getattr(jvk, name))
    assert coords(kp.vk.gamma_ABC) == coords(jvk.gamma_ABC)


def test_witness_map_over_fr_matches_jax(port_own, jax_run):
    """qap_witness_map over Fr (24 limbs) on the same Montgomery inputs."""
    ps, kp, primary, aux = port_own
    jsys = jax_run["system"]
    full = [1] + primary + aux
    dev = kp.pk.r1cs_dev
    H = qap_witness_map(dev, ps.domain_for(qap_domain, dev),
                        ps.fr.encode(full))
    jcs = jax_run["cs"]
    jdomain = jax_qap_domain(jsys.fr, jsys.fr.params, jcs)
    jH = jax_wmap(jax_run["kp"].pk.r1cs_dev, jdomain,
                  jnp.asarray(jsys.fr.encode(full)))
    assert H.shape[0] == 24
    np.testing.assert_array_equal(from_torch(H), np.asarray(jH))


def _carried_pk(ps, jpk):
    dev = jpk.r1cs_dev
    queries = {q: tuple(np.asarray(a) for a in getattr(jpk, q))
               for q in QUERIES}
    points = {name: coords(getattr(jpk, name)) for name in (
        "alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2")}
    matrices = {k: (m.rows, m.cols, m.coeffs)
                for k, m in (("A", dev.A), ("B", dev.B), ("C", dev.C))}
    return proving_key_from_numpy(ps, queries, points, matrices,
                                  dev.num_constraints, dev.num_inputs,
                                  dev.num_variables)


@pytest.fixture(scope="module")
def carried_proof(curves, jax_run):
    _, tc = curves
    ps = Groth16(tc, device="cpu")
    pk = _carried_pk(ps, jax_run["kp"].pk)
    return ps, pk, ps.prover(pk, jax_run["primary"], jax_run["aux"],
                             seed=PROVE_SEED)


def test_proof_from_carried_key_equals_host_recomputation(curves, jax_run,
                                                          carried_proof):
    """A = alpha + sum a_i A_i + r delta, B = beta + sum a_i B_i + s delta
    (G2), C = sum_aux a_i L_i + sum h_i H_i + s A + r (beta + sum a_i B1_i
    + s delta) - r s delta, from the key's query points decoded on the host,
    the witness map's H and the seeded r, s."""
    _, tc = curves
    ps, pk, proof = carried_proof
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


def test_carried_proof_verifies_on_the_host(curves, jax_run, carried_proof):
    _, tc = curves
    ps, _, proof = carried_proof
    vk, primary = jax_run["kp"].vk, jax_run["primary"]
    assert ps.verifier_strong_IC(vk, primary, proof)
    bad = [(primary[0] + 1) % tc.r] + primary[1:]
    assert not ps.verifier_strong_IC(vk, bad, proof)


@pytest.mark.slow
def test_whole_proof_equals_the_jax_prover(jax_run, carried_proof):
    """The JAX package's own BW6-761 prover (its MSMs at 48 limbs compile
    for many minutes on a CPU) on the same key and seed."""
    proof = jax_run["system"].prover(jax_run["kp"].pk, jax_run["primary"],
                                     jax_run["aux"], seed=PROVE_SEED)
    assert coords(carried_proof[2]) == coords(proof)


def test_needs_a_card_unless_cpu_is_asked(curves):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Groth16(curves[1])
