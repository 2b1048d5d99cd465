"""The port over BLS12-377 (24-limb Fq, Fq2 with non-residue -5, 16-limb Fr
of two-adicity 47) vs the JAX package, bit for bit (tolerance 0: all
arithmetic is exact and every value canonical).

Field ops of Fq and Fq2; dbl / add / madd / aadd of G1 and G2 with planted
infinity, P == Q and P == -Q lanes (aadd also for alt_bn128: the JAX
package runs it through its plain reference on the CPU, as its own tests
do); the NTT and the witness map over Fr; the pairing of the port's host
copy; and the seeded 20-constraint Groth16 proof from the carried-across
key, from the port's own generator and under both MSM strategies. On CPU
tensors the port runs the kernels' plain versions.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.domains import get_evaluation_domain as jax_domain
from libsnark_tpu.ops.ec import CurveKernel as JaxCurve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.fp2 import Fp2Kernel as JaxFp2
from libsnark_tpu.proof_systems.groth16 import Groth16 as JaxGroth16
from libsnark_tpu.reductions.r1cs_to_qap import qap_witness_map as jax_wmap
from libsnark_tpu.relations.examples import generate_r1cs_example as jax_example

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.fields import generic_pow
from libsnark_tpu_torch.interop import QUERIES, proving_key_from_numpy
from libsnark_tpu_torch.ops.domains import get_evaluation_domain
from libsnark_tpu_torch.ops.ec import CurveKernel
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.fp2 import Fp2Kernel
from libsnark_tpu_torch.ops.limbs import from_torch, to_torch
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_witness_map
from libsnark_tpu_torch.relations.examples import generate_r1cs_example

BLS = "bls12_377"
UNARY = {"sqr", "neg", "inv", "double"}
L = 12   # lanes: 0 P=inf, 1 Q=inf, 2 both, 3-4 P==Q, 5-6 P==-Q, rest random


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(name):
    jc, tc = jax_get_curve(name), get_curve(name)
    jfq, tfq = JaxFp(jc.fq_params), FpKernel(tc.fq_params, device="cpu")
    jf2 = JaxFp2(jfq, int(jc.Fq2.NON_RESIDUE))
    tf2 = Fp2Kernel(tfq, int(tc.Fq2.NON_RESIDUE))
    return {"fq": (jfq, tfq), "fq2": (jf2, tf2)}


def _ints(p, n, seed, nonzero=False):
    rng = random.Random(seed)
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]
    return [x or 1 for x in xs] if nonzero else xs


def _jax_op(fk, op):
    if op in UNARY:
        return jax.jit(lambda a: getattr(fk, op)(a))
    return jax.jit(lambda a, b: getattr(fk, op)(a, b))


# ------------------------------------------------------------------ fields

def test_bls12_377_field_shapes():
    tc = get_curve(BLS)
    assert (tc.fq_params.num_limbs, tc.fr_params.num_limbs) == (24, 16)
    assert tc.fr_params.two_adicity == 47
    fq = FpKernel(tc.fq_params, device="cpu")
    assert (fq.nw, fq.mod.n0inv) == (12, (-pow(tc.q, -1, 1 << 32)) % (1 << 32))
    f2 = Fp2Kernel(fq, int(tc.Fq2.NON_RESIDUE))
    assert (f2.beta_small, f2.beta_is_neg, f2.mod.beta_small) == (5, True, 5)
    one = sum(int(w) << (32 * k) for k, w in enumerate(fq.mod.one))
    assert one == (1 << 384) % tc.q == tc.fq_params.R


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg", "inv"])
def test_fq_op_matches_jax(op):
    jfk, tfk = _fields(BLS)["fq"]
    a = jfk.encode(_ints(jfk.p, 24, 1, nonzero=(op == "inv")))
    b = jfk.encode(_ints(jfk.p, 24, 2)[::-1])
    args = (a,) if op in UNARY else (a, b)
    want = _jax_op(jfk, op)(*[jnp.asarray(x) for x in args])
    got = getattr(tfk, op)(*[to_torch(x, "cpu") for x in args])
    assert got.dtype == torch.int32 and got.shape[0] == 24
    np.testing.assert_array_equal(from_torch(got), np.asarray(want))


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub"])
def test_fq2_op_matches_jax(op):
    jfk, tfk = _fields(BLS)["fq2"]
    F2 = get_curve(BLS).Fq2
    p = jfk.fp.p
    xs = [F2(a, b) for a, b in zip(_ints(p, 12, 5), _ints(p, 12, 6)[::-1])]
    ys = [F2(a, b) for a, b in zip(_ints(p, 12, 7), _ints(p, 12, 8))]
    a, b = jfk.encode(xs), jfk.encode(ys)
    args = (a,) if op in UNARY else (a, b)
    want = _jax_op(jfk, op)(*[jnp.asarray(x) for x in args])
    got = getattr(tfk, op)(*[to_torch(x, "cpu") for x in args])
    np.testing.assert_array_equal(from_torch(got), np.asarray(want))


def test_odd_or_unbuilt_limb_count_is_refused():
    """17 limbs (an odd count) and 32 limbs (16 words) have no build (csrc
    builds 12, 16, 19, 24 and 48 limbs). Both raise instead of running a
    plain path in silence."""
    from libsnark_tpu_torch.curves.curve import FieldParams
    from libsnark_tpu_torch.ops import cuda_lib
    p17 = (1 << 258) - 93         # an odd modulus of 17 limbs
    assert FieldParams.build(p17).num_limbs == 17
    with pytest.raises(ValueError, match="no kernels built for 17 limbs"):
        FpKernel(FieldParams.build(p17), device="cpu")
    with pytest.raises(ValueError, match="no kernels built"):
        cuda_lib.make_mod((1 << 509) - 1, 32)
    with pytest.raises(ValueError, match="no kernels built"):
        cuda_lib.words_of(32)


# ------------------------------------------------------------------ groups

def _curve_kernels(name, group):
    jf, tf = _fields(name)["fq" if group == "G1" else "fq2"]
    host = getattr(get_curve(name), group)
    return JaxCurve(jf, group), CurveKernel(tf, group), host


def _points(name, host_group, seed):
    rng = random.Random(seed)
    r = get_curve(name).r
    G = host_group.one()
    P = [G * rng.randrange(1, r) for _ in range(L)]
    Q = [G * rng.randrange(1, r) for _ in range(L)]
    P[0] = host_group.zero()
    Q[1] = host_group.zero()
    P[2], Q[2] = host_group.zero(), host_group.zero()
    Q[3], Q[4] = P[3], P[4]
    Q[5], Q[6] = -P[5], -P[6]
    return P, Q


def _rescale(name, tck, P, seed):
    """Jacobian P with a random non-trivial Z per lane (X Z^2, Y Z^3, Z)."""
    fk = tck.fk
    rng = random.Random(seed)
    if hasattr(fk, "fp"):
        F2 = get_curve(name).Fq2
        q = fk.fp.p
        Z = fk.encode([F2(rng.randrange(1, q), rng.randrange(q))
                       for _ in range(L)], device="cpu")
    else:
        Z = fk.encode([rng.randrange(1, fk.p) for _ in range(L)],
                      device="cpu")
    Z = fk.select(tck.is_zero(P), torch.zeros_like(Z), Z)
    Z2 = fk.sqr(Z)
    return (fk.mul(P[0], Z2), fk.mul(P[1], fk.mul(Z2, Z)), Z)


OPS = ["dbl", "add", "madd", "aadd"]
GROUP_CASES = ([(BLS, g, op) for g in ("G1", "G2") for op in OPS]
               + [("alt_bn128", g, "aadd") for g in ("G1", "G2")])
_CASES = {}


def _case(name, group):
    """Inputs and both packages' outputs for one group, computed once."""
    if (name, group) in _CASES:
        return _CASES[name, group]
    ops = [op for n, g, op in GROUP_CASES if (n, g) == (name, group)]
    jck, tck, host = _curve_kernels(name, group)
    Ph, Qh = _points(name, host, 11 if group == "G1" else 12)
    P = _rescale(name, tck, tck.encode_points(Ph, device="cpu"), 21)
    Q = _rescale(name, tck, tck.encode_points(Qh, device="cpu"), 22)
    Paff = tck.encode_points(Ph, jacobian=False, device="cpu")
    Qaff = tck.encode_points(Qh, jacobian=False, device="cpu")
    valid = torch.ones(L, dtype=torch.bool)
    valid[-1] = False
    j = lambda T: tuple(jnp.asarray(from_torch(a)) for a in T)
    jax_fns = {"dbl": lambda: jck.dbl(j(P)), "add": lambda: jck.add(j(P), j(Q)),
               "madd": lambda: jck.madd(j(P), j(Qaff),
                                        jnp.asarray(valid.numpy())),
               "aadd": lambda: jck.aadd(j(Paff), j(Qaff))}
    port_fns = {"dbl": lambda: tck.dbl(P), "add": lambda: tck.add(P, Q),
                "madd": lambda: tck.madd(P, Qaff, valid),
                "aadd": lambda: tck.aadd(Paff, Qaff)}
    want = jax.jit(lambda: tuple(jax_fns[op]() for op in ops))()
    got = tuple(port_fns[op]() for op in ops)
    _CASES[name, group] = dict(
        tck=tck, host=host, Ph=Ph, Qh=Qh, valid=valid,
        want=dict(zip(ops, want)), got=dict(zip(ops, got)))
    return _CASES[name, group]


@pytest.mark.parametrize("name,group,op", GROUP_CASES)
def test_group_op_matches_jax_and_host(name, group, op):
    """Jacobian limbs equal the JAX package's; affine points the oracle's."""
    case = _case(name, group)
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


# ------------------------------------------------- host pairing (own copy)

def test_port_host_pairing_bls_family():
    """The cases of tests/test_host_pairing.py on the port's copy."""
    curve = get_curve(BLS)
    P, Q = curve.G1.one(), curve.G2.one()
    e = curve.pairing(P, Q)
    assert e != curve.GT.one()
    assert generic_pow(e, curve.r) == curve.GT.one()
    a = random.Random(7).randrange(2, 1 << 64)
    assert curve.pairing(P * a, Q) == curve.pairing(P, Q * a)
    assert curve.pairing_check([(P * a, Q), (-P, Q * a)])
    assert not curve.pairing_check([(P * a, Q), (-P, Q * (a + 1))])
    assert curve.pairing(curve.G1.zero(), Q) == curve.GT.one()


# --------------------------------------------------- Fr: NTT, witness map

@pytest.fixture(scope="module")
def fr():
    jc, tc = jax_get_curve(BLS), get_curve(BLS)
    return (JaxFp(jc.fr_params), jc.fr_params,
            FpKernel(tc.fr_params, device="cpu"), tc.fr_params)


@pytest.mark.parametrize("min_size", [16, 256])
def test_fr_domain_transforms_match_jax(fr, min_size):
    jfk, jparams, tfk, tparams = fr
    assert tparams.multiplicative_generator == 22
    jd = jax_domain(jfk, jparams, min_size)
    td = get_evaluation_domain(tfk, tparams, min_size)
    assert (type(td).__name__, td.m) == (type(jd).__name__, jd.m)
    rng = random.Random(min_size)
    a = jfk.encode([rng.randrange(jfk.p) for _ in range(2 * td.m)])
    a = a.reshape(jfk.N, 2, td.m)

    @jax.jit
    def jax_all(x):
        return (jd.fft(x), jd.ifft(x), jd.coset_fft(x), jd.icoset_fft_divz(x))

    want = jax_all(jnp.asarray(a))
    ta = to_torch(a, "cpu")
    got = (td.fft(ta), td.ifft(ta), td.coset_fft(ta), td.icoset_fft_divz(ta))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(from_torch(g), np.asarray(w))


def test_fr_witness_map_matches_jax(fr):
    jfk, jparams, tfk, tparams = fr
    r = get_curve(BLS).r
    jcs, primary, aux = jax_example(r, 20, 2)
    tcs, tprimary, taux = generate_r1cs_example(r, 20, 2)
    assert (tprimary, taux) == (primary, aux)
    jcs.swap_AB_if_beneficial()
    tcs.swap_AB_if_beneficial()
    n = jcs.num_constraints + jcs.num_inputs + 1
    jd = jax_domain(jfk, jparams, n)
    td = get_evaluation_domain(tfk, tparams, n)
    assign = jfk.encode([1] + primary + aux)
    jdev = jcs.to_device(jfk)
    want = jax.jit(lambda s: jax_wmap(jdev, jd, s))(jnp.asarray(assign))
    got = qap_witness_map(tcs.to_device(tfk), td, to_torch(assign, "cpu"))
    np.testing.assert_array_equal(from_torch(got), np.asarray(want))


# ---------------------------------------------------- Groth16 end to end

def _g1(P):
    return None if P.is_zero() else (int(P.x), int(P.y))


def _g2(P):
    if P.is_zero():
        return None
    return ((int(P.x.c0), int(P.x.c1)), (int(P.y.c0), int(P.y.c1)))


def _proof_coords(proof):
    return (_g1(proof.g_A), _g2(proof.g_B), _g1(proof.g_C))


@pytest.fixture(scope="module")
def jax_run():
    """Circuit and seeds of tests/test_groth16.py's seeded case, over
    BLS12-377 (host fixed-base path: the device path's affine points)."""
    curve = jax_get_curve(BLS)
    cs, primary, aux = jax_example(curve.r, 20, 2)
    g16 = JaxGroth16(curve)
    g16.host_keygen = True
    kp = g16.generator(cs, seed=5)
    proof = g16.prover(kp.pk, primary, aux, seed=9)
    return dict(kp=kp, proof=proof, primary=primary, aux=aux)


def test_proof_from_carried_key_equals_jax(jax_run):
    """Default strategy, on the JAX key carried across as numpy (G1 rows of
    24 limbs, G2 of 2 x 24)."""
    port = Groth16(get_curve(BLS), device="cpu")
    pk = jax_run["kp"].pk
    dev = pk.r1cs_dev
    queries = {q: tuple(np.asarray(a) for a in getattr(pk, q))
               for q in QUERIES}
    assert queries["A_query"][0].shape[0] == 24
    assert queries["B_query_g2"][0].shape[:2] == (2, 24)
    points = {"alpha_g1": _g1(pk.alpha_g1), "beta_g1": _g1(pk.beta_g1),
              "delta_g1": _g1(pk.delta_g1), "beta_g2": _g2(pk.beta_g2),
              "delta_g2": _g2(pk.delta_g2)}
    matrices = {k: (m.rows, m.cols, m.coeffs)
                for k, m in (("A", dev.A), ("B", dev.B), ("C", dev.C))}
    tpk = proving_key_from_numpy(port, queries, points, matrices,
                                 dev.num_constraints, dev.num_inputs,
                                 dev.num_variables)
    proof = port.prover(tpk, jax_run["primary"], jax_run["aux"], seed=9)
    assert _proof_coords(proof) == _proof_coords(jax_run["proof"])


@pytest.fixture(scope="module")
def port_own():
    """The port's own generator (device fixed-base path) and a proof under
    the dense MSM strategy."""
    port = Groth16(get_curve(BLS), device="cpu", msm_strategy="dense")
    cs, primary, aux = generate_r1cs_example(port.curve.r, 20, 2)
    kp = port.generator(cs, seed=5)
    return port, kp, primary, port.prover(kp.pk, primary, aux, seed=9)


def test_own_generator_keys_equal_jax(port_own, jax_run):
    _, kp, _, _ = port_own
    jpk = jax_run["kp"].pk
    for q in QUERIES:
        for got, want in zip(getattr(kp.pk, q), getattr(jpk, q)):
            np.testing.assert_array_equal(from_torch(got), np.asarray(want))
    for name in ("alpha_g1", "beta_g1", "delta_g1"):
        assert _g1(getattr(kp.pk, name)) == _g1(getattr(jpk, name))
    for name in ("beta_g2", "delta_g2"):
        assert _g2(getattr(kp.pk, name)) == _g2(getattr(jpk, name))
    jvk = jax_run["kp"].vk
    assert [_g1(P) for P in kp.vk.gamma_ABC] == [_g1(P) for P in jvk.gamma_ABC]


def test_dense_proof_from_own_generator_equals_jax(port_own, jax_run):
    """Equal to the JAX proof, hence to the default strategy's proof above:
    the strategies differ in Jacobian window sums only."""
    _, _, _, proof = port_own
    assert _proof_coords(proof) == _proof_coords(jax_run["proof"])


def test_port_verifier_accepts_and_rejects(port_own):
    port, kp, primary, proof = port_own
    r = port.curve.r
    assert port.verifier_strong_IC(kp.vk, primary, proof)
    bad = [(primary[0] + 1) % r] + primary[1:]
    assert not port.verifier_strong_IC(kp.vk, bad, proof)
    tam = type(proof)(g_A=proof.g_A, g_B=proof.g_B,
                      g_C=proof.g_C + port.curve.G1.one())
    assert not port.verifier_strong_IC(kp.vk, primary, tam)
