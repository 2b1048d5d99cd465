"""The port's BCTV14 (r1cs_ppzksnark) vs the JAX package's, bit for bit.

Circuits and seeds of tests/test_proof_systems.py::test_bctv14_round_trip
(generate_r1cs_example(r, n, 2), generator seed 33, prover seed 44) at two
sizes: n = 8, whose QAP domain (n + k + 1 = 11) is a TwoPartDomain of 12,
and n = 5, a Radix2Domain of 8. At both, the Zt lane nv + 1 of the A/B/C
queries and the K query's lanes nv + 1 .. nv + 3 lie in the top half of
their 16-lane bucket. The JAX keypair comes from its host fixed-base path
(the same affine points as its device path). The port runs on the CPU
(plain versions of every kernel): its own generator (the device fixed-base
path at n = 8, the host one at n = 5) must give the JAX keys limb for limb,
and its proofs, from its own key and from the JAX key carried across by
``interop``, must equal the JAX proof. Tolerance: zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.fp import FpKernel as JaxFpKernel
from libsnark_tpu.proof_systems.bctv14 import BCTV14 as JaxBCTV14
from libsnark_tpu.reductions.r1cs_to_qap import (
    qap_domain as jax_qap_domain, qap_witness_map_zk as jax_witness_map_zk)
from libsnark_tpu.relations.examples import generate_r1cs_example as jax_example

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import bctv14_proving_key_from_numpy
from libsnark_tpu_torch.ops.limbs import from_torch
from libsnark_tpu_torch.proof_systems.bctv14 import BCTV14, QUERIES
from libsnark_tpu_torch.reductions.r1cs_to_qap import (
    qap_domain, qap_instance_map_with_evaluation, qap_witness_map_zk)
from libsnark_tpu_torch.relations.arithmetic_programs import (
    QAPWitness, qap_eval_is_satisfied)
from libsnark_tpu_torch.relations.examples import generate_r1cs_example

from _torch_port import (assert_keys_equal, coords, numpy_matrices,
                         numpy_queries)

# domain type -> constraints (2 inputs)
SIZES = {"TwoPartDomain": 8, "Radix2Domain": 5}
GEN_SEED, PROVE_SEED = 33, 44


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def curve():
    return get_curve("alt_bn128")


@pytest.fixture(scope="module")
def jax_system():
    ps = JaxBCTV14(jax_get_curve("alt_bn128"))
    ps.host_keygen = True
    return ps


@pytest.fixture(scope="module", params=list(SIZES))
def jax_run(request, jax_system):
    n = SIZES[request.param]
    cs, primary, aux = jax_example(jax_system.curve.r, n, 2)
    kp = jax_system.generator(cs, seed=GEN_SEED)
    proof = jax_system.prover(kp.pk, primary, aux, seed=PROVE_SEED)
    return dict(kind=request.param, n=n, kp=kp, proof=proof,
                primary=primary, aux=aux)


@pytest.fixture(scope="module")
def port_own(jax_run, curve):
    ps = BCTV14(curve, device="cpu")
    # the device fixed-base path at one size, the host path at the other
    ps.host_keygen = jax_run["kind"] == "Radix2Domain"
    cs, primary, aux = generate_r1cs_example(curve.r, jax_run["n"], 2)
    kp = ps.generator(cs, seed=GEN_SEED)
    domain = ps.domain_for(qap_domain, kp.pk.r1cs_dev)
    print(f"n = {jax_run['n']}: {type(domain).__name__}, m = {domain.m}")
    assert type(domain).__name__ == jax_run["kind"]
    return ps, kp, ps.prover(kp.pk, primary, aux, seed=PROVE_SEED)


def test_own_generator_keys_equal_jax(port_own, jax_run):
    _, kp, _ = port_own
    assert_keys_equal(kp, jax_run["kp"], QUERIES, "r1cs_dev", ("A", "B", "C"))


def test_proof_from_own_generator_equals_jax(port_own, jax_run):
    _, _, proof = port_own
    assert coords(proof) == coords(jax_run["proof"])


def test_proof_from_carried_pk_equals_jax(curve, jax_run):
    ps = BCTV14(curve, device="cpu")
    jdev = jax_run["kp"].pk.r1cs_dev
    pk = bctv14_proving_key_from_numpy(
        ps, numpy_queries(jax_run["kp"].pk, QUERIES),
        numpy_matrices(jdev, ("A", "B", "C")), jdev.num_constraints,
        jdev.num_inputs, jdev.num_variables)
    proof = ps.prover(pk, jax_run["primary"], jax_run["aux"],
                      seed=PROVE_SEED)
    assert coords(proof) == coords(jax_run["proof"])


def test_verifier_accepts_and_rejects(port_own, jax_run, curve):
    ps, kp, proof = port_own
    primary, r = jax_run["primary"], curve.r
    assert ps.verifier_strong_IC(kp.vk, primary, proof)
    bad = [(primary[0] + 1) % r] + primary[1:]
    assert not ps.verifier_strong_IC(kp.vk, bad, proof)
    tam = type(proof)(g_A=proof.g_A, g_B=proof.g_B, g_C=proof.g_C,
                      g_H=proof.g_H + curve.G1.one(), g_K=proof.g_K)
    assert not ps.verifier_strong_IC(kp.vk, primary, tam)
    assert not ps.verifier_strong_IC(kp.vk, primary[:1], proof)
    assert not ps.verifier_weak_IC(kp.vk, primary + [1], proof)


@pytest.mark.parametrize("kind", list(SIZES))
def test_qap_witness_map_zk_equals_jax(kind, curve):
    """The ZK witness map's (N, m + 1) limbs equal the JAX function's for
    the same Montgomery inputs, and the QAP holds at a point t."""
    import jax.numpy as jnp
    r = curve.r
    cs, primary, aux = generate_r1cs_example(r, SIZES[kind], 2)
    jcs, _, _ = jax_example(r, SIZES[kind], 2)
    ps = BCTV14(curve, device="cpu")
    domain = ps.domain_for(qap_domain, cs)
    print(f"n = {SIZES[kind]}: {type(domain).__name__}, m = {domain.m}")
    assert type(domain).__name__ == kind
    full = [1] + primary + aux
    d = (12345, 67890, 13579)
    H = qap_witness_map_zk(cs.to_device(ps.fr), domain, ps.fr.encode(full),
                           *(ps.fr.encode([v]) for v in d))

    jfr = JaxFpKernel(jax_get_curve("alt_bn128").fr_params)
    jdomain = jax_qap_domain(jfr, jfr.params, jcs)
    jH = jax_witness_map_zk(jcs.to_device(jfr), jdomain,
                            jnp.asarray(jfr.encode(full)),
                            *(jnp.asarray(jfr.encode([v])) for v in d))
    assert H.shape == (ps.fr.N, domain.m + 1)
    np.testing.assert_array_equal(from_torch(H), np.asarray(jH))

    qap = qap_instance_map_with_evaluation(cs, domain, 0xDEADBEEF1234567)
    wit = QAPWitness(d1=d[0], d2=d[1], d3=d[2], num_inputs=cs.num_inputs,
                     num_variables=cs.num_variables, degree=domain.m,
                     coefficients_for_ABCs=primary + aux,
                     coefficients_for_H=ps.fr.decode(H))
    assert qap_eval_is_satisfied(qap, wit, r)
    wit.coefficients_for_H = [(wit.coefficients_for_H[0] + 1) % r] + \
        wit.coefficients_for_H[1:]
    assert not qap_eval_is_satisfied(qap, wit, r)


def test_needs_a_card_unless_cpu_is_asked(curve):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BCTV14(curve)
