"""The port's DFGK14 (uscs_ppzksnark) vs the JAX package's, bit for bit.

Circuits and seeds of tests/test_proof_systems.py::test_dfgk14_round_trip
(generate_uscs_example(r, n, 2), generator seed 55, prover seed 66) at two
sizes: n = 10, whose SSP domain is a TwoPartDomain of 10 (the Zt lane
nv - k = 8 of the V_g1 queries and nv + 1 = 11 of V_g2 lie in the top
half of their 16-lane bucket), and n = 8, a Radix2Domain of 8. The JAX
keypair comes from its host fixed-base path. The port runs on the CPU:
its own generator (the device fixed-base path at n = 10, the host path at
n = 8) must give the JAX keys limb for limb, and its proofs, from its own
key and from the JAX key carried across by ``interop``, must equal the JAX
proof. Tolerance: zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.fp import FpKernel as JaxFpKernel
from libsnark_tpu.proof_systems.dfgk14 import DFGK14 as JaxDFGK14
from libsnark_tpu.reductions import uscs_to_ssp as jax_ssp
from libsnark_tpu.relations.examples import generate_uscs_example as jax_example

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import dfgk14_proving_key_from_numpy
from libsnark_tpu_torch.ops.limbs import from_torch
from libsnark_tpu_torch.proof_systems.dfgk14 import DFGK14, QUERIES
from libsnark_tpu_torch.reductions.uscs_to_ssp import (
    SSPDevice, ssp_domain, ssp_instance_map_with_evaluation, ssp_witness_map)
from libsnark_tpu_torch.relations.arithmetic_programs import (
    SSPWitness, ssp_eval_is_satisfied)
from libsnark_tpu_torch.relations.examples import generate_uscs_example

from _torch_port import (assert_keys_equal, coords, numpy_matrices,
                         numpy_queries)

# domain type -> constraints (2 inputs)
SIZES = {"TwoPartDomain": 10, "Radix2Domain": 8}
GEN_SEED, PROVE_SEED = 55, 66


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
    ps = JaxDFGK14(jax_get_curve("alt_bn128"))
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
    ps = DFGK14(curve, device="cpu")
    ps.host_keygen = jax_run["kind"] == "Radix2Domain"
    cs, primary, aux = generate_uscs_example(curve.r, jax_run["n"], 2)
    kp = ps.generator(cs, seed=GEN_SEED)
    domain = ps.domain_for(ssp_domain, kp.pk.ssp_dev)
    print(f"n = {jax_run['n']}: {type(domain).__name__}, m = {domain.m}")
    assert type(domain).__name__ == jax_run["kind"]
    return ps, kp, ps.prover(kp.pk, primary, aux, seed=PROVE_SEED)


def test_examples_equal_jax(curve):
    """generate_uscs_example is the JAX package's, seed for seed."""
    for n, k, seed in ((10, 2, 7), (33, 5, 123)):
        cs, primary, aux = generate_uscs_example(curve.r, n, k, seed=seed)
        jcs, jprimary, jaux = jax_example(curve.r, n, k, seed=seed)
        assert (primary, aux) == (jprimary, jaux)
        assert [[(t.index, t.coeff) for t in c.terms]
                for c in cs.constraints] == \
            [[(t.index, t.coeff) for t in c.terms] for c in jcs.constraints]
        assert cs.is_satisfied(primary, aux)


def test_own_generator_keys_equal_jax(port_own, jax_run):
    _, kp, _ = port_own
    assert_keys_equal(kp, jax_run["kp"], QUERIES, "ssp_dev", ("V",))


def test_proof_from_own_generator_equals_jax(port_own, jax_run):
    _, _, proof = port_own
    assert coords(proof) == coords(jax_run["proof"])


def test_proof_from_carried_pk_equals_jax(curve, jax_run):
    ps = DFGK14(curve, device="cpu")
    jpk = jax_run["kp"].pk
    jdev = jpk.ssp_dev
    pk = dfgk14_proving_key_from_numpy(
        ps, numpy_queries(jpk, QUERIES), numpy_matrices(jdev, ("V",)),
        jdev.num_constraints, jdev.num_inputs, jdev.num_variables,
        jdev.V.num_rows)
    proof = ps.prover(pk, jax_run["primary"], jax_run["aux"],
                      seed=PROVE_SEED)
    assert coords(proof) == coords(jax_run["proof"])


def test_verifier_accepts_and_rejects(port_own, jax_run, curve):
    ps, kp, proof = port_own
    primary, r = jax_run["primary"], curve.r
    assert ps.verifier_strong_IC(kp.vk, primary, proof)
    bad = [(primary[0] + 1) % r] + primary[1:]
    assert not ps.verifier_strong_IC(kp.vk, bad, proof)
    tam = type(proof)(V_g1=proof.V_g1, alpha_V_g1=proof.alpha_V_g1,
                      H_g1=proof.H_g1 + curve.G1.one(), V_g2=proof.V_g2)
    assert not ps.verifier_strong_IC(kp.vk, primary, tam)
    assert not ps.verifier_strong_IC(kp.vk, primary[:1], proof)


@pytest.mark.parametrize("kind", list(SIZES))
def test_ssp_witness_map_equals_jax(kind, curve):
    """ssp_witness_map limbs equal the JAX function's for the same
    Montgomery inputs, and the SSP holds at a point t."""
    import jax.numpy as jnp
    r = curve.r
    cs, primary, aux = generate_uscs_example(r, SIZES[kind], 2)
    jcs, _, _ = jax_example(r, SIZES[kind], 2)
    ps = DFGK14(curve, device="cpu")
    domain = ps.domain_for(ssp_domain, cs)
    print(f"n = {SIZES[kind]}: {type(domain).__name__}, m = {domain.m}")
    assert type(domain).__name__ == kind
    full = [1] + primary + aux
    d = 424242
    dev = SSPDevice.build(cs, ps.fr, domain.m)
    H = ssp_witness_map(dev, domain, ps.fr.encode(full), ps.fr.encode([d]))

    jfr = JaxFpKernel(jax_get_curve("alt_bn128").fr_params)
    jdomain = jax_ssp.ssp_domain(jfr, jfr.params, jcs)
    jdev = jax_ssp.SSPDevice.build(jcs, jfr, jdomain.m)
    jH = jax_ssp.ssp_witness_map(jdev, jdomain,
                                 jnp.asarray(jfr.encode(full)),
                                 jnp.asarray(jfr.encode([d])))
    assert H.shape == (ps.fr.N, domain.m + 1)
    np.testing.assert_array_equal(from_torch(H), np.asarray(jH))

    ssp = ssp_instance_map_with_evaluation(cs, domain, 0xABCDEF987)
    wit = SSPWitness(d=d, num_inputs=cs.num_inputs,
                     num_variables=cs.num_variables, degree=domain.m,
                     coefficients_for_Vs=primary + aux,
                     coefficients_for_H=ps.fr.decode(H))
    assert ssp_eval_is_satisfied(ssp, wit, r)
    wit.d = d + 1
    assert not ssp_eval_is_satisfied(ssp, wit, r)


def test_needs_a_card_unless_cpu_is_asked(curve):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DFGK14(curve)
