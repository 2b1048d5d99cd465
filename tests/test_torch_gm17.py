"""The port's GM17 (r1cs_se_ppzksnark) vs the JAX package's, bit for bit.

Circuits and seeds of tests/test_proof_systems.py::test_gm17_round_trip
(generate_r1cs_example(r, n, 2), generator seed 11, prover seed 22) at two
sizes: n = 8, whose SAP domain (2n + 2k + 1 = 21) is a TwoPartDomain of
24, and n = 12, a Radix2Domain of 32. The JAX keypair comes from its host
fixed-base path. The port runs on the CPU: its own generator (the device
fixed-base path over G = g_s G1 and H = h_s G2 at n = 8, the host path at
n = 12) must give the JAX keys limb for limb, and its proofs, from its own
key and from the JAX key carried across by ``interop``, must equal the JAX
proof. A Groth16 keygen that shares the GM17 system's window tables must
still key on the generators. Tolerance: zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.fp import FpKernel as JaxFpKernel
from libsnark_tpu.proof_systems.gm17 import GM17 as JaxGM17
from libsnark_tpu.proof_systems.groth16 import Groth16 as JaxGroth16
from libsnark_tpu.reductions import r1cs_to_sap as jax_sap
from libsnark_tpu.relations.examples import generate_r1cs_example as jax_example

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import (
    QUERIES as G16_QUERIES, gm17_proving_key_from_numpy)
from libsnark_tpu_torch.ops.limbs import from_torch
from libsnark_tpu_torch.proof_systems.gm17 import GM17, QUERIES
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.reductions.r1cs_to_sap import (
    SAPDevice, sap_domain, sap_extend_assignment,
    sap_instance_map_with_evaluation, sap_witness_map)
from libsnark_tpu_torch.relations.arithmetic_programs import (
    SAPWitness, sap_eval_is_satisfied)
from libsnark_tpu_torch.relations.examples import generate_r1cs_example

from _torch_port import (assert_keys_equal, coords, numpy_matrices,
                         numpy_queries)

# domain type -> constraints (2 inputs)
SIZES = {"TwoPartDomain": 8, "Radix2Domain": 12}
GEN_SEED, PROVE_SEED = 11, 22
SAP_MATRICES = ("A", "C", "AB_diff")
HOST_POINTS = ("G_gamma_Z", "H_gamma_Z", "G_ab_gamma_Z", "G_gamma2_Z2",
               "G_gamma2_Z_t0")


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
    ps = JaxGM17(jax_get_curve("alt_bn128"))
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
    ps = GM17(curve, device="cpu")
    ps.host_keygen = jax_run["kind"] == "Radix2Domain"
    cs, primary, aux = generate_r1cs_example(curve.r, jax_run["n"], 2)
    kp = ps.generator(cs, seed=GEN_SEED)
    domain = ps.domain_for(sap_domain, kp.pk.sap_dev)
    print(f"n = {jax_run['n']}: {type(domain).__name__}, m = {domain.m}")
    assert type(domain).__name__ == jax_run["kind"]
    return ps, kp, ps.prover(kp.pk, primary, aux, seed=PROVE_SEED)


def test_own_generator_keys_equal_jax(port_own, jax_run):
    _, kp, _ = port_own
    assert_keys_equal(kp, jax_run["kp"], QUERIES, "sap_dev", SAP_MATRICES)


def test_proof_from_own_generator_equals_jax(port_own, jax_run):
    _, _, proof = port_own
    assert coords(proof) == coords(jax_run["proof"])


def test_proof_from_carried_pk_equals_jax(port_own, jax_run):
    ps = port_own[0]              # its domain and tables made once a size
    jpk = jax_run["kp"].pk
    jdev = jpk.sap_dev
    pk = gm17_proving_key_from_numpy(
        ps, numpy_queries(jpk, QUERIES),
        {name: coords(getattr(jpk, name)) for name in HOST_POINTS},
        numpy_matrices(jdev, SAP_MATRICES), jdev.num_constraints,
        jdev.num_inputs, jdev.num_variables)
    proof = ps.prover(pk, jax_run["primary"], jax_run["aux"],
                      seed=PROVE_SEED)
    assert coords(proof) == coords(jax_run["proof"])


def test_verifier_accepts_and_rejects(port_own, jax_run, curve):
    ps, kp, proof = port_own
    primary, r = jax_run["primary"], curve.r
    vk = ps.verifier_process_vk(kp.vk)
    assert ps.verifier_strong_IC(vk, primary, proof)
    bad = [(primary[0] + 1) % r] + primary[1:]
    assert not ps.verifier_strong_IC(vk, bad, proof)
    tam = type(proof)(A=proof.A, B=proof.B, C=proof.C + curve.G1.one())
    assert not ps.verifier_strong_IC(vk, primary, tam)
    assert not ps.verifier_strong_IC(vk, primary[:1], proof)


def test_groth16_keygen_after_gm17_on_shared_tables(jax_system, curve):
    """GM17 keys on G = g_s G1 and H = h_s G2. A GM17 keygen on the device
    fixed-base path, then a Groth16 keygen whose window-table cache is the
    GM17 system's: both keys must equal the JAX package's."""
    ps = GM17(curve, device="cpu")
    cs, _, _ = generate_r1cs_example(curve.r, 4, 2)
    kp = ps.generator(cs, seed=GEN_SEED)
    jcs, _, _ = jax_example(curve.r, 4, 2)
    assert_keys_equal(kp, jax_system.generator(jcs, seed=GEN_SEED), QUERIES,
                      "sap_dev", SAP_MATRICES)
    assert len(ps._fixed_tables) == 2

    g16 = Groth16(curve, device="cpu")
    g16._fixed_tables = ps._fixed_tables
    cs, _, _ = generate_r1cs_example(curve.r, 4, 2)
    kp = g16.generator(cs, seed=5)
    assert len(ps._fixed_tables) == 4      # two bases in each group
    jg16 = JaxGroth16(jax_get_curve("alt_bn128"))
    jg16.host_keygen = True
    jcs, _, _ = jax_example(curve.r, 4, 2)
    jkp = jg16.generator(jcs, seed=5)
    for q in G16_QUERIES:
        for got, want in zip(getattr(kp.pk, q), getattr(jkp.pk, q)):
            np.testing.assert_array_equal(from_torch(got), np.asarray(want),
                                          err_msg=q)
    assert coords(kp.vk) == coords(jkp.vk)


@pytest.mark.parametrize("kind", list(SIZES))
def test_sap_witness_map_equals_jax(kind, curve):
    """sap_extend_assignment + sap_witness_map limbs equal the JAX
    functions' for the same Montgomery inputs, and the SAP holds at t."""
    import jax.numpy as jnp
    r = curve.r
    cs, primary, aux = generate_r1cs_example(r, SIZES[kind], 2)
    jcs, _, _ = jax_example(r, SIZES[kind], 2)
    ps = GM17(curve, device="cpu")
    domain = ps.domain_for(sap_domain, cs)
    print(f"n = {SIZES[kind]}: {type(domain).__name__}, m = {domain.m}")
    assert type(domain).__name__ == kind
    full = [1] + primary + aux
    d1, d2 = 12345, 67890
    dev = SAPDevice.build(cs, ps.fr)
    ext = sap_extend_assignment(dev, ps.fr, ps.fr.encode(full))
    H = sap_witness_map(dev, domain, ext, ps.fr.encode([d1]),
                        ps.fr.encode([d2]))

    jfr = JaxFpKernel(jax_get_curve("alt_bn128").fr_params)
    jdomain = jax_sap.sap_domain(jfr, jfr.params, jcs)
    jdev = jax_sap.SAPDevice.build(jcs, jfr)
    jext = jax_sap.sap_extend_assignment(jdev, jfr,
                                         jnp.asarray(jfr.encode(full)))
    jH = jax_sap.sap_witness_map(jdev, jdomain, jext,
                                 jnp.asarray(jfr.encode([d1])),
                                 jnp.asarray(jfr.encode([d2])))
    np.testing.assert_array_equal(from_torch(ext), np.asarray(jext))
    assert H.shape == (ps.fr.N, domain.m + 1)
    np.testing.assert_array_equal(from_torch(H), np.asarray(jH))

    sap = sap_instance_map_with_evaluation(cs, domain, 0xDEADBEEF1234567)
    wit = SAPWitness(d1=d1, d2=d2, num_inputs=cs.num_inputs,
                     num_variables=dev.sap_num_variables, degree=domain.m,
                     coefficients_for_ACs=ps.fr.decode(ext)[1:],
                     coefficients_for_H=ps.fr.decode(H))
    assert sap_eval_is_satisfied(sap, wit, r)
    wit.d2 = (d2 + 1) % r
    assert not sap_eval_is_satisfied(sap, wit, r)


def test_needs_a_card_unless_cpu_is_asked(curve):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GM17(curve)
