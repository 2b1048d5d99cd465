"""The port's BACS and TBCS ppzkSNARKs vs the JAX package's, bit for bit.

BACS runs BCTV14 over the BACS -> R1CS reduction, TBCS runs DFGK14 over the
TBCS -> USCS reduction. Circuits and seeds of
tests/test_proof_systems.py::test_bacs_round_trip / test_tbcs_round_trip
(generate_bacs_example(r, g, 2), seeds 77 / 88; generate_tbcs_example(g,
2), seeds 99 / 111) at two sizes each: BACS with 8 gates (9 constraints, a
TwoPartDomain of 12) and 12 gates (13 constraints, a Radix2Domain of 16);
TBCS with 8 gates (19 constraints, a TwoPartDomain of 20) and 13 gates (29
constraints, a Radix2Domain of 32). The port runs on the CPU: its own
generator (the host fixed-base path; tests/test_torch_bctv14.py and
test_torch_dfgk14.py hold the device path of the systems underneath) must
give the JAX keys limb for limb, and its proofs, from its
own key and from the JAX key carried across by ``interop``, must equal the
JAX proof. Tolerance: zero.
"""
import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.proof_systems.bacs_ppzksnark import (
    BACSPpzksnark as JaxBACS)
from libsnark_tpu.proof_systems.tbcs_ppzksnark import (
    TBCSPpzksnark as JaxTBCS)
from libsnark_tpu.relations import examples as jax_examples

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import (
    bctv14_proving_key_from_numpy, dfgk14_proving_key_from_numpy)
from libsnark_tpu_torch.proof_systems import bctv14, dfgk14
from libsnark_tpu_torch.proof_systems.bacs_ppzksnark import (
    BACSPpzksnark, BACSProvingKey)
from libsnark_tpu_torch.proof_systems.tbcs_ppzksnark import (
    TBCSPpzksnark, TBCSProvingKey)
from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
from libsnark_tpu_torch.reductions.uscs_to_ssp import ssp_domain
from libsnark_tpu_torch.relations import examples

from _torch_port import (assert_keys_equal, coords, numpy_matrices,
                         numpy_queries)

# (system, domain type) -> gates (2 inputs)
CASES = {("bacs", "TwoPartDomain"): 8, ("bacs", "Radix2Domain"): 12,
         ("tbcs", "TwoPartDomain"): 8, ("tbcs", "Radix2Domain"): 13}
SEEDS = {"bacs": (77, 88), "tbcs": (99, 111)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def curve():
    return get_curve("alt_bn128")


def _example(mod, which, r, gates):
    if which == "bacs":
        return mod.generate_bacs_example(r, gates, 2)
    return mod.generate_tbcs_example(gates, 2)


@pytest.fixture(scope="module")
def jax_systems():
    jc = jax_get_curve("alt_bn128")
    out = {"bacs": JaxBACS(jc), "tbcs": JaxTBCS(jc)}
    for ps in out.values():
        ps.host_keygen = True
    return out


@pytest.fixture(scope="module", params=list(CASES),
                ids=[f"{w}-{k}" for w, k in CASES])
def jax_run(request, jax_systems):
    which, kind = request.param
    ps = jax_systems[which]
    gates = CASES[request.param]
    circuit, primary, aux = _example(jax_examples, which, ps.curve.r, gates)
    gen, prove = SEEDS[which]
    if which == "bacs":
        kp = ps.bacs_generator(circuit, seed=gen)
        proof = ps.bacs_prover(kp.pk, primary, aux, seed=prove)
    else:
        kp = ps.tbcs_generator(circuit, seed=gen)
        proof = ps.tbcs_prover(kp.pk, primary, aux, seed=prove)
    return dict(which=which, kind=kind, gates=gates, kp=kp, proof=proof,
                primary=primary, aux=aux)


def _system(which, curve):
    return (BACSPpzksnark if which == "bacs" else TBCSPpzksnark)(
        curve, device="cpu")


def _prove(ps, which, pk, primary, aux):
    seed = SEEDS[which][1]
    if which == "bacs":
        return ps.bacs_prover(pk, primary, aux, seed=seed)
    return ps.tbcs_prover(pk, primary, aux, seed=seed)


def _verify(ps, which, vk, primary, proof):
    if which == "bacs":
        return ps.verifier_strong_IC(vk, primary, proof)
    return ps.tbcs_verifier_strong_IC(vk, primary, proof)


@pytest.fixture(scope="module")
def port_own(jax_run, curve):
    which = jax_run["which"]
    ps = _system(which, curve)
    # the host fixed-base path: the wrapped systems' own tests hold the
    # device path
    ps.host_keygen = True
    circuit, primary, aux = _example(examples, which, curve.r,
                                     jax_run["gates"])
    if which == "bacs":
        kp = ps.bacs_generator(circuit, seed=SEEDS[which][0])
        domain = ps.domain_for(qap_domain, kp.pk.r1cs_pk.r1cs_dev)
    else:
        kp = ps.tbcs_generator(circuit, seed=SEEDS[which][0])
        domain = ps.domain_for(ssp_domain, kp.pk.uscs_pk.ssp_dev)
    print(f"{which}, {jax_run['gates']} gates: {type(domain).__name__}, "
          f"m = {domain.m}")
    assert type(domain).__name__ == jax_run["kind"]
    return ps, kp, _prove(ps, which, kp.pk, primary, aux)


def test_examples_equal_jax(curve):
    """The BACS, TBCS and binary-input R1CS generators are the JAX
    package's, value for value."""
    r = curve.r
    for gates in (2, 8, 13):
        c, pr, aux = examples.generate_bacs_example(r, gates, 3)
        jc, jpr, jaux = jax_examples.generate_bacs_example(r, gates, 3)
        assert (pr, aux) == (jpr, jaux)
        assert c.get_all_wires(pr, aux) == jc.get_all_wires(jpr, jaux)
        assert c.is_satisfied(pr, aux)
        c, bits, aux = examples.generate_tbcs_example(gates, 3)
        jc, jbits, jaux = jax_examples.generate_tbcs_example(gates, 3)
        assert (bits, aux) == (jbits, jaux)
        assert [(g.left_wire, g.right_wire, int(g.type), g.output)
                for g in c.gates] == [(g.left_wire, g.right_wire, int(g.type),
                                       g.output) for g in jc.gates]
        assert c.is_satisfied(bits, aux)
        cs, pr, aux = examples.generate_r1cs_example_with_binary_input(
            r, gates + 3, 3)
        jcs, jpr, jaux = jax_examples.generate_r1cs_example_with_binary_input(
            r, gates + 3, 3)
        assert (pr, aux) == (jpr, jaux)
        assert [[(t.index, t.coeff) for lc in (c.a, c.b, c.c)
                 for t in lc.terms] for c in cs.constraints] == \
            [[(t.index, t.coeff) for lc in (c.a, c.b, c.c) for t in lc.terms]
             for c in jcs.constraints]
        assert cs.is_satisfied(pr, aux)


def test_own_generator_keys_equal_jax(port_own, jax_run):
    _, kp, _ = port_own
    jkp = jax_run["kp"]
    if jax_run["which"] == "bacs":
        own = bctv14.BCTV14Keypair(pk=kp.pk.r1cs_pk, vk=kp.vk)
        want = bctv14.BCTV14Keypair(pk=jkp.pk.r1cs_pk, vk=jkp.vk)
        assert_keys_equal(own, want, bctv14.QUERIES, "r1cs_dev",
                          ("A", "B", "C"))
    else:
        own = dfgk14.DFGK14Keypair(pk=kp.pk.uscs_pk, vk=kp.vk)
        want = dfgk14.DFGK14Keypair(pk=jkp.pk.uscs_pk, vk=jkp.vk)
        assert_keys_equal(own, want, dfgk14.QUERIES, "ssp_dev", ("V",))


def test_proof_from_own_generator_equals_jax(port_own, jax_run):
    _, _, proof = port_own
    assert coords(proof) == coords(jax_run["proof"])


def test_proof_from_carried_pk_equals_jax(curve, jax_run):
    which = jax_run["which"]
    ps = _system(which, curve)
    jpk = jax_run["kp"].pk
    circuit = _example(examples, which, curve.r, jax_run["gates"])[0]
    if which == "bacs":
        jdev = jpk.r1cs_pk.r1cs_dev
        inner = bctv14_proving_key_from_numpy(
            ps, numpy_queries(jpk.r1cs_pk, bctv14.QUERIES),
            numpy_matrices(jdev, ("A", "B", "C")), jdev.num_constraints,
            jdev.num_inputs, jdev.num_variables)
        pk = BACSProvingKey(circuit=circuit, r1cs_pk=inner)
    else:
        jdev = jpk.uscs_pk.ssp_dev
        inner = dfgk14_proving_key_from_numpy(
            ps, numpy_queries(jpk.uscs_pk, dfgk14.QUERIES),
            numpy_matrices(jdev, ("V",)), jdev.num_constraints,
            jdev.num_inputs, jdev.num_variables, jdev.V.num_rows)
        pk = TBCSProvingKey(circuit=circuit, uscs_pk=inner)
    proof = _prove(ps, which, pk, jax_run["primary"], jax_run["aux"])
    assert coords(proof) == coords(jax_run["proof"])


def test_verifier_accepts_and_rejects(port_own, jax_run, curve):
    """Accepted at both sizes; at the first, also rejected for a wrong
    primary input, a corrupted proof and a short primary input."""
    ps, kp, proof = port_own
    which, primary = jax_run["which"], jax_run["primary"]
    assert _verify(ps, which, kp.vk, primary, proof)
    if jax_run["kind"] == "Radix2Domain":
        return
    if which == "bacs":
        bad = [(primary[0] + 1) % curve.r] + primary[1:]
        tam = type(proof)(g_A=proof.g_A, g_B=proof.g_B, g_C=proof.g_C,
                          g_H=proof.g_H + curve.G1.one(), g_K=proof.g_K)
    else:
        bad = [not primary[0]] + primary[1:]
        tam = type(proof)(V_g1=proof.V_g1, alpha_V_g1=proof.alpha_V_g1,
                          H_g1=proof.H_g1 + curve.G1.one(), V_g2=proof.V_g2)
    assert not _verify(ps, which, kp.vk, bad, proof)
    assert not _verify(ps, which, kp.vk, primary, tam)
    assert not _verify(ps, which, kp.vk, primary[:1], proof)
