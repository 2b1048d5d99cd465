"""The port's ADSNARK (r1cs_ppzkadsnark) vs the JAX package's, bit for bit,
over alt_bn128.

Circuits and seeds of tests/test_adsnark.py::test_adsnark_round_trip
(generate_r1cs_example(r, n, 2), labels input0 / input1, auth_generator
seed 3, auth_sign seed 4, generator seed 5, prover seed 6) at two sizes: n
= 8, whose QAP domain (n + k + 1 = 11) is a TwoPartDomain of 12, and n = 5,
a Radix2Domain of 8 (the Zt lane nv + 1 and the K query's lanes nv + 1 ..
nv + 3 lie in the top half of their 16-lane bucket at both); the Schnorr
signatures at both, Ed25519 at n = 5. The JAX keypair comes from its host
fixed-base path (the same affine points as its device path). The port runs
on the CPU (plain versions of every kernel): its authentication keys and
data, its keys (the device fixed-base path at n = 8, the host one at n =
5) and its proofs (from its own key at n = 8, from the JAX key carried
across by ``interop`` at n = 5, from its own key with Ed25519) must equal
the JAX package's. Tolerance: zero. The host verifiers (pairings, ~0.5 s
each on a CPU) run at one size.
"""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.common.ed25519 import Ed25519Signature as JaxEd25519Signature
from libsnark_tpu.proof_systems.adsnark import ADSNARK as JaxADSNARK
from libsnark_tpu.relations.examples import generate_r1cs_example as jax_example

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import adsnark_proving_key_from_numpy
from libsnark_tpu_torch.proof_systems.adsnark import ADSNARK, QUERIES
from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
from libsnark_tpu_torch.relations.examples import generate_r1cs_example

from _torch_port import (assert_keys_equal, coords, numpy_matrices,
                         numpy_queries)

# domain type -> constraints (2 inputs)
SIZES = {"TwoPartDomain": 8, "Radix2Domain": 5}
LABELS = [b"input0", b"input1"]
AUTH_SEED, SIGN_SEED, GEN_SEED, PROVE_SEED = 3, 4, 5, 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def curve():
    return get_curve("alt_bn128")


def _sig_coords(x):
    """A signature (Schnorr: (R, s); Ed25519: bytes) or a verification key
    (a G1 point or bytes) as plain values."""
    if isinstance(x, (bytes, int)):
        return x
    if isinstance(x, tuple):
        return tuple(_sig_coords(v) for v in x)
    return coords(x)


def _auth_coords(keys, auth):
    return (coords(keys.pap.I1), coords(keys.pak.minusI2),
            _sig_coords(keys.pak.vkp), dataclasses.astuple(keys.sak),
            [(a.mu, coords(a.Lambda), _sig_coords(a.sigma)) for a in auth])


_RUNS = {}


def _jax_system(scheme):
    """One JAX ADSNARK for every case (its compiled MSMs are kept on it);
    the Ed25519 one shares its kernels and its cache of compiled MSMs
    (made here, before the copy, so that both hold the one dict) and sets
    the scheme as the constructor does."""
    if ("jax_system", "schnorr") not in _RUNS:
        ps = JaxADSNARK(jax_get_curve("alt_bn128"))
        ps.host_keygen = True
        ps._msm_jits = {}
        ed = copy.copy(ps)
        ed.sig = JaxEd25519Signature(ps.curve)
        _RUNS["jax_system", "schnorr"] = ps
        _RUNS["jax_system", "ed25519"] = ed
    return _RUNS["jax_system", scheme]


def _jax_case(kind, scheme="schnorr"):
    """The JAX package's authority keys, data, keypair and proof, once."""
    if ("jax", kind, scheme) not in _RUNS:
        ps = _jax_system(scheme)
        cs, primary, aux = jax_example(ps.curve.r, SIZES[kind], 2)
        keys = ps.auth_generator(seed=AUTH_SEED)
        auth = ps.auth_sign(primary, keys.sak, LABELS, seed=SIGN_SEED)
        kp = ps.generator(cs, keys.pap, seed=GEN_SEED)
        proof = ps.prover(kp.pk, primary, aux, auth, seed=PROVE_SEED)
        _RUNS["jax", kind, scheme] = dict(keys=keys, auth=auth, kp=kp,
                                          proof=proof, primary=primary,
                                          aux=aux)
    return _RUNS["jax", kind, scheme]


def _port_case(kind, scheme="schnorr"):
    """The port's (on the CPU): its keys on the device fixed-base path at
    the TwoPartDomain size, on the host path at the Radix2Domain size."""
    if ("port", kind, scheme) not in _RUNS:
        curve = get_curve("alt_bn128")
        ps = ADSNARK(curve, device="cpu", sig_scheme=scheme)
        ps.host_keygen = kind == "Radix2Domain"
        cs, primary, aux = generate_r1cs_example(curve.r, SIZES[kind], 2)
        keys = ps.auth_generator(seed=AUTH_SEED)
        auth = ps.auth_sign(primary, keys.sak, LABELS, seed=SIGN_SEED)
        kp = ps.generator(cs, keys.pap, seed=GEN_SEED)
        domain = ps.domain_for(qap_domain, kp.pk.r1cs_dev)
        print(f"n = {SIZES[kind]}: {type(domain).__name__}, m = {domain.m}")
        assert type(domain).__name__ == kind
        _RUNS["port", kind, scheme] = dict(ps=ps, keys=keys, auth=auth,
                                           kp=kp, primary=primary, aux=aux)
    return _RUNS["port", kind, scheme]


def _carried_pk(ps, jpk):
    jdev = jpk.r1cs_dev
    return adsnark_proving_key_from_numpy(
        ps, numpy_queries(jpk, QUERIES),
        {"rA_i_Z_g1": coords(jpk.rA_i_Z_g1)},
        numpy_matrices(jdev, ("A", "B", "C")), jdev.num_constraints,
        jdev.num_inputs, jdev.num_variables)


def _port_proof(kind):
    """The port's proof: from its own key at the TwoPartDomain size, from
    the JAX key carried by ``interop`` at the Radix2Domain size."""
    port, jax_case = _port_case(kind), _jax_case(kind)
    if "proof" not in port:
        ps = port["ps"]
        pk = port["kp"].pk if kind == "TwoPartDomain" else _carried_pk(
            ps, jax_case["kp"].pk)
        port["proof"] = ps.prover(pk, port["primary"], port["aux"],
                                  port["auth"], seed=PROVE_SEED)
    return port["proof"]


def _macs_of(ps, proof, vk, auth, other):
    """The proof the prover makes from the authenticated data ``other``
    where it was given ``auth``: the prover reads the data only in muA =
    dauth rA_i_Z_g1 + sum mu_i Ain_i, so it moves by sum (mu'_i - mu_i)
    Ain_i (the proving key's A query lanes 1 .. k are vk.Ain)."""
    r = ps.curve.r
    muA = proof.muA
    for a, b, P in zip(auth, other, vk.Ain):
        muA = muA + P * ((b.mu - a.mu) % r)
    return dataclasses.replace(proof, muA=muA)


@pytest.mark.parametrize("kind", list(SIZES))
def test_auth_keys_and_data_equal_jax(kind):
    port, jax_case = _port_case(kind), _jax_case(kind)
    assert _auth_coords(port["keys"], port["auth"]) == \
        _auth_coords(jax_case["keys"], jax_case["auth"])


@pytest.mark.parametrize("kind", list(SIZES))
def test_hashed_point_strings_equal_jax(kind):
    """The signature hashes read str() of host points (Schnorr: R and
    Lambda; Ed25519: Lambda): the port's host points print as the JAX
    package's, infinity included."""
    port, jax_case = _port_case(kind), _jax_case(kind)
    pts = [port["keys"].pap.I1, port["keys"].pak.minusI2]
    jpts = [jax_case["keys"].pap.I1, jax_case["keys"].pak.minusI2]
    for a, ja in zip(port["auth"], jax_case["auth"]):
        pts += [a.Lambda, a.sigma[0]]
        jpts += [ja.Lambda, ja.sigma[0]]
    assert [str(p) for p in pts] == [str(p) for p in jpts]
    assert str(pts[0] * 0) == str(jpts[0] * 0)


@pytest.mark.parametrize("kind", list(SIZES))
def test_own_generator_keys_equal_jax(kind):
    assert_keys_equal(_port_case(kind)["kp"], _jax_case(kind)["kp"],
                      QUERIES, "r1cs_dev", ("A", "B", "C"))


@pytest.mark.parametrize("kind", list(SIZES))
def test_proof_equals_jax(kind):
    """From the port's own key (TwoPartDomain) and from the carried JAX key
    (Radix2Domain)."""
    assert coords(_port_proof(kind)) == coords(_jax_case(kind)["proof"])


def test_verifiers_accept_and_reject(curve):
    kind = "Radix2Domain"
    port = _port_case(kind)
    ps, kp, keys, auth = (port[k] for k in ("ps", "kp", "keys", "auth"))
    proof, primary, r = _port_proof(kind), port["primary"], curve.r
    assert ps.auth_verify_sec(primary, auth, keys.sak, LABELS)
    assert ps.auth_verify_pub(primary, auth, keys.pak, LABELS)
    changed = [(primary[0] + 1) % r] + primary[1:]
    assert not ps.auth_verify_sec(changed, auth, keys.sak, LABELS)
    assert not ps.auth_verify_pub(changed, auth, keys.pak, LABELS)

    assert ps.verifier_sec(kp.vk, proof, keys.sak, LABELS)
    assert ps.verifier_pub(kp.vk, auth, proof, keys.pak, LABELS)
    # authenticated data for a changed input: the public verifier reads the
    # data's Lambdas and signatures, which do not depend on the value (so
    # it would accept the original proof beside them, as the JAX package's
    # does), but a proof made from them over the original input is
    # rejected by both verifiers
    bad_auth = ps.auth_sign(changed, keys.sak, LABELS, seed=7)
    assert [a.Lambda for a in bad_auth] == [a.Lambda for a in auth]
    bad = _macs_of(ps, proof, kp.vk, auth, bad_auth)
    assert not ps.verifier_pub(kp.vk, bad_auth, bad, keys.pak, LABELS)
    assert not ps.verifier_sec(kp.vk, bad, keys.sak, LABELS)
    # wrong labels fail both; a corrupted proof (both of its checks run
    # all six pairing checks after muA's: this one fails at muA's)
    assert not ps.verifier_sec(kp.vk, proof, keys.sak, [b"x0", b"x1"])
    assert not ps.verifier_pub(kp.vk, auth, proof, keys.pak, [b"x0", b"x1"])
    tam = dataclasses.replace(proof, muA=proof.muA + curve.G1.one())
    assert not ps.verifier_sec(kp.vk, tam, keys.sak, LABELS)
    assert not ps.verifier_pub(kp.vk, auth, tam, keys.pak, LABELS)


def test_ed25519_keys_data_and_proof_equal_jax(curve):
    """sig_scheme="ed25519" at the Radix2Domain size: the authentication
    keys and data, the keys and the proof equal the JAX package's; the
    public verifier (the one that reads the signatures) accepts, and
    rejects the proof from a changed input's data and a signature moved
    to another label."""
    kind = "Radix2Domain"
    jax_case = _jax_case(kind, "ed25519")
    port = _port_case(kind, "ed25519")
    ps, keys, auth, kp = (port[k] for k in ("ps", "keys", "auth", "kp"))
    primary, aux = port["primary"], port["aux"]
    assert isinstance(keys.pak.vkp, bytes) and len(keys.pak.vkp) == 32
    assert _auth_coords(keys, auth) == \
        _auth_coords(jax_case["keys"], jax_case["auth"])
    assert [str(a.Lambda) for a in auth] == \
        [str(a.Lambda) for a in jax_case["auth"]]
    assert_keys_equal(kp, jax_case["kp"], QUERIES, "r1cs_dev",
                      ("A", "B", "C"))
    proof = ps.prover(kp.pk, primary, aux, auth, seed=PROVE_SEED)
    assert coords(proof) == coords(jax_case["proof"])
    assert ps.verifier_pub(kp.vk, auth, proof, keys.pak, LABELS)
    changed = [(primary[0] + 1) % curve.r] + primary[1:]
    bad_auth = ps.auth_sign(changed, keys.sak, LABELS, seed=7)
    bad = _macs_of(ps, proof, kp.vk, auth, bad_auth)
    assert not ps.verifier_pub(kp.vk, bad_auth, bad, keys.pak, LABELS)
    forged = list(auth)
    forged[0] = dataclasses.replace(auth[0], sigma=auth[1].sigma)
    assert not ps.verifier_pub(kp.vk, forged, proof, keys.pak, LABELS)


def test_needs_a_card_unless_cpu_is_asked(curve):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ADSNARK(curve)
