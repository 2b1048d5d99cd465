"""The port's Groth16 verifier entry points and small API pieces, as in
tests/test_groth16.py::test_groth16_online_verifier_and_affine.

A seeded proof at 6 constraints over BLS12-377 (generate_r1cs_example(r,
6, 2), generator seed 5 on the host fixed-base path, prover seed 9, on the
CPU) is accepted by verifier_strong_IC, online_verifier_strong_IC,
online_verifier_weak_IC (over verifier_process_vk) and verifier_affine; a
wrong input and a short input are rejected.
"""
import random

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu_torch import available_curves, get_curve
from libsnark_tpu_torch.proof_systems.groth16 import (
    Groth16, Groth16ProcessedVK)
from libsnark_tpu_torch.relations.examples import generate_r1cs_example


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    curve = get_curve("bls12_377")
    g16 = Groth16(curve, device="cpu")
    g16.host_keygen = True
    cs, primary, aux = generate_r1cs_example(curve.r, 6, 2)
    kp = g16.generator(cs, seed=5)
    proof = g16.prover(kp.pk, primary, aux, seed=9)
    return g16, kp, proof, primary


def test_all_four_verifiers_accept(run):
    g16, kp, proof, primary = run
    assert g16.verifier_strong_IC(kp.vk, primary, proof)
    pvk = g16.verifier_process_vk(kp.vk)
    assert isinstance(pvk, Groth16ProcessedVK)
    assert g16.online_verifier_strong_IC(pvk, primary, proof)
    assert g16.online_verifier_weak_IC(pvk, primary, proof)
    assert g16.verifier_affine(kp.vk, primary, proof)


def test_online_verifier_rejects(run):
    g16, kp, proof, primary = run
    pvk = g16.verifier_process_vk(kp.vk)
    bad = [(primary[0] + 1) % g16.curve.r] + primary[1:]
    assert not g16.online_verifier_strong_IC(pvk, bad, proof)
    assert not g16.online_verifier_strong_IC(pvk, primary[:1], proof)
    assert not g16.online_verifier_weak_IC(pvk, primary + [1], proof)
    tam = type(proof)(g_A=proof.g_A, g_B=proof.g_B,
                      g_C=proof.g_C + g16.curve.G1.one())
    assert not g16.online_verifier_weak_IC(pvk, primary, tam)


def test_size_summary(run):
    g16, kp, _, _ = run
    nv = kp.pk.r1cs_dev.num_variables
    assert kp.pk.size_summary() == dict(
        A=nv + 1, B=nv + 1, H=kp.pk.H_query[0].shape[-1],
        L=kp.pk.L_query[0].shape[-1])


def test_bn128_is_alt_bn128():
    assert "bn128" in available_curves()
    bn, alt = get_curve("bn128"), get_curve("alt_bn128")
    coords = lambda c: (c.q, c.r, int(c.G1.one().x), int(c.G1.one().y),
                        int(c.G2.one().x.c0), int(c.G2.one().x.c1),
                        int(c.G2.one().y.c0), int(c.G2.one().y.c1))
    assert bn.name == "alt_bn128"
    assert coords(bn) == coords(alt)


def test_fixed_base_points_equal_host_points():
    """gamma_ABC's path: fixed_base_points_g1 on the device path (the plain
    versions here) and on the host path give the same points for a few
    hundred scalars (0, 1 and r - 1 among them), each s * G1."""
    bn = get_curve("alt_bn128")
    rng = random.Random(3)
    scalars = [0, 1, bn.r - 1] + [rng.randrange(bn.r) for _ in range(247)]
    dev = Groth16(bn, device="cpu")
    host = Groth16(bn, device="cpu")
    host.host_keygen = True
    G1 = bn.G1.one()
    got = dev.fixed_base_points_g1(G1, scalars)
    assert got == host.fixed_base_points_g1(G1, scalars)
    assert got[:3] == [bn.G1.zero(), G1, -G1]
    assert got[3:8] == [G1 * s for s in scalars[3:8]]
