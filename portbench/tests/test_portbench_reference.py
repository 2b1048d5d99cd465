"""The plain reference against the program on the CPU at small sizes,
for both configurations and several seeds, and the reference's own
curve data."""
import random

import pytest

from portbench import generate
from portbench.reference import ec, groth16 as ref_groth16, kzg10 as ref_kzg
from _small import load_system

SEEDS = (1, 2 ** 31 + 11, 2 ** 40 + 3)


@pytest.fixture(scope="module")
def curve():
    return ec.Curve("bls12_377")


def test_curve_data(curve):
    g1, g2 = curve.G1, curve.G2
    assert g1.on_curve(g1.generator, curve.b)
    assert g1.mul(curve.r) is None and g1.mul(curve.r + 5) == g1.mul(5)
    assert g2.mul(curve.r) is None and g2.mul(curve.r + 3) == g2.mul(3)
    w = curve.root_of_unity(1 << 10)
    assert pow(w, 1 << 10, curve.r) == 1 and pow(w, 1 << 9, curve.r) != 1


def test_lagrange_basis(curve):
    r, m = curve.r, 16
    L = ref_groth16.lagrange_at(123456789, m, curve.root_of_unity(m), r)
    assert sum(L) % r == 1                    # the constant polynomial 1
    w = curve.root_of_unity(m)
    # x itself: sum_j omega^j L_j(t) = t
    assert sum(pow(w, j, r) * L[j] for j in range(m)) % r == 123456789


def test_root_of_unity_is_the_programs(curve):
    from libsnark_tpu_torch.curves import get_curve
    params = get_curve("bls12_377").fr_params
    assert curve.root_of_unity(1 << params.two_adicity) == \
        params.root_of_unity


@pytest.mark.parametrize("seed", SEEDS)
def test_groth16_matches_program(seed):
    system = load_system("groth16_bls12_377_2e20.dense", seed,
                         num_constraints=(1 << 8) - 11)
    system.prepare()
    for i in (0, 1):
        got = system.as_ints(system.request(i))
        assert all(x is not None for x in got)
        assert system.wrong_elements(i, got) == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_kzg_matches_program(seed):
    system = load_system("kzg10_bls12_377_2e22.commit_open", seed,
                         degree=(1 << 10) - 1)
    system.prepare()
    for i in (0, 1):
        got = system.as_ints(system.request(i))
        assert system.wrong_elements(i, got) == 0


def test_kzg_reference_by_hand(curve):
    r = curve.r
    coeffs = [3, 0, 5]                        # 3 + 5 x^2
    C, v, W = ref_kzg.commit_and_open(curve, 7, coeffs, 2)
    assert v == 23
    assert C == curve.G1.mul(3 + 5 * 49)
    # q(x) = (f(x) - 23) / (x - 2) = 5 x + 10
    assert W == curve.G1.mul((5 * 7 + 10) % r)


def test_groth16_proof_changes_with_each_input(curve):
    """Each of the reference's inputs moves its proof: the witness, the
    randomness and every secret."""
    circuit = generate.circuit("chain", (1 << 5) - 11, 10)
    primary = generate.field_elements(5, "p", 10, curve.r)
    aux = circuit.witness(primary, curve.r)
    secrets = {k: random.Random(k).randrange(1, curve.r)
               for k in ("t", "alpha", "beta", "gamma", "delta")}
    qap = ref_groth16.QAPAtT(curve, circuit, secrets["t"])
    base = ref_groth16.proof(curve, qap, 10, secrets, primary, aux, 9)
    assert ref_groth16.proof(curve, qap, 10, secrets, primary, aux, 10) != base
    other = list(aux)
    other[0] += 1                     # z_0 feeds A and B of later rows
    assert ref_groth16.proof(curve, qap, 10, secrets, primary, other,
                             9) != base
    for k in ("alpha", "beta", "delta"):
        s = dict(secrets, **{k: secrets[k] + 1})
        assert ref_groth16.proof(curve, qap, 10, s, primary, aux, 9) != base
