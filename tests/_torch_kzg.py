"""Both packages' KZG10 over one curve, set up from the same seed, and the
checks of the SRS, one commitment and one opening that each curve's file
runs on it: tests/test_torch_kzg.py (alt_bn128, degree 13) and
tests/test_torch_kzg_bls12_377.py (BLS12-377, degree 9), each with its own
``pair`` fixture. Tolerance: zero."""
import random

import numpy as np
import pytest
import torch

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.polynomial_commitments.kzg10 import (
    KZG10 as JaxKZG10, KZG10Commitment as JaxCommitment)

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import srs_from_numpy
from libsnark_tpu_torch.ops.limbs import from_torch
from libsnark_tpu_torch.polynomial_commitments.kzg10 import (
    KZG10, KZG10Commitment)

SETUP_SEED = 3
DEGREE = {"alt_bn128": 13, "bls12_377": 9}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xy(P):
    return None if P.is_zero() else (int(P.x), int(P.y))


def _g2(P):
    return ((int(P.x.c0), int(P.x.c1)), (int(P.y.c0), int(P.y.c1)))


def _to(group, P):
    """A host G1 point of either package as a point of ``group``."""
    return group.zero() if P.is_zero() else group.point(int(P.x), int(P.y))


class Pair:
    """Both packages over one curve, set up from the same seed, with one
    seeded polynomial committed and opened by each."""

    def __init__(self, name):
        self.name = name
        self.deg = DEGREE[name]
        self.jcurve = jax_get_curve(name)
        self.curve = get_curve(name)
        self.r = self.curve.r
        self.jkzg = JaxKZG10(self.jcurve)
        self.kzg = KZG10(self.curve, device="cpu")
        self.alpha = random.Random(SETUP_SEED).randrange(2, self.r)
        self.jsrs = self.jkzg.setup(self.deg, seed=SETUP_SEED)
        self.srs = self.kzg.setup(self.deg, seed=SETUP_SEED)
        rng = random.Random(50)
        self.coeffs = [rng.randrange(self.r) for _ in range(self.deg + 1)]
        self.z = rng.randrange(self.r)
        self.jC = self.jkzg.commit(self.jsrs, self.coeffs)
        self.C = self.kzg.commit(self.srs, self.coeffs)
        self.jv, self.jW = self.jkzg.create_evaluation_witness(
            self.jsrs, self.coeffs, self.z)
        self.v, self.W = self.kzg.create_evaluation_witness(
            self.srs, self.coeffs, self.z)

    def oracle(self, coeffs):
        s = sum(c * pow(self.alpha, i, self.r) for i, c in enumerate(coeffs))
        return self.curve.G1.one() * (s % self.r)

    def carried_srs(self):
        """The JAX SRS as the port's, through numpy and integers only."""
        return srs_from_numpy(
            self.curve, tuple(np.asarray(a)
                              for a in self.jsrs.alpha_powers_g1),
            _g2(self.jsrs.alpha_g2), self.jsrs.degree, device="cpu")


_PAIRS = {}


def _pair(name):
    """One Pair per curve and module run (its set-up is the JAX compiles)."""
    if name not in _PAIRS:
        _PAIRS[name] = Pair(name)
    return _PAIRS[name]


def test_srs_limbs_equal_jax(pair):
    live = pair.deg + 1
    jx, jy, jinf = (np.asarray(a) for a in pair.jsrs.alpha_powers_g1)
    x, y, inf = (from_torch(a) for a in pair.srs.alpha_powers_g1)
    assert x.shape == jx.shape and inf.shape == jinf.shape
    np.testing.assert_array_equal(inf, jinf)
    assert not inf[:live].any() and inf[live:].all()
    np.testing.assert_array_equal(x[:, :live], jx[:, :live])
    np.testing.assert_array_equal(y[:, :live], jy[:, :live])
    assert _g2(pair.srs.alpha_g2) == _g2(pair.jsrs.alpha_g2)
    assert pair.srs.degree == pair.jsrs.degree == pair.deg


def test_srs_points_are_the_powers_of_alpha(pair):
    pts = pair.kzg.g1.decode_affine(pair.srs.alpha_powers_g1, pair.curve.G1)
    G = pair.curve.G1.one()
    assert pts[:pair.deg + 1] == [G * pow(pair.alpha, i, pair.r)
                                  for i in range(pair.deg + 1)]


def test_commitment_equals_jax_and_the_host_oracle(pair):
    assert _xy(pair.C.point) == _xy(pair.jC.point)
    assert pair.C.point == pair.oracle(pair.coeffs)


def test_witness_and_evaluation_equal_jax(pair):
    assert pair.v == pair.jv
    assert pair.v == pair.kzg.evaluate_polynomial(pair.coeffs, pair.z, pair.r)
    assert _xy(pair.W.point) == _xy(pair.jW.point)


def test_port_verifier_accepts_and_rejects(pair):
    kzg, srs, r = pair.kzg, pair.srs, pair.r
    assert kzg.verify_evaluation(srs, pair.C, pair.z, pair.v, pair.W)
    assert not kzg.verify_evaluation(srs, pair.C, pair.z, (pair.v + 1) % r,
                                     pair.W)
    assert not kzg.verify_evaluation(srs, pair.C, (pair.z + 1) % r, pair.v,
                                     pair.W)
    assert kzg.verify_poly(srs, pair.C, pair.coeffs)
    bad = [(pair.coeffs[0] + 1) % r] + pair.coeffs[1:]
    assert not kzg.verify_poly(srs, pair.C, bad)


def test_port_accepts_jax_output_under_the_carried_srs(pair):
    srs = pair.carried_srs()
    G1 = pair.curve.G1
    C = KZG10Commitment(_to(G1, pair.jC.point))
    W = KZG10Commitment(_to(G1, pair.jW.point))
    assert pair.kzg.verify_evaluation(srs, C, pair.z, pair.jv, W)
    assert not pair.kzg.verify_evaluation(srs, C, pair.z,
                                          (pair.jv + 1) % pair.r, W)
    # and the port commits to the same point under the carried SRS
    assert pair.kzg.commit(srs, pair.coeffs).point == C.point


def test_jax_verifier_accepts_the_port_output(pair):
    G1 = pair.jcurve.G1
    C = JaxCommitment(_to(G1, pair.C.point))
    W = JaxCommitment(_to(G1, pair.W.point))
    assert pair.jkzg.verify_evaluation(pair.jsrs, C, pair.z, pair.v, W)
    assert not pair.jkzg.verify_evaluation(pair.jsrs, C, pair.z,
                                           (pair.v + 1) % pair.r, W)
