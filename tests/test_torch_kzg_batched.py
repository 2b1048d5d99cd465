"""The port's batched two-point KZG10 opening and BDFG21 against the JAX
package's, on the CPU, at the inputs of tests/test_kzg_batched.py
(alt_bn128, an SRS of degree 15 from seed 42): evaluations, witnesses and
verdicts equal; each verifier accepts the witness the other package made
and rejects a changed evaluation. Tolerance: zero.
"""
import types

import pytest
import torch

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.polynomial_commitments.bdfg21 import BDFG21 as JaxBDFG21
from libsnark_tpu.polynomial_commitments.kzg10 import KZG10 as JaxKZG10
from libsnark_tpu.polynomial_commitments.kzg10_batched import (
    KZG10Batched2Point as JaxBatched)

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.polynomial_commitments.bdfg21 import BDFG21
from libsnark_tpu_torch.polynomial_commitments.kzg10 import KZG10
from libsnark_tpu_torch.polynomial_commitments.kzg10_batched import (
    BatchedEvaluationWitness, KZG10Batched2Point)

from _torch_kzg import _one_thread, _to, _xy  # noqa: F401


@pytest.fixture(scope="module")
def bn():
    """Both packages' KZG10 over alt_bn128 (the SRS is srs15's)."""
    curve = get_curve("alt_bn128")
    return types.SimpleNamespace(
        curve=curve, r=curve.r, kzg=KZG10(curve, device="cpu"),
        jkzg=JaxKZG10(jax_get_curve("alt_bn128")))


@pytest.fixture(scope="module")
def srs15(bn):
    """The JAX batched tests' SRS: degree 15, seed 42, in both packages."""
    return bn.jkzg.setup(15, seed=42), bn.kzg.setup(15, seed=42)


FS = [[1, 2, 3, 4], [5, 0, 7], [9, 8, 7, 6, 5]]
GS = [[11, 12], [13, 0, 0, 15]]


def test_batched_two_point_equals_jax(bn, srs15):
    jsrs, srs = srs15
    r = bn.r
    z_1, z_2, gamma_1, gamma_2, r_rand = 0xAA1, 0xBB2, 0xC01, 0xD02, 0xE03
    jb, b = JaxBatched(bn.jkzg), KZG10Batched2Point(bn.kzg)
    jev = jb.evaluate_polynomials(FS, GS, z_1, z_2)
    ev = b.evaluate_polynomials(FS, GS, z_1, z_2)
    assert (ev.s_1s, ev.s_2s) == (jev.s_1s, jev.s_2s)
    cm_1s = [bn.kzg.commit(srs, f) for f in FS]
    cm_2s = [bn.kzg.commit(srs, g) for g in GS]
    jwit = jb.create_evaluation_witness(FS, GS, z_1, z_2, jev, jsrs, gamma_1,
                                        gamma_2)
    wit = b.create_evaluation_witness(FS, GS, z_1, z_2, ev, srs, gamma_1,
                                      gamma_2)
    assert (_xy(wit.W_1), _xy(wit.W_2)) == (_xy(jwit.W_1), _xy(jwit.W_2))
    args = (z_1, z_2, ev, srs, gamma_1, gamma_2)
    assert b.verify_evaluations(*args, wit, cm_1s, cm_2s, r_rand)
    G1 = bn.curve.G1
    carried = BatchedEvaluationWitness(W_1=_to(G1, jwit.W_1),
                                       W_2=_to(G1, jwit.W_2))
    assert b.verify_evaluations(*args, carried, cm_1s, cm_2s, r_rand)
    bad = type(ev)(s_1s=[(ev.s_1s[0] + 1) % r] + ev.s_1s[1:], s_2s=ev.s_2s)
    assert not b.verify_evaluations(z_1, z_2, bad, srs, gamma_1, gamma_2,
                                    wit, cm_1s, cm_2s, r_rand)
    with pytest.raises(ValueError, match="do not match the polynomials"):
        b.create_evaluation_witness(FS, GS, z_1, z_2, bad, srs, gamma_1,
                                    gamma_2)
    with pytest.raises(ValueError, match="one evaluation per commitment"):
        b.verify_evaluations(*args, wit, cm_1s[:2], cm_2s, r_rand)


def test_bdfg21_equals_jax(bn, srs15):
    jsrs, srs = srs15
    r = bn.r
    f_sets = [[[1, 2, 3], [4, 5, 6, 7]], [[8, 9], [10, 11, 12]]]
    T = [0x111, 0x222]
    gamma, z = 0x333, 0x444
    jb, b = JaxBDFG21(bn.jkzg), BDFG21(bn.kzg)
    ev = b.evaluate_polynomials(f_sets, T)
    assert ev == jb.evaluate_polynomials(f_sets, T)
    cm_sets = [[bn.kzg.commit(srs, f) for f in fset] for fset in f_sets]
    jph1 = jb.create_evaluation_witness_phase_1(f_sets, T, ev, jsrs, gamma)
    ph1 = b.create_evaluation_witness_phase_1(f_sets, T, ev, srs, gamma)
    assert ph1.private_f_over_Z_T == jph1.private_f_over_Z_T
    jwit = jb.create_evaluation_witness(f_sets, T, ev, jsrs, gamma, jph1, z)
    wit = b.create_evaluation_witness(f_sets, T, ev, srs, gamma, ph1, z)
    assert (_xy(wit.W), _xy(wit.W_prime)) == (_xy(jwit.W), _xy(jwit.W_prime))
    assert b.verify_evaluations(T, ev, srs, gamma, z, wit, cm_sets)
    G1 = bn.curve.G1
    carried = type(wit)(W=_to(G1, jwit.W), W_prime=_to(G1, jwit.W_prime))
    assert b.verify_evaluations(T, ev, srs, gamma, z, carried, cm_sets)
    bad = [list(e) for e in ev]
    bad[0][0] = (bad[0][0] + 1) % r
    assert not b.verify_evaluations(T, bad, srs, gamma, z, wit, cm_sets)
    with pytest.raises(ValueError, match="not divisible"):
        b.create_evaluation_witness_phase_1(f_sets, T, bad, srs, gamma)
