"""The port's polynomial commitments (KZG10, the batched two-point opening,
BDFG21) and its profiler against the JAX package, on the CPU.

The same seeded alpha, coefficients and points go through libsnark_tpu's
classes and through the port's with device="cpu" (the plain version of
every kernel). Everything is compared exactly (tolerance 0: these are
integers and curve points): SRS limbs, commitments, witnesses, evaluations
and verdicts; each package's verifier accepts the other's output, the SRS
carried across by ``interop.srs_from_numpy``. alt_bn128 runs at the JAX
tests' shapes (degree 13; the batched and BDFG21 inputs of
tests/test_kzg_batched.py), BLS12-377 at degree 9. Polynomials a Groth16
witness never showed the MSM (the zero polynomial, one coefficient, fewer
coefficients than the SRS holds, all coefficients equal) are held against
the host oracle sum c_i alpha^i G1.
"""
import random

import numpy as np
import pytest
import torch

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.ntt import Radix2Domain as JaxDomain
from libsnark_tpu.ops.fp import FpKernel as JaxFpKernel
from libsnark_tpu.polynomial_commitments import polynomial_ops as jax_poly
from libsnark_tpu.polynomial_commitments.bdfg21 import BDFG21 as JaxBDFG21
from libsnark_tpu.polynomial_commitments.kzg10 import (
    KZG10 as JaxKZG10, KZG10Commitment as JaxCommitment)
from libsnark_tpu.polynomial_commitments.kzg10_batched import (
    KZG10Batched2Point as JaxBatched)

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import srs_from_numpy
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.limbs import from_torch
from libsnark_tpu_torch.ops.ntt import Radix2Domain
from libsnark_tpu_torch.polynomial_commitments import polynomial_ops
from libsnark_tpu_torch.polynomial_commitments.bdfg21 import BDFG21
from libsnark_tpu_torch.polynomial_commitments.kzg10 import (
    KZG10, KZG10Commitment)
from libsnark_tpu_torch.polynomial_commitments.kzg10_batched import (
    BatchedEvaluationWitness, KZG10Batched2Point)
from libsnark_tpu_torch.profiling import Profiler, synchronize

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


@pytest.fixture(scope="module", params=["alt_bn128", "bls12_377"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def bn():
    return _pair("alt_bn128")


# ------------------------------------------------------------------- KZG10

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


SPECIAL = {
    "zero polynomial": lambda p: [0] * (p.deg + 1),
    "one coefficient": lambda p: [p.coeffs[3]],
    "shorter than the SRS": lambda p: p.coeffs[:5],
    "all coefficients equal": lambda p: [p.coeffs[1]] * (p.deg + 1),
    "mostly zero": lambda p: [p.coeffs[0]] + [0] * (p.deg - 1) + [p.coeffs[2]],
    "unreduced coefficients": lambda p: [c + p.r for c in p.coeffs[:4]],
}


@pytest.mark.parametrize("label", list(SPECIAL))
def test_special_polynomials_commit_and_open(bn, label):
    """What a Groth16 witness never showed the MSM: against the host
    oracle, and the opening verifies."""
    coeffs = SPECIAL[label](bn)
    kzg, srs, r = bn.kzg, bn.srs, bn.r
    C = kzg.commit(srs, coeffs)
    assert C.point == bn.oracle(coeffs)
    z = 0xABCDEF
    v, W = kzg.create_evaluation_witness(srs, coeffs, z)
    assert v == polynomial_ops.poly_eval(coeffs, z, r)
    assert kzg.verify_evaluation(srs, C, z, v, W)
    if len(coeffs) <= 1 or not any(c % r for c in coeffs):
        assert W.point == bn.curve.G1.zero()
    if any(c % r for c in coeffs[1:]):
        assert not kzg.verify_evaluation(srs, C, z, (v + 1) % r, W)
        assert not kzg.verify_evaluation(srs, C, z + 1, v, W)


def test_all_equal_coefficients_equal_jax(bn):
    coeffs = SPECIAL["all coefficients equal"](bn)
    z = 0xABCDEF
    jv, jW = bn.jkzg.create_evaluation_witness(bn.jsrs, coeffs, z)
    v, W = bn.kzg.create_evaluation_witness(bn.srs, coeffs, z)
    assert (v, _xy(W.point)) == (jv, _xy(jW.point))
    assert _xy(bn.kzg.commit(bn.srs, coeffs).point) \
        == _xy(bn.jkzg.commit(bn.jsrs, coeffs).point)


def test_empty_polynomial_and_argument_checks(bn):
    kzg, srs = bn.kzg, bn.srs
    assert kzg.commit(srs, []).point == bn.curve.G1.zero()
    v, W = kzg.create_evaluation_witness(srs, [], 5)
    assert v == 0 and W.point == bn.curve.G1.zero()
    with pytest.raises(ValueError, match="under an SRS of degree 13"):
        kzg.commit(srs, [1] * 15)
    with pytest.raises(ValueError, match="under an SRS of degree 13"):
        kzg.create_evaluation_witness(srs, [1] * 15, 5)
    with pytest.raises(ValueError, match="degree must be"):
        kzg.setup_from_secret(-1, 5)
    # z on the evaluation coset g * <w>: the quotient's denominators vanish
    dom = Radix2Domain(kzg.fr, bn.curve.fr_params, 4)
    on_coset = dom.generator * dom.omega % bn.r
    with pytest.raises(ValueError, match="lies on the evaluation coset"):
        kzg.create_evaluation_witness(srs, bn.coeffs, on_coset)


def test_setup_from_secret_matches_jax_small(bn):
    """The JAX test's second shape: degree 7, alpha given."""
    alpha = 123456789
    srs = bn.kzg.setup_from_secret(7, alpha)
    jsrs = bn.jkzg.setup_from_secret(7, alpha)
    for got, want in zip(srs.alpha_powers_g1[:2], jsrs.alpha_powers_g1[:2]):
        np.testing.assert_array_equal(from_torch(got)[:, :8],
                                      np.asarray(want)[:, :8])
    rng = random.Random(51)
    coeffs = [rng.randrange(bn.r) for _ in range(8)]
    want = bn.curve.G1.one() * (
        sum(c * pow(alpha, i, bn.r) for i, c in enumerate(coeffs)) % bn.r)
    assert bn.kzg.commit(srs, coeffs).point == want


def test_kzg_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KZG10(get_curve("alt_bn128"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srs_from_numpy(get_curve("alt_bn128"), (np.zeros((16, 1), np.uint32),
                       np.zeros((16, 1), np.uint32), np.zeros(1, bool)),
                       ((0, 0), (0, 0)), 0)


# ------------------------------------------------- batched KZG10 and BDFG21

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


# ----------------------------------------------------- host helpers, domain

def test_polynomial_ops_equal_the_jax_package():
    r = get_curve("alt_bn128").r
    rng = random.Random(4)
    a = [rng.randrange(r) for _ in range(7)]
    b = [rng.randrange(r) for _ in range(4)]
    z, k = rng.randrange(r), rng.randrange(r)
    for fn, args in (("poly_eval", (a, z, r)), ("poly_scalar_mul", (a, k, r)),
                     ("poly_add", (a, b, r)), ("poly_sub", (b, a, r)),
                     ("poly_accumulate_with_power_factors", ([a, b, a], k, r)),
                     ("poly_accumulate_with_power_factors", ([b], k, r)),
                     ("poly_divide_by_linear", (a, z, r)),
                     ("poly_divide_by_linear", ([], z, r)),
                     ("poly_divide_by_linear", ([5], z, r))):
        assert getattr(polynomial_ops, fn)(*args) \
            == getattr(jax_poly, fn)(*args), fn
    q, rem = polynomial_ops.poly_divide_by_linear(a, z, r)
    assert rem == polynomial_ops.poly_eval(a, z, r)
    back = polynomial_ops.poly_add(
        polynomial_ops.poly_sub([0] + q, polynomial_ops.poly_scalar_mul(q, z, r),
                                r), [rem], r)
    assert back == a


@pytest.mark.parametrize("name", ["alt_bn128", "bls12_377"])
def test_domain_elements_equal_jax(name):
    curve, jcurve = get_curve(name), jax_get_curve(name)
    fr = FpKernel(curve.fr_params, device="cpu")
    for logm in (0, 1, 4):
        dom = Radix2Domain(fr, curve.fr_params, logm)
        want = JaxDomain(JaxFpKernel(jcurve.fr_params), jcurve.fr_params,
                         logm).domain_elements()
        assert fr.decode(dom.domain_elements_mont()) == want


# ----------------------------------------------------------------- profiler

def test_profiler_totals_counts_and_nesting(capsys):
    prof = Profiler()
    with prof.block("outer"):
        for _ in range(3):
            with prof.block("inner", sync=torch.zeros(2)):
                prof.count_op("mul", 2)
    assert prof.counts == {"outer": 1, "inner": 3}
    assert prof.op_counts == {"mul": 6}
    assert 0 <= prof.totals["inner"] <= prof.totals["outer"]
    assert prof.depth == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "(enter) outer"
    assert lines[1] == "  (enter) inner"
    assert lines[2].startswith("  (leave) inner  [")
    assert lines[-1].startswith("(leave) outer  [")
    prof.print_summary()
    out = capsys.readouterr().out
    assert "outer:" in out and "inner:" in out and " x3" in out
    assert "mul: 6" in out
    prof.start_profiling()
    assert not prof.totals and not prof.counts


def test_profiler_records_a_block_that_raises_and_stays_inert_when_off(capsys):
    prof = Profiler()
    with pytest.raises(KeyError):
        with prof.block("failing"):
            raise KeyError("x")
    assert prof.counts["failing"] == 1 and prof.depth == 0
    off = Profiler(enabled=False)
    capsys.readouterr()
    with off.block("quiet", sync=torch.zeros(1)):
        pass
    assert not off.counts and capsys.readouterr().out == ""


def test_profiler_sync_takes_a_tensor_or_a_device(monkeypatch):
    """Only a CUDA device is synchronised; a CPU tensor or device waits
    for nothing."""
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    synchronize(torch.zeros(1))
    synchronize(torch.device("cpu"))
    assert waited == []
    dev = torch.device("cuda", 0)
    synchronize(dev)
    assert waited == [dev]


def test_kzg_phases_run_under_the_global_profiler(bn, capsys):
    from libsnark_tpu_torch import profiling
    prof = profiling.PROFILER
    assert not prof.enabled                    # inert unless started
    profiling.start_profiling()
    try:
        C = bn.kzg.commit(bn.srs, bn.coeffs[:4])
        bn.kzg.create_evaluation_witness(bn.srs, bn.coeffs[:4], 9)
    finally:
        prof.enabled = False
    assert C.point == bn.oracle(bn.coeffs[:4])
    for name in ("kzg.commit.encode", "kzg.commit.msm", "kzg.commit.decode",
                 "kzg.open.evaluate", "kzg.open.encode", "kzg.open.quotient",
                 "kzg.open.msm", "kzg.open.decode"):
        assert prof.counts[name] == 1, name
    assert "(enter) kzg.open.quotient" in capsys.readouterr().out
    prof.start_profiling()
