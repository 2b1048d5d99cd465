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
the host oracle sum c_i alpha^i G1. The checks of tests/_torch_kzg.py
run here over alt_bn128; tests/test_torch_kzg_bls12_377.py runs them over
BLS12-377 and tests/test_torch_kzg_batched.py holds the batched opening
and BDFG21.
"""
import random

import numpy as np
import pytest
import torch

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.ntt import Radix2Domain as JaxDomain
from libsnark_tpu.ops.fp import FpKernel as JaxFpKernel
from libsnark_tpu.polynomial_commitments import polynomial_ops as jax_poly

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import srs_from_numpy
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.limbs import from_torch
from libsnark_tpu_torch.ops.ntt import Radix2Domain
from libsnark_tpu_torch.polynomial_commitments import polynomial_ops
from libsnark_tpu_torch.polynomial_commitments.kzg10 import KZG10
from libsnark_tpu_torch.profiling import Profiler, synchronize

from _torch_kzg import (  # noqa: F401  (fixtures and shared tests)
    _one_thread, _pair, _to, _xy, test_commitment_equals_jax_and_the_host_oracle,
    test_jax_verifier_accepts_the_port_output,
    test_port_accepts_jax_output_under_the_carried_srs,
    test_port_verifier_accepts_and_rejects,
    test_srs_limbs_equal_jax, test_srs_points_are_the_powers_of_alpha,
    test_witness_and_evaluation_equal_jax)


@pytest.fixture(scope="module", params=["alt_bn128"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def bn():
    return _pair("alt_bn128")


# ------------------------------------------------------------------- KZG10

SPECIAL = {
    "zero polynomial": lambda p: [0] * (p.deg + 1),
    "one coefficient": lambda p: [p.coeffs[3]],
    "shorter than the SRS": lambda p: p.coeffs[:5],
    "all coefficients equal": lambda p: [p.coeffs[1]] * (p.deg + 1),
    "mostly zero": lambda p: [p.coeffs[0]] + [0] * (p.deg - 1) + [p.coeffs[2]],
    "unreduced coefficients": lambda p: [c + p.r for c in p.coeffs[:4]],
}


_SPECIAL_RUNS = {}


def _special_run(bn, label):
    """The port's commitment and opening at z = 0xABCDEF of SPECIAL[label],
    made once a module run (the JAX comparison below reads them too)."""
    if label not in _SPECIAL_RUNS:
        coeffs = SPECIAL[label](bn)
        C = bn.kzg.commit(bn.srs, coeffs)
        v, W = bn.kzg.create_evaluation_witness(bn.srs, coeffs, 0xABCDEF)
        _SPECIAL_RUNS[label] = (coeffs, C, v, W)
    return _SPECIAL_RUNS[label]


@pytest.mark.parametrize("label", list(SPECIAL))
def test_special_polynomials_commit_and_open(bn, label):
    """What a Groth16 witness never showed the MSM: against the host
    oracle, and the opening verifies."""
    coeffs, C, v, W = _special_run(bn, label)
    kzg, srs, r = bn.kzg, bn.srs, bn.r
    assert C.point == bn.oracle(coeffs)
    z = 0xABCDEF
    assert v == polynomial_ops.poly_eval(coeffs, z, r)
    assert kzg.verify_evaluation(srs, C, z, v, W)
    if len(coeffs) <= 1 or not any(c % r for c in coeffs):
        assert W.point == bn.curve.G1.zero()
    if any(c % r for c in coeffs[1:]):
        assert not kzg.verify_evaluation(srs, C, z, (v + 1) % r, W)
        assert not kzg.verify_evaluation(srs, C, z + 1, v, W)


def test_all_equal_coefficients_equal_jax(bn):
    coeffs, C, v, W = _special_run(bn, "all coefficients equal")
    jv, jW = bn.jkzg.create_evaluation_witness(bn.jsrs, coeffs, 0xABCDEF)
    assert (v, _xy(W.point)) == (jv, _xy(jW.point))
    assert _xy(C.point) == _xy(bn.jkzg.commit(bn.jsrs, coeffs).point)


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
