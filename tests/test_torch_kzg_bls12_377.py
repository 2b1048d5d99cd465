"""The port's KZG10 against the JAX package's over BLS12-377 (degree 9) on
the CPU: the checks of tests/_torch_kzg.py (the SRS limbs and points, one
commitment and opening, each package's verifier on the other's output).
tests/test_torch_kzg.py runs them over alt_bn128. Tolerance: zero.
"""
import pytest
import torch  # noqa: F401

from _torch_kzg import (  # noqa: F401  (fixtures and shared tests)
    _one_thread, _pair, _to, _xy, test_commitment_equals_jax_and_the_host_oracle,
    test_jax_verifier_accepts_the_port_output,
    test_port_accepts_jax_output_under_the_carried_srs,
    test_port_verifier_accepts_and_rejects,
    test_srs_limbs_equal_jax, test_srs_points_are_the_powers_of_alpha,
    test_witness_and_evaluation_equal_jax)


@pytest.fixture(scope="module", params=["bls12_377"])
def pair(request):
    return _pair(request.param)
