"""The port's TBCS ppzkSNARK vs the JAX package's, bit for bit: the TBCS
cases of tests/_torch_bacs_tbcs.py (DFGK14 over the TBCS -> USCS
reduction; generate_tbcs_example(g, 2) with 8 gates, a TwoPartDomain of
20, and 13 gates, a Radix2Domain of 32; seeds 99 / 111).
tests/test_torch_bacs_tbcs.py holds the BACS cases. Tolerance: zero.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_bacs_tbcs import (  # noqa: F401  (fixtures and shared tests)
    CASES, _one_thread, curve, jax_case, jax_systems, port_own,
    test_own_generator_keys_equal_jax, test_proof_from_carried_pk_equals_jax,
    test_proof_from_own_generator_equals_jax,
    test_verifier_accepts_and_rejects)

MINE = [c for c in CASES if c[0] == "tbcs"]


@pytest.fixture(scope="module", params=MINE,
                ids=[f"{w}-{k}" for w, k in MINE])
def jax_run(request, jax_systems):
    return jax_case(request.param, jax_systems)
