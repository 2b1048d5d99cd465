"""The port's BACS ppzkSNARK vs the JAX package's, bit for bit: the BACS
cases of tests/_torch_bacs_tbcs.py (BCTV14 over the BACS -> R1CS
reduction; generate_bacs_example(r, g, 2) with 8 gates, a TwoPartDomain of
12, and 12 gates, a Radix2Domain of 16; seeds 77 / 88), and the example
generators against the JAX package's. tests/test_torch_tbcs.py holds the
TBCS cases. Tolerance: zero.
"""
import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu.relations import examples as jax_examples

from libsnark_tpu_torch.relations import examples

from _torch_bacs_tbcs import (  # noqa: F401  (fixtures and shared tests)
    CASES, _one_thread, curve, jax_case, jax_systems, port_own,
    test_own_generator_keys_equal_jax, test_proof_from_carried_pk_equals_jax,
    test_proof_from_own_generator_equals_jax,
    test_verifier_accepts_and_rejects)

MINE = [c for c in CASES if c[0] == "bacs"]


@pytest.fixture(scope="module", params=MINE,
                ids=[f"{w}-{k}" for w, k in MINE])
def jax_run(request, jax_systems):
    return jax_case(request.param, jax_systems)


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
