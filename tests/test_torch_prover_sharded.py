"""Groth16.prover_sharded of the port over gloo process groups on the CPU.

For D = 1, 2 and 4 ranks (one group of ranks spawned per D, every check of
it in one rank function, tests/_torch_gloo.py), the proof of
prover_sharded on a power-of-two domain (generate_r1cs_example(r, 61, 2):
m = 64, FourStepDomain) and on the step domain of
tests/test_parallel.py:79-99 (37 constraints: m = 40 = 32 + 8,
ShardedTwoPartDomain) must equal the port's single-device prover's at the
same seed, bit for bit; the port's prover is held against the JAX prover
by tests/test_torch_groth16.py. The verifier accepts each sharded proof of
the four ranks and rejects it for a changed input (the checks dealt out
over those ranks). Without a process group prover_sharded
raises. RUN_SLOW=1 adds the JAX package's own prover_sharded on the
8-device CPU mesh.
"""
import pytest
import torch

from _torch_gloo import proof_coords, run_ranks, sharded_proofs
from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.relations.examples import generate_r1cs_example

# (constraints, key seed, proof seed): a power-of-two domain and a step one
CASES = ((61, 3, 4), (37, 3, 4))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """Per case: the circuit, the keypair and the port's single-device
    proof (host keygen, as in the ranks)."""
    curve = get_curve("alt_bn128")
    out = {}
    for nc, kseed, pseed in CASES:
        cs, primary, aux = generate_r1cs_example(curve.r, nc, 2)
        g = Groth16(curve, device="cpu")
        g.host_keygen = True
        kp = g.generator(cs, seed=kseed)
        out[nc] = dict(g=g, kp=kp, primary=primary, aux=aux,
                       proof=g.prover(kp.pk, primary, aux, seed=pseed))
    return out


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda d: f"D{d}")
def sharded(request, tmp_path_factory):
    D = request.param
    res = run_ranks(sharded_proofs, D, tmp_path_factory.mktemp(f"gloo{D}"),
                    CASES, D == 4)
    return D, res


def test_prover_sharded_equals_prover(sharded, reference):
    D, res = sharded
    for nc, _, _ in CASES:
        want = proof_coords(reference[nc]["proof"])
        for rank in range(D):
            assert res[rank][nc]["proof"] == want, (nc, rank)
    assert res[0][61]["domain"] == ("FourStepDomain", 64)
    assert res[0][37]["domain"] == ("ShardedTwoPartDomain", 40)


    if D == 4:
        verdicts = {}
        for r in res:
            verdicts.update(r["verdicts"])
        assert verdicts == {(nc, what): what == "accepted"
                            for nc, _, _ in CASES
                            for what in ("accepted", "changed-input")}


def test_prover_sharded_needs_a_process_group(reference):
    import torch.distributed as dist
    assert not dist.is_initialized()
    ref = reference[37]
    with pytest.raises(RuntimeError, match="process group"):
        ref["g"].prover_sharded(ref["kp"].pk, ref["primary"], ref["aux"],
                                seed=4)


@pytest.mark.slow
def test_prover_sharded_equals_jax_prover_sharded(reference, tmp_path):
    """The JAX package's prover_sharded on the 8-device CPU mesh (its
    compile takes minutes) gives the port's sharded proof."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from libsnark_tpu import get_curve as jax_get_curve
    from libsnark_tpu.proof_systems.groth16 import Groth16 as JaxGroth16
    from libsnark_tpu.relations.examples import \
        generate_r1cs_example as jax_example
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    jc = jax_get_curve("alt_bn128")
    res = run_ranks(sharded_proofs, 2, tmp_path, CASES)
    for nc, kseed, pseed in CASES:
        cs, primary, aux = jax_example(jc.r, nc, 2)
        g = JaxGroth16(jc)
        g.host_keygen = True
        kp = g.generator(cs, seed=kseed)
        jproof = g.prover_sharded(kp.pk, primary, aux, mesh, "dp",
                                  seed=pseed)
        assert proof_coords(jproof) == res[0][nc]["proof"], nc
