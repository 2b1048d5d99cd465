"""The port's double-and-add MSM (MSMKernel.msm_simple) and the sharded
MSM's "simple" method vs the JAX package's.

msm_simple on 16 seeded G1 points must give the JAX msm_simple's Jacobian
limbs (the same dbl, madd and add sequence); over a gloo group of two
ranks (tests/_torch_gloo.py, one group for the module) the port's
sharded_msm(method="simple") on 64 points and on 61 (padded) must give the
JAX sharded_msm's affine point on the 8-device CPU mesh, and the
Pippenger method's.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from _torch_gloo import parallel_checks, run_ranks
from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.ec import CurveKernel as JaxCurve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.limbs import ints_to_limbs as jax_limbs
from libsnark_tpu.ops.msm import MSMKernel as JaxMSM
from libsnark_tpu.parallel.msm_sharded import pad_for_mesh as jax_pad
from libsnark_tpu.parallel.msm_sharded import sharded_msm as jax_sharded_msm

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops.limbs import from_torch, to_torch
from libsnark_tpu_torch.proof_systems.groth16 import Groth16

D = 2
SIZES = (64, 61)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    bn = jax_get_curve("alt_bn128")
    ck = JaxCurve(JaxFp(bn.fq_params), "G1")
    return bn, ck, JaxMSM(ck, bn.r.bit_length())


@pytest.fixture(scope="module")
def inputs(jax_side):
    bn = jax_side[0]
    rng = random.Random(61)
    out = {}
    for m in SIZES + (16,):
        pts = [bn.G1.one() * rng.randrange(1, bn.r) for _ in range(m)]
        out[m] = (pts, [rng.randrange(bn.r) for _ in range(m)])
    return out


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    ints = {m: ([int(P.x) for P in pts], [int(P.y) for P in pts], sc)
            for m, (pts, sc) in inputs.items() if m in SIZES}
    return run_ranks(parallel_checks, D, tmp_path_factory.mktemp("gloo"),
                     ints, ("simple", "pippenger"))


def test_msm_simple_matches_jax(jax_side, inputs):
    bn, ck, mk = jax_side
    pts, scalars = inputs[16]
    P = ck.encode_points(pts, jacobian=False)
    sc = jax_limbs(scalars, 16)
    want = mk.msm_simple(P, jnp.asarray(sc))
    g = Groth16(get_curve("alt_bn128"), device="cpu")
    tP = tuple(to_torch(np.asarray(a), "cpu") if a.dtype != bool
               else torch.from_numpy(np.array(a)) for a in P)
    got = g.msm_g1.msm_simple(tP, to_torch(sc, "cpu"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(from_torch(a), np.asarray(b))


@pytest.mark.parametrize("m", SIZES)
def test_sharded_simple_matches_jax(jax_side, inputs, port, m):
    bn, ck, mk = jax_side
    pts, scalars = inputs[m]
    P, sc = jax_pad(ck.encode_points(pts, jacobian=False),
                    jnp.asarray(jax_limbs(scalars, 16)), 8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    with mesh:
        out = jax_sharded_msm(mk, mesh, "dp", P, sc, c=5, method="simple")
    Q = ck.decode_points(out, bn.G1)[0]
    want = [(int(Q.x), int(Q.y))]
    for rank in range(D):
        assert port[rank]["msm"][m, "simple"] == want, rank
        assert port[rank]["msm"][m, "pippenger"] == want, rank
