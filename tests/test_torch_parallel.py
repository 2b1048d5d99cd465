"""The port's multi-device MSM and four-step NTT domains over a gloo group
of four ranks vs the JAX package's on the 8-device CPU mesh of
tests/conftest.py (the cases of tests/test_parallel.py).

The port's sharded_msm (Pippenger) on 64 seeded G1 points and on 61 (a
count no rank count divides: padded with infinity points and zero
scalars, pad_for_mesh) must give the JAX sharded_msm's affine points;
FourStepDomain at 2^6 (fft, ifft, the coset round trip) and
ShardedTwoPartDomain(4, 2) must give the JAX domains' limbs, and the
port's radix-2 domains' (icoset_fft_divz too). The double-and-add method
is held in tests/test_torch_msm_simple.py. One group of four ranks is
spawned for the module (tests/_torch_gloo.py).
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
from libsnark_tpu.parallel.ntt_sharded import FourStepDomain as JaxFourStep
from libsnark_tpu.parallel.ntt_sharded import \
    ShardedTwoPartDomain as JaxShardedTwoPart

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops.domains import TwoPartDomain
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.limbs import to_torch
from libsnark_tpu_torch.ops.ntt import Radix2Domain

D = 4
SIZES = (64, 61)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices()[:8])
    assert len(devs) == 8, "conftest must provide 8 virtual devices"
    return Mesh(devs, ("dp",))


@pytest.fixture(scope="module")
def inputs():
    """Seeded host points and scalars per size, the NTT inputs."""
    bn = jax_get_curve("alt_bn128")
    rng = random.Random(60)
    cases = {}
    for m in SIZES:
        pts = [bn.G1.one() * rng.randrange(1, bn.r) for _ in range(m)]
        cases[m] = (pts, [rng.randrange(bn.r) for _ in range(m)])
    ntt = [rng.randrange(bn.r) for _ in range(64)]
    two = [rng.randrange(bn.r) for _ in range(20)]
    return bn, cases, ntt, two


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    bn, cases, ntt, two = inputs
    ints = {m: ([int(P.x) for P in pts], [int(P.y) for P in pts], sc)
            for m, (pts, sc) in cases.items()}
    return run_ranks(parallel_checks, D, tmp_path_factory.mktemp("gloo"),
                     ints, ("pippenger",), ntt, two)


@pytest.mark.parametrize("m", SIZES)
def test_sharded_msm_matches_jax(inputs, port, mesh, m):
    bn, cases, _, _ = inputs
    pts, scalars = cases[m]
    ck = JaxCurve(JaxFp(bn.fq_params), "G1")
    mk = JaxMSM(ck, bn.r.bit_length())
    P, sc = jax_pad(ck.encode_points(pts, jacobian=False),
                    jnp.asarray(jax_limbs(scalars, 16)), 8)
    with mesh:
        # the program of tests/test_parallel.py (Jacobian out, c = 5, 64
        # lanes), so that either test finds the other's compile cached
        out = jax_sharded_msm(mk, mesh, "dp", P, sc, c=5)
    Q = ck.decode_points(out, bn.G1)[0]
    want = (int(Q.x), int(Q.y))
    host = bn.G1.zero()
    for P, s in zip(pts, scalars):
        host = host + P * s
    assert want == (int(host.x), int(host.y))
    for rank in range(D):
        assert port[rank]["msm"][m, "pippenger"] == [want], rank


def test_four_step_matches_jax(inputs, port, mesh):
    bn, _, vals, _ = inputs
    jfk = JaxFp(bn.fr_params)
    dist = JaxFourStep(jfk, bn.fr_params, 6, mesh, "dp")
    a = jnp.asarray(jfk.encode(vals))
    with mesh:
        f = jax.jit(dist.fft)(a)
        want = [f, jax.jit(dist.ifft)(f),
                dist.icoset_fft(dist.coset_fft(a))]
    got = port[0]["four_step"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the port's own radix-2 domain, icoset_fft_divz too
    tc = get_curve("alt_bn128")
    fk = FpKernel(tc.fr_params, "cpu")
    ref = Radix2Domain(fk, tc.fr_params, 6)
    ta = to_torch(np.asarray(jfk.encode(vals)), "cpu")
    np.testing.assert_array_equal(got[0], ref.fft(ta).numpy())
    np.testing.assert_array_equal(got[3], ref.icoset_fft_divz(ta).numpy())
    for rank in range(1, D):
        for g, w in zip(port[rank]["four_step"], got):
            np.testing.assert_array_equal(g, w)


def test_sharded_two_part_matches_jax(inputs, port, mesh):
    """ShardedTwoPartDomain(4, 2): n1 = 16 < 4 D^2 = 64, so both parts
    stay replicated radix-2, as in the JAX package at its mesh."""
    bn, _, _, vals = inputs
    jfk = JaxFp(bn.fr_params)
    dist = JaxShardedTwoPart(jfk, bn.fr_params, 4, 2, mesh, "dp")
    a = jnp.asarray(jfk.encode(vals))
    with mesh:
        f = dist.fft(a)
        want = [f, dist.ifft(f), dist.icoset_fft(dist.coset_fft(a))]
    for rank in range(D):
        for g, w in zip(port[rank]["two_part"], want):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert port[0]["two_part_kinds"] == ("Radix2Domain", "Radix2Domain")
    np.testing.assert_array_equal(port[0]["two_part"][2],
                                  np.asarray(jfk.encode(vals)))
    tc = get_curve("alt_bn128")
    fk = FpKernel(tc.fr_params, "cpu")
    ref = TwoPartDomain(fk, tc.fr_params, 4, 2)
    np.testing.assert_array_equal(
        port[0]["two_part"][0],
        ref.fft(to_torch(np.asarray(jfk.encode(vals)), "cpu")).numpy())
