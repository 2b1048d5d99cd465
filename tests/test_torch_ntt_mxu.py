"""The port's digit-matrix NTT (ops/ntt_mxu.py), FpKernel.mul_wide, the
Radix2Domain MXU route and the domains' add_poly_z / domain_elements vs
the JAX package.

The cases of tests/test_ntt_mxu.py: MxDft at logn in {1, 3, 4, 6, 9} for
both operand types, on BW6-761's and MNT4's scalar fields, on all-(p - 1)
inputs and with batch axes, must give the JAX MxDft's limbs on the same
seeded inputs; mul_wide the JAX mul_wide's on random and extreme wide
operands, with broadcast tables. The domain made with mxu=True must give
its radix-2 forms' limbs in every transform the witness map calls, and the
witness map itself the same H. On the CPU both operand types take the same
exact float32 product; they differ only on the card
(tests/test_torch_gpu.py).
"""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libsnark_tpu.curves import get_curve as jax_get_curve
from libsnark_tpu.ops.domains import TwoPartDomain as JaxTwoPart
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.ntt import Radix2Domain as JaxRadix2
from libsnark_tpu.ops.ntt_mxu import MxDft as JaxMxDft

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops.domains import TwoPartDomain
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.limbs import from_torch, to_torch
from libsnark_tpu_torch.ops.ntt import Radix2Domain
from libsnark_tpu_torch.ops.ntt_mxu import MxDft
from libsnark_tpu_torch.reductions.r1cs_to_qap import (qap_domain,
                                                        qap_witness_map)
from libsnark_tpu_torch.relations.examples import generate_r1cs_example


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_FIELDS = {}


def fields(curve: str):
    """(JAX Fr kernel, port Fr kernel on the CPU, params) of a curve."""
    if curve not in _FIELDS:
        jc, tc = jax_get_curve(curve), get_curve(curve)
        _FIELDS[curve] = (JaxFp(jc.fr_params), FpKernel(tc.fr_params, "cpu"),
                          tc.fr_params)
    return _FIELDS[curve]


def both(jfk, xs, shape=None):
    """The same Montgomery limbs for both packages: (jnp array, tensor)."""
    a = np.asarray(jfk.encode(xs))
    if shape is not None:
        a = a.reshape(shape)
    return jnp.asarray(a), to_torch(a, "cpu")


def assert_same(got, want):
    np.testing.assert_array_equal(from_torch(got), np.asarray(want))


@pytest.mark.parametrize("logn", [1, 3, 4, 6, 9])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_mxdft_matches_jax(logn, dtype):
    jfk, fk, params = fields("alt_bn128")
    n = 1 << logn
    rng = random.Random(logn * 7 + len(dtype))
    omega = Radix2Domain(fk, params, logn).omega
    xs = [rng.randrange(params.p) for _ in range(n)]
    ja, ta = both(jfk, xs)
    want = JaxMxDft(jfk, logn, omega, dtype=dtype).apply(ja)
    assert_same(MxDft(fk, logn, omega, dtype=dtype).apply(ta), want)


@pytest.mark.parametrize("curve,logn", [("bw6_761", 4), ("mnt4", 5),
                                        ("bls12_377", 6)])
def test_mxdft_other_scalar_fields(curve, logn):
    """24-limb (BW6-761), 19-limb (MNT4) and BLS12-377's Fr."""
    jfk, fk, params = fields(curve)
    rng = random.Random(len(curve) * 31 + logn)
    omega = Radix2Domain(fk, params, logn).omega
    xs = [rng.randrange(params.p) for _ in range(1 << logn)]
    ja, ta = both(jfk, xs)
    assert_same(MxDft(fk, logn, omega).apply(ta),
                JaxMxDft(jfk, logn, omega).apply(ja))


def test_mxdft_adversarial_max_values():
    """All inputs p - 1: every nibble near its top, the worst column sums
    of the digit products and the widest carries into mul_wide."""
    jfk, fk, params = fields("alt_bn128")
    omega = Radix2Domain(fk, params, 6).omega
    ja, ta = both(jfk, [params.p - 1] * 64)
    assert_same(MxDft(fk, 6, omega).apply(ta),
                JaxMxDft(jfk, 6, omega).apply(ja))


def test_mxdft_batch_dims():
    """Leading batch axes transform independently along the last one."""
    jfk, fk, params = fields("alt_bn128")
    omega = Radix2Domain(fk, params, 5).omega
    rng = random.Random(5)
    xs = [rng.randrange(params.p) for _ in range(3 * 2 * 32)]
    ja, ta = both(jfk, xs, (fk.N, 3, 2, 32))
    got = MxDft(fk, 5, omega).apply(ta)
    assert_same(got, JaxMxDft(jfk, 5, omega).apply(ja))
    one = MxDft(fk, 5, omega).apply(ta[:, 1, 0])
    assert torch.equal(got[:, 1, 0], one)


def _wide(vals, wa):
    return np.array([[(v >> (16 * i)) & 0xFFFF for v in vals]
                     for i in range(wa)], dtype=np.uint32)


@pytest.mark.parametrize("curve", ["alt_bn128", "bw6_761", "mnt4"])
@pytest.mark.parametrize("extra", [2, "2N", 5])
def test_mul_wide_matches_jax(curve, extra):
    """Random wide operands, the all-0xFFFF one and a zero one, against
    the JAX mul_wide and the integers; Wa = N + 2 (the NTT's), 2N and an
    odd N + 5 (a half-word round on the card)."""
    jfk, fk, params = fields(curve)
    p, N = params.p, fk.N
    Wa = 2 * N if extra == "2N" else N + extra
    rng = random.Random(77 + Wa)
    vals = [rng.randrange(1 << (16 * Wa)) for _ in range(5)]
    vals += [(1 << (16 * Wa)) - 1, 0]
    bs = [rng.randrange(p) for _ in vals[:-1]] + [p - 1]
    a = _wide(vals, Wa)
    b = np.asarray(jfk.encode(bs, mont=False))
    want = jfk.mul_wide(jnp.asarray(a), jnp.asarray(b))
    got = fk.mul_wide(to_torch(a, "cpu"), to_torch(b, "cpu"))
    assert_same(got, want)
    rinv = pow(1 << (16 * Wa), -1, p)
    assert fk.decode(got, mont=False) == [
        v * w * rinv % p for v, w in zip(vals, bs)]


def test_mul_wide_broadcast_tables():
    """b broadcasts against a's batch from the right (a twiddle table
    under a batch of subproblems, one constant), and the limb columns
    (more than SMALL_LANES lanes) give the limbs of the integers."""
    from libsnark_tpu_torch.ops import cuda_fp
    jfk, fk, params = fields("alt_bn128")
    N = fk.N
    rng = random.Random(9)
    a = _wide([rng.randrange(1 << (16 * (N + 2))) for _ in range(3 * 16 * 4)],
              N + 2).reshape(N + 2, 3, 16, 4)
    tbl = np.asarray(jfk.encode([rng.randrange(params.p) for _ in range(64)],
                                mont=False)).reshape(N, 16, 4)
    want = jfk.mul_wide(jnp.asarray(a), jnp.asarray(tbl))
    got = fk.mul_wide(to_torch(a, "cpu"), to_torch(tbl, "cpu"))
    assert_same(got, want)
    one = np.asarray(jfk.encode([12345], mont=False)).reshape(N, 1)
    assert_same(fk.mul_wide(to_torch(a, "cpu"), to_torch(one, "cpu")),
                jfk.mul_wide(jnp.asarray(a), jnp.asarray(one)))
    small = cuda_fp.SMALL_LANES
    cuda_fp.SMALL_LANES = 0
    try:
        cols = fk.mul_wide(to_torch(a, "cpu"), to_torch(tbl, "cpu"))
    finally:
        cuda_fp.SMALL_LANES = small
    assert torch.equal(cols, got)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_domain_mxu_route_matches_radix2(dtype):
    """Every transform of a domain made with mxu=True (fft, ifft, the coset
    forms, icoset_fft_divz as one transform) equals the radix-2 form, and
    fft_mxu / ifft_mxu equal the JAX package's."""
    jfk, fk, params = fields("alt_bn128")
    rng = random.Random(99)
    ref = Radix2Domain(fk, params, 7)
    mx = Radix2Domain(fk, params, 7, mxu=True, dtype=dtype)
    ja, ta = both(jfk, [rng.randrange(params.p) for _ in range(2 * 128)],
                  (fk.N, 2, 128))
    for name in ("fft", "ifft", "coset_fft", "icoset_fft",
                 "icoset_fft_divz"):
        assert torch.equal(getattr(mx, name)(ta), getattr(ref, name)(ta)), \
            name
    jd = JaxRadix2(jfk, params, 7)
    assert_same(ref.fft_mxu(ta, dtype), jd.fft_mxu(ja))
    assert_same(ref.ifft_mxu(ta, dtype), jd.ifft_mxu(ja))
    assert torch.equal(mx.ifft(mx.fft(ta)), ta)


def test_witness_map_on_the_mxu_route():
    """qap_witness_map on an mxu=True domain gives the radix-2 domain's H."""
    tc = get_curve("alt_bn128")
    _, fk, params = fields("alt_bn128")
    cs, primary, aux = generate_r1cs_example(tc.r, 60, 2)
    ref = qap_domain(fk, params, cs)
    assert isinstance(ref, Radix2Domain)
    mx = Radix2Domain(fk, params, ref.logm, mxu=True)
    dev = cs.to_device(fk)
    full = fk.encode([1] + primary + aux)
    assert torch.equal(qap_witness_map(dev, mx, full),
                       qap_witness_map(dev, ref, full))


@pytest.mark.parametrize("shape", [(4, -1), (4, 2), (3, 3)])
def test_add_poly_z_and_domain_elements(shape):
    """add_poly_z of Radix2Domain (log1 only) and TwoPartDomain (extended
    and step), and the host domain_elements, against the JAX package's."""
    jfk, fk, params = fields("alt_bn128")
    log1, log2 = shape
    if log2 < 0:
        dom, jdom = (Radix2Domain(fk, params, log1),
                     JaxRadix2(jfk, params, log1))
    else:
        dom, jdom = (TwoPartDomain(fk, params, log1, log2),
                     JaxTwoPart(jfk, params, log1, log2))
    rng = random.Random(sum(shape))
    ja, ta = both(jfk, [rng.randrange(params.p) for _ in range(dom.m + 3)])
    before = ta.clone()
    for coeff in (0, 1, rng.randrange(params.p), params.p - 1):
        got = dom.add_poly_z(coeff, ta)
        assert_same(got, jdom.add_poly_z(coeff, ja))
    assert torch.equal(ta, before)      # a new tensor; the input is kept
    assert dom.domain_elements() == [int(v) for v in
                                     jdom.domain_elements()]
