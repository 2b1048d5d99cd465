"""Host encoding into Montgomery limbs: the port's ``FpKernel.encode`` (the
host reduces mod p and packs limbs; ``to_mont``, one mont_mul launch on the
card or the plain product here, makes the Montgomery form) against the
form it replaced (``int(x) * R % p`` in Python per element) and against the
JAX package's ``FpKernel.encode``, limb for limb, at 16 and 24 limbs, for
Fp and for Fp2 (``Fp2Kernel.encode`` over the same ``FpKernel.encode``).

Values: 0, 1, p - 1, R mod p, p, p + 1, 2p + 5, 2^(16 N) - 1, a negative
value, then seeded random values below p and below 2^(16 N).

The public helpers beside ``encode``, each against the JAX package's:
``FpKernel.encode_scalar`` (one element's limbs, Montgomery form or not),
``eq`` on Fp, Fp2 and Fp3 (batch-shaped bool, planted equal and unequal
lanes), and ``PairingSystem.encode_host_points_g1`` / ``_g2`` (affine
limbs and the infinity mask of seeded host points and infinity; G2 over
Fq2 and over Fq3). Tolerance: zero.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.fp2 import Fp2Kernel as JaxFp2
from libsnark_tpu.ops.fp3 import Fp3Kernel as JaxFp3
from libsnark_tpu.proof_systems.base import PairingSystem as JaxPairingSystem

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.fp2 import Fp2Kernel
from libsnark_tpu_torch.ops.fp3 import Fp3Kernel
from libsnark_tpu_torch.proof_systems.base import PairingSystem
from libsnark_tpu_torch.ops.limbs import from_torch, ints_to_limbs

# (curve, field): Fq of alt_bn128 has 16 limbs, Fq of BLS12-377 24
FIELDS = [("alt_bn128", "fq"), ("alt_bn128", "fr"), ("bls12_377", "fq"),
          ("bls12_377", "fr")]


def _values(p: int, N: int, seed: int, n: int = 200):
    rng = random.Random(seed)
    R = 1 << (16 * N)
    edges = [0, 1, p - 1, R % p, p, p + 1, 2 * p + 5, R - 1, -3]
    return edges + [rng.randrange(p) for _ in range(n // 2)] + [
        rng.randrange(R) for _ in range(n // 2)]


def _python_form(p: int, N: int, xs):
    """The encoding the port replaced: Montgomery form per element on the
    host."""
    R = 1 << (16 * N)
    return ints_to_limbs([int(x) * R % p for x in xs], N)


def _kernels(curve: str, field: str):
    jc, tc = jax_get_curve(curve), get_curve(curve)
    jp = getattr(jc, f"{field}_params")
    tp = getattr(tc, f"{field}_params")
    return jc, tc, JaxFp(jp), FpKernel(tp, device="cpu")


@pytest.mark.parametrize("curve,field", FIELDS)
def test_fp_encode_matches_python_form_and_jax(curve, field):
    _, _, jfk, tfk = _kernels(curve, field)
    xs = _values(tfk.p, tfk.N, seed=tfk.N)
    got = from_torch(tfk.encode(xs))
    np.testing.assert_array_equal(got, _python_form(tfk.p, tfk.N, xs))
    np.testing.assert_array_equal(got, np.asarray(jfk.encode(xs)))
    plain = from_torch(tfk.encode(xs, mont=False))
    np.testing.assert_array_equal(plain, np.asarray(jfk.encode(xs,
                                                               mont=False)))
    assert tfk.decode(tfk.encode(xs)) == [x % tfk.p for x in xs]


@pytest.mark.parametrize("curve", ["alt_bn128", "bls12_377"])
def test_fp2_encode_matches_python_form_and_jax(curve):
    jc, tc, jfq, tfq = _kernels(curve, "fq")
    jfk = JaxFp2(jfq, int(jc.Fq2.NON_RESIDUE))
    tfk = Fp2Kernel(tfq, int(tc.Fq2.NON_RESIDUE))
    c0 = _values(tfq.p, tfq.N, seed=1, n=60)
    c1 = _values(tfq.p, tfq.N, seed=2, n=60)[::-1]
    xs = [tc.Fq2(a % tfq.p, b % tfq.p) for a, b in zip(c0, c1)]
    got = from_torch(tfk.encode(xs))
    want = np.stack([_python_form(tfq.p, tfq.N, [int(x.c0) for x in xs]),
                     _python_form(tfq.p, tfq.N, [int(x.c1) for x in xs])])
    np.testing.assert_array_equal(got, want)
    jxs = [jc.Fq2(int(x.c0), int(x.c1)) for x in xs]
    np.testing.assert_array_equal(got, np.asarray(jfk.encode(jxs)))


def test_encode_of_nothing():
    _, _, _, tfk = _kernels("alt_bn128", "fr")
    assert tuple(tfk.encode([]).shape) == (tfk.N, 0)


# ------------------------------------------------------- public helpers

@pytest.mark.parametrize("curve,field", FIELDS + [("mnt4", "fq"),
                                                  ("edwards", "fq")])
@pytest.mark.parametrize("mont", [True, False])
def test_encode_scalar_matches_encode_and_jax(curve, field, mont):
    jc, tc, _, tfk = _kernels(curve, field)
    jfk = JaxFp(getattr(jc, f"{field}_params"))
    rng = np.random.default_rng(tfk.N)
    xs = [0, 1, tfk.p - 1] + [
        int.from_bytes(rng.bytes(2 * tfk.N), "little") % tfk.p
        for _ in range(8)]
    lanes = from_torch(tfk.encode(xs, mont=mont))
    for i, x in enumerate(xs):
        got = tfk.encode_scalar(x, mont=mont)
        assert got.shape == (tfk.N,) and got.dtype == torch.int32
        np.testing.assert_array_equal(from_torch(got), lanes[:, i])
        np.testing.assert_array_equal(
            from_torch(got), np.asarray(jfk.encode_scalar(x, mont=mont)))


def _random_field(p: int, n: int, rng):
    return [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]


def _planted_pairs(p: int, deg: int, n: int, seed: int):
    """(a, b, expected eq) with deg coefficient lists of n lanes: lane i of
    b equals a's except in coefficient i % (deg + 1) (none when that is
    deg), and lanes whose changed coefficient lands on the same value."""
    rng = np.random.default_rng(seed)
    a = [_random_field(p, n, rng) for _ in range(deg)]
    b = [list(c) for c in a]
    want = []
    for i in range(n):
        k = i % (deg + 1)
        if k < deg:
            b[k][i] = (b[k][i] + 1 + i) % p
        want.append(k == deg)
    return a, b, np.array(want)


@pytest.mark.parametrize("curve,deg", [("alt_bn128", 1), ("bls12_377", 1),
                                       ("alt_bn128", 2), ("mnt6", 3),
                                       ("edwards", 3)])
def test_eq_matches_jax(curve, deg):
    """FpKernel.eq, Fp2Kernel.eq and Fp3Kernel.eq on the same limbs as the
    JAX package's: equal lanes and lanes that differ in one coefficient."""
    jc, tc, jfq, tfq = _kernels(curve, "fq")
    if deg == 1:
        tfk, jfk = tfq, jfq
    elif deg == 2:
        tfk = Fp2Kernel(tfq, int(tc.Fq2.NON_RESIDUE))
        jfk = JaxFp2(jfq, int(jc.Fq2.NON_RESIDUE))
    else:
        tfk = Fp3Kernel(tfq, int(tc.Fq3.NON_RESIDUE))
        jfk = JaxFp3(jfq, int(jc.Fq3.NON_RESIDUE))
    a, b, want = _planted_pairs(tfq.p, deg, 24, seed=deg)

    def limbs(cs):
        arr = np.stack([tfq.encode(c).numpy() for c in cs])
        return arr[0] if deg == 1 else arr
    got = tfk.eq(torch.from_numpy(limbs(a)), torch.from_numpy(limbs(b)))
    assert got.dtype == torch.bool and tuple(got.shape) == (24,)
    np.testing.assert_array_equal(got.numpy(), want)
    jgot = jfk.eq(limbs(a).astype(np.uint32), limbs(b).astype(np.uint32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


@pytest.mark.parametrize("curve", ["alt_bn128", "mnt6"])
def test_encode_host_points_matches_jax(curve):
    """encode_host_points_g1 / _g2 on seeded multiples of the generators and
    infinity: the same affine limbs and mask as the JAX package's, on the
    system's device."""
    jc, tc = jax_get_curve(curve), get_curve(curve)
    ps = PairingSystem(tc, device="cpu")
    jps = JaxPairingSystem(jc)
    rng = np.random.default_rng(5)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=5)]
    for enc, G, jG in (("encode_host_points_g1", tc.G1, jc.G1),
                       ("encode_host_points_g2", tc.G2, jc.G2)):
        pts = [G.one() * k for k in ks] + [G.zero()]
        jpts = [jG.one() * k for k in ks] + [jG.zero()]
        got = getattr(ps, enc)(pts)
        want = getattr(jps, enc)(jpts)
        assert all(t.device.type == "cpu" for t in got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                g.numpy().astype(np.int64), np.asarray(w).astype(np.int64),
                err_msg=f"{curve} {enc}")
