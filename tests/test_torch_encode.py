"""Host encoding into Montgomery limbs: the port's ``FpKernel.encode`` (the
host reduces mod p and packs limbs; ``to_mont``, one mont_mul launch on the
card or the plain product here, makes the Montgomery form) against the
form it replaced (``int(x) * R % p`` in Python per element) and against the
JAX package's ``FpKernel.encode``, limb for limb, at 16 and 24 limbs, for
Fp and for Fp2 (``Fp2Kernel.encode`` over the same ``FpKernel.encode``).

Values: 0, 1, p - 1, R mod p, p, p + 1, 2p + 5, 2^(16 N) - 1, a negative
value, then seeded random values below p and below 2^(16 N).
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.fp2 import Fp2Kernel as JaxFp2

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.fp2 import Fp2Kernel
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
