"""Port FpKernel / Fp2Kernel vs the JAX package's on its CPU jnp path.

The same seeded inputs (python ints -> numpy limbs) go through both; every
output limb must be equal (tolerance 0: all arithmetic is exact and every
value canonical). On CPU tensors the port's mul runs the plain version of
the mont_mul kernel; the kernel itself is held against that plain version
on the card by tests/test_torch_gpu.py.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.fp2 import Fp2Kernel as JaxFp2

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.fp2 import Fp2Kernel
from libsnark_tpu_torch.ops.limbs import from_torch, ints_to_limbs, to_torch

FIELDS = ["fr", "fq"]
UNARY = {"sqr", "neg", "inv", "to_mont", "from_mont", "double"}
OPS = ["mul", "sqr", "add", "sub", "neg", "double", "inv", "to_mont",
       "from_mont"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kernels():
    jc, tc = jax_get_curve("alt_bn128"), get_curve("alt_bn128")
    out = {}
    for f in FIELDS:
        jp = jc.fr_params if f == "fr" else jc.fq_params
        tp = tc.fr_params if f == "fr" else tc.fq_params
        out[f] = (JaxFp(jp), FpKernel(tp, device="cpu"))
    jq, tq = out["fq"]
    out["fq2"] = (JaxFp2(jq, int(jc.Fq2.NON_RESIDUE)),
                  Fp2Kernel(tq, int(tc.Fq2.NON_RESIDUE)))
    return out


def _ints(p, n, seed, nonzero=False):
    rng = random.Random(seed)
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]
    if nonzero:
        xs = [x or 1 for x in xs]
    return xs


def _jax_op(fk, op):
    if op in UNARY:
        return jax.jit(lambda a: getattr(fk, op)(a))
    return jax.jit(lambda a, b: getattr(fk, op)(a, b))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", FIELDS)
def test_fp_op_matches_jax(kernels, field, op):
    jfk, tfk = kernels[field]
    n = 24
    a = jfk.encode(_ints(jfk.p, n, 1, nonzero=(op == "inv")))
    b = jfk.encode(_ints(jfk.p, n, 2)[::-1])
    if op in UNARY:
        want = _jax_op(jfk, op)(jnp.asarray(a))
        got = getattr(tfk, op)(to_torch(a, "cpu"))
    else:
        want = _jax_op(jfk, op)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(tfk, op)(to_torch(a, "cpu"), to_torch(b, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(from_torch(got), np.asarray(want))


@pytest.mark.parametrize("field", FIELDS)
def test_encode_decode_and_reduce_lazy(kernels, field):
    jfk, tfk = kernels[field]
    xs = _ints(jfk.p, 16, 3)
    np.testing.assert_array_equal(from_torch(tfk.encode(xs)), jfk.encode(xs))
    assert tfk.decode(tfk.encode(xs)) == [x % jfk.p for x in xs]
    # lazy column sums of 8 Montgomery values per lane
    vals = jfk.encode(_ints(jfk.p, 8 * 16, 4)).reshape(jfk.N, 8, 16)
    cols = vals.sum(axis=1, dtype=np.uint32)
    want = jax.jit(jfk.reduce_lazy)(jnp.asarray(cols))
    got = tfk.reduce_lazy(torch.from_numpy(cols.astype(np.int64)))
    np.testing.assert_array_equal(from_torch(got), np.asarray(want))


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg", "inv"])
def test_fp2_op_matches_jax(kernels, op):
    jfk, tfk = kernels["fq2"]
    F2 = get_curve("alt_bn128").Fq2
    p = jfk.fp.p
    n = 12
    c0, c1 = _ints(p, n, 5), _ints(p, n, 6)[::-1]
    xs = [F2(a, b) for a, b in zip(c0, c1)]
    if op == "inv":
        xs = [x if not x.is_zero() else F2.one() for x in xs]
    ys = [F2(a, b) for a, b in zip(_ints(p, n, 7), _ints(p, n, 8))]
    a, b = jfk.encode(xs), jfk.encode(ys)
    if op in ("sqr", "neg", "inv"):
        want = _jax_op(jfk, op)(jnp.asarray(a))
        got = getattr(tfk, op)(to_torch(a, "cpu"))
    else:
        want = _jax_op(jfk, op)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(tfk, op)(to_torch(a, "cpu"), to_torch(b, "cpu"))
    np.testing.assert_array_equal(from_torch(got), np.asarray(want))



@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("curve_name", ["alt_bn128", "bls12_377", "bw6_761",
                                        "mnt4", "mnt6", "edwards"])
def test_small_lane_forms_equal_the_limb_columns(curve_name, op, monkeypatch):
    """Up to SMALL_LANES lanes on the CPU, mul, add and sub take Python
    integers (cuda_fp.mont_mul_ints, lane_ints): the same limbs as the
    limb-column forms, for canonical inputs, inputs in [p, R) and R - 1,
    at 1, 2 and 8 lanes, with a broadcast operand."""
    from libsnark_tpu_torch.ops import cuda_fp
    tc = get_curve(curve_name)
    rng = random.Random(9)
    for params in (tc.fq_params, tc.fr_params):
        fk = FpKernel(params, device="cpu")
        R = 1 << (16 * fk.N)
        for lanes in (1, 2, 8):
            vals = lambda: [rng.choice([rng.randrange(fk.p), rng.randrange(R),
                                        R - 1, 0, fk.p - 1, fk.p])
                            for _ in range(lanes)]
            a = torch.from_numpy(ints_to_limbs(vals(), fk.N).astype(np.int32))
            b = torch.from_numpy(ints_to_limbs(vals(), fk.N).astype(np.int32))
            for x, y in ((a, b), (a, b[:, :1])):
                assert cuda_fp.small_lanes(x, y)
                got = getattr(fk, op)(x, y)
                with monkeypatch.context() as m:
                    m.setattr(cuda_fp, "SMALL_LANES", 0)
                    want = getattr(fk, op)(x, y)
                assert got.dtype == want.dtype == torch.int32
                assert torch.equal(got, want)
