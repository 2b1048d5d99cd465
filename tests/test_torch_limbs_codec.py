"""The port's native limb codec (libsnark_tpu_torch/native, built with g++
at first use): ``ops.limbs.ints_to_limbs`` and ``limbs_to_ints`` through it,
and their Python forms, against the JAX package's
``libsnark_tpu.ops.limbs`` at 16 and 24 limbs, in both directions.

Values: 0, 1, p - 1 (alt_bn128 Fq at 16 limbs, BLS12-377 Fq at 24),
2^(16 N) - 1, numpy integers, an empty list and 2^12 seeded values. With
a modulus, the codec reduces negative ints and ints of p or more: held
against x % p at every width (12, 16, 19, 24, 48 limbs).
"""
import importlib.util
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu.ops import limbs as jax_limbs

from libsnark_tpu_torch import get_curve, native
from libsnark_tpu_torch.ops import limbs

# N -> the base field of the curve with that many limbs
MODULI = {16: get_curve("alt_bn128").fq_params.p,
          24: get_curve("bls12_377").fq_params.p}


def _values(N: int) -> list:
    p, top = MODULI[N], (1 << (16 * N)) - 1
    rng = random.Random(N)
    return [0, 1, p - 1, top, np.uint32(7), np.int64(1 << 40),
            np.uint64((1 << 64) - 1)] + [rng.randrange(top + 1)
                                         for _ in range(1 << 12)]


@pytest.mark.parametrize("N", [16, 24])
@pytest.mark.parametrize("encode", [limbs.ints_to_limbs,
                                    limbs._ints_to_limbs_py],
                         ids=["codec", "python"])
def test_ints_to_limbs_equal_the_jax_packages(N, encode):
    xs = _values(N)
    got = encode(xs, N)
    want = jax_limbs.ints_to_limbs(xs, N)
    assert got.dtype == np.uint32 and got.shape == (N, len(xs))
    assert got.flags.c_contiguous and got.flags.writeable
    np.testing.assert_array_equal(got, want)
    assert encode([], N).shape == (N, 0)
    assert encode(iter(xs[:5]), N).tolist() == want[:, :5].tolist()


@pytest.mark.parametrize("N", [16, 24])
@pytest.mark.parametrize("decode", [limbs.limbs_to_ints,
                                    limbs._limbs_to_ints_py],
                         ids=["codec", "python"])
def test_limbs_to_ints_equal_the_jax_packages(N, decode):
    xs = [int(x) for x in _values(N)]
    arr = jax_limbs.ints_to_limbs(xs, N)
    got = decode(arr)
    assert got == jax_limbs.limbs_to_ints(arr) == xs
    assert all(type(v) is int for v in got)
    # the torch side's int32 limbs, and a view that is not contiguous
    assert decode(arr.astype(np.int32)) == xs
    assert decode(np.asfortranarray(arr)[:, ::-1]) == xs[::-1]
    assert decode(np.zeros((N, 0), dtype=np.uint32)) == []


@pytest.mark.parametrize("encode", [limbs.ints_to_limbs,
                                    limbs._ints_to_limbs_py],
                         ids=["codec", "python"])
def test_ints_to_limbs_refuses_what_does_not_fit(encode):
    for bad in (-1, 1 << 256):
        with pytest.raises(OverflowError):
            encode([1, bad], 16)


# every field width of the port -> a curve whose Fq has it (Fr alongside)
WIDTHS = {12: "edwards", 16: "alt_bn128", 19: "mnt4", 24: "bls12_377",
          48: "bw6_761"}


@pytest.mark.parametrize("N", list(WIDTHS))
@pytest.mark.parametrize("encode", [limbs.ints_to_limbs,
                                    limbs._ints_to_limbs_py],
                         ids=["codec", "python"])
def test_ints_to_limbs_reduces_mod_p_where_asked(N, encode):
    """ints_to_limbs(xs, N, p) (and its Python form, the comprehension the
    codec replaced) equals the limbs of x % p (Python's %) for
    negative ints, 0, p - 1, p, 2p + 5 and 2^(16 N) - 1, for numpy
    integers and bools, and for seeded ints on both sides of p, at every
    width and for both fields of the curve that has it (a modulus of
    fewer limbs too); FpKernel.encode takes its limbs from it."""
    from libsnark_tpu_torch.ops.fp import FpKernel
    curve = get_curve(WIDTHS[N])
    top = (1 << (16 * N)) - 1
    rng = random.Random(N)
    for params in (curve.fq_params, curve.fr_params):
        p = params.p
        xs = [-1, -p, -p - 3, -(1 << 70), 0, 1, p - 1, p, p + 1, 2 * p + 5,
              top, (1 << 63) - 1, 1 << 63, -(1 << 63), np.int64(-5),
              np.uint64((1 << 64) - 1), True] + [
            rng.randrange(-top, top + 1) for _ in range(512)]
        got = encode(xs, N, p)
        want = jax_limbs.ints_to_limbs([int(x) % p for x in xs], N)
        assert got.dtype == np.uint32 and got.flags.writeable
        np.testing.assert_array_equal(got, want)
        fk = FpKernel(params, "cpu")
        if fk.N == N:
            enc = fk.encode(xs, mont=False)
            np.testing.assert_array_equal(enc.numpy().astype(np.uint32),
                                          want)
    if encode is limbs.ints_to_limbs:
        with pytest.raises(ValueError, match="positive"):
            encode([1], N, 0)


@pytest.mark.parametrize("cxx", ["no-such-compiler", "false"])
def test_a_failed_build_raises(tmp_path, cxx):
    """No compiler, or one that fails: RuntimeError, no file left."""
    with pytest.raises(RuntimeError, match="limb codec"):
        native.build(tmp_path / "codec.so", cxx=str(tmp_path / cxx)
                     if cxx != "false" else cxx)
    assert not list(tmp_path.iterdir())


def test_builds_at_once_leave_one_whole_library(tmp_path):
    """Builders racing on one path (as test workers do) each compile to a
    file of their own and move it into place: the library that stays
    loads, and no temporary file is left."""
    so = tmp_path / "codec.so"
    with ThreadPoolExecutor(4) as pool:
        done = [f.result(timeout=120) for f in
                [pool.submit(native.build, so) for _ in range(4)]]
    assert done == [so] * 4
    assert sorted(tmp_path.iterdir()) == [so]
    spec = importlib.util.spec_from_file_location("_limbcodec", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.decode(mod.encode([5, 1 << 31], 2), 2, 2) == [5, 1 << 31]
