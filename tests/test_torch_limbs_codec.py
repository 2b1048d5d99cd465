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


@pytest.mark.parametrize("p", [(1 << 61) - 1, get_curve("mnt4").r,
                               get_curve("bw6_761").fq_params.p])
def test_native_compact_equals_compact_terms(p):
    """The codec's ``compact`` (R1CSConstraintSystem.compacted's merge)
    against variable.compact_terms on seeded term lists: duplicate
    indices, coefficients of 0, 1, -1, machine words, words whose sums
    pass 2^100, ints of p and above, negative ints, runs that cancel to 0
    mod p, an empty list; rows, indices and coefficients equal."""
    from libsnark_tpu_torch.relations.variable import (
        LinearTerm, compact_terms)
    rng = random.Random(p % 1000)
    picks = [0, 1, -1, p, -p, p - 1, 2 * p + 3, (1 << 63) - 1, -(1 << 63),
             1 << 64, -(1 << 70)]
    lists = [[]]
    for _ in range(300):
        n = rng.randrange(1, 40)
        lists.append([LinearTerm(rng.randrange(12), rng.choice(picks) if
                                 rng.random() < 0.5 else rng.randrange(
                                     -(1 << 300), 1 << 300))
                      for _ in range(n)])
    lists.append([LinearTerm(3, 5), LinearTerm(3, p - 5)])   # cancels
    lists.append([LinearTerm(2, (1 << 63) - 1)] * 4096)      # word overflow
    rows, cols, coeffs = [], [], []
    native.limbcodec().compact(lists, p, rows, cols, coeffs)
    want = ([], [], [])
    for j, terms in enumerate(lists):
        idx, cf = compact_terms(terms, p)
        want[0].extend([j] * len(idx))
        want[1].extend(idx)
        want[2].extend(cf)
    assert (rows, cols, coeffs) == want
    with pytest.raises(ValueError):
        native.limbcodec().compact(lists, 0, [], [], [])


class _ComputedTerm:
    """A term without __slots__ whose coeff is a new int on every read,
    held by no one else."""

    def __init__(self, index, coeff):
        self.index = index
        self._text = str(coeff)

    @property
    def coeff(self):
        return int(self._text)


def test_native_compact_reads_computed_coefficients():
    """``compact`` on terms read through getattr, whose wide coefficients
    no one else keeps alive: the same as compact_terms on their values."""
    from libsnark_tpu_torch.relations.variable import (
        LinearTerm, compact_terms)
    p = get_curve("mnt4").r
    rng = random.Random(7)
    lists = [[_ComputedTerm(rng.randrange(6), rng.randrange(
        -(1 << 400), 1 << 400) if rng.random() < 0.7 else rng.randrange(9))
              for _ in range(rng.randrange(1, 30))] for _ in range(200)]
    rows, cols, coeffs = [], [], []
    native.limbcodec().compact(lists, p, rows, cols, coeffs)
    want = ([], [], [])
    for j, terms in enumerate(lists):
        idx, cf = compact_terms([LinearTerm(t.index, t.coeff)
                                 for t in terms], p)
        want[0].extend([j] * len(idx))
        want[1].extend(idx)
        want[2].extend(cf)
    assert (rows, cols, coeffs) == want


@pytest.mark.parametrize("seed", range(4))
def test_swap_ab_counts_every_term(seed):
    """swap_AB_if_beneficial (the codec's ``mark`` counts the variables
    above the inputs that A and B use) swaps exactly when the set form it
    replaced would: every term counts, a zero coefficient too."""
    from libsnark_tpu_torch.relations.r1cs import R1CSConstraintSystem
    from libsnark_tpu_torch.relations.variable import (
        LinearCombination, LinearTerm)
    rng = random.Random(seed)
    k, aux = 3, 40
    cs = R1CSConstraintSystem(97, k, aux)

    def lc(width):
        out = LinearCombination()
        out.terms = [LinearTerm(rng.randrange(k + aux + 1),
                                rng.choice([0, 1, 5, 96]))
                     for _ in range(rng.randrange(width))]
        return out

    for _ in range(30):
        cs.add_constraint(lc(4 + seed), lc(7 - seed), lc(3))
    a_nz = {t.index for c in cs.constraints for t in c.a.terms if t.index > k}
    b_nz = {t.index for c in cs.constraints for t in c.b.terms if t.index > k}
    before = [(c.a, c.b) for c in cs.constraints]
    assert cs.swap_AB_if_beneficial() == (len(b_nz) > len(a_nz))
    swapped = len(b_nz) > len(a_nz)
    assert [(c.a, c.b) for c in cs.constraints] == (
        [(b, a) for a, b in before] if swapped else before)
