"""The plain versions of the port's probe kernels (libsnark_tpu_torch/
probes.py) against Python integer arithmetic and numpy, exactly. The
kernels are held against these plain versions on the card
(tests/test_torch_gpu.py, scripts/probe_h100.py, chip_smoke.py); on CPU
tensors the wrappers run the plain versions.

The eleven layout probes are checked against numpy (``np.transpose``,
``np.roll``, slices, ``np.where``) at the shapes of the TPU scripts they
replace (scripts/probe_mosaic_dma.py, scripts/probe_mosaic_ops.py; those
run at import and are not imported here) and in the cases those scripts'
``arange`` inputs never reach.
"""
import random
import struct

import numpy as np
import pytest
import torch

from libsnark_tpu_torch import get_curve, probes
from libsnark_tpu_torch.ops import cuda_lib
from libsnark_tpu_torch.ops.fp import FpKernel

M32 = 0xFFFFFFFF


M64 = (1 << 64) - 1


def _step(op, x, hi, y):
    """One step of a chain on Python ints (x, hi: the 64-bit ops' halves)."""
    if op == "mul_lo":
        return (x * y) & M32, 0
    if op == "mad_lo":
        return (x * y + y) & M32, 0
    if op == "mad_hi":
        return (((x * y) >> 32) + y) & M32, 0
    if op == "mad_wide_split":
        w = (x * y + ((hi << 32) | x)) & M64   # w = lo(w)*y + w
        return w & M32, w >> 32
    if op == "add64":
        w = (((hi << 32) | x) + ((y << 32) | y)) & M64
        return w & M32, w >> 32
    if op == "shift_and":
        return ((x >> 1) & y) ^ y, 0
    raise AssertionError(op)


def _thread(op, xs, ys, K):
    """The CHAINS final values of one thread, on Python ints. mad_wide:
    w[c] = lo(w[c ^ 1]) y[c] + w[c], chains in order (an even chain reads
    its partner's old w, an odd one the new). mad_cc: the chains are the
    64-bit limbs of one 512-bit number that gains sum_c x[c] y[c] 2^(64 c)
    a step (the carry out of the top dropped), so K steps add K times that
    product: a closed form the kernel's step-by-step carry chain must
    meet."""
    if op == "mad_wide":
        w = list(xs)
        for _ in range(K):
            for c in range(len(w)):
                w[c] = ((w[c ^ 1] & M32) * ys[c] + w[c]) & M64
        return [(v & M32) ^ (v >> 32) for v in w]
    if op == "mad_cc":
        acc = sum(x << (64 * c) for c, x in enumerate(xs))
        step = sum((x * y) << (64 * c) for c, (x, y) in enumerate(zip(xs, ys)))
        acc = (acc + K * step) % (1 << (64 * len(xs)))
        w = [(acc >> (64 * c)) & M64 for c in range(len(xs))]
        return [(v & M32) ^ (v >> 32) for v in w]
    out = []
    for x, y in zip(xs, ys):
        hi = 0
        for _ in range(K):
            x, hi = _step(op, x, hi, y)
        out.append(x ^ hi if op in ("mad_wide_split", "add64") else x)
    return out


def _bits(v):
    return v - (1 << 32) if v >= 1 << 31 else v


@pytest.mark.parametrize("op", [o for o in probes.RATE_OPS if o != "mul_f32"])
def test_rate_chain_plain_matches_python_ints(op):
    """Every integer chain, the three wide multiply-add forms among them
    (mad_wide's pairs, mad_wide_split's own low word, mad_cc's carry chain
    over the 8 chains), against Python integers."""
    rng = random.Random(1)
    T, K = 5, 9
    edge = [0, 1, M32, 1 << 31, 0xFFFF0001]
    xs = [[rng.choice(edge + [rng.getrandbits(32)]) for _ in range(T)]
          for _ in range(probes.CHAINS)]
    ys = [[rng.choice(edge + [rng.getrandbits(32)]) for _ in range(T)]
          for _ in range(probes.CHAINS)]
    if op == "mad_cc":                  # carries that ripple through all 8
        for c in range(probes.CHAINS):
            xs[c][0], ys[c][0] = M32, M32
    cols = [_thread(op, [r[t] for r in xs], [r[t] for r in ys], K)
            for t in range(T)]
    want = [[_bits(cols[t][c]) for t in range(T)]
            for c in range(probes.CHAINS)]
    a = torch.tensor([[_bits(v) for v in r] for r in xs], dtype=torch.int32)
    b = torch.tensor([[_bits(v) for v in r] for r in ys], dtype=torch.int32)
    got = probes.rate_chain(op, a, b, K)          # CPU tensors: plain version
    assert got.dtype == torch.int32
    assert got.tolist() == want


def test_rate_chain_f32_is_a_plain_product_chain():
    a = torch.full((probes.CHAINS, 3), 1.25)
    b = torch.full((probes.CHAINS, 3), 1.0 + 2.0 ** -12)
    got = probes.rate_chain("mul_f32", a, b, 5)
    x = 1.25
    for _ in range(5):
        x = struct.unpack("f", struct.pack("f", x * (1.0 + 2.0 ** -12)))[0]
    assert got.dtype == torch.float32 and float(got[0, 0]) == x


@pytest.mark.parametrize("curve_name,field", [("alt_bn128", "fq"),
                                              ("bls12_377", "fq")])
def test_cios_chain_plain_matches_python_ints(curve_name, field):
    curve = get_curve(curve_name)
    fk = FpKernel(getattr(curve, f"{field}_params"), device="cpu")
    rng = random.Random(2)
    xs = [0, 1, fk.p - 1] + [rng.randrange(fk.p) for _ in range(5)]
    ys = [rng.randrange(fk.p) for _ in range(8)]
    K = 3
    a, b = fk.encode(xs, mont=False), fk.encode(ys, mont=False)
    rinv = pow(fk.params.R, -1, fk.p)
    want = [x * pow(y * rinv, K, fk.p) % fk.p for x, y in zip(xs, ys)]
    for variant in probes.CIOS_VARIANTS:          # CPU: one plain version
        got = probes.cios_chain(fk, variant, a, b, K)
        assert fk.decode(got, mont=False) == want


def test_probe_wrappers_check_their_arguments():
    fk = FpKernel(get_curve("alt_bn128").fq_params, device="cpu")
    a = torch.zeros((probes.CHAINS, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown rate op"):
        probes.rate_chain("div", a, a, 1)
    with pytest.raises(ValueError, match="takes two"):
        probes.rate_chain("mul_lo", a[:3], a[:3], 1)
    with pytest.raises(ValueError, match="takes two"):
        probes.rate_chain("mul_f32", a, a, 1)
    x = fk.encode([1, 2])
    with pytest.raises(ValueError, match="unknown CIOS variant"):
        probes.cios_chain(fk, "fios", x, x, 1)
    with pytest.raises(ValueError, match="limb tensors"):
        probes.cios_chain(fk, "cios", x[:8], x[:8], 1)


def test_main_loop_counts_the_longest_backward_branch():
    """The listing reader behind ``sass_loops``: the loop is the span of the
    longest backward branch; predicates and encodings are skipped."""
    sass = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x0a */
        /*0010*/                   IMAD.WIDE.U32 R2, R2, R4, R2 ;  /* 0x0b */
        /*0020*/                   IMAD.WIDE.U32 R6, R6, R4, R6 ;
        /*0030*/                   IADD3 R9, R9, 0x1, RZ ;
        /*0040*/             @!P0  BRA 0x10 ;
        /*0050*/                   SHF.R.U32.HI R3, RZ, 0x1, R3 ;
        /*0060*/              @P1  BRA 0x50 ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
    """
    assert probes.loop_counts(probes.main_loop(sass)) == \
        {"IMAD.WIDE.U32": 2, "IADD3": 1, "BRA": 1}
    assert probes.main_loop("/*0000*/ EXIT ;") == []
    assert probes._kernel_label("_Z11rate_kernelILi3EEvPKjS1_Pjli") \
        == "probe_rate_mad_wide"
    assert probes._kernel_label("_Z11rate_kernelILi7EEvPKjS1_Pjli") \
        == "probe_rate_mad_wide_split"
    assert probes._kernel_label("_Z11rate_kernelILi8EEvPKjS1_Pjli") \
        == "probe_rate_mad_cc"
    assert probes._kernel_label("_Z11cios_kernelILi12ELi1EEvPKiS1_Pili") \
        == "probe_cios_sos_n24"


def _wide_loop(extra: str) -> str:
    """A main loop of CHAINS x RATE_UNROLL IMAD.WIDE.U32 steps with the
    loop's own counter step (a uniform register), compare and branch, as
    ptxas lays out mad_wide, and ``extra`` inside."""
    n = probes.CHAINS * probes.RATE_UNROLL
    lines = [f"/*{0x500 + 16 * i:04x}*/  IMAD.WIDE.U32 R{2 * i}, R40, R41, "
             f"R{2 * i} ;" for i in range(n)]
    lines += [f"/*{0x500 + 16 * n:04x}*/  UIADD3 UR4, UR4, -0x4, URZ ;",
              f"/*{0x510 + 16 * n:04x}*/  {extra}",
              f"/*{0x520 + 16 * n:04x}*/  ISETP.NE.AND P0, PT, RZ, UR4, PT ;",
              f"/*{0x530 + 16 * n:04x}*/  @P0 BRA 0x500 ;",
              f"/*{0x540 + 16 * n:04x}*/  EXIT ;"]
    return "\n".join(lines)


@pytest.mark.parametrize("extra,one_a_step", [
    ("NOP ;", False),
    ("IADD3 R0, P0, R32, R0, RZ ;", False),
    ("IADD3.X R1, R33, R1, RZ, P0, !PT ;", False),
    ("IADD3 R2, R2, 0x1, RZ ;", False),     # an immediate into a chain
    ("VIADD R44, R44, 0xfffffffc ;", False),  # a counter no compare reads
    ("UIADD3 UR4, UR4, 0x4, URZ ;", True),  # a second step of the counter
    ("BRA 0x500 ;", True)])
def test_single_wide_mad_loop_check(extra, one_a_step):
    """The check chip_smoke.py holds mad_wide's listing to: one
    IMAD.WIDE.U32 a step and nothing else once the loop's own control (its
    branches, compares and the steps of the register its compare reads) is
    left out; any other add beside it fails, an add of an immediate to a
    chain's register among them."""
    loop = probes.main_loop(_wide_loop(extra))
    full = probes.loop_counts(loop)
    steps = probes.loop_counts(loop, control=False)
    assert full["IMAD.WIDE.U32"] == probes.CHAINS * probes.RATE_UNROLL
    assert full["UIADD3"] >= 1 and full["ISETP.NE.AND"] == 1
    assert "UIADD3" not in steps and "ISETP.NE.AND" not in steps
    assert probes.single_wide_mad_loop(steps) is one_a_step
    fewer = _wide_loop(extra).replace("IMAD.WIDE.U32 R0,", "IMAD.U32 R0,", 1)
    assert not probes.single_wide_mad_loop(
        probes.loop_counts(probes.main_loop(fewer), control=False))


# ------------------------------------------------------------ layout probes

def _ar(*shape):
    """The TPU scripts' input: arange over the shape, as 32-bit words."""
    return np.arange(int(np.prod(shape)), dtype=np.uint32).reshape(shape)


def _rnd(seed, *shape):
    return np.random.default_rng(seed).integers(
        0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy uint32 words -> the int32 bit patterns the port carries."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _n(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("width,into3d", [(32, False), (128, False),
                                          (32, True), (128, True),
                                          (64, False)])
def test_row_copy_at_the_tpu_cases(width, into3d):
    x = _ar(1024, width)
    got = probes.row_copy(_t(x), 40, 16, into3d=into3d)
    assert got.dtype == torch.int32 and got.shape == (1, 16, width)
    np.testing.assert_array_equal(_n(got)[0], x[40:56])


def test_row_copy_segments_and_bounds():
    x = _rnd(1, 300, 24)                # a G1 row at 24 limbs: 2 x 12 words
    seg = torch.tensor([0, 250, 7, 7, 283], dtype=torch.int64)
    got = _n(probes.row_copy(_t(x), 1, 16, seg))
    for b, o in enumerate(seg.tolist()):
        np.testing.assert_array_equal(got[b], x[1 + o:17 + o])
    for s, R, sg in ((285, 16, None), (-1, 16, None), (1, 16, seg + 1),
                     (0, 16, torch.tensor([-1]))):
        with pytest.raises(ValueError, match="leaves the array"):
            probes.row_copy(_t(x), s, R, sg)
    with pytest.raises(ValueError, match="shared memory"):
        probes.row_copy(_t(_ar(64, 1024)), 0, 16)
    with pytest.raises(ValueError, match="1-D int64"):
        probes.row_copy(_t(x), 0, 16, seg.to(torch.int32))
    with pytest.raises(ValueError, match="2-D int32"):
        probes.row_copy(torch.zeros((4, 4), dtype=torch.int64), 0, 1)


@pytest.mark.parametrize("x", [_ar(128, 8, 32), _rnd(2, 70, 3, 45)],
                         ids=["tpu (128,8,32)", "ragged (70,3,45)"])
def test_transpose_plain_matches_numpy(x):
    got = probes.transpose3d(_t(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(_n(got), np.transpose(x, (2, 1, 0)))


@pytest.mark.parametrize("name,shape,out", [
    ("reshape_merge_minor", (16, 16, 8), (16, 128)),
    ("reshape_merge_major", (16, 2, 128), (32, 128)),
    ("squeeze", (16, 1, 128), (16, 128)),
    ("reshape_merge_minor", (5, 7, 3), (5, 21)),
    ("reshape_merge_major", (5, 7, 3), (35, 3))])
def test_reshapes_plain_match_numpy(name, shape, out):
    x = _ar(*shape) if shape[0] == 16 else _rnd(3, *shape)
    got = probes.reshape3d(name, _t(x))
    assert tuple(got.shape) == out
    np.testing.assert_array_equal(_n(got), x.reshape(out))


def test_reshape_argument_checks():
    with pytest.raises(ValueError, match="middle axis of length 1"):
        probes.reshape3d("squeeze", _t(_ar(4, 2, 8)))
    with pytest.raises(ValueError, match="unknown reshape"):
        probes.reshape3d("flatten", _t(_ar(4, 2, 8)))


def test_div_magic_divides_every_31_bit_numerator():
    """The reshape kernel's division, (n m) >> s with probes.div_magic's
    (m, s), is n // d for divisors of every size and for numerators at the
    edges of each quotient up to 2^31 - 1."""
    rng = random.Random(5)
    ds = set(range(1, 300)) | {1 << k for k in range(31)}
    ds |= {(1 << k) + e for k in range(2, 31) for e in (-1, 1)}
    ds |= {rng.randrange(1, 1 << 31) for _ in range(300)}
    ds = sorted(d for d in ds if 1 <= d < 1 << 31)
    top = (1 << 31) - 1
    for d in ds:
        m, sh = probes.div_magic(d)
        assert m < 1 << 32 and 31 <= sh <= 62
        q_top = top // d
        ns = {0, 1, d - 1, d, d + 1, top, q_top * d, q_top * d - 1,
              2 * d - 1} | {rng.randrange(1 << 31) for _ in range(40)}
        for n in ns:
            if 0 <= n <= top:
                assert (n * m) >> sh == n // d, (n, d)
    for bad in (0, -1, 1 << 31):
        with pytest.raises(ValueError, match="divisor"):
            probes.div_magic(bad)


@pytest.mark.parametrize("shape", [(16, 16, 2), (16, 2, 32), (16, 1, 32),
                                   (5, 7, 3), (37, 1, 11), (3, 65537, 5)])
def test_reshape_index_arithmetic_model(shape):
    """The kernel's decomposition of a piece number t by magic division
    (row = t / C, k, i = row / Bm, j) gives the source's (i, j, k) for
    every t of the shape, in 32-bit values."""
    A, B, C = shape
    t = np.arange(A * B * C, dtype=np.uint64)
    mC, sC = probes.div_magic(C)
    mB, sB = probes.div_magic(B)
    row = (t * np.uint64(mC)) >> np.uint64(sC)
    k = t - row * np.uint64(C)
    i = (row * np.uint64(mB)) >> np.uint64(sB)
    j = row - i * np.uint64(B)
    wi, wj, wk = np.unravel_index(t.astype(np.int64), shape)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_array_equal(j, wj)
    np.testing.assert_array_equal(k, wk)


@pytest.mark.parametrize("s", [40, 0, 1, 127, 128, 300, -1, -40, -129])
def test_roll_minor_plain_matches_numpy(s):
    x = _ar(16, 128)
    np.testing.assert_array_equal(_n(probes.roll_minor(_t(x), s)),
                                  np.roll(x, s, axis=1))
    # the definition the kernel is written to: out[i, j] = x[i, (j - s) mod n]
    j = np.arange(128)
    np.testing.assert_array_equal(np.roll(x, s, axis=1), x[:, (j - s) % 128])


@pytest.mark.parametrize("s", [3, 0, 7, 8, 11, -1, -3, -9])
def test_roll_middle_plain_matches_numpy(s):
    x = _ar(16, 8, 128)
    np.testing.assert_array_equal(_n(probes.roll_middle(_t(x), s)),
                                  np.roll(x, s, axis=1))


def test_roll_argument_checks():
    with pytest.raises(ValueError, match="middle axis of 8"):
        probes.roll_middle(_t(_ar(2, 4, 8)), 1)
    with pytest.raises(ValueError, match="fit 32 bits"):
        probes.roll_minor(_t(_ar(2, 8)), 1 << 31)


def _cond_inputs():
    x = _ar(16, 128)
    low = x % 8
    last = low.copy()
    last[15, 127] = 8
    top = low.copy()
    top[7, 5] = 0xFFFFFFFF
    wrap = x.copy()
    wrap[0, 0] = 0xFFFFFFFF
    return {"arange: first branch": x, "no word above 7": low,
            "only the last word above 7": last,
            "one word with the top bit set": top,
            "x + 1 wraps": wrap}


@pytest.mark.parametrize("label", list(_cond_inputs()))
def test_cond_plain_matches_numpy(label):
    x = _cond_inputs()[label]
    want = np.where((x > 7).any(), x + np.uint32(1), x)
    np.testing.assert_array_equal(_n(probes.cond_add_one(_t(x))), want)
    assert (want != x).any() == (label != "no word above 7")


@pytest.mark.parametrize("shape,where", [
    ((1, 1), None), ((1, 1), (0, 0)), ((13, 127), (12, 126)),
    ((1, 4099), (0, 4098)), ((9, 700), (8, 699)), ((9, 700), None),
    ((1, 4355), (0, 4354)), ((3, 1), (1, 0))])
def test_cond_plain_at_the_kernels_splits(shape, where):
    """The sizes where the kernel's paths part: one word; a tile that is no
    multiple of 4 words (1651: 3 words past the last 16-byte piece); more
    words than its registers hold (4096, and 256 more a word a thread), so
    that the last ones are read in its loop. ``where``: the one word above
    7, with its top bit set (else every word is 7 or less)."""
    x = _rnd(30 + shape[1], *shape) % 8
    if where is not None:
        x[where] = 0x80000008
    want = x + np.uint32(1) if where is not None else x
    np.testing.assert_array_equal(_n(probes.cond_add_one(_t(x))), want)


@pytest.mark.parametrize("s", [40, 0, 41, 3, 896, 895])
def test_window_copy_plain_matches_numpy(s):
    """s counts words; odd offsets (not 16-byte aligned) give the same
    window."""
    x = _ar(32, 1024)
    got = probes.window_copy(_t(x), s)
    assert got.shape == (32, 128) and got.is_contiguous()
    np.testing.assert_array_equal(_n(got), x[:, s:s + 128])


def test_window_copy_argument_checks():
    x = _t(_ar(4, 256))
    for s, W in ((-1, 128), (129, 128), (0, 0)):
        with pytest.raises(ValueError, match="inside a row"):
            probes.window_copy(x, s, W)


@pytest.mark.parametrize("n", range(7))
def test_loop_dyn_plain_matches_numpy(n):
    """n = 0 is the TPU script's arange case (max(x[0, :8]) = 7)."""
    if n == 0:
        x = _ar(16, 128)
    else:
        x = _rnd(10 + n, 16, 128)
        x[0, :8] = [3, 0, 7 * 11 + n, 5, 1, 2, 4, 6]
    assert int(x[0, :8].max()) % 7 == n
    want = np.zeros_like(x)
    for _ in range(n):                  # the loop the kernel runs
        want = want + x
    np.testing.assert_array_equal(_n(probes.loop_dyn(_t(x))), want)


def test_loop_dyn_reads_the_trip_count_unsigned():
    x = _rnd(5, 16, 128)
    x[0, :8] = [0xFFFFFFFF, 1, 2, 3, 4, 5, 6, 7]
    n = 0xFFFFFFFF % 7
    want = (x.astype(np.uint64) * n).astype(np.uint32)
    np.testing.assert_array_equal(_n(probes.loop_dyn(_t(x))), want)
    with pytest.raises(ValueError, match="first 8 words"):
        probes.loop_dyn(_t(_ar(4, 4)))


@pytest.mark.parametrize("n", [4, 0, 1, 3])
def test_dynslice_sum_plain_matches_numpy(n):
    for x in (_ar(16, 8, 128), _rnd(6, 9, 8, 50)):
        want = np.zeros((x.shape[0], x.shape[2]), dtype=np.uint32)
        for i in range(n):
            want = want + x[:, 2 * i, :]
        got = probes.dynslice_sum(_t(x), n)
        np.testing.assert_array_equal(_n(got), want)
    with pytest.raises(ValueError, match="at most 4 terms"):
        probes.dynslice_sum(_t(x), 5)


def test_layout_cases_cover_every_probe_and_agree_on_the_cpu():
    """The list the card's checks walk: every probe present, its TPU case
    first, wrapper == plain version == library call on CPU tensors."""
    cases = probes.layout_cases("cpu")
    first, no_library = {}, set()
    for name, label, kern, plain, lib, nbytes in cases:
        if name not in first and lib is None:
            no_library.add(name)
        first.setdefault(name, label)
        want = plain()
        assert torch.equal(kern(), want), (name, label)
        if lib is not None:
            assert torch.equal(lib(), want), (name, label)
        assert nbytes > 0
    assert tuple(first) == probes.LAYOUT_PROBES
    # a branch on a reduction and a data-dependent trip count take several
    # PyTorch calls; every other probe is timed beside one call
    assert no_library == {"cond", "loop_dyn"}
    assert first["row_copy"].startswith("(1024,32)[40:56]")
    assert first["loop_dyn"].endswith("n = 7 mod 7 = 0")
    assert all(v == 0 for k, v in probes.LAUNCHES.items()
               if k.startswith("probe_layout_"))


def test_layout_kernel_labels_and_memory_ops():
    assert probes._kernel_label("_Z15row_copy_kernelPKjPKlPjiili") \
        == "probe_layout_row_copy"
    assert probes._kernel_label("_Z14reshape_kernelILi1EEvPKjPjiii") \
        == "probe_layout_reshape_merge_major"
    assert probes._kernel_label("_Z19dynslice_sum_kernelPKjPjiii") \
        == "probe_layout_dynslice_sum"
    assert probes._kernel_label("_Z9no_kernelPKj") is None
    sass = """
        /*0000*/                   LDG.E.CONSTANT R2, desc[UR4][R2.64] ;
        /*0010*/                   STL [R1], R2 ;
        /*0020*/             @!P0  LDL R5, [R4] ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/                   IADD3 R9, R9, 0x1, RZ ;
        /*0050*/                   STG.E desc[UR4][R6.64], R5 ;
    """
    assert probes.memory_ops(sass) == {"LDG": 1, "STL": 1, "LDL": 1, "BAR": 1,
                                       "STG": 1}
    wide = """
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0010*/             @P0   LDG.E.128.CONSTANT R8, desc[UR4][R2.64+0x1000] ;
        /*0020*/                   LDG.E.CONSTANT R12, desc[UR4][R2.64] ;
        /*0030*/                   STG.E.128 desc[UR4][R6.64], R4 ;
        /*0040*/                   STG.E desc[UR4][R6.64], R12 ;
    """
    assert probes.memory_ops(wide) == {"LDG.128": 2, "LDG": 1, "STG.128": 1,
                                       "STG": 1}


def test_ptxas_summary_reads_registers_and_stack_frames():
    """The reader of ``nvcc -Xptxas -v`` output that says whether a
    per-thread array got a stack frame."""
    text = """
ptxas info    : Compiling entry function '_Z14reshape_kernelILi2EEvPKjPjiii' for 'sm_90a'
ptxas info    : Function properties for _Z14reshape_kernelILi2EEvPKjPjiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z19dynslice_sum_kernelPKjPjiii' for 'sm_90a'
ptxas info    : Function properties for _Z19dynslice_sum_kernelPKjPjiii
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, 380 bytes cmem[0]
"""
    assert cuda_lib.ptxas_summary({"probe_layout": text}) == [
        "ptxas[probe_layout] reshape_kernel<2>: 24 registers, stack 0 B, "
        "spill stores/loads 0/0 B",
        "ptxas[probe_layout] dynslice_sum_kernel: 28 registers, stack 32 B, "
        "spill stores/loads 0/0 B"]
    assert cuda_lib.ptxas_summary({}) == []
    assert "probe_layout" in cuda_lib.SOURCES
    assert set(cuda_lib._ARGTYPES) == set(cuda_lib.SOURCES)
