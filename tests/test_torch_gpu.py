"""Card-only tests: each CUDA kernel of the port against its plain version.

Every comparison is bit-exact. The tests carry the ``gpu`` marker and skip
without a CUDA card. They import the port only (no JAX), so they run on a
machine that has PyTorch for CUDA and nvcc but no JAX:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""
import random
import time

import pytest
import torch

from libsnark_tpu_torch import get_curve, probes
from libsnark_tpu_torch.ops import cuda_bucket, cuda_ec, cuda_fp, cuda_lib
from libsnark_tpu_torch.ops.limbs import ints_to_limbs
from libsnark_tpu_torch.ops.msm import MSMKernel
from libsnark_tpu_torch.polynomial_commitments.kzg10 import KZG10
from libsnark_tpu_torch.proof_systems.base import PairingSystem

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", params=["alt_bn128", "bls12_377", "bw6_761"])
def system(request):
    """One system per curve: 16-limb, 24-limb and 48-limb base fields (at
    48 limbs G2 lies over Fq too: every group kernel runs with ext = 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return PairingSystem(get_curve(request.param), device="cuda")


def _ints(p, n, seed):
    rng = random.Random(seed)
    return [0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]


def _group(system, name):
    return (system.g1, system.msm_g1) if name == "G1" else \
        (system.g2, system.msm_g2)


def test_mont_mul_kernel_matches_plain_on_card(system):
    for fk in (system.fr, system.fq):
        a = fk.encode(_ints(fk.p, 4096, 9))
        b = fk.encode(_ints(fk.p, 4096, 10)[::-1])
        before = cuda_fp.LAUNCHES[f"mont_mul_n{fk.N}"]
        got = cuda_fp.mont_mul(fk, a, b)
        assert cuda_fp.LAUNCHES[f"mont_mul_n{fk.N}"] == before + 1
        assert torch.equal(got, cuda_fp.mont_mul_plain(fk, a, b))


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_ec_kernels_match_plain_on_card(system, group_name):
    """Lanes 0 P = inf, 1 Q = inf, 2 both, 3-4 P == Q, 5-6 P == -Q, 7
    invalid for madd; the rest random."""
    ck, _ = _group(system, group_name)
    group = getattr(system.curve, group_name)
    rng = random.Random(11)
    G = group.one()
    Ph = [G * rng.randrange(1, system.curve.r) for _ in range(12)]
    Qh = [G * rng.randrange(1, system.curve.r) for _ in range(12)]
    Ph[0] = Qh[1] = Ph[2] = Qh[2] = group.zero()
    Qh[3], Qh[4] = Ph[3], Ph[4]
    Qh[5], Qh[6] = -Ph[5], -Ph[6]
    P, Q = ck.encode_points(Ph), ck.encode_points(Qh)
    Qa = ck.encode_points(Qh, jacobian=False)
    valid = torch.ones(12, dtype=torch.bool, device=P[0].device)
    valid[7] = False
    fk = ck.fk
    Pa = ck.encode_points(Ph, jacobian=False)
    before = cuda_ec.LAUNCHES[cuda_ec.counter_key("aadd", fk)]
    for kern, plain in (
            (cuda_ec.dbl(fk, P, 3), cuda_ec.dbl_plain(fk, P, 3)),
            (cuda_ec.add(fk, P, Q), cuda_ec.add_plain(fk, P, Q)),
            (cuda_ec.madd(fk, P, Qa, valid),
             cuda_ec.madd_plain(fk, P, Qa, valid)),
            (cuda_ec.aadd(fk, Pa, Qa), cuda_ec.aadd_plain(fk, Pa, Qa))):
        for a, b in zip(kern, plain):
            assert torch.equal(a, b)
    assert cuda_ec.LAUNCHES[cuda_ec.counter_key("aadd", fk)] == before + 1
    got = ck.decode_points(cuda_ec.aadd(fk, Pa, Qa), group)
    assert got == [A + B for A, B in zip(Ph, Qh)]


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_bucket_and_horner_kernels_match_plain_on_card(system, group_name):
    """Signed-digit buckets of a 256-point MSM with an infinity point, a
    zero scalar and eight equal (point, scalar) pairs."""
    ck, mk = _group(system, group_name)
    group = getattr(system.curve, group_name)
    r = system.curve.r
    rng = random.Random(9)
    G = group.one()
    pts = [G * rng.randrange(1, r) for _ in range(256)]
    scalars = [rng.randrange(r) for _ in range(256)]
    pts[1] = group.zero()
    scalars[2] = 0
    for i in range(8, 16):
        pts[i], scalars[i] = pts[8], scalars[8]
    c = 6
    seg = mk.bucket_segments(system.scalars_to_dev(scalars), c)
    args = (mk.row_table(ck.encode_points(pts, jacobian=False)),
            seg["gidx"], seg["seg_start"], seg["seg_count"])
    kern = cuda_bucket.bucket_reduce(mk.fk, *args, seg["seg_order"])
    plain = cuda_bucket.bucket_reduce_plain(mk.fk, *args)
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    S = tuple(a[:, :seg["W"]].contiguous() for a in kern)
    hk = cuda_bucket.horner_combine(mk.fk, S, c)
    hp = cuda_bucket.horner_combine_plain(mk.fk, S, c)
    assert all(torch.equal(a, b) for a, b in zip(hk, hp))


def _horner_windows(group, r, W, c, rng):
    """Planted window sums (host points, window 0 first): random; an
    infinity window; an infinity top window; S_(W-2) = 2^c S_(W-1) (the
    first add meets P == Q); S_0 = -(the rest) (a sum at infinity)."""
    G = group.one()
    rnd = lambda: [G * rng.randrange(1, r) for _ in range(W)]
    if W == 1:
        return [rnd(), [group.zero()]]
    out = [rnd()]
    for plant in range(4):
        pts = rnd()
        if plant == 0:
            pts[W // 2 if W > 2 else 0] = group.zero()
        elif plant == 1:
            pts[W - 1] = group.zero()
        elif plant == 2:
            pts[W - 2] = pts[W - 1] * (1 << c)
        else:
            rest = group.zero()
            for w in range(1, W):
                rest = rest + pts[w] * (1 << (c * w))
            pts[0] = -rest
        out.append(pts)
    return out


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_horner_planted_windows_on_card(system, group_name):
    """horner_combine at W in {1, 2, 18} and c in {1, 15, 16} on planted
    window sums with random Z, bit-exact against the plain version run over
    all cases of a (W, c) at once."""
    ck, _ = _group(system, group_name)
    group = getattr(system.curve, group_name)
    fk = ck.fk
    ext = 2 if hasattr(fk, "fp") else 1
    FW = ext * fk.N
    rng = random.Random(23)
    key = cuda_ec.counter_key("horner_combine", fk)
    for W in (1, 2, 18):
        for c in (1, 15, 16):
            S = []
            for pts in _horner_windows(group, system.curve.r, W, c, rng):
                X, Y, Z = ck.encode_points(pts)
                zs = ck.encode_points([group.one() * rng.randrange(
                    1, system.curve.r) for _ in range(W)])[0]   # nonzero
                z2 = fk.sqr(zs)
                S.append([fk.mul(X, z2).reshape(FW, W),
                          fk.mul(Y, fk.mul(z2, zs)).reshape(FW, W),
                          fk.mul(Z, zs).reshape(FW, W)])
            batch = tuple(torch.stack([s[i] for s in S], -1)
                          for i in range(3))
            want = cuda_bucket.horner_combine_plain(fk, batch, c)
            for b, s in enumerate(S):
                before = cuda_bucket.LAUNCHES[key]
                got = cuda_bucket.horner_combine(fk, s, c)
                assert cuda_bucket.LAUNCHES[key] == before + 1
                for x, y in zip(got, want):
                    assert torch.equal(x, y[:, b:b + 1]), (W, c, b)
            if W > 1:
                assert not bool(want[2][:, 4].any())     # the sum at infinity


def test_row_copy_segments_on_card(system):
    """row_copy at the default segment, at single-row and 16-row segments
    of bucket_reduce's row widths, at a width that takes the word path and
    from a negative s: bit-exact against the plain gather."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    for width in (16, 24, 32, 48, 5):
        x = torch.randint(-(1 << 31), 1 << 31, (4096, width), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
        assert torch.equal(probes.row_copy(x, 9, 16),
                           probes.row_copy_plain(x, 9, 16))
        for R in (1, 16):
            seg = torch.randint(0, 4096 - R - 3, (1000,), generator=gen,
                                device="cuda")
            want = probes.row_copy_plain(x, 3, R, seg)
            assert torch.equal(probes.row_copy(x, 3, R, seg), want)
            assert torch.equal(probes.row_copy(x, 3, R, seg, validate=False),
                               want)
            assert torch.equal(probes.row_copy(x, -3, R, seg + 6),
                               probes.row_copy_plain(x, -3, R, seg + 6))
        empty = torch.zeros(0, dtype=torch.int64, device="cuda")
        assert probes.row_copy(x, 0, 4, empty).shape == (0, 4, width)


def _planted_lanes(system, group_name, L):
    """Jacobian P, Q over L lanes from 16 random points with random Z:
    lanes 0-7 P = inf, 8-15 Q = inf, 16-23 both, 24-31 P == Q (other Z),
    32-39 P == -Q; the rest random pairs."""
    ck, _ = _group(system, group_name)
    group = getattr(system.curve, group_name)
    fk = ck.fk
    rng = random.Random(17)
    G = group.one()
    pts = [G * rng.randrange(1, system.curve.r) for _ in range(16)]
    aff = ck.encode_points(pts, jacobian=False)
    gen = torch.Generator(device="cuda").manual_seed(5)
    i1 = torch.randint(0, 16, (L,), generator=gen, device="cuda")
    i2 = torch.randint(0, 16, (L,), generator=gen, device="cuda")
    i2[24:40] = i1[24:40]
    zs = ck.encode_points([G * rng.randrange(1, system.curve.r)
                           for _ in range(16)])[0]       # nonzero field values

    def lift(idx, zi):
        x, y = aff[0][..., idx], aff[1][..., idx]
        Z = zs[..., zi]
        Z2 = fk.sqr(Z)
        return [fk.mul(x, Z2), fk.mul(y, fk.mul(Z2, Z)), Z]
    P = lift(i1, torch.randint(0, 16, (L,), generator=gen, device="cuda"))
    Q = lift(i2, torch.randint(0, 16, (L,), generator=gen, device="cuda"))
    Q[1][..., 32:40] = fk.neg(Q[1][..., 32:40])
    for T, lanes in ((P, slice(0, 8)), (Q, slice(8, 16)), (P, slice(16, 24)),
                     (Q, slice(16, 24))):
        T[2][..., lanes] = 0
    return tuple(P), tuple(Q)


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_add_kernel_at_scan_width_matches_plain_on_card(system, group_name):
    """add over 294,930 lanes, one launch of the suffix scan of a 2^20-point
    MSM (18 windows of 2^14 + 1 buckets), with planted infinity, P == Q and
    P == -Q lanes."""
    ck, _ = _group(system, group_name)
    L = 18 * ((1 << 14) + 1)
    P, Q = _planted_lanes(system, group_name, L)
    got = cuda_ec.add(ck.fk, P, Q)
    want = cuda_ec.add_plain(ck.fk, P, Q)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    inf = ck.fk.is_zero(got[2])
    assert bool(inf[16:24].all()) and bool(inf[32:40].all())
    assert not bool(inf[:16].any()) and not bool(inf[24:32].any())


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_bucket_reduce_deep_and_wide_on_card(system, group_name):
    """bucket_reduce on the packed rows of a 2^16-point MSM (c = 11) whose
    first 4096 scalars are equal (4096 rows in one bucket of every window,
    cut into segments of seg_len), the rest random: bit-exact against the
    plain version, and the same sums in length order, in segment order and
    in a random order."""
    ck, mk = _group(system, group_name)
    group = getattr(system.curve, group_name)
    m, c = 1 << 16, 11
    rng = random.Random(19)
    G = group.one()
    base = ck.encode_points([G * rng.randrange(1, system.curve.r)
                             for _ in range(64)], jacobian=False)
    gen = torch.Generator(device="cuda").manual_seed(6)
    idx = torch.randint(0, 64, (m,), generator=gen, device="cuda")
    inf = torch.zeros(m, dtype=torch.bool, device="cuda")
    inf[5000:5008] = True
    pts = (base[0][..., idx], base[1][..., idx], inf)
    sc = system.scalars_to_dev([rng.randrange(system.curve.r)
                                for _ in range(m)])
    sc[:, :4096] = sc[:, :1]
    seg = mk.bucket_segments(sc, c)
    counts = seg["seg_count"]
    assert int(counts.max()) == max(16, 2 * -(-m // (1 << (c - 1))))
    args = (mk.row_table(pts), seg["gidx"], seg["seg_start"], counts)
    want = cuda_bucket.bucket_reduce_plain(mk.fk, *args)
    perm = torch.randperm(counts.numel(), generator=gen, device="cuda")
    for order in (seg["seg_order"], None, perm):
        got = cuda_bucket.bucket_reduce(mk.fk, *args, order)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_dense_window_sums_equal_default_on_card(system, group_name,
                                                 monkeypatch):
    """The dense strategy (aadd_rows level 0, add tree, chunk loop forced by
    a shallow depth and sixteen equal scalars) gives the default strategy's
    window sums as affine points; the public aadd never launches."""
    ck, mk = _group(system, group_name)
    group = getattr(system.curve, group_name)
    r = system.curve.r
    rng = random.Random(13)
    G = group.one()
    base = [G * rng.randrange(1, r) for _ in range(16)]
    pts = [base[rng.randrange(16)] for _ in range(512)]
    scalars = [rng.randrange(r) for _ in range(512)]
    pts[1] = group.zero()
    scalars[2] = 0
    for i in range(8, 24):
        pts[i], scalars[i] = pts[8], scalars[8]
    aff = ck.encode_points(pts, jacobian=False)
    sc = system.scalars_to_dev(scalars)
    c = 7
    dense = MSMKernel(ck, mk.scalar_bits, strategy="dense")
    key = cuda_ec.counter_key("aadd_rows", mk.fk)
    aadd = cuda_ec.counter_key("aadd", mk.fk)
    before, aadd_before = cuda_ec.LAUNCHES[key], cuda_ec.LAUNCHES[aadd]
    lanes = lambda S: tuple(a.movedim(0, -2) for a in S)   # (.., W, 1)
    want = ck.to_affine(lanes(mk.window_sums(aff, sc, c)))
    assert cuda_ec.LAUNCHES[key] == before
    monkeypatch.setattr(dense, "dense_depth", lambda *a: 4)  # chunk loop
    got = ck.to_affine(lanes(dense.window_sums_dense(aff, sc, c)))
    assert cuda_ec.LAUNCHES[key] > before
    assert cuda_ec.LAUNCHES[aadd] == aadd_before
    assert torch.equal(got[2], want[2])
    live = ~want[2]
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a[..., live], b[..., live])


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_aadd_rows_matches_plain_and_gathered_form_on_card(system,
                                                           group_name):
    """aadd_rows on the dense layout of a 2^12-point MSM at c = 8 whose
    first 40 scalars are equal (a 40-deep bucket in every window), with a
    point and its negation and a point twice at one scalar, two places
    apart in their runs (P == -Q, P == Q at chunk depth 4), and infinity
    bases: the full windows at depths 0-3 and 4-7 (a second chunk) and 0-47
    (one chunk past every count but the deep bucket's), and the partial top
    window; bit-exact against the plain version and the gathered form with
    the aadd kernel (MSMKernel.dense_level0_composed), one launch a call."""
    ck, mk = _group(system, group_name)
    group = getattr(system.curve, group_name)
    r = system.curve.r
    m, c = 1 << 12, 8
    rng = random.Random(23)
    G = group.one()
    base = [G * rng.randrange(1, r) for _ in range(64)]
    pts = [base[rng.randrange(64)] for _ in range(m)]
    scalars = [rng.randrange(1, r) for _ in range(m)]
    for i in range(40):
        scalars[i] = scalars[0]
    scalars[101] = scalars[102] = scalars[100]
    scalars[104] = scalars[105] = scalars[103]
    pts[102], pts[105] = pts[100], -pts[103]
    for i in range(200, 208):
        pts[i] = group.zero()
    aff = ck.encode_points(pts, jacobian=False)
    sc = system.scalars_to_dev(scalars)
    B = 1 << (c - 1)
    digits, signs = mk.signed_digits(sc, c)
    gidx, starts, counts = (t.to(torch.int32) for t in
                            mk._sort_signed_bounds(digits, signs, m, B))
    runs = (mk.row_table(aff, signed=True), gidx.reshape(-1), starts, counts,
            m)
    W_full = mk.scalar_bits // c
    nb_top = min(B + 1, (1 << (mk.scalar_bits - c * W_full)) + 2)
    key = cuda_ec.counter_key("aadd_rows", mk.fk)
    for chunk in ((0, 2, 0, W_full, B + 1), (4, 2, 0, W_full, B + 1),
                  (0, 24, 0, W_full, B + 1), (0, 2, W_full, 1, nb_top)):
        before = cuda_ec.LAUNCHES[key]
        got = cuda_ec.aadd_rows(mk.fk, *runs, *chunk)
        assert cuda_ec.LAUNCHES[key] == before + 1
        for want in (cuda_ec.aadd_rows_plain(mk.fk, *runs, *chunk),
                     mk.dense_level0_composed(*runs, *chunk)):
            for a, b in zip(got, want):
                assert torch.equal(a, b), chunk


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_dbl_chain_matches_plain_on_card(system, group_name):
    """dbl_chain at the keygen's W = 32, c = 8, at c = 4 and at c = 0 (every
    base is the point): bit-exact against its plain version and the
    per-window dbl_n loop; window_table launches it once and no dbl."""
    ck, mk = _group(system, group_name)
    group = getattr(system.curve, group_name)
    fk = mk.fk
    P = ck.encode_points([group.one() * 12345])
    key = cuda_bucket.counter_key("dbl_chain", fk)
    for c, W in ((8, 32), (4, 3), (0, 2)):
        before = cuda_bucket.LAUNCHES[key]
        got = cuda_bucket.dbl_chain(fk, P, c, W)
        assert cuda_bucket.LAUNCHES[key] == before + 1
        for want in (cuda_bucket.dbl_chain_plain(fk, P, c, W),
                     mk.window_bases_loop(P, c, W)):
            for a, b in zip(got, want):
                assert torch.equal(a, b), (c, W)
    dbl = cuda_ec.counter_key("dbl", fk)
    before, dbl_before = cuda_bucket.LAUNCHES[key], cuda_ec.LAUNCHES[dbl]
    aff = ck.encode_points([group.one()], jacobian=False)
    T = mk.window_table(aff[:2], 8, 32)
    assert cuda_bucket.LAUNCHES[key] == before + 1
    assert cuda_ec.LAUNCHES[dbl] == dbl_before
    assert ck.decode_points(tuple(a[..., 5, 3:4] for a in T), group) == [
        group.one() * (3 << 40)]


def _planted_scalar_ints(r, c, W, m, seed, nl):
    """0, 1, r - 1, every window 2^c - 1 (all 16 nl bits set), digit 0 in
    every odd / every even window, only the top window nonzero; the rest
    random below r."""
    rng = random.Random(seed)
    full = (1 << (16 * nl)) - 1
    digits = lambda keep: sum(rng.randrange(1, 1 << c) << (c * w)
                              for w in range(W) if keep(w)) & full
    top = ((rng.randrange(1 << c) | 1) << (c * (W - 1))) & full
    xs = [0, 1, r - 1, full, digits(lambda w: w % 2 == 0),
          digits(lambda w: w % 2 == 1), top or 1 << (16 * nl - 1)]
    return xs + [rng.randrange(r) for _ in range(m - len(xs))]


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_madd_windows_matches_plain_and_loop_on_card(system, group_name):
    """The windowed fixed-base kernel at m = 2^12 on the fixed-base path's
    own table (c = 4, 8; c = 6 puts digits across two limbs and a last
    window past the last limb), planted scalars: bit-exact against its
    plain version and against the per-window madd kernel loop, one launch
    a call."""
    ck, mk = _group(system, group_name)
    group = getattr(system.curve, group_name)
    key = cuda_ec.counter_key("madd_win", mk.fk)
    for c in (4, 6, 8):
        taff, rows = system._window_table_affine(ck, mk, group.one(), c)
        W = rows.shape[0] >> c
        nl = system.scalar_limbs
        xs = _planted_scalar_ints(system.curve.r, c, W, 1 << 12, seed=c,
                                  nl=nl)
        sc = torch.from_numpy(ints_to_limbs(xs, nl).astype("int32")).cuda()
        before = cuda_ec.LAUNCHES[key]
        got = mk.batch_exp(taff, sc, c, rows)
        assert cuda_ec.LAUNCHES[key] == before + 1
        want = cuda_ec.madd_windows_plain(mk.fk, rows, sc, c)
        loop = mk.batch_exp_loop(taff, sc, c)
        for a, b, d in zip(got, want, loop):
            assert torch.equal(a, b), c
            assert torch.equal(a, d), c
        inf = mk.fk.is_zero(got[2])
        assert bool(inf[0]) and not bool(inf[1:].any())
        assert ck.decode_points(tuple(a[..., 1:2] for a in got),
                                group) == [group.one()]


def test_reshape_forms_match_plain_on_card(system):
    """Each reshape in its 16-byte form (C % 4 == 0, aligned), its word
    form (C % 4 != 0, or an array 4 bytes off 16-byte alignment) and over
    more pieces than one pass of the grid holds."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rnd = lambda *shape: torch.randint(-(1 << 31), 1 << 31, shape,
                                       generator=gen, device="cuda",
                                       dtype=torch.int64).to(torch.int32)
    for name in probes.RESHAPES:
        mid = 1 if name == "squeeze" else 7
        big = rnd(300, mid, 8191)         # more pieces than one grid pass
        shifted = rnd(1 + 33 * mid * 16).narrow(0, 1, 33 * mid * 16)
        for x in (rnd(16, mid, 128), rnd(5, mid, 3), rnd(37, mid, 12),
                  shifted.view(33, mid, 16), big, big[:, :, :8188]):
            assert torch.equal(probes.reshape3d(name, x),
                               probes.reshape_plain(name, x)), (name, x.shape)


def test_probe_kernels_match_plain_on_card(system):
    """The rate chains (the three wide multiply-add forms among them, and
    mad_wide's main loop one IMAD.WIDE.U32 a step with no add beside it),
    and the Montgomery bodies of the CIOS probe (CIOS, operand scanning,
    the carry chain that is fp_mul) against the plain product at both
    widths."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    assert {"mad_wide", "mad_wide_split", "mad_cc"} <= set(probes.RATE_OPS)
    for op in probes.RATE_OPS:
        a, b = probes._rate_inputs(op, 1000, gen)
        before = probes.LAUNCHES[f"probe_rate_{op}"]
        assert torch.equal(probes.rate_chain(op, a, b, 37),
                           probes.rate_chain_plain(op, a, b, 37)), op
        assert probes.LAUNCHES[f"probe_rate_{op}"] == before + 1
    steps = {k: probes.loop_counts(loop, control=False)
             for k, loop in probes.sass_loops().items()}
    assert probes.single_wide_mad_loop(steps["probe_rate_mad_wide"]), steps
    assert not probes.single_wide_mad_loop(steps["probe_rate_mad_wide_split"])
    for fk in (system.fr, system.fq):
        if fk.nw not in cuda_lib.PROBE_WIDTHS:      # 48 limbs: no probe
            continue
        a = fk.encode(_ints(fk.p, 512, 9))
        b = fk.encode(_ints(fk.p, 512, 10)[::-1])
        want = probes.cios_chain_plain(fk, a, b, 5)
        for variant in probes.CIOS_VARIANTS:
            assert torch.equal(probes.cios_chain(fk, variant, a, b, 5),
                               want), (fk.N, variant)


def test_layout_kernels_match_plain_on_card(system):
    """Every case of probes.layout_cases: the TPU scripts' shapes, odd
    offsets, shifts outside [0, axis), tiles with no word above 7, trip
    counts 1..6. Each case launches its kernel once; the PyTorch call
    timed beside a kernel computes the same function."""
    seen = set()
    for name, label, kern, plain, lib, _ in probes.layout_cases("cuda"):
        before = probes.LAUNCHES[f"probe_layout_{name}"]
        got = kern()
        assert probes.LAUNCHES[f"probe_layout_{name}"] == before + 1
        want = plain()
        assert torch.equal(got, want), (name, label)
        if lib is not None:
            assert torch.equal(lib(), want), (name, label)
        seen.add(name)
    assert seen == set(probes.LAYOUT_PROBES)


def test_cond_kernel_paths_match_plain_on_card(system):
    """cond_add_one against its plain version where the kernel's paths
    part: 16-byte pieces (both arrays aligned) or words (a view 4 bytes
    off), a tile of one word, 1-3 words past the last whole piece, more
    words than the registers hold (4096 and one more a thread) so that the
    last ones go through its loop; every word at most 7, or one word above
    7 (its top bit set) at the start, the middle or the end."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    for n in (1, 3, 5, 2047, 2048, 4095, 4096, 4099, 4352, 4353, 4356,
              10001):
        low = torch.randint(0, 8, (n + 1,), generator=gen, device="cuda",
                            dtype=torch.int32)
        for off in (0, 1):                       # aligned; 4 bytes off
            for where in (None, 0, n // 2, n - 1):
                buf = low.clone()
                if where is not None:
                    buf[off + where] = -(1 << 31) + 8        # 0x80000008
                x = buf[off:off + n].view(1, n)
                assert (x.data_ptr() % 16 == 0) == (off == 0)
                before = probes.LAUNCHES["probe_layout_cond"]
                got = probes.cond_add_one(x)
                assert probes.LAUNCHES["probe_layout_cond"] == before + 1
                assert torch.equal(got, probes.cond_plain(x)), (n, off, where)


def test_graph_timing_counts_the_kernels_that_ran(system):
    """A wrapper called while a CUDA graph is captured runs no kernel: the
    count rises by the warm-up call and by ``reps`` per replay."""
    x = torch.arange(16 * 128, dtype=torch.int32, device="cuda").reshape(16, 128)
    before = dict(probes.LAUNCHES)
    assert probes._graph_ms(lambda: probes.roll_minor(x, 40), 10) > 0
    grown = {k: n - before[k] for k, n in probes.LAUNCHES.items()
             if n != before[k]}
    assert grown == {"probe_layout_roll_minor": 1 + 2 * 10}


def test_kzg_round_trip_on_card(system):
    """KZG10 at degree 2^14 - 1 through the kernels: the opening verifies, a
    wrong value, a wrong point and a changed coefficient are rejected, and
    the dense strategy commits to the same point."""
    curve = system.curve
    r = curve.r
    n = 1 << 14
    rng = random.Random(31)
    kzg = KZG10(curve, device="cuda")
    srs = kzg.setup(n - 1, seed=3)
    coeffs = [rng.randrange(r) for _ in range(n)]
    before = cuda_bucket.LAUNCHES[cuda_ec.counter_key("bucket_reduce", kzg.fq)]
    C = kzg.commit(srs, coeffs)
    assert cuda_bucket.LAUNCHES[
        cuda_ec.counter_key("bucket_reduce", kzg.fq)] == before + 1
    z = rng.randrange(r)
    v, W = kzg.create_evaluation_witness(srs, coeffs, z)
    assert v == kzg.evaluate_polynomial(coeffs, z, r)
    assert kzg.verify_evaluation(srs, C, z, v, W)
    assert not kzg.verify_evaluation(srs, C, z, (v + 1) % r, W)
    assert not kzg.verify_evaluation(srs, C, (z + 1) % r, v, W)
    assert kzg.verify_poly(srs, C, coeffs)
    assert not kzg.verify_poly(srs, C, [(coeffs[0] + 1) % r] + coeffs[1:])
    dense = KZG10(curve, device="cuda", msm_strategy="dense")
    assert dense.commit(srs, coeffs).point == C.point
    assert kzg.commit(srs, [0] * n).point == curve.G1.zero()


@pytest.mark.parametrize("which", ["BCTV14", "GM17", "DFGK14", "ADSNARK",
                                   "Groth16-bw6_761"])
def test_proof_systems_card_proof_equals_cpu_proof(which):
    """20 constraints over alt_bn128 (Groth16 over BW6-761: 48-limb Fq):
    the seeded keys from the device fixed-base path and the proof on the
    card equal the CPU's (plain versions, host fixed-base path), and the
    card's proof verifies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from libsnark_tpu_torch.proof_systems.adsnark import ADSNARK
    from libsnark_tpu_torch.proof_systems.bctv14 import BCTV14
    from libsnark_tpu_torch.proof_systems.dfgk14 import DFGK14
    from libsnark_tpu_torch.proof_systems.gm17 import GM17
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.relations import examples
    curve = get_curve("bw6_761" if which == "Groth16-bw6_761"
                      else "alt_bn128")
    cls = {"BCTV14": BCTV14, "GM17": GM17, "DFGK14": DFGK14,
           "ADSNARK": ADSNARK, "Groth16-bw6_761": Groth16}[which]
    make = (examples.generate_uscs_example if which == "DFGK14"
            else examples.generate_r1cs_example)
    labels = [b"input0", b"input1"]
    proofs = []
    for device in ("cuda", "cpu"):
        cs, primary, aux = make(curve.r, 20, 2)
        ps = cls(curve, device=device)
        ps.host_keygen = device == "cpu"
        if which == "ADSNARK":
            keys = ps.auth_generator(seed=3)
            auth = ps.auth_sign(primary, keys.sak, labels, seed=4)
            kp = ps.generator(cs, keys.pap, seed=5)
            proofs.append(ps.prover(kp.pk, primary, aux, auth, seed=9))
        else:
            kp = ps.generator(cs, seed=5)
            proofs.append(ps.prover(kp.pk, primary, aux, seed=9))
    assert proofs[0] == proofs[1]
    if which == "ADSNARK":
        assert ps.verifier_sec(kp.vk, proofs[0], keys.sak, labels)
        assert ps.verifier_pub(kp.vk, auth, proofs[0], keys.pak, labels)
    else:
        assert ps.verifier_strong_IC(kp.vk, primary, proofs[0])


def test_fp2_at_48_limbs_is_refused_on_card():
    """csrc builds the group kernels at 24 words for ext = 1 only: each C
    entry returns cudaErrorInvalidValue for ext = 2 there, and the Python
    wrappers raise before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import ctypes
    from libsnark_tpu_torch.ops.fp2 import Fp2Kernel
    ps = PairingSystem(get_curve("bw6_761"), device="cuda")
    fq = ps.fq
    x = fq.encode([1, 2])
    null = ctypes.c_void_p(0)
    stream = cuda_lib.stream_ptr(x)
    ec, bucket = cuda_lib.lib("ec"), cuda_lib.lib("bucket")
    mod = ctypes.addressof(fq.mod)
    ptr = x.data_ptr()
    codes = [
        ec.lsn_ec_dbl(24, 2, ptr, ptr, ptr, ptr, ptr, ptr, 0, 1, mod, stream),
        ec.lsn_ec_add(24, 2, *[ptr] * 9, 0, mod, stream),
        bucket.lsn_bucket_reduce(24, 2, ptr, 0, ptr, ptr, ptr, null, 0, ptr,
                                 ptr, ptr, mod, stream),
        bucket.lsn_horner(24, 2, ptr, ptr, ptr, 1, 1, ptr, ptr, ptr, mod,
                          stream),
        bucket.lsn_dbl_chain(24, 2, ptr, ptr, ptr, 1, 1, ptr, ptr, ptr, mod,
                             stream)]
    assert all(code != 0 for code in codes), codes
    assert ec.lsn_ec_dbl(24, 1, ptr, ptr, ptr, ptr, ptr, ptr, 0, 1, mod,
                         stream) == 0
    f2 = Fp2Kernel(fq, -4)
    P = (torch.stack([x, x]),) * 3
    with pytest.raises(ValueError, match="degree 2 at 24"):
        cuda_ec.dbl(f2, P)


def _pcd_log(label, t0, timings):
    """One line of a PCD test's phases (run with -s to see it)."""
    torch.cuda.synchronize()
    print(f"{label}: {time.perf_counter() - t0:.2f} s; "
          + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
          + f"; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def test_sp_pcd_one_proof_on_card():
    """SpPCD over BLS12-377 -> BW6-761 with one inner proof (the tally
    predicate of arity 2): device keygen, a real inner step proof, the
    aggregation (69,527 constraints) proved over BW6-761 on the card; the
    verifier accepts and rejects a changed statement."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from libsnark_tpu_torch.proof_systems.compliance_predicate import (
        PCDLocalData, PCDMessage, TallyCompliancePredicate)
    from libsnark_tpu_torch.proof_systems.pcd import SpPCD
    bls, bw6 = get_curve("bls12_377"), get_curve("bw6_761")
    cp = TallyCompliancePredicate(bls.r, max_arity=2)
    cp.generate_r1cs_constraints()
    pcd = SpPCD(bls, bw6)
    torch.cuda.reset_peak_memory_stats()
    t0, t = time.perf_counter(), {}
    pk, vk = pcd.generator(cp, num_proofs=1, seed=77, timings=t)
    _pcd_log("sp_pcd generator", t0, t)
    assert pk.outer_keypair.pk.r1cs_dev.num_constraints == 69527
    t0 = time.perf_counter()
    stmt, inner = pcd.prove_step(
        pk, cp, [PCDMessage(1, [10, 1]), PCDMessage(1, [20, 2])],
        PCDLocalData([5]), seed=5)
    assert stmt[1:3] == [35, 4]
    assert pcd.g16_inner.verifier_strong_IC(pk.inner_keypair.vk, stmt, inner)
    _pcd_log("sp_pcd prove_step + inner verify", t0, {})
    t0, t = time.perf_counter(), {}
    proof = pcd.prover(pk, [stmt], [inner], seed=9, timings=t)
    _pcd_log("sp_pcd prover", t0, t)
    t0 = time.perf_counter()
    assert pcd.verifier(vk, [stmt], proof)
    bad = list(stmt)
    bad[1] = (bad[1] + 1) % bls.r
    assert not pcd.verifier(vk, [bad], proof)
    _pcd_log("sp_pcd verifier (accept, reject)", t0, {})


def test_mp_pcd_two_predicates_one_proof_on_card():
    """MpPCD with two compliance predicates (the tally of arity 2 and of
    arity 1: both statements of 4 inputs), one proof, max_vks 8: generator
    (two inner keys, the committed vk set, the outer key on the card), a
    real inner proof under one predicate, prover, verifier accepts and
    rejects a changed statement; a proof under a key outside the committed
    set has no membership proof, so the prover refuses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from libsnark_tpu_torch.proof_systems.compliance_predicate import (
        PCDLocalData, PCDMessage, TallyCompliancePredicate)
    from libsnark_tpu_torch.proof_systems.mp_pcd import MpPCD
    bls, bw6 = get_curve("bls12_377"), get_curve("bw6_761")
    handlers = {}
    for name, arity in (("tally2", 2), ("tally1", 1)):
        handlers[name] = TallyCompliancePredicate(bls.r, max_arity=arity)
        handlers[name].generate_r1cs_constraints()
    mp = MpPCD(bls, bw6)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pk, vk = mp.generator(handlers, num_proofs=1, max_vks=8, seed=41)
    _pcd_log("mp_pcd generator", t0, {})
    print(f"mp_pcd outer circuit: "
          f"{pk.outer_keypair.pk.r1cs_dev.num_constraints} constraints",
          flush=True)
    h = handlers["tally2"]
    h.generate_r1cs_witness([PCDMessage(1, [10, 1]), PCDMessage(1, [20, 2])],
                            PCDLocalData([5]))
    stmt = h.pb.primary_input()
    inner = mp.g16_inner.prover(pk.inner_keypairs["tally2"].pk, stmt,
                                h.pb.auxiliary_input(), seed=5)
    t0 = time.perf_counter()
    proof = mp.prover(pk, [("tally2", stmt, inner)], seed=9)
    _pcd_log("mp_pcd prover", t0, {})
    t0 = time.perf_counter()
    assert mp.verifier(vk, [stmt], proof)
    bad = list(stmt)
    bad[1] = (bad[1] + 1) % bls.r
    assert not mp.verifier(vk, [bad], proof)
    _pcd_log("mp_pcd verifier (accept, reject)", t0, {})
    # a third key, outside the committed set
    mp.g16_inner.host_keygen = True
    foreign = mp.g16_inner.generator(h.pb.get_constraint_system(), seed=99)
    outside = dataclasses.replace(pk, inner_keypairs={"foreign": foreign})
    inner = mp.g16_inner.prover(foreign.pk, stmt, h.pb.auxiliary_input(),
                                seed=5)
    with pytest.raises(KeyError):
        mp.prover(outside, [("foreign", stmt, inner)], seed=9)


@pytest.mark.parametrize("curve_name", ["alt_bn128", "bls12_377", "bw6_761",
                                        "mnt4", "edwards"])
def test_fp_addsub_matches_plain_on_card(curve_name):
    """The field addition and subtraction kernel at every width (16, 24, 48,
    19, 12 limbs) against FpKernel.add / sub's int64 limb passes, on
    canonical lanes with 0, 1 and p - 1 planted, on any 16-bit limbs and
    with a broadcast operand; FpKernel.add / sub / neg launch it once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    ps = PairingSystem(get_curve(curve_name), device="cuda")
    for fk in (ps.fq, ps.fr):
        plain = fk.as_plain()
        a = fk.encode(_ints(fk.p, 4096, 21))
        b = fk.encode(_ints(fk.p, 4096, 22)[::-1])
        wild = torch.randint(0, 1 << 16, (fk.N, 4096), dtype=torch.int32,
                             device="cuda")
        for x, y in ((a, b), (wild, wild.flip(-1)), (a, b[:, :1])):
            for sub in (False, True):
                got = cuda_fp.add_sub(fk, x, y, sub)
                want = (plain.sub if sub else plain.add)(x, y)
                assert torch.equal(got, want)
        key = f"fp_addsub_n{fk.N}"
        before = cuda_fp.LAUNCHES[key]
        assert torch.equal(fk.neg(a), plain.neg(a))
        assert torch.equal(fk.add(a, b), plain.add(a, b))
        assert cuda_fp.LAUNCHES[key] == before + 2


@pytest.mark.parametrize("curve_name", ["mnt4", "mnt6", "edwards"])
def test_mont_mul_at_19_and_12_limbs_matches_plain_on_card(curve_name):
    """The product at 19 limbs (R = 2^304: nine word rounds and a half-word
    round, MNT4 and MNT6) and at 12 (the carry chain at 6 words, edwards),
    Fq and Fr, 2^16 lanes with 0, 1 and p - 1 planted, against its plain
    version; one launch each, counted under the field's limbs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    ps = PairingSystem(get_curve(curve_name), device="cuda")
    for fk in (ps.fq, ps.fr):
        assert fk.N == (12 if curve_name == "edwards" else 19)
        a = fk.encode(_ints(fk.p, 1 << 16, 19))
        b = fk.encode(_ints(fk.p, 1 << 16, 20)[::-1])
        before = cuda_fp.LAUNCHES[f"mont_mul_n{fk.N}"]
        got = cuda_fp.mont_mul(fk, a, b)
        assert cuda_fp.LAUNCHES[f"mont_mul_n{fk.N}"] == before + 1
        assert torch.equal(got, cuda_fp.mont_mul_plain(fk, a, b))
        x = fk.decode(a[:, :64]), fk.decode(b[:, :64])
        assert fk.decode(got[:, :64]) == [u * v % fk.p for u, v in zip(*x)]


@pytest.mark.parametrize("curve_name,log2", [("mnt4", 20), ("mnt6", 18),
                                             ("edwards", 14)])
def test_generic_a_groth16_on_card(curve_name, log2):
    """Groth16 over a curve with an a-coefficient through the entry points
    on the card (MNT4 at 2^20 - 3 constraints, its Fr of two-adicity 34
    allowing it; MNT6 at 2^18 - 3, its witness map on the extended domain
    of 2 x 2^17): keygen on the device fixed-base path, both strategy
    names giving one proof, verify accepted and a wrong input rejected;
    mont_mul and fp_addsub launch at Fq's and Fr's width and no group
    kernel does
    (bucket_reduce, horner_combine, dbl_chain, madd_win, aadd_rows, dbl,
    add, madd, aadd hard-code a = 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from libsnark_tpu_torch.ops import launch_counts, reset_launch_counts
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.relations.examples import generate_r1cs_example
    curve = get_curve(curve_name)
    cs, primary, aux = generate_r1cs_example(curve.r, (1 << log2) - 3, 2)
    g16 = Groth16(curve)
    t0 = time.perf_counter()
    reset_launch_counts()
    timings = {}
    kp = g16.generator(cs, seed=5, timings=timings)
    proofs = [g16.prover(kp.pk, primary, aux, seed=9, timings=timings)]
    proofs.append(Groth16(curve, msm_strategy="dense").prover(
        kp.pk, primary, aux, seed=9))
    counts = {k: v for k, v in launch_counts().items() if v}
    _pcd_log(f"groth16 {curve_name} 2^{log2}", t0, timings)
    assert proofs[0] == proofs[1]
    assert [k for k in counts
            if not k.startswith(("mont_mul_", "fp_addsub_"))] == []
    for fk in (g16.fq, g16.fr):
        assert counts[f"mont_mul_n{fk.N}"] and counts[f"fp_addsub_n{fk.N}"]
    if curve_name == "mnt6":
        from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
        assert g16.domain_for(qap_domain, cs).kind == "extended"
    assert g16.verifier_strong_IC(kp.vk, primary, proofs[0])
    bad = [(primary[0] + 1) % curve.r] + primary[1:]
    assert not g16.verifier_strong_IC(kp.vk, bad, proofs[0])


def _ram_arith_program():
    """tests/test_ram_universal.py's arithmetic program (accepted)."""
    from libsnark_tpu_torch.relations.tinyram import Opcode, TinyRAMProgram
    prog = TinyRAMProgram()
    prog.add(Opcode.MOV, True, 0, 0, 9)
    prog.add(Opcode.ADD, True, 0, 0, 33)
    prog.add(Opcode.SUB, True, 0, 0, 42)
    prog.add(Opcode.ANSWER, False, 0, 0, 0)
    return prog


def test_ram_universal_card_proof_equals_cpu_proof():
    """The RAM ppzkSNARK on the 4,765-constraint universal circuit (TinyRAM
    w = 16, k = 4, boot-trace and time bounds 5) over alt_bn128: the keys
    from the device fixed-base path and the proof on the card equal the
    CPU's (plain versions, host fixed-base path); the card's proof
    verifies and is rejected with a changed boot input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from libsnark_tpu_torch.proof_systems.ram_ppzksnark import RAMPpzksnark
    from libsnark_tpu_torch.relations.tinyram import TinyRAMParams
    curve = get_curve("alt_bn128")
    ap = TinyRAMParams(w=16, k=4)
    out = []
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        rs = RAMPpzksnark(curve, device=device)
        rs.host_keygen = device == "cpu"
        kp = rs.ram_generator(ap, 5, 5, seed=5)
        proof, boot = rs.ram_prover(kp.pk, _ram_arith_program(), [], [],
                                    seed=9)
        out.append((kp, proof, boot))
        print(f"ram_ppzksnark 4765 constraints on {device}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    (kp, proof, boot), (kp_cpu, proof_cpu, boot_cpu) = out
    assert kp.pk.r1cs_pk.r1cs_dev.num_constraints == 4765
    assert boot == boot_cpu and proof == proof_cpu
    assert rs.ram_verifier(kp.vk, boot, proof)
    assert not rs.ram_verifier(kp.vk, [boot[0] + 1] + boot[1:], proof)


def test_ram_ppzksnark_2_19_on_card():
    """The RAM ppzkSNARK over alt_bn128 at w = 32, k = 16, boot-trace bound
    102 and time bound 256 (a 2^19 domain): gen_ram_example_complex's
    satisfiable example proved and verified, rejected with one boot-input
    element changed; the unsatisfiable example refused by the prover."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from libsnark_tpu_torch.proof_systems.ram_ppzksnark import RAMPpzksnark
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    from libsnark_tpu_torch.relations.examples import gen_ram_example_complex
    from libsnark_tpu_torch.relations.tinyram import TinyRAMParams
    curve = get_curve("alt_bn128")
    ap = TinyRAMParams(w=32, k=16)
    B, T = 102, 256
    prog, primary, aux, _ = gen_ram_example_complex(ap, B, T, seed=21)
    rs = RAMPpzksnark(curve)
    torch.cuda.reset_peak_memory_stats()
    t0, t = time.perf_counter(), {}
    kp = rs.ram_generator(ap, B, T, seed=5, timings=t)
    _pcd_log("ram_ppzksnark 2^19 generator", t0, t)
    dev = kp.pk.r1cs_pk.r1cs_dev
    domain = rs.domain_for(qap_domain, dev)
    print(f"ram_ppzksnark: {dev.num_constraints} constraints, "
          f"{dev.num_inputs} inputs, domain {type(domain).__name__} "
          f"m = {domain.m}", flush=True)
    assert domain.m == 1 << 19
    t0, t = time.perf_counter(), {}
    proof, boot = rs.ram_prover(kp.pk, prog, primary, aux, seed=9,
                                timings=t)
    _pcd_log("ram_ppzksnark 2^19 prover", t0, t)
    t0 = time.perf_counter()
    assert rs.ram_verifier(kp.vk, boot, proof)
    bad = list(boot)
    bad[-1] = (bad[-1] + 1) % curve.r
    assert not rs.ram_verifier(kp.vk, bad, proof)
    _pcd_log("ram_ppzksnark 2^19 verifier (accept, reject)", t0, {})
    unsat = gen_ram_example_complex(ap, B, T, satisfiable=False, seed=21)
    with pytest.raises(AssertionError, match="did not accept"):
        rs.ram_prover(kp.pk, *unsat[:3], seed=9)


def test_ram_zksnark_succinct_on_card():
    """The succinct RAM zkSNARK at T = 2: TinyRAM w = 32, k = 16 with the
    full 32-bit delegated address space, two inner Groth16 proofs over
    BLS12-377 aggregated by one outer proof over BW6-761 (two verifier
    gadgets); verifier_succinct accepts, and rejects a final message with
    a changed register (the outer proof's statement) and one with
    has_accepted = 0 (the host checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from libsnark_tpu_torch.proof_systems.ram_zksnark import (
        RamZkSnark, RamZkSnarkArchParams)
    from libsnark_tpu_torch.relations.examples import gen_ram_example_simple
    from libsnark_tpu_torch.relations.tinyram import TinyRAMParams
    bls, bw6 = get_curve("bls12_377"), get_curve("bw6_761")
    arch = RamZkSnarkArchParams(ap=TinyRAMParams(w=32, k=16))
    T = 2
    prog, primary, aux, _ = gen_ram_example_simple(arch.ap, 8, T, seed=4)
    rzs = RamZkSnark(bls)
    torch.cuda.reset_peak_memory_stats()
    t0, t = time.perf_counter(), {}
    skp = rzs.generator_succinct(arch, bw6, T, seed=7, timings=t)
    _pcd_log("ram_zksnark succinct generator", t0, t)
    print(f"ram_zksnark outer circuit: "
          f"{skp.outer_keypair.pk.r1cs_dev.num_constraints} constraints",
          flush=True)
    t0, t = time.perf_counter(), {}
    proof = rzs.prover_succinct(skp, prog, primary, T, aux, seed=9,
                                timings=t)
    _pcd_log("ram_zksnark succinct prover", t0, t)
    t0 = time.perf_counter()
    vk = skp.outer_keypair.vk
    assert rzs.verifier_succinct(vk, arch, bw6, prog, primary, T, proof)
    regs = list(proof.msg_final.regs)
    regs[1] += 1
    moved = dataclasses.replace(proof, msg_final=dataclasses.replace(
        proof.msg_final, regs=regs))
    assert not rzs.verifier_succinct(vk, arch, bw6, prog, primary, T, moved)
    false = dataclasses.replace(proof, msg_final=dataclasses.replace(
        proof.msg_final, has_accepted=0))
    assert not rzs.verifier_succinct(vk, arch, bw6, prog, primary, T, false)
    _pcd_log("ram_zksnark succinct verifier (accept, reject twice)", t0, {})


def _to_cpu(pk):
    """A Groth16 proving key with every tensor (queries, device R1CS) moved
    to the CPU: what the plain versions prove with."""
    import dataclasses
    dev = pk.r1cs_dev
    mats = {n: dataclasses.replace(getattr(dev, n), **{
        f: getattr(getattr(dev, n), f).cpu() for f in ("rows", "cols",
                                                        "coeffs")})
        for n in ("A", "B", "C")}
    queries = {n: tuple(t.cpu() for t in getattr(pk, n)) for n in (
        "A_query", "B_query_g2", "B_query_g1", "H_query", "L_query")}
    return dataclasses.replace(pk, r1cs_dev=dataclasses.replace(
        dev, **mats), **queries)


@pytest.fixture(scope="module")
def cycle_chain():
    """CycleSpPCD over MNT4 -> MNT6 on the card with the tally predicate
    of arity 1: the generator, then steps at depths 0-3 (local 5, 10, 20,
    40), each consuming the previous step's translation proof; the
    translation board's assignment of the depth-1 step is kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from libsnark_tpu_torch.proof_systems.compliance_predicate import (
        PCDLocalData, TallyCompliancePredicate)
    from libsnark_tpu_torch.proof_systems.pcd_cycle import CycleSpPCD
    pcd = CycleSpPCD()

    def tally():
        h = TallyCompliancePredicate(pcd.A.r, max_arity=1)
        h.generate_r1cs_constraints()
        return h

    torch.cuda.reset_peak_memory_stats()
    t0, t = time.perf_counter(), {}
    pk, vk = pcd.generator(tally(), seed=31, timings=t)
    _pcd_log("cycle_sp_pcd generator", t0, t)
    proofs, depth1 = [], None
    for depth, local in enumerate((5, 10, 20, 40)):
        t0, t = time.perf_counter(), {}
        proofs.append(pcd.prover(pk, tally(), proofs[-1:],
                                 PCDLocalData([local]), seed=11 + depth,
                                 timings=t))
        _pcd_log(f"cycle_sp_pcd prover depth {depth}", t0, t)
        if depth == 1:
            T = pcd.translation_board(pk.kp_a.vk)["pb"]
            depth1 = (T.primary_input(), T.auxiliary_input())
    return dict(pcd=pcd, pk=pk, vk=vk, proofs=proofs, depth1=depth1)


def test_cycle_sp_pcd_depth_3_on_card(cycle_chain):
    """A depth-3 chain of CycleSpPCD steps on the card (each a compliance
    prove over MNT4 and a translation prove over MNT6): the tally payloads
    [5, 1], [15, 2], [35, 3], [75, 4]; the verifier accepts every depth's
    proof and rejects the last under a changed payload element."""
    from libsnark_tpu_torch.proof_systems.compliance_predicate import (
        PCDMessage)
    from libsnark_tpu_torch.proof_systems.pcd_cycle import CyclePCDProof
    c = cycle_chain
    pcd, vk, proofs = c["pcd"], c["vk"], c["proofs"]
    assert [p.msg.payload for p in proofs] == [[5, 1], [15, 2], [35, 3],
                                               [75, 4]]
    t0 = time.perf_counter()
    assert all(pcd.verifier(vk, p.msg, p) for p in proofs)
    bad = PCDMessage(1, [76, 4])
    assert not pcd.verifier(vk, bad, CyclePCDProof(
        msg=bad, translation_proof=proofs[-1].translation_proof))
    _pcd_log("cycle_sp_pcd verifier (4 accepted, 1 rejected)", t0, {})


def test_cycle_translation_step_card_equals_cpu(cycle_chain):
    """The depth-1 step's translation prove (Groth16 over MNT6 on a 2^15
    domain): its witness map H on the card equals the port's CPU plain
    versions' under the same proving key (moved to the CPU) and board
    assignment, and a second card prove at the same seed gives the same
    proof, which verifies. (A whole CPU plain prove at this size takes
    hours: its G2 MSM over Fq3 runs the one-lane generic-a formulas.)"""
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.reductions.r1cs_to_qap import (
        qap_domain, qap_witness_map)
    c = cycle_chain
    pcd, pk = c["pcd"], c["pk"].kp_b.pk
    primary, aux = c["depth1"]
    r = pcd.B.r
    full = [1] + [v % r for v in primary] + [v % r for v in aux]
    H = {}
    for label, g16, key in (("card", pcd.g16_b, pk),
                            ("cpu", Groth16(get_curve("mnt6"), device="cpu"),
                             _to_cpu(pk))):
        t0 = time.perf_counter()
        domain = g16.domain_for(qap_domain, key.r1cs_dev)
        H[label] = g16.fr.decode(qap_witness_map(
            key.r1cs_dev, domain, g16.fr.encode(full)))
        _pcd_log(f"cycle translation witness map ({label})", t0, {})
    assert H["card"] == H["cpu"]
    proof = pcd.g16_b.prover(pk, primary, aux, seed=12 + 7)
    assert proof == c["proofs"][1].translation_proof
    assert pcd.g16_b.verifier_strong_IC(c["pk"].kp_b.vk, primary, proof)


def test_cycle_device_check_equals_host_check_on_card(cycle_chain):
    """The device satisfaction check on the card (mont_mul and fp_addsub
    at 19 limbs over the proving key's device R1CS) against
    Protoboard.first_unsatisfied on the translation board: satisfied, a
    statement bit flipped with the verifier gadget's witness made again,
    one auxiliary value changed."""
    c = cycle_chain
    pcd, pk = c["pcd"], c["pk"]
    T = pcd.translation_board(pk.kp_a.vk)
    pb, dev = T["pb"], pk.kp_b.pk.r1cs_dev
    assert pb.first_unsatisfied() is None
    assert pcd.g16_b.first_unsatisfied(dev, pb) is None
    b = T["hbits"][3]
    pb.setval(b, 1 - pb.val(b))
    T["ver"].generate_witness()
    bad = pb.first_unsatisfied()
    assert bad is not None and pcd.g16_b.first_unsatisfied(dev, pb) == bad
    pb.setval(b, 1 - pb.val(b))
    T["ver"].generate_witness()
    i = pb.num_variables // 3
    pb._values[i] = (pb._values[i] + 1) % pb.p
    bad = pb.first_unsatisfied()
    assert bad is not None and pcd.g16_b.first_unsatisfied(dev, pb) == bad
    pb._values[i] = (pb._values[i] - 1) % pb.p


def test_sp_pcd_device_check_equals_host_check_on_card():
    """The device check on SpPCD's one-proof aggregation circuit over
    BW6-761 (69,527 constraints; a trapdoor inner proof over BLS12-377):
    the same verdict and message as Protoboard.first_unsatisfied when
    satisfied, with one statement bit flipped (and the verifier gadget's
    witness made again) and with one auxiliary value changed; the host
    check's and the device check's seconds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import gc
    from libsnark_tpu_torch.proof_systems.groth16 import (
        Groth16, Groth16Proof, Groth16VerificationKey)
    from libsnark_tpu_torch.proof_systems.pcd import SpPCD
    from libsnark_tpu_torch.relations.r1cs import R1CSConstraintSystem
    from libsnark_tpu_torch.relations.variable import Variable
    bls, bw6 = get_curve("bls12_377"), get_curve("bw6_761")
    rng = random.Random(3)
    r = bls.r
    # a trapdoor vk / proof of a one-constraint system with 4 inputs
    # (tests/_torch_port.py's trapdoor_groth16 needs the test helpers)
    from libsnark_tpu_torch.ops.fp import FpKernel
    from libsnark_tpu_torch.reductions.r1cs_to_qap import (
        qap_domain, qap_instance_map_with_evaluation)
    stmt = [1, 35, 4, 2]
    cs = R1CSConstraintSystem(r, 4, 1)
    w = Variable(5)
    cs.add_constraint(w * 1, w * 1, w * 1, "w_bool")
    t, alpha, beta, gamma, delta, rr, ss = (rng.randrange(1, r)
                                            for _ in range(7))
    fr = FpKernel(bls.fr_params, "cpu")
    qap = qap_instance_map_with_evaluation(
        cs, qap_domain(fr, bls.fr_params, cs), t)
    full = [1] + stmt + [0]
    A_e = (alpha + sum(s * a for s, a in zip(full, qap.At)) + rr * delta) % r
    B_e = (beta + sum(s * b for s, b in zip(full, qap.Bt)) + ss * delta) % r
    pub = sum(full[i] * (beta * qap.At[i] + alpha * qap.Bt[i] + qap.Ct[i])
              for i in range(5)) % r
    C_e = (A_e * B_e - alpha * beta - pub) * pow(delta, -1, r) % r
    G1, G2 = bls.G1.one(), bls.G2.one()
    vk = Groth16VerificationKey(
        alpha_g1=G1 * alpha, beta_g2=G2 * beta, gamma_g2=G2 * gamma,
        delta_g2=G2 * delta,
        gamma_ABC=[G1 * ((beta * qap.At[i] + alpha * qap.Bt[i] + qap.Ct[i])
                         * pow(gamma, -1, r) % r) for i in range(5)])
    proof = Groth16Proof(g_A=G1 * A_e, g_B=G2 * B_e, g_C=G1 * C_e)
    sp = SpPCD(bls, bw6)
    gc.disable()
    try:
        t0 = time.perf_counter()
        pb, bits, gadgets = sp.aggregation_witness(vk, r.bit_length(),
                                                   [stmt], [proof])
        g16 = Groth16(bw6)
        dev = pb.get_constraint_system().to_device(g16.fr)
        _pcd_log("sp_pcd aggregation circuit + its device R1CS", t0, {})
        checks = []
        for label in ("satisfied", "statement bit", "auxiliary value"):
            if label == "statement bit":
                b = bits[0][1][0]
                pb.setval(b, 1 - pb.val(b))
                gadgets[0].generate_witness()
            elif label == "auxiliary value":
                b = bits[0][1][0]
                pb.setval(b, 1 - pb.val(b))
                gadgets[0].generate_witness()
                i = pb.num_variables // 2
                pb._values[i] = (pb._values[i] + 1) % pb.p
            t0 = time.perf_counter()
            host = pb.first_unsatisfied()
            t1 = time.perf_counter()
            device = g16.first_unsatisfied(dev, pb)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(f"sp_pcd check {label}: host {t1 - t0:.2f} s, device "
                  f"{t2 - t1:.2f} s: {device}", flush=True)
            checks.append((host, device))
        assert checks[0] == (None, None)
        assert all(h is not None and h == d for h, d in checks[1:])
    finally:
        gc.enable()


def test_cycle_mp_pcd_two_predicates_on_card():
    """CycleMpPCD over MNT4 -> MNT6 with two predicates (the tally of
    arity 1 twice: two compliance keys, two translation keys, their
    processed vks committed in one knapsack-Merkle set): a base step
    under predicate 0, then a depth-1 step under predicate 1 consuming
    it (a cross-predicate chain); the verifier accepts both and rejects a
    changed payload and an out-of-range predicate index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from libsnark_tpu_torch.proof_systems.compliance_predicate import (
        PCDLocalData, PCDMessage, TallyCompliancePredicate)
    from libsnark_tpu_torch.proof_systems.mp_pcd_cycle import CycleMpPCD
    mp = CycleMpPCD()

    def tally():
        h = TallyCompliancePredicate(mp.A.r, max_arity=1)
        h.generate_r1cs_constraints()
        return h

    torch.cuda.reset_peak_memory_stats()
    t0, t = time.perf_counter(), {}
    pk, vk = mp.generator([tally(), tally()], seed=41, timings=t)
    _pcd_log("cycle_mp_pcd generator", t0, t)
    t0, t = time.perf_counter(), {}
    p0 = mp.prover(pk, 0, tally(), [], PCDLocalData([5]), seed=3,
                   timings=t)
    _pcd_log("cycle_mp_pcd prover (predicate 0, depth 0)", t0, t)
    t0, t = time.perf_counter(), {}
    p1 = mp.prover(pk, 1, tally(), [p0], PCDLocalData([10]), seed=4,
                   timings=t)
    _pcd_log("cycle_mp_pcd prover (predicate 1, depth 1)", t0, t)
    assert (p0.predicate_idx, p1.predicate_idx) == (0, 1)
    assert (p0.msg.payload, p1.msg.payload) == ([5, 1], [15, 2])
    t0 = time.perf_counter()
    assert mp.verifier(vk, p0.msg, p0) and mp.verifier(vk, p1.msg, p1)
    bad = PCDMessage(1, [16, 2])
    assert not mp.verifier(vk, bad, dataclasses.replace(p1, msg=bad))
    assert not mp.verifier(vk, p1.msg, dataclasses.replace(
        p1, predicate_idx=2))
    _pcd_log("cycle_mp_pcd verifier (2 accepted, 2 rejected)", t0, {})


def test_ram_zksnark_cycle_two_steps_on_card():
    """RamZkSnarkCycle (the unbounded RAM zkSNARK over the MNT cycle) at
    T = 2 on TinyRAM w = 16, k = 2 with a delegated tree of depth 4: a
    real chain of two one-CPU-step PCD proofs; the verifier accepts the
    final proof, and rejects a false final claim (a changed register in
    the final message) and the proof under a longer time bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from libsnark_tpu_torch.proof_systems.compliance_predicate import (
        PCDMessage)
    from libsnark_tpu_torch.proof_systems.ram_zksnark import (
        RamZkSnarkArchParams, RamZkSnarkCycle, payload_to_ram_msg,
        ram_cycle_payload)
    from libsnark_tpu_torch.relations.tinyram import (
        Opcode, TinyRAMParams, TinyRAMProgram)
    arch = RamZkSnarkArchParams(ap=TinyRAMParams(w=16, k=2), tree_depth=4)
    prog = TinyRAMProgram()                 # store, then answer: 2 steps
    prog.add(Opcode.STOREW, True, 0, 0, 5)
    prog.add(Opcode.ANSWER, True, 0, 0, 0)
    T = 2
    rzc = RamZkSnarkCycle()
    torch.cuda.reset_peak_memory_stats()
    t0, t = time.perf_counter(), {}
    kp = rzc.generator(arch, seed=23, timings=t)
    _pcd_log("ram_zksnark_cycle generator", t0, t)
    t0, t = time.perf_counter(), {}
    proof = rzc.prover(kp, prog, [], T, [], seed=5, timings=t)
    _pcd_log(f"ram_zksnark_cycle prover ({T} steps)", t0, t)
    t0 = time.perf_counter()
    assert rzc.verifier(kp.pcd_vk, arch, prog, [], T, proof)
    ds = rzc.p.bit_length()
    final = payload_to_ram_msg(ds, arch, proof.msg.payload)
    regs = list(final.regs)
    regs[1] += 1
    false = PCDMessage(proof.msg.type, ram_cycle_payload(
        ds, arch, dataclasses.replace(final, regs=regs)))
    assert not rzc.verifier(kp.pcd_vk, arch, prog, [], T,
                            dataclasses.replace(proof, msg=false))
    assert not rzc.verifier(kp.pcd_vk, arch, prog, [], T + 1, proof)
    _pcd_log("ram_zksnark_cycle verifier (accepted, 2 rejected)", t0, {})


@pytest.mark.parametrize("curve_name", ["alt_bn128", "bw6_761", "mnt4",
                                        "edwards"])
def test_mul_wide_matches_plain_on_card(curve_name):
    """The product with a wide operand at 16, 24, 19 and 12 limbs: Wa = N +
    2 (the MXU NTT's), 2N and an odd N + 5 (the half-word round), random
    and all-0xFFFF wide operands, b whole, a broadcast table and one
    constant, against its plain version; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    fk = PairingSystem(get_curve(curve_name), device="cuda").fr
    N, L = fk.N, 1 << 14
    gen = torch.Generator(device="cuda").manual_seed(5)
    b = fk.encode(_ints(fk.p, L, 31), mont=False)
    for wa in (N + 2, 2 * N, N + 5):
        a = torch.randint(0, 1 << 16, (wa, L), dtype=torch.int32,
                          device="cuda", generator=gen)
        a[:, :3] = (1 << 16) - 1
        for bb in (b, b[:, :64].reshape(N, 1, 64), b[:, :1]):
            aa = a.reshape((wa, L // 64, 64)) if bb.dim() == 3 else a
            key = f"mul_wide_n{N}"
            before = cuda_fp.LAUNCHES[key]
            got = cuda_fp.mul_wide(fk, aa, bb)
            assert cuda_fp.LAUNCHES[key] == before + 1
            assert torch.equal(got, cuda_fp.mul_wide_plain(fk, aa, bb))


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_mxu_ntt_matches_radix2_on_card(dtype):
    """The MXU route at 2^16 over BLS12-377's Fr (fft, ifft, the coset
    forms, icoset_fft_divz as one transform) equals the radix-2 forms, and
    the 2^12 forms equal the CPU's plain versions; mul_wide launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from libsnark_tpu_torch.ops import ntt_mxu
    from libsnark_tpu_torch.ops.ntt import Radix2Domain
    curve = get_curve("bls12_377")
    fk = PairingSystem(curve, device="cuda").fr
    a = fk.encode(_ints(fk.p, 1 << 16, 41))
    ref = Radix2Domain(fk, curve.fr_params, 16)
    mx = Radix2Domain(fk, curve.fr_params, 16, mxu=True, dtype=dtype)
    before = (cuda_fp.LAUNCHES["mul_wide_n16"], ntt_mxu.MATMULS[dtype])
    for name in ("fft", "ifft", "coset_fft", "icoset_fft",
                 "icoset_fft_divz"):
        assert torch.equal(getattr(mx, name)(a), getattr(ref, name)(a)), name
    assert cuda_fp.LAUNCHES["mul_wide_n16"] > before[0]
    assert ntt_mxu.MATMULS[dtype] > before[1]
    small = Radix2Domain(fk, curve.fr_params, 12)
    cpu = Radix2Domain(PairingSystem(curve, device="cpu").fr,
                       curve.fr_params, 12)
    b = a[:, :1 << 12]
    assert torch.equal(small.fft_mxu(b, dtype).cpu(),
                       cpu.fft_mxu(b.cpu(), dtype))


def test_four_step_and_msm_simple_on_card(tmp_path):
    """FourStepDomain at 2^16 over a one-rank NCCL group equals the
    radix-2 forms on the card; msm_simple on 2^10 points equals the
    Pippenger MSM's affine sum; sharded_msm's two methods agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import torch.distributed as dist
    from libsnark_tpu_torch.ops.ntt import Radix2Domain
    from libsnark_tpu_torch.parallel.msm_sharded import sharded_msm
    from libsnark_tpu_torch.parallel.ntt_sharded import FourStepDomain
    curve = get_curve("bls12_377")
    ps = PairingSystem(curve, device="cuda")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        fk = ps.fr
        a = fk.encode(_ints(fk.p, 1 << 16, 43))
        fs = FourStepDomain(fk, curve.fr_params, 16)
        ref = Radix2Domain(fk, curve.fr_params, 16)
        for name in ("fft", "ifft", "icoset_fft_divz"):
            assert torch.equal(getattr(fs, name)(a), getattr(ref, name)(a))
        m = 1 << 10
        rng = random.Random(44)
        pts = [curve.G1.one() * rng.randrange(1, curve.r) for _ in range(8)]
        P = ps.g1.encode_points([pts[i % 8] for i in range(m)],
                                jacobian=False)
        sc = ps.scalars_to_dev([rng.randrange(curve.r) for _ in range(m)])
        want = ps.msm_affine("g1", P, sc, 8)
        simple = ps.g1.to_affine(ps.msm_g1.msm_simple(P, sc))
        for x, y in zip(simple, want):
            assert torch.equal(x, y)
        for method in ("pippenger", "simple"):
            got = sharded_msm(ps.msm_g1, None, P, sc, c=8, affine=True,
                              method=method)
            for x, y in zip(got, want):
                assert torch.equal(x, y)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- front-ends

def _front_end(module: str, argv, **kw) -> float:
    """A front-end's main on the card (no --device: "cuda"); exit code 0
    required. Returns its wall seconds, printed with the card's name."""
    import importlib
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    mod = importlib.import_module(f"libsnark_tpu_torch.{module}")
    t0 = time.perf_counter()
    rc = mod.main([str(a) for a in argv], **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"front_end {module} {' '.join(map(str, argv))}: {secs:.1f} s on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    assert rc == 0
    return secs


def _demo_files(d):
    """tests/test_demos.py's input files for the TinyRAM file demos."""
    (d / "ap.txt").write_text("16 4\n")
    (d / "cb.txt").write_text("2 8 6\n")
    asm = "mov 1 0 0 7\nstorew 1 0 0 64\nloadw 1 1 0 64\nanswer 1 0 0 0\n"
    (d / "prog.txt").write_text(asm)
    (d / "prog.s").write_text(asm)
    (d / "pi.txt").write_text("0\n")
    (d / "ai.txt").write_text("0\n")
    return ["--assembly", d / "prog.s", "--processed_assembly",
            d / "prog.txt", "--architecture_params", d / "ap.txt",
            "--computation_bounds", d / "cb.txt", "--primary_input",
            d / "pi.txt", "--auxiliary_input", d / "ai.txt"]


@pytest.mark.parametrize("module,argv", [
    ("profiles.profile_r1cs_gg_ppzksnark", [1000, 10]),
    ("profiles.profile_r1cs_ppzksnark", [1000, 10]),
    ("profiles.profile_r1cs_se_ppzksnark", [1000, 10]),
    ("profiles.profile_uscs_ppzksnark", [1000, 10]),
    ("profiles.profile_bacs_ppzksnark", [100, 4]),
    ("profiles.profile_tbcs_ppzksnark", [100, 4]),
    ("profiles.profile_ram_ppzksnark", [4, 8]),
    ("profiles.profile_routing_algorithms", [8]),
    ("profiles.profile_routing_gadgets", [5]),
    ("demos.demo_r1cs_ppzkadsnark", [100, 4]),
    ("examples.tutorial_gadgetlib2", []),
    ("demos.demo_arithmetization", "files"),
    ("demos.demo_ram_ppzksnark", "files")])
def test_front_end_small_on_card(module, argv, tmp_path):
    _front_end(module, _demo_files(tmp_path) if argv == "files" else argv)


def test_ram_demo_trio_on_card(tmp_path):
    """The split RAM demos on the card: pk.pt written from the card and
    read back onto it (its tensors on the card again); the prover demo's
    proof equals profile_ram_ppzksnark's (the same seeds, its key in
    memory); the verifier demo accepts, and exits 1 after one boot-input
    word is changed."""
    from libsnark_tpu_torch.demos import demo_ram_ppzksnark_verifier
    from libsnark_tpu_torch.proof_systems.bctv14 import QUERIES
    from libsnark_tpu_torch.proof_systems.ram_ppzksnark import (
        load_proving_key)
    from libsnark_tpu_torch.serialization import Codec
    res = {}
    _front_end("profiles.profile_ram_ppzksnark", [4, 8], result=res)
    for name in ("generator", "prover", "verifier"):
        _front_end(f"demos.demo_ram_ppzksnark_{name}", [tmp_path])
    pk = load_proving_key(tmp_path / "pk.pt", "cuda")
    mem = res["keypair"].pk
    for q in QUERIES:
        for got, want in zip(getattr(pk.r1cs_pk, q), getattr(mem.r1cs_pk, q)):
            assert got.is_cuda and torch.equal(got, want), q
    c = Codec(get_curve("alt_bn128"))
    with open(tmp_path / "proof.txt", "rb") as f:
        assert c.read_bctv14_proof(f) == res["proof"]
    with open(tmp_path / "boot_input.txt", "rb") as f:
        boot = c.read_fr_vector(f)
    assert boot == res["boot_input"]
    boot[1] = (boot[1] + 1) % get_curve("alt_bn128").r
    with open(tmp_path / "boot_input.txt", "wb") as f:
        c.write_fr_vector(f, boot)
    assert demo_ram_ppzksnark_verifier.main([str(tmp_path)]) == 1


@pytest.mark.parametrize("module,argv", [
    ("profiles.profile_r1cs_sp_ppzkpcd", [1]),
    ("profiles.profile_r1cs_mp_ppzkpcd", [2]),
    ("profiles.profile_r1cs_sp_ppzkpcd_cycle", [1]),
    ("profiles.profile_ram_zksnark", [16, 4, 3, "--backend=transcript"])])
def test_recursion_front_end_on_card(module, argv):
    """The recursion front-ends at the JAX defaults (the cycle PCD at depth
    1): too heavy for the CPU tests and for the smoke."""
    _front_end(module, argv)
