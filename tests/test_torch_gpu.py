"""Card-only tests: each CUDA kernel of the port against its plain version.

Every comparison is bit-exact. The tests carry the ``gpu`` marker and skip
without a CUDA card. They import the port only (no JAX), so they run on a
machine that has PyTorch for CUDA and nvcc but no JAX:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""
import random

import pytest
import torch

from libsnark_tpu_torch import get_curve, probes
from libsnark_tpu_torch.ops import cuda_bucket, cuda_ec, cuda_fp
from libsnark_tpu_torch.ops.limbs import ints_to_limbs
from libsnark_tpu_torch.ops.msm import MSMKernel
from libsnark_tpu_torch.polynomial_commitments.kzg10 import KZG10
from libsnark_tpu_torch.proof_systems.base import PairingSystem

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", params=["alt_bn128", "bls12_377"])
def system(request):
    """One system per curve: 16-limb and 24-limb base fields."""
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


def _planted_scalar_ints(r, c, W, m, seed):
    """0, 1, r - 1, every window 2^c - 1 (all 256 bits set), digit 0 in
    every odd / every even window, only the top window nonzero; the rest
    random below r."""
    rng = random.Random(seed)
    full = (1 << 256) - 1
    digits = lambda keep: sum(rng.randrange(1, 1 << c) << (c * w)
                              for w in range(W) if keep(w)) & full
    top = ((rng.randrange(1 << c) | 1) << (c * (W - 1))) & full
    xs = [0, 1, r - 1, full, digits(lambda w: w % 2 == 0),
          digits(lambda w: w % 2 == 1), top or 1 << 255]
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
        xs = _planted_scalar_ints(system.curve.r, c, W, 1 << 12, seed=c)
        sc = torch.from_numpy(ints_to_limbs(xs, 16).astype("int32")).cuda()
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


@pytest.mark.parametrize("which", ["BCTV14", "GM17", "DFGK14"])
def test_proof_systems_card_proof_equals_cpu_proof(which):
    """20 constraints over alt_bn128: the seeded keys from the device
    fixed-base path and the proof on the card equal the CPU's (plain
    versions, host fixed-base path), and the card's proof verifies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from libsnark_tpu_torch.proof_systems.bctv14 import BCTV14
    from libsnark_tpu_torch.proof_systems.dfgk14 import DFGK14
    from libsnark_tpu_torch.proof_systems.gm17 import GM17
    from libsnark_tpu_torch.relations import examples
    curve = get_curve("alt_bn128")
    cls = {"BCTV14": BCTV14, "GM17": GM17, "DFGK14": DFGK14}[which]
    make = (examples.generate_uscs_example if which == "DFGK14"
            else examples.generate_r1cs_example)
    proofs = []
    for device in ("cuda", "cpu"):
        cs, primary, aux = make(curve.r, 20, 2)
        ps = cls(curve, device=device)
        ps.host_keygen = device == "cpu"
        kp = ps.generator(cs, seed=5)
        proofs.append(ps.prover(kp.pk, primary, aux, seed=9))
    assert proofs[0] == proofs[1]
    assert ps.verifier_strong_IC(kp.vk, primary, proofs[0])
