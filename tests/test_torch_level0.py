"""Level 0 of the dense MSM (``aadd_rows``) and the bases of the fixed-base
window table (``dbl_chain``) against the JAX package, on the CPU.

On CPU tensors both wrappers run their plain versions: ``aadd_rows`` the
gathered form (row gather, limb split, infinity mask, ``aadd_plain``),
``dbl_chain`` c plain doublings a window. Every comparison is exact
(tolerance 0: every value is canonical).

aadd_rows: the inputs are a real dense layout of m = 64 points at c = 6
(signed digits, sorted runs, the signed packed row table), with a duplicate
point and scalar (level 0 meets P == Q), a point and its negation with one
scalar (P == -Q), each two places apart in a run, an infinity base with
a nonzero scalar and a 12-deep bucket; the chunks are windows 1-8 (full
windows) at depths 0-3 and 4-7 (a second chunk) at chunk depth 4, which
leaves many depths past their bucket's count, and the partial top window
(2 or 1 scalar bits, its own bucket count). A numpy model of the kernel's lane arithmetic (lane -> depth pair,
window, bucket; clamped positions; infinity by y == 0 or depth >= count)
gives the pairs each lane adds; the JAX package's ``aadd`` on those pairs
and the form level 0 had before ``aadd_rows`` must give its limbs.

dbl_chain: the bases 2^(c w) G equal lane 1 of the JAX package's
``window_table`` (whose lane 1 is its base: an add of infinity keeps it),
and the port's whole table equals the JAX package's.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.ec import CurveKernel as JaxCurve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.fp2 import Fp2Kernel as JaxFp2
from libsnark_tpu.ops.msm import MSMKernel as JaxMSM

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops import cuda_bucket, cuda_ec
from libsnark_tpu_torch.ops.limbs import from_torch, to_torch, words_to_limbs
from libsnark_tpu_torch.ops.msm import MSMKernel
from libsnark_tpu_torch.proof_systems.base import PairingSystem

M, C, R = 64, 6, 4        # points, window bits, chunk depth
W_LO, WN = 1, 8           # the full windows of the first two chunks
CURVES = ("alt_bn128", "bls12_377")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    """curve -> (port PairingSystem on the CPU, JAX G1 / G2 kernels)."""
    out = {}
    for name in CURVES:
        jc = jax_get_curve(name)
        jfq = JaxFp(jc.fq_params)
        jck = {"G1": JaxCurve(jfq, "G1"),
               "G2": JaxCurve(JaxFp2(jfq, int(jc.Fq2.NON_RESIDUE)), "G2")}
        out[name] = (PairingSystem(get_curve(name), device="cpu"), jck, jc)
    return out


def _group(ps, group_name):
    return (ps.g1, ps.msm_g1) if group_name == "G1" else (ps.g2, ps.msm_g2)


def _planted(curve, group_name, seed):
    group = getattr(curve, group_name)
    rng = random.Random(seed)
    pts = [group.one() * rng.randrange(1, curve.r)]     # a run of neighbours
    for _ in range(M - 1):
        pts.append(pts[-1] + group.one())
    rng.shuffle(pts)
    scalars = [rng.randrange(1, curve.r) for _ in range(M)]
    # one scalar for 6-8 and for 9-11: adjacent in their buckets' runs, so
    # 6 and 8 (P == Q), 9 and 11 (P == -Q) lie half = 2 depths apart
    scalars[7] = scalars[8] = scalars[6]
    scalars[10] = scalars[11] = scalars[9]
    pts[8], pts[11] = pts[6], -pts[9]
    pts[12] = group.zero()                           # an infinity row
    for j in range(20, 32):                          # a 12-deep bucket
        pts[j], scalars[j] = pts[20], scalars[20]
    return pts, scalars


def _lane_model(fk, rows, gidx, starts, counts, m, base, half, w_lo, Wn, nb):
    """The pairs aadd_rows_kernel adds, by its own lane arithmetic: lane t
    = (r Wn + w) nb + b reads depths base + r and base + r + half of bucket
    (w_lo + w, b). Returns ((x1, y1, i1), (x2, y2, i2)) with batch (L,)."""
    FW = cuda_ec.ext_of(fk) * fk.N
    lead = (2, fk.N) if cuda_ec.ext_of(fk) == 2 else (fk.N,)
    st_all, ct_all = starts.numpy(), counts.numpy()
    g_all, rows_np = gidx.numpy(), rows.numpy()
    t = np.arange(half * Wn * nb)
    span = Wn * nb
    r = t // span
    wb = t - r * span
    w = wb // nb
    b = wb - w * nb
    st, ct = st_all[w_lo + w, b], ct_all[w_lo + w, b]
    out = []
    for d in (base + r, base + r + half):
        pos = np.clip(st.astype(np.int64) + d, 0, m - 1)
        g = g_all[(w_lo + w).astype(np.int64) * m + pos]
        limbs = words_to_limbs(torch.from_numpy(rows_np[g].T.copy()))
        x, y = limbs[:FW], limbs[FW:]
        inf = (y == 0).all(dim=0) | torch.from_numpy(d >= ct)
        out.append((x.reshape(lead + (t.size,)), y.reshape(lead + (t.size,)),
                    inf))
    return out


def _old_level0(fk, aadd_fn, rows, gidx, starts, counts, m, base, half,
                w_lo, Wn, nb):
    """Level 0 as _dense_reduce ran it before aadd_rows (int64 runs)."""
    FW = cuda_ec.ext_of(fk) * fk.N
    lead = (2, fk.N) if cuda_ec.ext_of(fk) == 2 else (fk.N,)
    st = starts.to(torch.int64)[w_lo:w_lo + Wn, :nb]
    ct = counts.to(torch.int64)[w_lo:w_lo + Wn, :nb]
    woff = (torch.arange(w_lo, w_lo + Wn, dtype=torch.int64) * m)[None, :, None]
    r_idx = torch.arange(2 * half, dtype=torch.int64)[:, None, None]
    depth = base + r_idx
    pos = torch.clamp(st[None] + depth, 0, m - 1)
    live = (depth < ct[None]).reshape(2 * half, Wn * nb)
    rg = gidx.to(torch.int64)[(woff + pos).reshape(-1)]
    gt = words_to_limbs(rows[rg].T)
    qx = gt[:FW].reshape(lead + (2 * half, Wn * nb))
    qy = gt[FW:].reshape(lead + (2 * half, Wn * nb))
    qinf = (gt[FW:] == 0).all(dim=0).reshape(2 * half, Wn * nb) | ~live
    lo = (qx.narrow(-2, 0, half), qy.narrow(-2, 0, half), qinf[:half])
    hi = (qx.narrow(-2, half, half), qy.narrow(-2, half, half), qinf[half:])
    return aadd_fn(lo, hi)


@pytest.fixture(scope="module",
                params=[(c, g) for c in CURVES for g in ("G1", "G2")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def level0(request, systems):
    """The dense layout of one (curve, group) and its three chunks, each
    through aadd_rows, with the lane model's pairs."""
    curve_name, group_name = request.param
    ps, jck, _ = systems[curve_name]
    ck, mk = _group(ps, group_name)
    dense = MSMKernel(ck, mk.scalar_bits, strategy="dense")
    fk = ck.fk
    pts, scalars = _planted(ps.curve, group_name, 5)
    aff = ck.encode_points(pts, jacobian=False)
    sc = ps.scalars_to_dev(scalars)
    B = 1 << (C - 1)
    digits, signs = dense.signed_digits(sc, C)
    gidx, starts, counts = (t.to(torch.int32) for t in
                            dense._sort_signed_bounds(digits, signs, M, B))
    gidx = gidx.reshape(-1)
    rows = dense.row_table(aff, signed=True)
    W_full = dense.scalar_bits // C
    eff = dense.scalar_bits - C * W_full
    assert 0 < eff < C and dense.num_windows(C) == W_full + 2
    chunks = [(0, R // 2, W_LO, WN, B + 1), (R, R // 2, W_LO, WN, B + 1),
              (0, R // 2, W_full, 1, min(B + 1, (1 << eff) + 2))]
    runs = (rows, gidx, starts, counts, M)
    got = [cuda_ec.aadd_rows(fk, *runs, *ch) for ch in chunks]
    pairs = [_lane_model(fk, *runs, *ch) for ch in chunks]
    return dict(group=group_name, ps=ps, ck=ck, dense=dense, fk=fk,
                jck=jck[group_name], runs=runs, chunks=chunks, got=got,
                pairs=pairs)


def _flat(P):
    """(.., half, Wn nb) -> (.., L)."""
    return tuple(a.reshape(a.shape[:-2] + (-1,)) for a in P)


def test_aadd_rows_equals_the_lane_model(level0):
    fk = level0["fk"]
    for got, (lo, hi) in zip(level0["got"], level0["pairs"]):
        for a, b in zip(_flat(got), cuda_ec.aadd_plain(fk, lo, hi)):
            assert torch.equal(a, b)


def test_aadd_rows_equals_the_gathered_form(level0):
    """The form level 0 had before aadd_rows; on the partial window also
    the yardstick that keeps it (MSMKernel.dense_level0_composed) and
    MSMKernel.dense_level0."""
    fk, ck, dense = level0["fk"], level0["ck"], level0["dense"]
    for got, ch in zip(level0["got"], level0["chunks"]):
        wants = [_old_level0(fk, ck.aadd, *level0["runs"], *ch)]
        if ch[3] == 1:
            wants += [dense.dense_level0_composed(*level0["runs"], *ch),
                      dense.dense_level0(*level0["runs"], *ch)]
        for want in wants:
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_aadd_rows_equals_jax_aadd(level0):
    """The JAX package's aadd on every chunk's pairs at once."""
    cat = lambda k, i: np.concatenate(
        [from_torch(p[k][i]) for p in level0["pairs"]], axis=-1)
    jlo, jhi = (tuple(jnp.asarray(cat(k, i)) for i in range(3))
                for k in range(2))
    want = jax.jit(level0["jck"].aadd)(jlo, jhi)
    got = [np.concatenate([from_torch(_flat(g)[i]) for g in level0["got"]],
                          axis=-1) for i in range(3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_planted_cases_reach_level0(level0):
    """P == Q, P == -Q, an infinity row at a live depth, depths past the
    count and a live second chunk all occur among the lanes."""
    fk = level0["fk"]
    seen = dict.fromkeys(("P == Q", "P == -Q", "infinity row", "dead depth",
                          "live second chunk"), False)
    counts = level0["runs"][3]
    for k, (lo, hi) in enumerate(level0["pairs"]):
        x1, y1, i1 = lo
        x2, y2, i2 = hi
        live = ~(i1 | i2)
        same_x = (x1 == x2).all(dim=tuple(range(x1.dim() - 1)))
        same_y = (y1 == y2).all(dim=tuple(range(y1.dim() - 1)))
        seen["P == Q"] |= bool((live & same_x & same_y).any())
        seen["P == -Q"] |= bool((live & same_x & ~same_y).any())
        seen["live second chunk"] |= k == 1 and bool(live.any())
        for x, y, i in (lo, hi):
            zero_y = (y == 0).all(dim=tuple(range(y.dim() - 1)))
            seen["infinity row"] |= bool((zero_y & i).any())
            seen["dead depth"] |= bool((i & ~zero_y).any())
    assert int(counts.max()) > R
    assert all(seen.values()), seen


def _check_bases(ps, group_name, base, got, c, W):
    """got == the per-window dbl_n loop, and its points 2^(c w) G."""
    ck, mk = _group(ps, group_name)
    for g, w in zip(mk.window_bases_loop(base, c, W), got):
        assert torch.equal(g, w)
    host = getattr(ps.curve, group_name)
    assert ck.decode_points(got, host) == [host.one() * (1 << (c * w))
                                           for w in range(W)]


@pytest.mark.parametrize("curve_name,c,W", [("alt_bn128", 8, 3),
                                            ("bls12_377", 4, 3)])
def test_dbl_chain_matches_jax_window_table(systems, curve_name, c, W):
    ps, jck, jc = systems[curve_name]
    fk = ps.g1.fk
    jmk = JaxMSM(jck["G1"], jc.r.bit_length())
    jx, jy, _ = jck["G1"].encode_points([jc.G1.one()], jacobian=False)
    want = jax.jit(lambda x, y: jmk.window_table((x, y), c, W))(jx, jy)
    base = (to_torch(np.asarray(jx), "cpu"), to_torch(np.asarray(jy), "cpu"),
            fk.one((1,)))
    got = cuda_bucket.dbl_chain(fk, base, c, W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(from_torch(g), np.asarray(w)[..., 1])
    for g, w in zip(ps.msm_g1.window_table(base[:2], c, W), want):
        np.testing.assert_array_equal(from_torch(g), np.asarray(w))
    _check_bases(ps, "G1", base, got, c, W)


@pytest.mark.parametrize("curve_name", CURVES)
def test_dbl_chain_g2_bases(systems, curve_name):
    """G2 (Fp2 doublings) at c in {4, 8}: the per-window loop's limbs (its
    dbl is the JAX package's, tests/test_torch_ec.py) and the host's
    points."""
    ps = systems[curve_name][0]
    G = ps.g2.encode_points([ps.curve.G2.one()])
    for c, W in ((4, 3), (8, 2)):
        _check_bases(ps, "G2", G, cuda_bucket.dbl_chain(ps.fq2, G, c, W), c,
                     W)


def test_aadd_rows_argument_checks(systems):
    ps = systems["alt_bn128"][0]
    fk = ps.g1.fk
    FW = fk.N
    m, W, ncols = 8, 3, 5
    rows = torch.zeros((2 * m, FW), dtype=torch.int32)
    gidx = torch.zeros(W * m, dtype=torch.int32)
    runs = torch.zeros((W, ncols), dtype=torch.int32)
    ok = (0, 1, 0, W, ncols)
    assert cuda_ec.aadd_rows(fk, rows, gidx, runs, runs, m, *ok)[0].shape == (
        FW, 1, W * ncols)
    for bad_rows in (rows[:m], rows.to(torch.int64), rows[:, :-1]):
        with pytest.raises(ValueError, match="signed row table"):
            cuda_ec.aadd_rows(fk, bad_rows, gidx, runs, runs, m, *ok)
    for g, s, c in ((gidx[:-1], runs, runs), (gidx.float(), runs, runs),
                    (gidx, runs[:2], runs[:2]), (gidx, runs, runs[:, :2])):
        with pytest.raises(ValueError, match="bucket starts and counts"):
            cuda_ec.aadd_rows(fk, rows, g, s, c, m, *ok)
    for chunk in ((0, 0, 0, W, ncols), (-1, 1, 0, W, ncols),
                  (0, 1, 1, W, ncols), (0, 1, 0, 0, ncols),
                  (0, 1, 0, W, ncols + 1), (0, 1, 0, W, 0)):
        with pytest.raises(ValueError, match="outside"):
            cuda_ec.aadd_rows(fk, rows, gidx, runs, runs, m, *chunk)
    with pytest.raises(ValueError, match="2\\^31"):
        cuda_ec.aadd_rows(fk, rows, gidx, runs, runs, m, 0, 1 << 30, 0, W,
                          ncols)


def test_dbl_chain_argument_checks(systems):
    ps = systems["alt_bn128"][0]
    fk = ps.g1.fk
    P = ps.g1.zero((1,))
    assert cuda_bucket.dbl_chain(fk, P, 0, 2)[2].shape == (fk.N, 2)
    for args in ((P, 8, 0), (P, -1, 2), (ps.g1.zero((2,)), 8, 2),
                 (tuple(a.to(torch.int64) for a in P), 8, 2), (P[:2], 8, 2),
                 (ps.g2.zero((1,)), 8, 2)):
        with pytest.raises(ValueError, match="dbl_chain takes"):
            cuda_bucket.dbl_chain(fk, *args)
