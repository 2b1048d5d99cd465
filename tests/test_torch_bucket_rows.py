"""The packed row table that ``bucket_reduce`` gathers, the plain bucket
reduce on it through ``MSMKernel.msm`` against the JAX package's host
oracle (points k_i G, so that sum s_i P_i = (sum s_i k_i) G), and the
length order of the segments.

Cases: infinity rows, zero scalars, negative digits, P == Q inside one
bucket (equal points with equal scalars), segments of length 1 and of the
full segment length (a bucket deeper than it), and the carry-only top
window (alt_bn128's 254-bit r with c = 2: the last full window's digit of
r - 1 is 3 > 2 and carries into it). Affine results are canonical, so
every comparison is exact.
"""
import random

import pytest
import torch

from libsnark_tpu import get_curve as jax_get_curve

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops.cuda_bucket import bucket_reduce
from libsnark_tpu_torch.ops.cuda_ec import ext_of
from libsnark_tpu_torch.ops.limbs import limbs_to_words, words_to_limbs
from libsnark_tpu_torch.ops.msm import msm_host_scalars
from libsnark_tpu_torch.proof_systems.base import PairingSystem


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SYSTEMS = {}


def _system(name):
    if name not in _SYSTEMS:
        _SYSTEMS[name] = (jax_get_curve(name),
                          PairingSystem(get_curve(name), device="cpu"))
    return _SYSTEMS[name]


def _host_points(jcurve, group_name, m, seed):
    """m host points P_i = k_i G, k_i = a + i b mod r (two scalar
    multiples, then additions), their k_i, and the rng."""
    group = getattr(jcurve, group_name)
    rng = random.Random(seed)
    a, b = rng.randrange(1, jcurve.r), rng.randrange(1, jcurve.r)
    P, D = group.one() * a, group.one() * b
    pts, ks = [], []
    for i in range(m):
        pts.append(P)
        ks.append((a + i * b) % jcurve.r)
        P = P + D
    return pts, ks, rng


def _to_port(tcurve, group_name, pts):
    """JAX-package host points -> the port's host points."""
    group = getattr(tcurve, group_name)
    out = []
    for P in pts:
        if P.is_zero():
            out.append(group.zero())
        elif group_name == "G1":
            out.append(group.point(int(P.x), int(P.y)))
        else:
            F2 = tcurve.Fq2
            out.append(group.point(F2(int(P.x.c0), int(P.x.c1)),
                                   F2(int(P.y.c0), int(P.y.c1))))
    return out


def _coords(P):
    if P.is_zero():
        return None
    if hasattr(P.x, "c0"):
        return (int(P.x.c0), int(P.x.c1), int(P.y.c0), int(P.y.c1))
    return (int(P.x), int(P.y))


def test_limb_word_round_trip():
    rng = random.Random(1)
    limbs = torch.tensor([[rng.randrange(1 << 16) for _ in range(7)]
                          for _ in range(24)] + [[0xFFFF] * 7, [0] * 7],
                         dtype=torch.int32)
    words = limbs_to_words(limbs)
    assert words.shape == (13, 7) and words.dtype == torch.int32
    want = [[(int(limbs[2 * k + 1, j]) << 16) | int(limbs[2 * k, j])
             for j in range(7)] for k in range(13)]
    assert (words.to(torch.int64) & 0xFFFFFFFF).tolist() == want
    assert torch.equal(words_to_limbs(words), limbs)


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_row_table_is_packed_words(group_name):
    """Row i is x then y of point i as 32-bit words (word k = limbs 2k and
    2k + 1), infinity rows zero; signed rows m.. hold -y."""
    jcurve, tps = _system("alt_bn128")
    mk = tps.msm_g1 if group_name == "G1" else tps.msm_g2
    pts, _, _ = _host_points(jcurve, group_name, 6, 3)
    pts[2] = getattr(jcurve, group_name).zero()
    aff = mk.ck.encode_points(_to_port(tps.curve, group_name, pts),
                              jacobian=False)
    FW = ext_of(mk.fk) * mk.fk.N
    rows = mk.row_table(aff)
    assert rows.shape == (6, FW) and rows.dtype == torch.int32
    limbs = words_to_limbs(rows.T)                      # (2FW, m)
    assert torch.equal(limbs[:FW].reshape(aff[0].shape)[..., [0, 1, 3]],
                       aff[0][..., [0, 1, 3]])
    assert torch.equal(limbs[FW:].reshape(aff[1].shape)[..., [0, 1, 3]],
                       aff[1][..., [0, 1, 3]])
    assert not bool(rows[2].any())
    signed = mk.row_table(aff, signed=True)
    assert torch.equal(signed[:6], rows)
    neg_y = words_to_limbs(signed[6:].T)[FW:].reshape(aff[1].shape)
    assert torch.equal(neg_y[..., 4], mk.fk.neg(aff[1])[..., 4])
    assert not bool(signed[8].any())


@pytest.mark.parametrize("curve_name,group_name,m,c,case", [
    ("alt_bn128", "G1", 64, 5, "deep bucket"),
    ("alt_bn128", "G2", 24, 4, ""),
    ("alt_bn128", "G1", 24, 2, "carry window"),
    ("bls12_377", "G1", 24, 4, "")])
def test_packed_msm_matches_host_oracle(curve_name, group_name, m, c, case):
    jcurve, tps = _system(curve_name)
    group = getattr(jcurve, group_name)
    pts, ks, rng = _host_points(jcurve, group_name, m, m + c)
    scalars = [rng.randrange(jcurve.r) for _ in range(m)]
    pts[1], ks[1] = group.zero(), 0                # infinity row
    scalars[2] = 0                                 # zero scalar
    scalars[3] = jcurve.r - 1                      # negative digits, carries
    for i in range(4, min(m, 24)):                 # one deep bucket,
        pts[i], ks[i], scalars[i] = pts[4], ks[4], scalars[4]   # P == Q
    want = group.one() * (sum(k * s for k, s in zip(ks, scalars)) % jcurve.r)
    mk = tps.msm_g1 if group_name == "G1" else tps.msm_g2
    sc = tps.scalars_to_dev(scalars)
    seg = mk.bucket_segments(sc, c)
    counts = seg["seg_count"]
    assert int((counts == 1).sum()) > 0
    if case == "deep bucket":                      # 20 rows, cut at 16
        assert int(counts.max()) == max(16, 2 * -(-m // (1 << (c - 1))))
    digits, signs = mk.signed_digits(sc, c)
    assert bool(signs.any())
    if case == "carry window":
        assert mk.scalar_bits == c * (digits.shape[0] - 1)
        assert int(digits[-1].sum()) > 0
    aff = mk.ck.encode_points(_to_port(tps.curve, group_name, pts),
                              jacobian=False)
    out = msm_host_scalars(mk, aff, scalars, jcurve.r, c)
    got = mk.ck.decode_points(out, getattr(tps.curve, group_name))[0]
    assert _coords(got) == _coords(want)


def test_segments_in_length_order():
    """seg_order lists every segment once, longest first, ties in segment
    order; the plain reduce gives the same per-segment sums whatever order
    it is handed."""
    jcurve, tps = _system("alt_bn128")
    mk = tps.msm_g1
    pts, _, rng = _host_points(jcurve, "G1", 48, 9)
    scalars = [rng.randrange(jcurve.r) for _ in range(48)]
    scalars[10:40] = [scalars[10]] * 30
    seg = mk.bucket_segments(tps.scalars_to_dev(scalars), 5)
    counts, order = seg["seg_count"], seg["seg_order"]
    assert sorted(order.tolist()) == list(range(counts.numel()))
    c = counts[order].tolist()
    assert c == sorted(c, reverse=True)
    for a, b in zip(order.tolist(), order.tolist()[1:]):
        assert counts[a] > counts[b] or a < b
    aff = mk.ck.encode_points(_to_port(tps.curve, "G1", pts), jacobian=False)
    args = (mk.row_table(aff), seg["gidx"], seg["seg_start"], counts)
    base = bucket_reduce(mk.fk, *args)
    for o in (order, torch.flip(order, [0])):
        assert all(torch.equal(x, y)
                   for x, y in zip(bucket_reduce(mk.fk, *args, o), base))


def test_work_counts_read_and_reset():
    """The wrappers' work counters (a bucket_reduce count is a device
    scalar) read as ints and reset with the launch counts."""
    from libsnark_tpu_torch.ops import (cuda_bucket, cuda_ec,
                                        launch_counts, reset_launch_counts,
                                        work_counts)
    key = "bucket_reduce_fp_n24"
    cuda_bucket.WORK[key] += torch.tensor([3, 4]).sum()
    cuda_ec.WORK["add_fp_n16"] += 7
    cuda_ec.LAUNCHES["add_fp_n16"] += 1
    got = work_counts()
    assert got[key] == 7 and got["add_fp_n16"] == 7
    assert all(type(v) is int for v in got.values())
    reset_launch_counts()
    assert not any(work_counts().values())
    assert not any(launch_counts().values())
