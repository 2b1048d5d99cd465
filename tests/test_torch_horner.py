"""Port's Horner window combine vs the JAX package's, and the word-level
model of the lane-split Montgomery product vs the JAX package's product.

``MSMKernel.combine_windows`` (one ``horner_combine`` a call; on CPU
tensors its plain version) and ``horner_combine_plain`` over a batch of
chains go against the JAX package's ``MSMKernel.combine_windows`` (its scan
path on the CPU, jitted once per group) on the same seeded window sums:
Jacobian points with random Z, W = 5 windows of c = 4 bits, with an
infinity window in the middle, an infinity top window, a step that meets
P == Q (S_3 = 2^4 S_4) and a sum at infinity. The decoded affine points
must be equal (exact: every value is canonical).

``probes.mont_mul_lanes_plain`` models csrc/field.cuh's fp_mul_lanes word
by word (lanes as a tensor axis, shuffles as shifts, votes as bit masks);
it must equal the JAX package's ``FpKernel.mul`` at 16 and 24 limbs,
edge values included. The kernel itself is held against the plain product
on the card (tests/test_torch_gpu.py).
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.proof_systems.base import PairingSystem as JaxPairing

from libsnark_tpu_torch import get_curve, probes
from libsnark_tpu_torch.ops.cuda_bucket import horner_combine_plain
from libsnark_tpu_torch.ops.fp import FpKernel
from libsnark_tpu_torch.ops.limbs import from_torch, ints_to_limbs, to_torch
from libsnark_tpu_torch.proof_systems.base import PairingSystem

W, C = 5, 4
CASES = ["random", "infinity window", "infinity top window",
         "P == Q at the first add", "sum at infinity"]
GROUPS = [("alt_bn128", "G1"), ("alt_bn128", "G2"), ("bls12_377", "G1")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(group, r, seed):
    """The planted window sums of every case, host points (window 0 first)."""
    rng = random.Random(seed)
    G = group.one()
    rnd = lambda: [G * rng.randrange(1, r) for _ in range(W)]
    out = {"random": rnd()}
    pts = rnd()
    pts[W // 2] = group.zero()
    out["infinity window"] = pts
    pts = rnd()
    pts[W - 1] = group.zero()
    out["infinity top window"] = pts
    pts = rnd()
    pts[W - 2] = pts[W - 1] * (1 << C)
    out["P == Q at the first add"] = pts
    pts = rnd()
    rest = group.zero()
    for w in range(1, W):
        rest = rest + pts[w] * (1 << (C * w))
    pts[0] = -rest
    out["sum at infinity"] = pts
    return out


def _coords(P):
    if P.is_zero():
        return None
    if hasattr(P.x, "c0"):
        return (int(P.x.c0), int(P.x.c1), int(P.y.c0), int(P.y.c1))
    return (int(P.x), int(P.y))


@pytest.fixture(scope="module", params=GROUPS,
                ids=[f"{c}-{g}" for c, g in GROUPS])
def combined(request):
    """Per group: the windows of every case as numpy Jacobian limbs (random
    Z), the JAX package's combined points and the port's systems."""
    curve_name, gname = request.param
    jps = JaxPairing(jax_get_curve(curve_name))
    tps = PairingSystem(get_curve(curve_name), device="cpu")
    jck, jmk = (jps.g1, jps.msm_g1) if gname == "G1" else (jps.g2, jps.msm_g2)
    tck = tps.g1 if gname == "G1" else tps.g2
    jgroup = getattr(jps.curve, gname)
    fk = tck.fk
    gen = np.random.default_rng(17)
    combine = jax.jit(lambda *S: jmk.combine_windows(S, C))
    out = {}
    for k, (label, pts) in enumerate(_windows(jgroup, jps.curve.r,
                                              len(CASES) * 3).items()):
        X, Y, Z = (to_torch(np.asarray(a), "cpu") for a in
                   jck.encode_points(pts))
        base = fk.fp if hasattr(fk, "fp") else fk
        ext = X.numel() // (base.N * W)
        z = base.encode([int(v) % (base.p - 1) + 1 for v in
                         gen.integers(1, 1 << 62, size=ext * W)])
        z = z.reshape(base.N, ext, W).movedim(1, 0).reshape(X.shape)
        z2 = fk.sqr(z)
        S = [fk.mul(X, z2), fk.mul(Y, fk.mul(z2, z)), fk.mul(Z, z)]
        S = [from_torch(a) for a in S]            # (N, W) or (2, N, W)
        jS = tuple(jnp.asarray(np.moveaxis(a, -1, 0)[..., None]) for a in S)
        want = jck.decode_points(combine(*jS), jgroup)[0]
        out[label] = (S, _coords(want), pts)
    return tps, gname, out


@pytest.mark.parametrize("case", CASES)
def test_combine_windows_matches_jax(combined, case):
    tps, gname, cases = combined
    S, want, pts = cases[case]
    tck, tmk = (tps.g1, tps.msm_g1) if gname == "G1" else (tps.g2, tps.msm_g2)
    tgroup = getattr(tps.curve, gname)
    tS = tuple(torch.from_numpy(np.moveaxis(a, -1, 0)[..., None]
                                .astype(np.int32)) for a in S)   # (W, .., 1)
    got = tck.decode_points(tmk.combine_windows(tS, C), tgroup)[0]
    assert _coords(got) == want
    if case == "sum at infinity":
        assert want is None
    if case in ("P == Q at the first add", "random"):
        assert want is not None


def test_horner_plain_batch_matches_jax(combined):
    """horner_combine_plain over all cases of a group at once, one chain a
    column, against the JAX package's points."""
    tps, gname, cases = combined
    tck = tps.g1 if gname == "G1" else tps.g2
    tgroup = getattr(tps.curve, gname)
    fk = tck.fk
    FW = fk.N * (2 if hasattr(fk, "fp") else 1)
    batch = tuple(torch.stack([torch.from_numpy(
        cases[c][0][i].astype(np.int32)).reshape(FW, W) for c in CASES], -1)
        for i in range(3))
    out = horner_combine_plain(fk, batch, C)
    shape = (2, fk.N, len(CASES)) if FW != fk.N else (fk.N, len(CASES))
    got = tck.decode_points(tuple(a.reshape(shape) for a in out), tgroup)
    assert [_coords(P) for P in got] == [cases[c][1] for c in CASES]


def _edge_ints(p, nw, n, seed):
    """0, 1, p - 1, R mod p, words of all ones (below p), then random."""
    rng = random.Random(seed)
    ones = (1 << (32 * (nw - 1))) - 1
    return ([0, 1, p - 1, (1 << (32 * nw)) % p, ones, ones >> 1,
             p - 1 - ones] + [rng.randrange(p) for _ in range(n - 7)])


@pytest.mark.parametrize("curve_name", ["alt_bn128", "bls12_377"],
                         ids=["N=16", "N=24"])
def test_lane_split_product_model_matches_jax(curve_name):
    jfk = JaxFp(jax_get_curve(curve_name).fq_params)
    tfk = FpKernel(get_curve(curve_name).fq_params, device="cpu")
    nw = tfk.N // 2
    xs = _edge_ints(tfk.p, nw, 64, 1)
    ys = _edge_ints(tfk.p, nw, 64, 2)
    # every pair (x, y), as raw limbs (the words the carries run through)
    a = np.repeat(ints_to_limbs(xs, tfk.N), len(ys), axis=1)
    b = np.tile(ints_to_limbs(ys, tfk.N), (1, len(xs)))
    want = np.asarray(jax.jit(jfk.mul)(jnp.asarray(a), jnp.asarray(b)))
    got = probes.mont_mul_lanes_plain(tfk, to_torch(a, "cpu"),
                                      to_torch(b, "cpu"))
    np.testing.assert_array_equal(from_torch(got), want)
