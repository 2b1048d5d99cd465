"""The port's dense-bucket MSM strategy (``MSMKernel(ck, bits,
strategy="dense")``: aadd at level 0 of the bucket tree, then the add tree,
a chunk loop for deep buckets, a shape of its own for each partial top
window) against the JAX package under LIBSNARK_TPU_MSM_DENSE=1, the host
oracle and the port's default strategy. Affine results are canonical, so
every comparison is exact (tolerance 0).

Inputs are those of tests/test_msm_ntt.py::test_msm_g1_dense_path: a
duplicate point with the same scalar (level 0 hits its P == Q case), an
infinity base, a zero scalar and an all-equal tail that makes one bucket
deeper than the chunk depth. On CPU tensors the port runs the kernels'
plain versions.
"""
import random

import pytest
import torch

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.curves.host_ec import multi_scalar_mul
from libsnark_tpu.ops.ec import CurveKernel as JaxCurve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.fp2 import Fp2Kernel as JaxFp2
from libsnark_tpu.ops.msm import MSMKernel as JaxMSM
from libsnark_tpu.ops.msm import msm_host_scalars as jax_msm_host_scalars

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops import cuda_ec
from libsnark_tpu_torch.ops.msm import MSMKernel, msm_host_scalars
from libsnark_tpu_torch.proof_systems.base import PairingSystem

M, C = 64, 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    return PairingSystem(get_curve("alt_bn128"), device="cpu")


def _inputs(curve, group_name, m=M, seed=33):
    """Host points and scalars with the adversarial cases planted."""
    group = getattr(curve, group_name)
    rng = random.Random(seed)
    pts = [group.one() * rng.randrange(1, curve.r) for _ in range(m)]
    pts[7] = pts[6]                       # duplicate point
    pts[9] = group.zero()                 # infinity base
    scalars = [rng.randrange(curve.r) for _ in range(m)]
    scalars[7] = scalars[6]               # same digits -> same buckets
    scalars[3] = 0
    for j in range(20, 32):               # deep single bucket
        pts[j], scalars[j] = pts[20], scalars[20]
    return pts, scalars


def _coords(P):
    if P.is_zero():
        return None
    if hasattr(P.x, "c0"):
        return (int(P.x.c0), int(P.x.c1), int(P.y.c0), int(P.y.c1))
    return (int(P.x), int(P.y))


def _kernels(system, group_name, strategy):
    ck = system.g1 if group_name == "G1" else system.g2
    return ck, MSMKernel(ck, system.curve.r.bit_length(), strategy=strategy)


@pytest.fixture(scope="module", params=["G1", "G2"])
def dense_run(request, system):
    """One dense MSM of the port per group, with its aadd launch check."""
    group_name = request.param
    pts, scalars = _inputs(system.curve, group_name)
    ck, mk = _kernels(system, group_name, "dense")
    aff = ck.encode_points(pts, jacobian=False)
    out = msm_host_scalars(mk, aff, scalars, system.curve.r, C)
    got = ck.decode_points(out, getattr(system.curve, group_name))[0]
    return dict(group=group_name, pts=pts, scalars=scalars, got=got, aff=aff)


def test_dense_msm_matches_jax_dense(dense_run, monkeypatch):
    monkeypatch.setenv("LIBSNARK_TPU_MSM_DENSE", "1")
    jc = jax_get_curve("alt_bn128")
    group_name = dense_run["group"]
    jpts, jscalars = _inputs(jc, group_name)
    assert jscalars == dense_run["scalars"]
    jfq = JaxFp(jc.fq_params)
    jfk = jfq if group_name == "G1" else JaxFp2(jfq, int(jc.Fq2.NON_RESIDUE))
    jck = JaxCurve(jfk, group_name)
    jmk = JaxMSM(jck, jc.r.bit_length())
    out = jax_msm_host_scalars(jmk, jck.encode_points(jpts, jacobian=False),
                               jscalars, jc.r, c=C)
    want = jck.decode_points(out, getattr(jc, group_name))[0]
    assert _coords(dense_run["got"]) == _coords(want)
    assert _coords(want) == _coords(multi_scalar_mul(jpts, jscalars))


def test_dense_msm_matches_host_oracle(dense_run):
    acc = dense_run["pts"][0] * 0
    for P, s in zip(dense_run["pts"], dense_run["scalars"]):
        acc = acc + P * s
    assert dense_run["got"] == acc


def test_dense_window_sums_equal_default_strategy(dense_run, system,
                                                  monkeypatch):
    """Window by window, as affine points (the Jacobian triples differ);
    a chunk depth of 4 forces the chunk loop through the 12-deep bucket."""
    group_name = dense_run["group"]
    ck, dense = _kernels(system, group_name, "dense")
    _, default = _kernels(system, group_name, "segments")
    sc = system.scalars_to_dev(dense_run["scalars"])
    lanes = lambda S: tuple(a.movedim(0, -2) for a in S)     # (.., W, 1)
    want = ck.to_affine(lanes(default.window_sums(dense_run["aff"], sc, C)))
    for depth in ((None, 4) if group_name == "G1" else (4,)):
        if depth:
            monkeypatch.setattr(dense, "dense_depth", lambda *a: depth)
        got = ck.to_affine(lanes(dense.window_sums_dense(
            dense_run["aff"], sc, C)))
        assert torch.equal(got[2], want[2])
        live = ~want[2]
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a[..., live], b[..., live])


def test_dense_partial_top_window_and_small_m(system):
    """c = 6 leaves a 2-bit partial top window with its own bucket count
    (6) and depth (254 = 42 * 6 + 2); m = 33 is no power of two."""
    curve = system.curve
    pts, scalars = _inputs(curve, "G1", m=33, seed=5)
    scalars[4] = curve.r - 1
    ck, dense = _kernels(system, "G1", "dense")
    aff = ck.encode_points(pts, jacobian=False)
    out = msm_host_scalars(dense, aff, scalars, curve.r, 6)
    acc = curve.G1.zero()
    for P, s in zip(pts, scalars):
        acc = acc + P * s
    assert ck.decode_points(out, curve.G1)[0] == acc


def test_dense_depth_is_even_and_capped(system):
    _, g1 = _kernels(system, "G1", "dense")
    _, g2 = _kernels(system, "G2", "dense")
    for mk in (g1, g2):
        for m, c in ((64, 5), (1 << 16, 11), (1 << 20, 15)):
            B, W = 1 << (c - 1), mk.num_windows(c)
            R = mk.dense_depth(m, B, W * B, W * (B + 1))
            assert R % 2 == 0 and 8 <= R <= max(m, 16)
    # at 2^20 the memory cap, not the occupancy bound, sets the depth,
    # and the wider G2 rows get the shallower chunks
    c = 15
    lanes = g1.num_windows(c) * ((1 << (c - 1)) + 1)
    args = (1 << 20, 1 << (c - 1), lanes, lanes)
    assert g2.dense_depth(*args) <= g1.dense_depth(*args) < 126


def test_strategy_argument_is_checked(system):
    with pytest.raises(ValueError, match="unknown MSM strategy"):
        MSMKernel(system.g1, 254, strategy="rake")
    with pytest.raises(ValueError, match="unknown MSM strategy"):
        PairingSystem(system.curve, device="cpu", msm_strategy="fused")
    assert system.msm_g1.strategy == "segments"
    assert PairingSystem(system.curve, device="cpu",
                         msm_strategy="dense").msm_g2.strategy == "dense"


def test_aadd_infinity_order_and_repair(system):
    """i2 lifts P, i1 lifts Q, both give (x2, y2, 0); P == Q doubles."""
    ck = system.g1
    curve = system.curve
    G = curve.G1.one()
    Ph = [G * 3, curve.G1.zero(), G * 5, curve.G1.zero(), G * 7, G * 9]
    Qh = [curve.G1.zero(), G * 4, G * 5, curve.G1.zero(), -(G * 7), G * 2]
    Pa = ck.encode_points(Ph, jacobian=False)
    Qa = ck.encode_points(Qh, jacobian=False)
    X, Y, Z = cuda_ec.aadd_plain(ck.fk, Pa, Qa)
    one = ck.fk.one((1,))
    assert torch.equal(X[:, 0], Pa[0][:, 0]) and torch.equal(Z[:, 0:1], one)
    assert torch.equal(X[:, 1], Qa[0][:, 1]) and torch.equal(Z[:, 1:2], one)
    assert torch.equal(X[:, 3], Qa[0][:, 3]) and not Z[:, 3].any()
    assert not Z[:, 4].any()                       # P == -Q
    got = ck.decode_points((X, Y, Z), curve.G1)
    assert got == [P + Q for P, Q in zip(Ph, Qh)]
    want_dbl = cuda_ec.dbl_plain(ck.fk, (Pa[0][:, 2:3], Pa[1][:, 2:3], one))
    for a, b in zip((X, Y, Z), want_dbl):
        assert torch.equal(a[:, 2:3], b)
