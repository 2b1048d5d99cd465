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
from libsnark_tpu_torch.ops.msm import MSMKernel
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
    kern = cuda_bucket.bucket_reduce(mk.fk, *args)
    plain = cuda_bucket.bucket_reduce_plain(mk.fk, *args)
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    S = tuple(a[:, :seg["W"]].contiguous() for a in kern)
    hk = cuda_bucket.horner_combine(mk.fk, S, c)
    hp = cuda_bucket.horner_combine_plain(mk.fk, S, c)
    assert all(torch.equal(a, b) for a, b in zip(hk, hp))


@pytest.mark.parametrize("group_name", ["G1", "G2"])
def test_dense_window_sums_equal_default_on_card(system, group_name,
                                                 monkeypatch):
    """The dense strategy (aadd level 0, add tree, chunk loop forced by a
    shallow depth and sixteen equal scalars) gives the default strategy's
    window sums as affine points."""
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
    key = cuda_ec.counter_key("aadd", mk.fk)
    before = cuda_ec.LAUNCHES[key]
    lanes = lambda S: tuple(a.movedim(0, -2) for a in S)   # (.., W, 1)
    want = ck.to_affine(lanes(mk.window_sums(aff, sc, c)))
    assert cuda_ec.LAUNCHES[key] == before
    monkeypatch.setattr(dense, "dense_depth", lambda *a: 4)  # chunk loop
    got = ck.to_affine(lanes(dense.window_sums_dense(aff, sc, c)))
    assert cuda_ec.LAUNCHES[key] > before
    assert torch.equal(got[2], want[2])
    live = ~want[2]
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a[..., live], b[..., live])


def test_probe_kernels_match_plain_on_card(system):
    gen = torch.Generator(device="cuda").manual_seed(3)
    for op in probes.RATE_OPS:
        a, b = probes._rate_inputs(op, 1000, gen)
        assert torch.equal(probes.rate_chain(op, a, b, 37),
                           probes.rate_chain_plain(op, a, b, 37)), op
    for fk in (system.fr, system.fq):
        a = fk.encode(_ints(fk.p, 512, 9))
        b = fk.encode(_ints(fk.p, 512, 10)[::-1])
        want = probes.cios_chain_plain(fk, a, b, 5)
        for variant in probes.CIOS_VARIANTS:
            assert torch.equal(probes.cios_chain(fk, variant, a, b, 5),
                               want), (fk.N, variant)
