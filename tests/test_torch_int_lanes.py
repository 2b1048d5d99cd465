"""The plain versions' integer forms against their limb-column forms.

On the CPU, up to cuda_fp.SMALL_LANES lanes, the plain group law
(cuda_ec.dbl_plain / add_plain / madd_plain), the plain Horner combine
(cuda_bucket.horner_combine_plain) and the generic-a window loop
(MSMKernel.combine_windows_loop) run their formulas on Python integers
(int_lanes). Each must give the limbs of the torch form over the field
kernel -- the form the card kernels are held against -- on lanes and
window sums with planted infinity, P == Q and P == -Q, over Fp, Fp2 and
Fp3, with masks. The torch form is forced by
setting SMALL_LANES to 0 (and a_coeffs to None for the generic-a loop).
"""
import random

import pytest
import torch

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops import cuda_bucket, cuda_fp
from libsnark_tpu_torch.ops.cuda_ec import ext_of
from libsnark_tpu_torch.proof_systems.base import PairingSystem


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(curve, group, ck, seed):
    """Jacobian window sums (W = 7): two equal windows, infinity, P and -P,
    a doubled point; as (X, Y, Z) of shape (W, *lead, 1)."""
    rng = random.Random(seed)
    P = [group.one() * rng.randrange(1, curve.r) for _ in range(3)]
    pts = [P[0], P[0], group.zero(), P[1], -P[1], P[2] * 2, P[2]]
    J = ck.encode_points(pts, device="cpu")
    return tuple(a.movedim(-1, 0).unsqueeze(-1) for a in J)


def _torch_form(fn):
    small = cuda_fp.SMALL_LANES
    cuda_fp.SMALL_LANES = 0
    try:
        return fn()
    finally:
        cuda_fp.SMALL_LANES = small


@pytest.mark.parametrize("curve_name", ["alt_bn128", "bw6_761"])
@pytest.mark.parametrize("which", ["g1", "g2"])
def test_horner_integers_equal_limb_columns(curve_name, which):
    curve = get_curve(curve_name)
    ps = PairingSystem(curve, device="cpu")
    ck = getattr(ps, which)
    group = curve.G1 if which == "g1" else curve.G2
    S = _windows(curve, group, ck, 3)
    FW = ext_of(ck.fk) * ck.fk.N
    flat = tuple(a[..., 0].reshape(a.shape[0], FW).t().contiguous()
                 for a in S)
    for c in (1, 4):
        got = cuda_bucket.horner_combine_plain(ck.fk, flat, c)
        want = _torch_form(lambda: cuda_bucket.horner_combine_plain(
            ck.fk, flat, c))
        for a, b in zip(got, want):
            assert torch.equal(a, b), c


@pytest.mark.parametrize("curve_name,which", [("mnt4", "g1"), ("mnt4", "g2"),
                                              ("mnt6", "g2"),
                                              ("edwards", "g1")])
def test_generic_a_loop_integers_equal_limb_columns(curve_name, which):
    curve = get_curve(curve_name)
    ps = PairingSystem(curve, device="cpu")
    mk = getattr(ps, f"msm_{which}")
    group = curve.G1 if which == "g1" else curve.G2
    S = _windows(curve, group, mk.ck, 5)
    got = mk.combine_windows_loop(S, 3)
    a_coeffs, mk.ck.a_coeffs = mk.ck.a_coeffs, None
    try:
        assert a_coeffs is not None
        want = _torch_form(lambda: mk.combine_windows_loop(S, 3))
    finally:
        mk.ck.a_coeffs = a_coeffs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and the sum itself: sum_w 2^(3 w) S_w on the host
    host = group.zero()
    for w, P in enumerate(mk.ck.decode_points(
            tuple(a[..., 0].movedim(0, -1) for a in S), group)):
        host = host + P * (1 << (3 * w))
    assert mk.ck.decode_points(got, group)[0] == host


@pytest.mark.parametrize("curve_name", ["alt_bn128", "bls12_377"])
@pytest.mark.parametrize("which", ["g1", "g2"])
def test_group_law_integers_equal_limb_columns(curve_name, which):
    from libsnark_tpu_torch.ops import cuda_ec
    curve = get_curve(curve_name)
    ps = PairingSystem(curve, device="cpu")
    ck = getattr(ps, which)
    fk = ck.fk
    group = curve.G1 if which == "g1" else curve.G2
    rng = random.Random(7)
    P = [group.one() * rng.randrange(1, curve.r) for _ in range(4)]
    ps_ = [P[0], P[1], group.zero(), P[2], P[3], group.zero()]
    qs = [P[0], -P[1], P[1], group.zero(), P[0], group.zero()]
    A = ck.encode_points(ps_, device="cpu")
    # P == Q in Jacobian form with Z != 1: A's doubling
    A = tuple(torch.cat([a, b], dim=-1) for a, b in zip(
        A, cuda_ec.dbl_plain(fk, ck.encode_points(P[:2], device="cpu"))))
    B = ck.encode_points(qs + [P[0] * 2, P[1] * 2], device="cpu")
    Baff = ck.encode_points(qs + [P[0] * 2, P[3]], jacobian=False,
                            device="cpu")
    valid = torch.tensor([True, True, False, True, True, True, True, False])
    cases = [
        ("dbl", lambda: cuda_ec.dbl_plain(fk, A, 3)),
        ("add", lambda: cuda_ec.add_plain(fk, A, B)),
        ("madd", lambda: cuda_ec.madd_plain(fk, A, Baff)),
        ("madd valid", lambda: cuda_ec.madd_plain(fk, A, Baff, valid)),
    ]
    for name, fn in cases:
        got, want = fn(), _torch_form(fn)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
