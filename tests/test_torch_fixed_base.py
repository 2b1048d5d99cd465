"""The port's fixed-base scan against the JAX package's.

``MSMKernel.batch_exp`` of the port (one ``madd_windows`` launch on the
card; on these CPU tensors its plain version, the per-window madd loop over
the packed row table) and of the JAX package (a ``lax.scan`` of madds) get
the same affine window table and the same scalar limbs, and must give the
same Jacobian limbs (tolerance 0: every value is canonical). The table is
built once per (curve, group, c) with the JAX package's host curve and
encoder, and its numpy limbs go to both sides, so only the scan is
compared.

Planted scalars: 0, 1, r - 1, 2^c - 1 in every window (all 256 bits set),
digit 0 in every odd and in every even window, only the top window
nonzero; the rest random below r. c = 6 puts digits across two limbs and a
last window past the last limb.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.proof_systems.base import PairingSystem as JaxPairing

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.ops import cuda_ec
from libsnark_tpu_torch.ops.limbs import from_torch, ints_to_limbs, to_torch
from libsnark_tpu_torch.proof_systems.base import PairingSystem

M = 64
NL = 16                    # scalar limbs of both curves' r


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    """(curve, group, c) -> (JAX system, port system, numpy affine table
    (x, y, inf) with batch (W, 2^c)), each built once."""
    systems, built = {}, {}

    def get(curve, group_name, c):
        if curve not in systems:
            systems[curve] = (JaxPairing(jax_get_curve(curve)),
                              PairingSystem(get_curve(curve), device="cpu"))
        jps, tps = systems[curve]
        key = (curve, group_name, c)
        if key not in built:
            group = getattr(jps.curve, group_name)
            jck = jps.g1 if group_name == "G1" else jps.g2
            W = -(-jps.curve.r.bit_length() // c)
            pts, base = [], group.one()
            for _ in range(W):                 # row w: j 2^(c w) base
                acc = group.zero()
                row = [acc]
                for _ in range((1 << c) - 1):
                    acc = acc + base
                    row.append(acc)
                pts += row
                base = acc + base
            x, y, inf = (np.asarray(a) for a in
                         jck.encode_points(pts, jacobian=False))
            shape = lambda a: a.reshape(a.shape[:-1] + (W, 1 << c))
            built[key] = (jps, tps, (shape(x), shape(y), shape(inf)))
        return built[key]
    return get


def _planted_scalars(r: int, c: int, W: int, seed: int):
    rng = random.Random(seed)
    full = (1 << (NL * 16)) - 1
    digits = lambda keep: sum(rng.randrange(1, 1 << c) << (c * w)
                              for w in range(W) if keep(w)) & full
    top = ((rng.randrange(1 << c) | 1) << (c * (W - 1))) & full
    xs = [0, 1, r - 1, full, digits(lambda w: w % 2 == 0),
          digits(lambda w: w % 2 == 1), top or 1 << (NL * 16 - 1)]
    return xs + [rng.randrange(r) for _ in range(M - len(xs))]


CASES = [("alt_bn128", "G1", 4), ("alt_bn128", "G1", 8),
         ("alt_bn128", "G1", 6), ("alt_bn128", "G2", 4),
         ("alt_bn128", "G2", 8), ("bls12_377", "G1", 4),
         ("bls12_377", "G1", 8)]


@pytest.mark.parametrize("curve,group_name,c", CASES)
def test_batch_exp_matches_jax(tables, curve, group_name, c):
    jps, tps, (x, y, inf) = tables(curve, group_name, c)
    jmk = jps.msm_g1 if group_name == "G1" else jps.msm_g2
    tmk = tps.msm_g1 if group_name == "G1" else tps.msm_g2
    W = x.shape[-2]
    sc = ints_to_limbs(_planted_scalars(jps.curve.r, c, W, seed=c), NL)
    want = jmk.batch_exp((jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf)),
                         jnp.asarray(sc), c)
    taff = (to_torch(x, "cpu"), to_torch(y, "cpu"), to_torch(inf, "cpu"))
    got = tmk.batch_exp(taff, to_torch(sc, "cpu"), c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(from_torch(g), np.asarray(w))
    # the windowed form reads the packed rows; the per-window loop the
    # affine table: the same scan
    for g, w in zip(tmk.batch_exp_loop(taff, to_torch(sc, "cpu"), c), got):
        assert torch.equal(g, w)
    # lanes 0 (scalar 0) and 1 (scalar 1): infinity as (1, 1, 0), the base
    assert not bool(got[2][..., 0].any())
    assert not bool(tmk.fk.is_zero(got[2])[1:].any())


@pytest.mark.parametrize("curve,group_name", [("alt_bn128", "G1"),
                                              ("alt_bn128", "G2"),
                                              ("bls12_377", "G1")])
def test_fixed_base_rows_round_trip(tables, curve, group_name):
    """The packed rows of a window table hold its affine limbs, row
    w 2^c + j = T[w, j], and zero rows exactly at its infinity lanes."""
    c = 4
    _, tps, (x, y, inf) = tables(curve, group_name, c)
    tmk = tps.msm_g1 if group_name == "G1" else tps.msm_g2
    taff = (to_torch(x, "cpu"), to_torch(y, "cpu"), to_torch(inf, "cpu"))
    rows = tmk.fixed_base_rows(taff)
    W = x.shape[-2]
    assert rows.shape == (W << c, x.size // (W << c))     # FW words
    bx, by, binf = cuda_ec.table_from_rows(tmk.fk, rows, c)
    assert torch.equal(binf, taff[2])
    assert bool(binf[:, 0].all()) and not bool(binf[:, 1:].any())
    live = ~taff[2]
    assert torch.equal(bx[..., live], taff[0][..., live])
    assert torch.equal(by[..., live], taff[1][..., live])
    assert not bool(bx[..., ~live].any()) and not bool(by[..., ~live].any())


def test_madd_windows_argument_checks(tables):
    _, tps, (x, y, inf) = tables("alt_bn128", "G1", 4)
    mk = tps.msm_g1
    rows = mk.fixed_base_rows((to_torch(x, "cpu"), to_torch(y, "cpu"),
                               to_torch(inf, "cpu")))
    sc = to_torch(ints_to_limbs([1, 2], NL), "cpu")
    with pytest.raises(ValueError, match="window bits"):
        cuda_ec.madd_windows(mk.fk, rows, sc, 17)
    with pytest.raises(ValueError, match="row table"):
        cuda_ec.madd_windows(mk.fk, rows[:-1], sc, 4)
    with pytest.raises(ValueError, match="row table"):
        cuda_ec.madd_windows(mk.fk, rows, sc.to(torch.int64), 4)
