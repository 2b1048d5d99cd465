"""Pippenger bucket reduce and Horner window combine: the CUDA kernels and
their plain versions.

``bucket_reduce`` replaces the Pallas TPU kernel
``libsnark_tpu/ops/pallas_bucket.py:_build_bucket_reduce``; ``horner_combine``
replaces ``_build_horner`` in the same file. Both run for G1 (ext = 1) and
G2 over Fp2 (ext = 2).

bucket_reduce (csrc/bucket.cu): one thread per segment (a bounded piece of
a bucket's run of the per-window sorted signed index list) walks its
indices, gathers each point's row from the packed (m, FW) row table of
``MSMKernel.row_table`` (32-bit words, half the bytes of 16-bit limbs; no
(W*m, FW) copy of rows is made), negates y for a negative digit, skips
rows with y == 0 (the point at infinity) and accumulates with madd,
repairing P == Q in-thread. Threads take the segments in the given order
(longest first from ``bucket_segments``) so that a warp's threads walk
runs of about the same length; every segment's sum goes to its own output
column, so the order changes no result. The next row is staged in shared
memory with cp.async while the current madd runs. Bound on the card: madd
field products (11 per row for G1, 33 base products for G2), i.e. integer
multiply throughput; a row is 4 FW bytes. Nothing carries across blocks:
deterministic sums.

horner_combine: sum_w 2^(c w) S_w MSB first (c doublings and one add per
window), a chain of (W - 1)(c + 1) group operations whose critical path is
(W - 1)(3 c + 5) dependent base-field products (``DEPTH``): latency, not
throughput, bounds it. One block runs the chain with its field elements in
shared memory; the independent products of each level of dbl and add run
at once, each on a group of 8 or 16 lanes (the lane-split Montgomery
product of csrc/field.cuh, one word a lane), and the additions between the
levels run one word a lane too.

dbl_chain: the bases 2^(c w) G of a fixed-base window table (the JAX
package's ``window_table`` scan, one Pallas dbl of c reps a window), c (W -
1) dependent doublings in one launch of one block: horner_combine's lane
form and doubling, each base stored as it is reached. Its bound is the
chain's latency, 3 levels of dependent products a doubling (``DEPTH``).

The plain versions run the same sequence of group operations with torch
ops over plain field products, so kernel and plain results are equal
limb for limb, Jacobian coordinates included. On the CPU, for a few
lanes, the plain Horner chain runs the same formulas on Python integers
(ops/int_lanes.py): a torch call a field operation of one lane would
otherwise take most of a small prove.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .cuda_ec import (add_formula, add_plain, counter_key, counter_keys,
                      dbl_formula, dbl_plain, ext_of, lead_of, madd_plain,
                      width_args)
from .cuda_fp import small_lanes
from .int_lanes import on_lanes
from .limbs import words_to_limbs

LAUNCHES = dict.fromkeys(counter_keys(("bucket_reduce", "horner_combine",
                                       "dbl_chain")), 0)
# the work of those launches: bucket_reduce madd rows (a device scalar, so
# that counting never waits for the card), horner_combine products of the
# coordinate field, (W - 1)(7 c + 16) for c doublings and one add a window;
# dbl_chain doublings, c (W - 1)
WORK = dict.fromkeys(LAUNCHES, 0)
# the chains' critical path in dependent base-field products: dbl is 3
# levels of independent products, add 5; horner_combine (W - 1)(3 c + 5) a
# launch, dbl_chain 3 c (W - 1)
DEPTH = dict.fromkeys(LAUNCHES, 0)


def _field_view(fk, a):
    """(FW, ...) rows -> the field kernel's (N, ...) / (ext, N, ...)
    shape."""
    return a.reshape(lead_of(fk) + tuple(a.shape[1:]))


def bucket_reduce_plain(fk, rows, gidx, starts, counts, order=None):
    """Per-segment Jacobian sums, one madd round per row depth over the
    segments that reach it (a segment past its count keeps its sum, as the
    kernel's thread does). ``order`` (which thread takes which segment)
    changes nothing here."""
    FW = ext_of(fk) * fk.N
    m = rows.shape[0]
    nb = counts.shape[0]
    dev = rows.device
    zero = fk.zeros((nb,), dev)
    one = fk.one((nb,), dev)
    acc = (one, one, zero)
    counts64 = counts.to(torch.int64)
    maxc = int(counts64.max()) if nb else 0
    starts = starts.to(torch.int64)
    for k in range(maxc):
        sel = torch.nonzero(counts64 > k).reshape(-1)   # the live segments
        g = gidx[starts[sel] + k].to(torch.int64)
        neg = g >= m
        i = torch.where(neg, g - m, g)
        r = words_to_limbs(rows[i].T)                 # (2FW, live) limbs
        x = _field_view(fk, r[:FW])
        y = _field_view(fk, r[FW:])
        q_inf = fk.is_zero(y)
        y = fk.select(neg, fk.as_plain().neg(y), y)
        out = madd_plain(fk, tuple(a[..., sel] for a in acc), (x, y, q_inf))
        acc = tuple(a.index_copy(a.dim() - 1, sel, o)
                    for a, o in zip(acc, out))
    return tuple(a.reshape(FW, nb) for a in acc)


def bucket_reduce(fk, rows, gidx, starts, counts, order=None):
    """Reduce segments of bucket runs to one Jacobian point each.

    rows:   (m, FW) int32 packed row table [x words | y words] of
            ``MSMKernel.row_table`` (Fp2 rows are [x0 x1 | y0 y1]); y == 0
            marks the point at infinity
    gidx:   (W*m,) int32 signed row indices idx + sign*m, sorted per window
    starts: (nb,) int64 offset of each segment in gidx
    counts: (nb,) int32 segment lengths (0 for never-used buckets)
    order:  (nb,) int64 segment ids, the one thread t takes (default
            0 .. nb - 1); the sums do not depend on it
    Returns (X, Y, Z), each (FW, nb) int32: column s is segment s's sum.
    """
    if not rows.is_cuda:
        return bucket_reduce_plain(fk, rows, gidx, starts, counts, order)
    FW = ext_of(fk) * fk.N
    m, width = rows.shape
    if width != FW or rows.dtype != torch.int32:
        raise ValueError("bucket_reduce: rows must be the (m, FW) int32 "
                         "packed row table")
    rows = rows.contiguous()
    gidx = gidx.to(torch.int32).contiguous()
    starts = starts.to(torch.int64).contiguous()
    counts = counts.to(torch.int32).contiguous()
    nb = counts.shape[0]
    if order is not None:
        order = order.to(torch.int64).contiguous()
        if order.shape != (nb,):
            raise ValueError("bucket_reduce: order must list the nb segments")
    outs = [torch.empty((FW, nb), dtype=torch.int32, device=rows.device)
            for _ in range(3)]
    code = cuda_lib.lib("bucket").lsn_bucket_reduce(
        *width_args(fk), rows.data_ptr(), m, gidx.data_ptr(),
        starts.data_ptr(), counts.data_ptr(),
        None if order is None else order.data_ptr(), nb,
        *[o.data_ptr() for o in outs], ctypes.addressof(fk.mod),
        cuda_lib.stream_ptr(rows))
    cuda_lib.check(code, "bucket_reduce")
    LAUNCHES[counter_key("bucket_reduce", fk)] += 1
    WORK[counter_key("bucket_reduce", fk)] += counts.sum(dtype=torch.int64)
    return tuple(outs)


def _horner_chain(W: int, c: int):
    """The Horner chain over one lane's W window sums (v: X, Y, Z of each
    window in turn), for int_lanes.on_lanes."""
    def chain(F, v, m):
        acc = tuple(v[3 * (W - 1):])
        for w in range(W - 2, -1, -1):
            for _ in range(c):
                acc = dbl_formula(F, acc)
            acc = add_formula(F, acc, tuple(v[3 * w:3 * w + 3]))
        return acc
    return chain


def horner_combine_plain(fk, S, c: int):
    """The same chain with torch ops. S: (X, Y, Z) of shape (FW, W), or
    (FW, W, B) for B independent combines at once (one column each);
    returns (FW, 1), or (FW, B). On the CPU, for a few lanes, on Python
    integers (the same formulas, the same limbs)."""
    FW = ext_of(fk) * fk.N
    W = S[0].shape[1]
    batch = S[0].shape[2:]
    if small_lanes(S[0]):
        out = on_lanes(fk, _horner_chain(W, c), [
            _field_view(fk, a[:, w]) for w in range(W) for a in S])
        if out is not None:
            return tuple(a.reshape(FW, -1) for a in out)
    pt = lambda w: tuple(_field_view(fk, a[:, w:w + 1] if not batch
                                     else a[:, w]) for a in S)
    acc = pt(W - 1)
    for w in range(W - 2, -1, -1):
        acc = dbl_plain(fk, acc, c)
        acc = add_plain(fk, acc, pt(w))
    return tuple(a.reshape(FW, -1) for a in acc)


def horner_combine(fk, S, c: int):
    """S: (X, Y, Z) of shape (FW, W), window 0 = LSB. Returns
    sum_w 2^(c w) S_w as (FW, 1) coordinate tensors."""
    if not S[0].is_cuda:
        return horner_combine_plain(fk, S, c)
    FW = ext_of(fk) * fk.N
    S = [a.to(torch.int32).contiguous() for a in S]
    W = S[0].shape[-1]
    if S[0].shape[0] != FW or W < 1 or c < 0:
        raise ValueError("horner_combine: S must be (FW, W) tensors, W >= 1, "
                         "c >= 0")
    outs = [torch.empty((FW, 1), dtype=torch.int32, device=S[0].device)
            for _ in range(3)]
    code = cuda_lib.lib("bucket").lsn_horner(
        *width_args(fk), *[a.data_ptr() for a in S], W, c,
        *[o.data_ptr() for o in outs], ctypes.addressof(fk.mod),
        cuda_lib.stream_ptr(S[0]))
    cuda_lib.check(code, "horner_combine")
    key = counter_key("horner_combine", fk)
    LAUNCHES[key] += 1
    WORK[key] += (W - 1) * (7 * c + 16)
    DEPTH[key] += (W - 1) * (3 * c + 5)
    return tuple(outs)


def dbl_chain_plain(fk, P, c: int, W: int):
    """The same bases with torch ops: c plain doublings a window."""
    gs = [P]
    for _ in range(W - 1):
        gs.append(dbl_plain(fk, gs[-1], c))
    return tuple(torch.cat([g[k] for g in gs], dim=-1) for k in range(3))


def dbl_chain(fk, P, c: int, W: int):
    """The bases of a fixed-base window table: P, 2^c P, ..., 2^(c (W - 1))
    P, ONE launch on the card. P: one Jacobian point (batch (1,)); returns
    Jacobian (X, Y, Z) with batch (W,), column w = 2^(c w) P."""
    FW = ext_of(fk) * fk.N
    lead = lead_of(fk)
    if (len(P) != 3 or any(a.shape != lead + (1,) or a.dtype != torch.int32
                           for a in P) or W < 1 or c < 0):
        raise ValueError(f"dbl_chain takes one Jacobian point (int32 "
                         f"coordinates of shape {lead + (1,)}), W >= 1 and "
                         "c >= 0")
    if not P[0].is_cuda:
        return dbl_chain_plain(fk, P, c, W)
    flat = [a.reshape(FW, 1).contiguous() for a in P]
    outs = [torch.empty((FW, W), dtype=torch.int32, device=P[0].device)
            for _ in range(3)]
    code = cuda_lib.lib("bucket").lsn_dbl_chain(
        *width_args(fk), *[a.data_ptr() for a in flat], W, c,
        *[o.data_ptr() for o in outs], ctypes.addressof(fk.mod),
        cuda_lib.stream_ptr(outs[0]))
    cuda_lib.check(code, "dbl_chain")
    key = counter_key("dbl_chain", fk)
    LAUNCHES[key] += 1
    WORK[key] += c * (W - 1)
    DEPTH[key] += 3 * c * (W - 1)
    return tuple(o.reshape(lead + (W,)) for o in outs)
