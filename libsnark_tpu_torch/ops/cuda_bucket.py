"""Pippenger bucket reduce and Horner window combine: the CUDA kernels and
their plain versions.

``bucket_reduce`` replaces the Pallas TPU kernel
``libsnark_tpu/ops/pallas_bucket.py:_build_bucket_reduce``; ``horner_combine``
replaces ``_build_horner`` in the same file. Both run for G1 (ext = 1) and
G2 over Fp2 (ext = 2).

bucket_reduce (csrc/bucket.cu): one thread per bucket walks its run of the
per-window sorted signed index list, gathers each point's row from the
(m, 2FW) row table (so no (W*m, 2FW) copy of rows is made), negates y for
a negative digit, skips rows with y == 0 (the point at infinity) and
accumulates with madd, repairing P == Q in-thread. Bound on the card:
madd field products (~11 per point for G1, ~33 base products for G2),
i.e. integer multiply throughput; rows are 8 N (G1) or 16 N (G2) bytes
read once per window. Nothing carries across blocks: deterministic sums.

horner_combine: one thread, sum_w 2^(c w) S_w MSB first (c doublings and
one add per window) -- a latency-bound chain of a few hundred group ops.

The plain versions run the same sequence of group operations with torch
ops over plain field products, so kernel and plain results are equal
limb for limb, Jacobian coordinates included.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .cuda_ec import (add_plain, counter_key, counter_keys, dbl_plain,
                      ext_of, madd_plain)

LAUNCHES = dict.fromkeys(counter_keys(("bucket_reduce", "horner_combine")), 0)


def _field_view(fk, a):
    """(FW, ...) rows -> the field kernel's (N, ...) / (2, N, ...) shape."""
    if ext_of(fk) == 2:
        return a.reshape((2, fk.N) + tuple(a.shape[1:]))
    return a


def bucket_reduce_plain(fk, rows, gidx, starts, counts):
    """Per-bucket Jacobian sums, one masked madd round per row depth."""
    FW = ext_of(fk) * fk.N
    m = rows.shape[0]
    nb = counts.shape[0]
    dev = rows.device
    zero = fk.zeros((nb,), dev)
    one = fk.one((nb,), dev)
    acc = (one, one, zero)
    counts64 = counts.to(torch.int64)
    maxc = int(counts64.max()) if nb else 0
    for k in range(maxc):
        live = k < counts64
        pos = torch.clamp(starts + k, max=gidx.shape[0] - 1)
        g = gidx[pos].to(torch.int64)
        neg = g >= m
        i = torch.where(neg, g - m, g)
        r = rows[i]                                   # (nb, 2FW)
        x = _field_view(fk, r[:, :FW].T)
        y = _field_view(fk, r[:, FW:].T)
        q_inf = fk.is_zero(y) | ~live
        y = fk.select(neg, fk.as_plain().neg(y), y)
        acc = madd_plain(fk, acc, (x, y, q_inf))
    return tuple(a.reshape(FW, nb) for a in acc)


def bucket_reduce(fk, rows, gidx, starts, counts):
    """Reduce bucket runs to one Jacobian point per bucket.

    rows:   (m, 2FW) int32 row table [x limbs | y limbs] (Fp2 rows are
            [x0 x1 | y0 y1]); y == 0 marks the point at infinity
    gidx:   (W*m,) int32 signed row indices idx + sign*m, sorted per window
    starts: (nb,) int64 offset of each bucket's run in gidx
    counts: (nb,) int32 run lengths (0 for never-used buckets)
    Returns (X, Y, Z), each (FW, nb) int32.
    """
    if not rows.is_cuda:
        return bucket_reduce_plain(fk, rows, gidx, starts, counts)
    FW = ext_of(fk) * fk.N
    m, w2 = rows.shape
    if w2 != 2 * FW or rows.dtype != torch.int32:
        raise ValueError("bucket_reduce: rows must be (m, 2FW) int32")
    rows = rows.contiguous()
    gidx = gidx.to(torch.int32).contiguous()
    starts = starts.to(torch.int64).contiguous()
    counts = counts.to(torch.int32).contiguous()
    nb = counts.shape[0]
    outs = [torch.empty((FW, nb), dtype=torch.int32, device=rows.device)
            for _ in range(3)]
    code = cuda_lib.lib("bucket").lsn_bucket_reduce(
        fk.nw, ext_of(fk), rows.data_ptr(), m, gidx.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), nb, *[o.data_ptr() for o in outs],
        ctypes.addressof(fk.mod), cuda_lib.stream_ptr(rows))
    cuda_lib.check(code, "bucket_reduce")
    LAUNCHES[counter_key("bucket_reduce", fk)] += 1
    return tuple(outs)


def horner_combine_plain(fk, S, c: int):
    FW = ext_of(fk) * fk.N
    W = S[0].shape[-1]
    pt = lambda w: tuple(_field_view(fk, a[:, w:w + 1]) for a in S)
    acc = pt(W - 1)
    for w in range(W - 2, -1, -1):
        acc = dbl_plain(fk, acc, c)
        acc = add_plain(fk, acc, pt(w))
    return tuple(a.reshape(FW, 1) for a in acc)


def horner_combine(fk, S, c: int):
    """S: (X, Y, Z) of shape (FW, W), window 0 = LSB. Returns
    sum_w 2^(c w) S_w as (FW, 1) coordinate tensors."""
    if not S[0].is_cuda:
        return horner_combine_plain(fk, S, c)
    FW = ext_of(fk) * fk.N
    S = [a.to(torch.int32).contiguous() for a in S]
    W = S[0].shape[-1]
    if S[0].shape[0] != FW or W < 1:
        raise ValueError("horner_combine: S must be (FW, W) tensors")
    outs = [torch.empty((FW, 1), dtype=torch.int32, device=S[0].device)
            for _ in range(3)]
    code = cuda_lib.lib("bucket").lsn_horner(
        fk.nw, ext_of(fk), *[a.data_ptr() for a in S], W, c,
        *[o.data_ptr() for o in outs], ctypes.addressof(fk.mod),
        cuda_lib.stream_ptr(S[0]))
    cuda_lib.check(code, "horner_combine")
    LAUNCHES[counter_key("horner_combine", fk)] += 1
    return tuple(outs)
