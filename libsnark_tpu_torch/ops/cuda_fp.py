"""Batched Montgomery multiplication: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``libsnark_tpu/ops/pallas_fp.py:_build_mul``
(public ``mont_mul``). The kernel (csrc/fp.cu, built per field width) runs
one thread per lane: it loads both operands' N limbs (coalesced: limb k of
lane t at k*L + t), repacks them into N/2 words of 32 bits, runs the
carry-chain Montgomery product of csrc/field.cuh and stores N limbs. What bounds it on the card: at 2^20
lanes the 12 N bytes each lane moves against N^2/2 + N/2 wide multiply-adds
put it near the memory bound; the design keeps every intermediate in
registers and touches each word of input and output once.

The plain version computes the same canonical product in int64 torch ops
over 16-bit limbs (a schoolbook product into lazy columns, then REDC); on
the CPU, up to SMALL_LANES lanes, the same REDC on Python integers.
The wrapper takes it only for tensors on the CPU; a CUDA tensor always
launches the kernel.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import cuda_lib
from .limbs import LIMB_BITS, LIMB_MASK

# launches per field width (N 16-bit limbs), and the work they did: lanes,
# one product each
LAUNCHES = {f"mont_mul_n{2 * nw}": 0 for nw in cuda_lib.WIDTHS}
WORK = dict.fromkeys(LAUNCHES, 0)


def normalize(cols: torch.Tensor):
    """Carry (or borrow) normalization of int64 limb columns.

    Parallel passes -- keep the low 16 bits, add each column's high part
    into the next column -- until no column holds more than 16 bits.
    Arithmetic shifts make negative columns borrow. Returns (digits, carry)
    with digits in [0, 2^16) and the signed carry out of the top column."""
    cols = cols.clone()
    carry = torch.zeros_like(cols[0])
    while True:
        hi = cols >> LIMB_BITS
        if not bool(hi.any()):
            return cols, carry
        cols &= LIMB_MASK
        cols[1:] += hi[:-1]
        carry += hi[-1]


_DIAG = {}


def mul_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of two int64 limb vectors as lazy columns:
    (Na, *B) x (Nb, *B) -> (Na + Nb, *B), column k = sum_{i+j=k} a_i b_j."""
    na, nb = a.shape[0], b.shape[0]
    key = (na, nb, str(a.device))
    if key not in _DIAG:
        idx = torch.arange(na).unsqueeze(1) + torch.arange(nb).unsqueeze(0)
        _DIAG[key] = idx.reshape(-1).to(a.device)
    prod = a.unsqueeze(1) * b.unsqueeze(0)
    batch = tuple(prod.shape[2:])
    cols = torch.zeros((na + nb,) + batch, dtype=torch.int64, device=a.device)
    return cols.index_add_(0, _DIAG[key], prod.reshape((na * nb,) + batch))


def cond_sub_p(fk, r: torch.Tensor) -> torch.Tensor:
    """r (int64 limbs, value < 2p) -> canonical N limbs (< p)."""
    p = fk.p_col(r.device, r.dim() - 1, r.shape[0])
    d, c = normalize(r - p)
    return torch.where((c < 0).unsqueeze(0), r, d)[: fk.N]


def redc(fk, T: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of lazy non-negative int64 columns T (value
    < R*p, at most 2N columns): (T + m p) / R with m = -T p^-1 mod R.

    The low half of U = T + m p is 0 mod R, so once every column is at
    most 2^16 its value is 0 or exactly R: the carry into column N is
    whether any low column is non-zero. That replaces the N-column carry
    ripple through the low half. Canonical output (N limbs)."""
    N = fk.N
    np_ = fk.nprime_col(T.device, T.dim() - 1)
    m, _ = normalize(mul_columns(T[:N], np_)[:N])          # mod R
    U = torch.zeros((2 * N + 1,) + tuple(T.shape[1:]), dtype=torch.int64,
                    device=T.device)
    U[:T.shape[0]] += T
    U[:2 * N] += mul_columns(m, fk.p_col(T.device, T.dim() - 1))
    while int(U.max()) > 1 << LIMB_BITS:
        hi = U[:-1] >> LIMB_BITS
        U[:-1] &= LIMB_MASK
        U[1:] += hi
    high = U[N:]
    high[0] += U[:N].ne(0).any(dim=0).to(torch.int64)
    r, _ = normalize(high)
    return cond_sub_p(fk, r)


def mont_mul_plain(fk, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p over int64 16-bit limbs (canonical output):
    one schoolbook product, then one REDC. Up to SMALL_LANES lanes on the
    CPU, the same REDC on Python integers (mont_mul_ints)."""
    if small_lanes(a, b):
        out = mont_mul_ints(fk, a, b)
        if out is not None:
            return out
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a64 = a.to(torch.int64).expand(shape)
    b64 = b.to(torch.int64).expand(shape)
    return redc(fk, mul_columns(a64, b64)).to(torch.int32)


# Lanes up to which the CPU plain versions (this product, FpKernel.add and
# sub) take Python integers: a chain of one-lane operations (a Horner
# combine, a window table's bases, a Fermat inversion) would otherwise
# spend its time in one torch call per carry pass.
SMALL_LANES = 8


def lanes_shape(*ts):
    """The shape the tensors broadcast to (their own where all agree)."""
    shape = ts[0].shape
    if all(t.shape == shape for t in ts[1:]):
        return shape
    return torch.broadcast_shapes(*(t.shape for t in ts))


def small_lanes(*ts) -> bool:
    """Whether the CPU plain versions take the Python-integer forms: CPU
    tensors of at most SMALL_LANES lanes."""
    return (not any(t.is_cuda for t in ts)
            and math.prod(lanes_shape(*ts)[1:]) <= SMALL_LANES)


def lane_ints(fk, *ts):
    """The integer value of each lane of each (N, *batch) limb tensor
    (broadcast to one shape), or None if a limb lies outside [0, 2^16)."""
    shape = lanes_shape(*ts)
    nbytes = 2 * fk.N
    out = []
    for t in ts:
        a = t.expand(shape).reshape(fk.N, -1).numpy()
        if a.min() < 0 or a.max() > LIMB_MASK:
            return None
        raw = a.T.astype("<u2").tobytes()
        out.append([int.from_bytes(raw[i:i + nbytes], "little")
                    for i in range(0, len(raw), nbytes)])
    return out


def ints_lanes(fk, vals, shape) -> torch.Tensor:
    """lane_ints' inverse: the low N limbs of each value, int32 (N, *batch)."""
    nbytes = 2 * fk.N
    mask = (1 << (8 * nbytes)) - 1
    raw = b"".join((v & mask).to_bytes(nbytes, "little") for v in vals)
    a = np.frombuffer(raw, dtype="<u2").reshape(len(vals), fk.N)
    return torch.from_numpy(a.T.astype(np.int32)).reshape(shape)


def mont_mul_ints(fk, a: torch.Tensor, b: torch.Tensor):
    """The REDC of redc() on the Python integers of a few lanes: U = (a b +
    m p) / R with m = -a b p^-1 mod R, U - p where U >= p, the low N limbs
    of that. The same value redc() computes in limb columns, so the same
    limbs. None (the caller takes the limb columns) if a limb lies outside
    [0, 2^16)."""
    vals = lane_ints(fk, a, b)
    if vals is None:
        return None
    key = ("ints", fk.N)
    if key not in fk._consts:
        R = 1 << (LIMB_BITS * fk.N)
        fk._consts[key] = (R, (-pow(fk.p, -1, R)) % R)
    R, nprime = fk._consts[key]
    p, shift = fk.p, LIMB_BITS * fk.N
    out = []
    for x, y in zip(*vals):
        t = x * y
        u = (t + (t * nprime % R) * p) >> shift
        out.append(u - p if u >= p else u)
    return ints_lanes(fk, out, lanes_shape(a, b))


def mont_mul(fk, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of canonical (N, *batch) int32 limb tensors.

    b broadcasts against a. CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if not a.is_cuda:
        return mont_mul_plain(fk, a, b)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul takes int32 limb tensors")
    if a.shape[0] != fk.N or b.device != a.device:
        raise ValueError("mont_mul: operands must be (N, *batch) on one device")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a2 = a.expand(shape).contiguous()
    b2 = b.expand(shape).contiguous()
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    L = a2.numel() // fk.N
    code = cuda_lib.lib("fp").lsn_mont_mul(
        fk.nw, a2.data_ptr(), b2.data_ptr(), out.data_ptr(), L,
        ctypes.addressof(fk.mod), cuda_lib.stream_ptr(a2))
    cuda_lib.check(code, "mont_mul")
    LAUNCHES[f"mont_mul_n{fk.N}"] += 1
    WORK[f"mont_mul_n{fk.N}"] += L
    return out
