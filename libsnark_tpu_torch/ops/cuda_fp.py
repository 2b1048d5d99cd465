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
over 16-bit limbs (a schoolbook product into lazy columns, then REDC).
The wrapper takes it only for tensors on the CPU; a CUDA tensor always
launches the kernel.
"""
from __future__ import annotations

import ctypes

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
    one schoolbook product, then one REDC."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a64 = a.to(torch.int64).expand(shape)
    b64 = b.to(torch.int64).expand(shape)
    return redc(fk, mul_columns(a64, b64)).to(torch.int32)


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
