"""Batched Montgomery multiplication: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``libsnark_tpu/ops/pallas_fp.py:_build_mul``
(public ``mont_mul``). The kernel (csrc/fp.cu, built per field width) runs
one thread per lane: it loads both operands' N limbs (coalesced: limb k of
lane t at k*L + t), repacks them into ceil(N/2) words of 32 bits, runs the
Montgomery product of csrc/field.cuh (the carry chain at an even N; at N =
19, R = 2^304, word rounds and a last half-word round) and stores N limbs.
What bounds it on the card: at 2^20 lanes the 12 N bytes each lane moves
against 2 NW^2 + NW wide multiply-adds (NW = ceil(N/2)) put it near the
memory bound; the design keeps every intermediate in registers and touches
each word of input and output once.

The plain version computes the same canonical product in int64 torch ops
over 16-bit limbs (a schoolbook product into lazy columns, then REDC); on
the CPU, up to SMALL_LANES lanes, the same REDC on Python integers.
The wrapper takes it only for tensors on the CPU; a CUDA tensor always
launches the kernel.

``mul_wide`` launches the product with a wide first operand of the same
source (``mul_wide_kernel``: a of Wa >= N limbs, a b 2^(-16 Wa) mod p, the
JAX package's ``FpKernel.mul_wide``, a jnp scan there): the per-level
product of the MXU NTT (ops/ntt_mxu.py). Its plain version is the same
REDC with R = 2^(16 Wa) (``redc``'s ``low``).

``add_sub`` launches the field addition and subtraction of the same
source (``fp_addsub_kernel``: one thread a lane, no products, the JAX
package's ``FpKernel.add`` / ``sub``); its plain version is
``FpKernel.add`` / ``sub`` over int64 limb passes (``normalize``,
``cond_sub_p``), which the field kernel runs on CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import cuda_lib
from .limbs import LIMB_BITS, LIMB_MASK, ints_to_limbs, limbs_to_ints

# launches per kernel and field width (N 16-bit limbs), and the work they
# did: lanes, one product (mont_mul) or one sum or difference (fp_addsub)
# each
LAUNCHES = {f"{k}_n{n}": 0 for k in ("mont_mul", "fp_addsub")
            for n in cuda_lib.FIELD_LIMBS}
LAUNCHES.update({f"mul_wide_n{n}": 0 for n in cuda_lib.WIDE_LIMBS})
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


def redc(fk, T: torch.Tensor, low: int = None) -> torch.Tensor:
    """Montgomery reduction of lazy non-negative int64 columns T (value
    < R*p, at most low + N columns): (T + m p) / R with m = -T p^-1 mod R,
    R = 2^(16 low) (low = N, the field's R, by default).

    The low half of U = T + m p is 0 mod R, so once every column is at
    most 2^16 its value is 0 or exactly R: the carry into column low is
    whether any low column is non-zero. That replaces the carry ripple
    through the low half. Canonical output (N limbs)."""
    N = fk.N
    low = low or N
    np_ = fk.nprime_col(T.device, T.dim() - 1, low)
    m, _ = normalize(mul_columns(T[:low], np_)[:low])      # mod R
    U = torch.zeros((low + N + 1,) + tuple(T.shape[1:]), dtype=torch.int64,
                    device=T.device)
    U[:T.shape[0]] += T
    U[:low + N] += mul_columns(m, fk.p_col(T.device, T.dim() - 1))
    while int(U.max()) > 1 << LIMB_BITS:
        hi = U[:-1] >> LIMB_BITS
        U[:-1] &= LIMB_MASK
        U[1:] += hi
    high = U[low:]
    high[0] += U[:low].ne(0).any(dim=0).to(torch.int64)
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
    a64 = a.to(torch.int64).expand(shape).reshape(fk.N, -1)
    b64 = b.to(torch.int64).expand(shape).reshape(fk.N, -1)
    # lanes a pass, so that the N x N x lanes columns stay within
    # PLAIN_CHUNK_BYTES
    step = max(1, PLAIN_CHUNK_BYTES // (8 * fk.N * fk.N))
    out = [redc(fk, mul_columns(a64[:, i:i + step], b64[:, i:i + step]))
           for i in range(0, a64.shape[1], step)]
    return torch.cat(out, dim=1).to(torch.int32).reshape(shape)


# bytes of the schoolbook columns one pass of the plain product may hold (a
# group law's stacked products on 2^20 lanes would otherwise ask for tens
# of GiB on the card); the passes change no limb
PLAIN_CHUNK_BYTES = 4 << 30


# Lanes up to which the CPU plain versions (this product, FpKernel.add and
# sub) take Python integers: a chain of one-lane operations (a Horner
# combine, a window table's bases, a Fermat inversion) would otherwise
# spend its time in one torch call per carry pass, and at any width the
# integers beat the limb columns on one CPU core too (the product of 4096
# lanes: 14 ms against 39 ms at 19 limbs, 55 ms against 337 ms at 48).
SMALL_LANES = 1 << 16


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
    (broadcast to one shape), or None if a limb lies outside [0, 2^16).
    Through the native limb codec (``limbs_to_ints``)."""
    shape = lanes_shape(*ts)
    out = []
    for t in ts:
        a = t.expand(shape).reshape(fk.N, -1).numpy()
        if a.min() < 0 or a.max() > LIMB_MASK:
            return None
        out.append(limbs_to_ints(a))
    return out


def ints_lanes(fk, vals, shape) -> torch.Tensor:
    """lane_ints' inverse: the low N limbs of each value, int32 (N, *batch),
    through the native limb codec (``ints_to_limbs``)."""
    mask = (1 << (LIMB_BITS * fk.N)) - 1
    a = ints_to_limbs([v & mask for v in vals], fk.N)
    return torch.from_numpy(a.view(np.int32)).reshape(shape)


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
    a2, b2, shape, L = _operands(fk, a, b, "mont_mul")
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    code = cuda_lib.lib("fp").lsn_mont_mul(
        fk.N, a2.data_ptr(), b2.data_ptr(), out.data_ptr(), L,
        ctypes.addressof(fk.mod), cuda_lib.stream_ptr(a2))
    cuda_lib.check(code, f"mont_mul at {fk.N} limbs")
    LAUNCHES[f"mont_mul_n{fk.N}"] += 1
    WORK[f"mont_mul_n{fk.N}"] += L
    return out


def _lead_expand(t: torch.Tensor, batch) -> torch.Tensor:
    """(K, *tb) -> (K, *batch), tb broadcasting against batch from the
    right (the limb axis stays in front)."""
    pad = (1,) * (len(batch) - (t.dim() - 1))
    return t.reshape((t.shape[0],) + pad + tuple(t.shape[1:])).expand(
        (t.shape[0],) + tuple(batch))


def mul_wide_plain(fk, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^(-16 Wa) mod p for a of Wa >= N 16-bit limbs (value below
    2^(16 Wa)) and canonical b (N limbs; its batch broadcasts against a's
    from the right): one schoolbook product of Wa x N limbs, then the REDC
    with R = 2^(16 Wa); up to SMALL_LANES lanes on the CPU, the same REDC on
    Python integers. Canonical output."""
    wa, N = a.shape[0], fk.N
    if wa < N:
        raise ValueError(f"mul_wide: a has {wa} limbs, fewer than {N}")
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a64 = _lead_expand(a.to(torch.int64), batch).reshape(wa, -1)
    b64 = _lead_expand(b.to(torch.int64), batch).reshape(N, -1)
    if small_lanes(a64[:1], b64[:1]) and int(a64.min()) >= 0 \
            and int(a64.max()) <= LIMB_MASK and int(b64.min()) >= 0 \
            and int(b64.max()) <= LIMB_MASK:
        shift = LIMB_BITS * wa
        R = 1 << shift
        key = ("ints_wide", wa)
        if key not in fk._consts:
            fk._consts[key] = (-pow(fk.p, -1, R)) % R
        nprime, p = fk._consts[key], fk.p
        out = []
        for x, y in zip(limbs_to_ints(a64.numpy()), limbs_to_ints(b64.numpy())):
            t = x * y
            u = (t + (t * nprime % R) * p) >> shift
            out.append(u - p if u >= p else u)
        return ints_lanes(fk, out, (N,) + batch)
    step = max(1, PLAIN_CHUNK_BYTES // (8 * wa * N))
    out = [redc(fk, mul_columns(a64[:, i:i + step], b64[:, i:i + step]),
                low=wa)
           for i in range(0, a64.shape[1], step)]
    return torch.cat(out, dim=1).to(torch.int32).reshape((N,) + batch)


def mul_wide(fk, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^(-16 Wa) mod p: a (Wa, *batch) int32 16-bit limbs with Wa >=
    N, b (N, *bb) canonical, broadcasting against a's batch from the right.
    CUDA tensors launch ``mul_wide_kernel`` (b is read in place when its
    batch is the trailing part of a's, as a twiddle table or one constant
    is); CPU tensors take the plain version."""
    if not a.is_cuda:
        return mul_wide_plain(fk, a, b)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mul_wide takes int32 limb tensors")
    wa, N = a.shape[0], fk.N
    if f"mul_wide_n{N}" not in LAUNCHES:
        raise ValueError(f"no mul_wide kernel built for {N} limbs "
                         f"(16-bit limbs: {cuda_lib.WIDE_LIMBS})")
    if wa < N or b.shape[0] != N or b.device != a.device:
        raise ValueError("mul_wide: a must be (Wa >= N, *batch) and b (N, "
                         "*bb) on one device")
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a2 = _lead_expand(a, batch).contiguous()
    bb = tuple(b.shape[1:])
    if batch[len(batch) - len(bb):] == bb:
        b2, Lb = b.contiguous(), math.prod(bb)
    else:
        b2 = _lead_expand(b, batch).contiguous()
        Lb = math.prod(batch)
    L = math.prod(batch)
    out = torch.empty((N,) + batch, dtype=torch.int32, device=a.device)
    code = cuda_lib.lib("fp").lsn_mul_wide(
        N, a2.data_ptr(), wa, b2.data_ptr(), Lb, out.data_ptr(), L,
        ctypes.addressof(fk.mod), cuda_lib.stream_ptr(a2))
    cuda_lib.check(code, f"mul_wide at {N} limbs")
    LAUNCHES[f"mul_wide_n{N}"] += 1
    WORK[f"mul_wide_n{N}"] += L
    return out


def _operands(fk, a, b, what: str):
    """a and b broadcast to one (N, *batch) int32 shape on one card,
    contiguous, with the lanes L."""
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"{what} takes int32 limb tensors")
    if a.shape[0] != fk.N or b.device != a.device:
        raise ValueError(f"{what}: operands must be (N, *batch) on one "
                         "device")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return (a.expand(shape).contiguous(), b.expand(shape).contiguous(),
            shape, math.prod(shape[1:]))


def add_sub(fk, a: torch.Tensor, b: torch.Tensor, sub: bool) -> torch.Tensor:
    """a + b (sub False) or a - b mod p of (N, *batch) int32 limb tensors on
    the card (b broadcasts against a): ONE fp_addsub launch, the limbs of
    ``FpKernel.add`` / ``sub``'s limb passes for any 16-bit limbs."""
    a2, b2, shape, L = _operands(fk, a, b, "fp_addsub")
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    code = cuda_lib.lib("fp").lsn_fp_addsub(
        fk.N, int(sub), a2.data_ptr(), b2.data_ptr(), out.data_ptr(), L,
        ctypes.addressof(fk.mod), cuda_lib.stream_ptr(a2))
    cuda_lib.check(code, f"fp_addsub at {fk.N} limbs")
    LAUNCHES[f"fp_addsub_n{fk.N}"] += 1
    WORK[f"fp_addsub_n{fk.N}"] += L
    return out
