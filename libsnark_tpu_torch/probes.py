"""Measurement kernels for the card: 32-bit operation rates and Montgomery
product bodies (csrc/probe.cu), and the layout and row-copy probes
(csrc/probe_layout.cu). No part of the proving path.

``rate_chain`` replaces the TPU probe ``scripts/probe_vpu_ops.py:49``: every
thread runs 8 chains of K dependent steps of one operation (``RATE_OPS``),
so a launch takes steps / rate. Three of them are the 32x32->64-bit
multiply-add the field products are made of: ``mad_wide`` (one
IMAD.WIDE.U32 a step, its 64-bit addend inside; ``single_wide_mad_loop``
checks the machine code), ``mad_wide_split`` (PTX mad.wide, which the
toolchain splits into a multiply and adds) and ``mad_cc`` (one row of the
carry-chain product: the 8 chains are one 512-bit accumulator).
``cios_chain`` replaces ``scripts/probe_cios.py:98``: K chained Montgomery
products x <- x * b per lane in five bodies (``CIOS_VARIANTS``), at every
built field width; the fifth splits each product over a group of lanes
(``mont_mul_lanes_plain`` models it word by word).
``measure_product_latency`` runs the chains over one element: the latency
of one dependent product, the yardstick of ``horner_combine``'s bound.

Beside each stands its plain PyTorch version (int64 arithmetic masked to
32 bits; the plain Montgomery product), taken for CPU tensors and used to
check the kernels' final values on the card. ``scripts/probe_h100.py``
prints the tables.

The layout probes replace the eleven TPU kernels of
``scripts/probe_mosaic_dma.py`` (``row_copy``) and
``scripts/probe_mosaic_ops.py`` (``transpose3d``, the three reshapes, the
two rolls, ``cond_add_one``, ``window_copy``, ``loop_dyn``,
``dynslice_sum``): each computes its TPU counterpart's function on 32-bit
words carried as int32 bit patterns, beside a plain PyTorch version
(``permute``, ``reshape``, ``torch.roll``, slicing, ``torch.where``).
``layout_cases`` lists every case a kernel is held to (the TPU scripts'
shapes first, then odd offsets, shifts outside [0, axis), tiles with no
word above 7, trip counts 1..6), ``measure_layout`` times the eleven and
``measure_row_copy`` times ``row_copy`` at the row widths ``bucket_reduce``
gathers; ``launch_floor_ms`` times an empty kernel launched and replayed the
same way, the least time any of them can take.

``sass_loops`` reads the machine code of the built probe kernels
(``cuobjdump -sass``) and lists the instructions of each kernel's main
loop, each tagged as the loop's own control or not, so that a rate can be
read as the rate of an instruction: a step that compiles to one
instruction runs at that instruction's rate, one that compiles to three
does not. Without the loop's own control (its branches, compares and
counter steps) the counts are what a rate kernel's ``RATE_UNROLL`` x 8
steps compiled to. ``sass_memory_ops`` counts,
per layout kernel, the instructions that say where its data went (global,
shared, local memory, shuffles, votes, barriers; 16-byte accesses apart).
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .ops import cuda_lib
from .ops.cuda_fp import mont_mul_plain
from .ops.limbs import limbs_to_words, words_to_limbs

CHAINS = 8                       # chains per thread (probe.cu)
RATE_UNROLL = 4                  # steps of a chain a pass of the main loop
RATE_OPS = ("mul_lo", "mad_lo", "mad_hi", "mad_wide", "add64", "shift_and",
            "mul_f32", "mad_wide_split", "mad_cc")  # order of enum RateOp
# CIOS; separated operand scanning; field.cuh's carry chain with its rounds
# unrolled and in a loop of two rounds; field.cuh's lane-split product
CIOS_VARIANTS = ("cios", "sos", "chain", "chain_rolled", "lanes")
# field.cuh's fp_mul_half, the kernels' product at 19 limbs (R = 2^304),
# where the five above (R = 2^(32 NW)) do not apply: variant 5 of the C entry
HALF_VARIANT = "half"
LAUNCHES = {f"probe_rate_{op}": 0 for op in RATE_OPS}
# the product bodies of the kernels: the latency probe's, at every width
LATENCY_VARIANTS = ("chain", "chain_rolled", "lanes")
LAUNCHES.update({f"probe_cios_{v}_n{2 * nw}": 0 for v in CIOS_VARIANTS
                 for nw in cuda_lib.GROUP_WIDTHS + (6,)
                 if nw in cuda_lib.PROBE_WIDTHS or v in LATENCY_VARIANTS})
LAUNCHES[f"probe_cios_{HALF_VARIANT}_n19"] = 0
LAUNCHES["probe_dep_mad"] = 0


def bodies(fk, latency: bool = False) -> tuple:
    """The product bodies the CIOS probe builds at fk's width: the five at
    6, 8 and 12 words, the kernels' three (LATENCY_VARIANTS) at 24 (latency
    only), fp_mul_half at 19 limbs; with latency, those of the latency
    probe."""
    if fk.N % 2:
        return (HALF_VARIANT,)
    if latency or fk.nw not in cuda_lib.PROBE_WIDTHS:
        return LATENCY_VARIANTS
    return CIOS_VARIANTS


def dependent_mads(nw: int) -> int:
    """Multiply-adds on a chain that every body of the product must run one
    after another: round i needs the low word t_0 that round i - 1 left,
    and t_0 takes four dependent steps a round (t_0 + a_0 b_i, m = t_0
    n0inv, the carry of m p_0 + t_0, the next t_0 = m p_1 + t_1 + that
    carry), NW rounds: 4 NW. What the bodies add to it (the carries
    across the words, the lane-split product's shuffles and votes, the
    final subtraction) is left out, so the chain bounds every variant
    from below."""
    return 4 * nw

# layout probes, in the order of the TPU kernels they replace; the three
# reshapes, each with a C entry of its own, in the order of enum ReshapeMode
# (probe_layout.cu), which numbers their instantiations in the machine code
RESHAPES = ("reshape_merge_minor", "reshape_merge_major", "squeeze")
LAYOUT_PROBES = ("row_copy", "transpose") + RESHAPES + (
    "roll_minor", "roll_middle", "cond", "window_copy", "loop_dyn",
    "dynslice_sum")
LAUNCHES.update({f"probe_layout_{name}": 0 for name in LAYOUT_PROBES})
ROLL_R = 8                       # middle-axis length of roll_middle / dynslice_sum

_M32 = 0xFFFFFFFF


def _mul_hi(x, y):
    """High 32 bits of the 64-bit product of two int64 tensors < 2^32."""
    xl, xh = x & 0xFFFF, x >> 16
    yl, yh = y & 0xFFFF, y >> 16
    mid = xh * yl + xl * yh + ((xl * yl) >> 16)
    return xh * yh + (mid >> 16)


def _mad64(m, y, lo, hi):
    """(lo, hi) + m y mod 2^64 on int64 tensors of 32-bit halves."""
    s = ((m * y) & _M32) + lo
    return s & _M32, (_mul_hi(m, y) + hi + (s >> 32)) & _M32


def rate_chain_plain(op: str, a: torch.Tensor, b: torch.Tensor, K: int):
    """K steps of the chain ``op`` on every element, as int32 bit patterns
    (mul_f32: float32 in, float32 out). The 64-bit ops start from w = a
    (high half 0) and return lo(w) ^ hi(w). mad_wide: w[c] = lo(w[c ^ 1])
    b[c] + w[c], pairs in order (the even chain reads its partner's old w,
    the odd one the new); mad_wide_split: w = lo(w) b + w; mad_cc: w[c] +=
    a[c] b[c] + carry over the chains in order, the last carry dropped."""
    if op == "mul_f32":
        x = a.clone()
        for _ in range(K):
            x = x * b
        return x
    x = a.to(torch.int64) & _M32
    y = b.to(torch.int64) & _M32
    hi = torch.zeros_like(x)
    if op == "mad_wide":
        lo_e, hi_e, y_e = x[0::2], hi[0::2], y[0::2]
        lo_o, hi_o, y_o = x[1::2], hi[1::2], y[1::2]
        for _ in range(K):
            lo_e, hi_e = _mad64(lo_o, y_e, lo_e, hi_e)
            lo_o, hi_o = _mad64(lo_e, y_o, lo_o, hi_o)
        x = torch.stack([lo_e, lo_o], 1).reshape(x.shape)
        hi = torch.stack([hi_e, hi_o], 1).reshape(x.shape)
    elif op == "mad_cc":                # the products are loop-invariant
        plo, phi = ((x * y) & _M32).unbind(0), _mul_hi(x, y).unbind(0)
        lo, his = list(x.unbind(0)), list(hi.unbind(0))
        for _ in range(K):
            carry = 0
            for c in range(x.shape[0]):
                s = plo[c] + lo[c] + carry
                h = phi[c] + his[c] + (s >> 32)
                lo[c], his[c], carry = s & _M32, h & _M32, h >> 32
        x, hi = torch.stack(lo), torch.stack(his)
    else:
        for _ in range(K):
            if op == "mul_lo":
                x = (x * y) & _M32
            elif op == "mad_lo":
                x = (x * y + y) & _M32
            elif op == "mad_hi":
                x = (_mul_hi(x, y) + y) & _M32
            elif op == "mad_wide_split":
                x, hi = _mad64(x, y, x, hi)
            elif op == "add64":
                lo = x + y
                x, hi = lo & _M32, (hi + y + (lo >> 32)) & _M32
            elif op == "shift_and":
                x = ((x >> 1) & y) ^ y
            else:
                raise ValueError(f"unknown rate op {op!r}; available: "
                                 f"{RATE_OPS}")
    if op in ("mad_wide", "add64", "mad_wide_split", "mad_cc"):
        x = x ^ hi
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def rate_chain(op: str, a: torch.Tensor, b: torch.Tensor, K: int):
    """a, b: (CHAINS, T) int32 bit patterns (float32 for ``mul_f32``), chain
    c of thread t at [c, t]. Returns the chains' values after K steps. One
    launch on the card; the plain version for CPU tensors."""
    if op not in RATE_OPS:
        raise ValueError(f"unknown rate op {op!r}; available: {RATE_OPS}")
    want = torch.float32 if op == "mul_f32" else torch.int32
    if a.dtype != want or b.dtype != want or a.shape != b.shape \
            or a.dim() != 2 or a.shape[0] != CHAINS:
        raise ValueError(f"rate_chain({op}) takes two ({CHAINS}, T) "
                         f"{want} tensors")
    if not a.is_cuda:
        return rate_chain_plain(op, a, b, K)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    code = cuda_lib.lib("probe").lsn_probe_rate(
        RATE_OPS.index(op), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        a.shape[1], K, cuda_lib.stream_ptr(a))
    cuda_lib.check(code, f"probe_rate[{op}]")
    LAUNCHES[f"probe_rate_{op}"] += 1
    return out


def cios_chain_plain(fk, a: torch.Tensor, b: torch.Tensor, K: int):
    x = a
    for _ in range(K):
        x = mont_mul_plain(fk, x, b)
    return x


def mont_mul_lanes_plain(fk, a: torch.Tensor, b: torch.Tensor):
    """The lane-split Montgomery product of csrc/field.cuh (fp_mul_lanes),
    word by word: the lanes of a group are axis 0 of (NW, L) int64 tensors
    (lane j holds word j), a shuffle down or up is a shift along that axis
    with the edge lane zeroed, the broadcast of m a copy of row 0, a warp
    vote a bit mask over the rows. a, b: canonical (N, L) int32 limbs;
    returns a b R^-1 mod p, canonical, as (N, L) int32 limbs."""
    nw = fk.N // 2
    dev = a.device
    aw = limbs_to_words(a).to(torch.int64) & _M32
    bw = limbs_to_words(b).to(torch.int64) & _M32
    p = torch.tensor([(fk.p >> (32 * k)) & _M32 for k in range(nw)],
                     dtype=torch.int64, device=dev)[:, None]
    n0inv = (-pow(fk.p, -1, 1 << 32)) % (1 << 32)
    j = torch.arange(nw, device=dev)[:, None]
    first, last = j == 0, j == nw - 1
    t = torch.zeros_like(aw)
    for i in range(nw):
        bi = bw[i:i + 1]
        U = t + ((aw * bi) & _M32)                       # + lo(a_j b_i)
        m = ((U[0:1] & _M32) * n0inv) & _M32             # lane 0, broadcast
        U = U + ((m * p) & _M32)                         # + lo(m p_j)
        H = _mul_hi(aw, bi) + _mul_hi(m, p)
        down = torch.roll(U, -1, 0).masked_fill(last, 0)  # shuffle down
        t = down + H + torch.where(first, U >> 32, 0)
    up = torch.roll(t >> 32, 1, 0).masked_fill(first, 0)  # shuffle up
    s = (t & _M32) + up
    w = s & _M32
    bit = 1 << j

    def vote(pred):
        return (pred.to(torch.int64) * bit).sum(0, keepdim=True)
    G, P = vote(s >> 32 != 0), vote(w == _M32)
    w = (w + ((((G + (G | P)) ^ P) >> j) & 1)) & _M32
    BG, BP = vote(w < p), vote(w == p)
    S = BG + (BG | BP)
    d = (w - p - (((S ^ BP) >> j) & 1)) & _M32
    r = torch.where(((S >> nw) & 1) == 1, w, d)
    return words_to_limbs(_i32(r))


def cios_chain(fk, variant: str, a: torch.Tensor, b: torch.Tensor, K: int):
    """x <- x * b (Montgomery) K times per lane, a and b canonical (N, L)
    int32 limbs of the field kernel ``fk``; ``variant`` picks the body."""
    if variant not in CIOS_VARIANTS + (HALF_VARIANT,):
        raise ValueError(f"unknown CIOS variant {variant!r}; "
                         f"available: {CIOS_VARIANTS + (HALF_VARIANT,)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32 \
            or a.shape != b.shape or a.dim() != 2 or a.shape[0] != fk.N:
        raise ValueError("cios_chain takes two (N, L) int32 limb tensors")
    if not a.is_cuda:
        return cios_chain_plain(fk, a, b, K)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    code = cuda_lib.lib("probe").lsn_probe_cios(
        fk.nw, (CIOS_VARIANTS + (HALF_VARIANT,)).index(variant),
        a.data_ptr(), b.data_ptr(),
        out.data_ptr(), a.shape[1], K, ctypes.addressof(fk.mod),
        cuda_lib.stream_ptr(a))
    cuda_lib.check(code, f"probe_cios[{variant}]")
    LAUNCHES[f"probe_cios_{variant}_n{fk.N}"] += 1
    return out


# ------------------------------------------------------------ layout probes

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & _M32


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values (any size) -> the int32 bit pattern of v mod 2^32."""
    v = v & _M32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _words(x: torch.Tensor, ndim: int, what: str) -> torch.Tensor:
    if x.dtype != torch.int32 or x.dim() != ndim:
        raise ValueError(f"{what} takes a {ndim}-D int32 tensor of 32-bit "
                         f"words, got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _launch(name: str, entry: str, x: torch.Tensor, *args):
    """Call one C entry of the layout library on x's stream and count it."""
    code = getattr(cuda_lib.lib("probe_layout"), entry)(
        *args, cuda_lib.stream_ptr(x))
    cuda_lib.check(code, f"probe_layout[{name}]")
    LAUNCHES[f"probe_layout_{name}"] += 1


def row_copy_plain(x, s: int, R: int, seg=None):
    seg = torch.zeros(1, dtype=torch.int64, device=x.device) \
        if seg is None else seg
    idx = (s + seg)[:, None] + torch.arange(R, device=x.device)
    return x[idx]


def row_copy(x, s: int, R: int, seg=None, into3d: bool = False,
             validate: bool = True):
    """out[b] = x[s + seg[b] : s + seg[b] + R, :] as (nseg, R, width).

    x: (rows, width) words; s: row offset, a kernel argument read at run
    time; seg: (nseg,) int64 further row offsets (default one segment at 0,
    which the kernel takes from a null pointer: no device allocation);
    into3d: the TPU probe's staging through slot 0 of a (2, R, width)
    buffer, which only doubles the staging size checked against 48 KB.
    The kernel copies each segment's R * width contiguous words in 16-byte
    pieces where the width allows, many segments a block. validate=False
    skips the bounds check of seg (a reduction that waits for the device):
    only for offsets already checked, as in a timing loop."""
    x = _words(x, 2, "row_copy")
    rows, width = x.shape
    slots = 2 if into3d else 1
    if R < 1 or slots * R * width * 4 > 48 * 1024:
        raise ValueError("row_copy: the staging buffer must hold 1 row or "
                         "more and fit 48 KB of shared memory")
    if seg is None:
        lo = hi = 0
    elif seg.dtype != torch.int64 or seg.dim() != 1 or seg.device != x.device:
        raise ValueError("row_copy: seg must be a 1-D int64 tensor on x's "
                         "device")
    elif validate and seg.numel():
        lo, hi = int(seg.min()), int(seg.max())
    else:
        lo, hi = -s, rows - R - s
    if s + lo < 0 or s + hi + R > rows:
        raise ValueError("row_copy: a segment leaves the array")
    if not x.is_cuda:
        return row_copy_plain(x, s, R, seg)
    nseg = 1 if seg is None else seg.numel()
    seg = None if seg is None else seg.contiguous()
    out = torch.empty((nseg, R, width), dtype=torch.int32, device=x.device)
    _launch("row_copy", "lsn_layout_row_copy", x, x.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(), width, R,
            nseg, s, slots)
    return out


def row_gather_index(s: int, R: int, seg, device):
    """The (nseg R,) row indices of ``row_copy``'s segments, for the one
    PyTorch call that computes the same gather (``x.index_select``)."""
    seg = torch.zeros(1, dtype=torch.int64, device=device) \
        if seg is None else seg
    return ((s + seg)[:, None] + torch.arange(R, device=device)).reshape(-1)


def transpose_plain(x):
    return x.permute(2, 1, 0).contiguous()


def transpose3d(x):
    """out[l, r, b] = x[b, r, l]: (B, R, L) -> (L, R, B) through padded
    32 x 32 shared-memory tiles."""
    x = _words(x, 3, "transpose3d")
    if not x.is_cuda:
        return transpose_plain(x)
    B, R, L = x.shape
    if x.numel() == 0 or R > 65535:
        raise ValueError("transpose3d: empty array or middle axis > 65535")
    out = torch.empty((L, R, B), dtype=torch.int32, device=x.device)
    _launch("transpose", "lsn_layout_transpose", x, x.data_ptr(),
            out.data_ptr(), B, R, L)
    return out


def _reshape_shape(name: str, shape):
    A, B, C = shape
    if name == "reshape_merge_minor":
        return (A, B * C)
    if name == "reshape_merge_major":
        return (A * B, C)
    if name == "squeeze":
        if B != 1:
            raise ValueError("squeeze drops a middle axis of length 1")
        return (A, C)
    raise ValueError(f"unknown reshape {name!r}; available: {RESHAPES}")


def reshape_plain(name: str, x):
    return x.reshape(_reshape_shape(name, x.shape)).clone()


def div_magic(d: int):
    """(m, s) with n // d == (n * m) >> s for every 0 <= n < 2^31, m < 2^32:
    the reshape kernel's division by a run-time divisor d in [1, 2^31)
    (Granlund and Montgomery's round-up multiplier: l = ceil(log2 d),
    m = 2^(31 + l) // d + 1, so that 2^(31 + l) < m d <= 2^(31 + l) + 2^l)."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"div_magic: divisor {d} outside [1, 2^31)")
    shift = 31 + (d - 1).bit_length()
    m = (1 << shift) // d + 1
    if m >= 1 << 32:
        raise ValueError(f"div_magic: no 32-bit multiplier for {d}")
    return m, shift


def reshape3d(name: str, x):
    """One of ``RESHAPES`` on a contiguous (A, B, C) array: merge the two
    minor dimensions, merge the two major ones, or drop a unit middle
    one. The kernel reads by the source's indices and writes by the
    destination's, in 32-bit index arithmetic (A B C < 2^31), moving
    16-byte pieces where C % 4 == 0 and both arrays are 16-byte aligned."""
    x = _words(x, 3, name)
    shape = _reshape_shape(name, x.shape)
    if not x.is_cuda:
        return reshape_plain(name, x)
    A, B, C = x.shape
    if x.numel() == 0 or x.numel() >= 1 << 31:
        raise ValueError(f"{name}: the array must hold 1 to 2^31 - 1 words")
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    vec = C % 4 == 0 and (x.data_ptr() | out.data_ptr()) % 16 == 0
    _launch(name, f"lsn_layout_{name}", x, x.data_ptr(), out.data_ptr(),
            A, B, C, int(vec), *div_magic(C // 4 if vec else C),
            *div_magic(B))
    return out


def roll_plain(x, s: int, axis: int):
    return torch.roll(x, int(s), axis)


def _shift(s) -> int:
    """The shift as a C int; any Python int rolls by its residue, which the
    kernels take themselves, so only the width is checked."""
    s = int(s)
    if not -(1 << 31) <= s < 1 << 31:
        raise ValueError("the roll's shift must fit 32 bits")
    return s


def roll_minor(x, s: int):
    """out[i, j] = x[i, (j - s) mod n] on (rows, n), as jnp.roll: s is a
    run-time kernel argument of any sign or size."""
    x = _words(x, 2, "roll_minor")
    s = _shift(s)
    if not x.is_cuda:
        return roll_plain(x, s, 1)
    rows, n = x.shape
    if n == 0 or n * 4 > 48 * 1024:
        raise ValueError("roll_minor: a row must hold 1 word or more and "
                         "fit 48 KB of shared memory")
    out = torch.empty_like(x)
    _launch("roll_minor", "lsn_layout_roll_minor", x, x.data_ptr(),
            out.data_ptr(), rows, n, s)
    return out


def roll_middle(x, s: int):
    """out[a, r, l] = x[a, (r - s) mod 8, l] on (A, 8, L): the eight
    values of a thread live in a per-thread array read back at a run-time
    index."""
    x = _words(x, 3, "roll_middle")
    s = _shift(s)
    if x.shape[1] != ROLL_R:
        raise ValueError(f"roll_middle takes a middle axis of {ROLL_R}")
    if not x.is_cuda:
        return roll_plain(x, s, 1)
    if x.numel() == 0:
        raise ValueError("roll_middle: empty array")
    out = torch.empty_like(x)
    _launch("roll_middle", "lsn_layout_roll_middle", x, x.data_ptr(),
            out.data_ptr(), x.shape[0], x.shape[2], s)
    return out


def cond_plain(x):
    v = _u32(x)
    return _i32(torch.where((v > 7).any(), v + 1, v))


def cond_add_one(x):
    """x + 1 (mod 2^32) if any word of the tile is > 7 (unsigned), else x:
    one block, one block-wide vote, one uniform branch. The kernel loads
    each word once into registers (16-byte pieces where both arrays are
    16-byte aligned, else words) and stores from them; only a tile of more
    than 4096 + 256 words is read twice past those."""
    x = _words(x, 2, "cond_add_one")
    if not x.is_cuda:
        return cond_plain(x)
    if not 0 < x.numel() < 1 << 31:
        raise ValueError("cond_add_one: the tile must hold 1 to 2^31 - 1 "
                         "words")
    out = torch.empty_like(x)
    _launch("cond", "lsn_layout_cond", x, x.data_ptr(), out.data_ptr(),
            x.numel())
    return out


def window_copy_plain(x, s: int, W: int = 128):
    return x[:, s:s + W].contiguous()


def window_copy(x, s: int, W: int = 128):
    """out = x[:, s : s + W] on (rows, total): s counts words, is read at
    run time and need not be aligned to anything wider than a word."""
    x = _words(x, 2, "window_copy")
    rows, total = x.shape
    if not (0 <= s and 0 < W and s + W <= total) or W * 4 > 48 * 1024:
        raise ValueError("window_copy: the window must lie inside a row and "
                         "fit 48 KB of shared memory")
    if not x.is_cuda:
        return window_copy_plain(x, s, W)
    out = torch.empty((rows, W), dtype=torch.int32, device=x.device)
    _launch("window_copy", "lsn_layout_window_copy", x, x.data_ptr(),
            out.data_ptr(), rows, total, W, s)
    return out


def loop_dyn_plain(x):
    v = _u32(x)
    n = v.reshape(-1)[:8].max() % 7
    return _i32(n * v)


def loop_dyn(x):
    """A loop whose trip count is read from the data: n = max(x[0, :8])
    mod 7 (unsigned), out = x added up n times (mod 2^32)."""
    x = _words(x, 2, "loop_dyn")
    if x.shape[1] < 8:
        raise ValueError("loop_dyn reads the first 8 words of row 0")
    if not x.is_cuda:
        return loop_dyn_plain(x)
    out = torch.empty_like(x)
    _launch("loop_dyn", "lsn_layout_loop_dyn", x, x.data_ptr(),
            out.data_ptr(), x.numel())
    return out


def dynslice_sum_plain(x, n: int = 4):
    return _i32(_u32(x)[:, 0:2 * n:2, :].sum(dim=1))


def dynslice_sum(x, n: int = 4):
    """out[a, l] = sum over i < n of x[a, 2 i, l] (mod 2^32) on (A, 8, L),
    n <= 4 a run-time trip count: a per-thread array indexed by the loop
    variable."""
    x = _words(x, 3, "dynslice_sum")
    if x.shape[1] != ROLL_R or not 0 <= 2 * n <= ROLL_R:
        raise ValueError(f"dynslice_sum takes a middle axis of {ROLL_R} and "
                         f"at most {ROLL_R // 2} terms")
    if not x.is_cuda:
        return dynslice_sum_plain(x, n)
    if x.numel() == 0:
        raise ValueError("dynslice_sum: empty array")
    out = torch.empty((x.shape[0], x.shape[2]), dtype=torch.int32,
                      device=x.device)
    _launch("dynslice_sum", "lsn_layout_dynslice_sum", x, x.data_ptr(),
            out.data_ptr(), x.shape[0], x.shape[2], n)
    return out


def layout_cases(device, seed: int = 11) -> list:
    """Every case the layout kernels are held to, as (name, case, kernel
    call, plain call, library call or None, bytes moved). The first case of
    each name is its TPU script's (``arange`` input, the script's shapes and
    offsets); the rest are the cases those inputs never reach. The library
    call is the one PyTorch call that computes the same function into a new
    tensor, where there is one."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def ar(*shape):
        n = 1
        for d in shape:
            n *= d
        return torch.arange(n, dtype=torch.int32, device=device).reshape(shape)

    def rnd(*shape):          # all 32 bits in use
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                             device=device, dtype=torch.int64).to(torch.int32)

    cases = []

    def case(name, label, kern, plain, lib, words):
        cases.append((name, label, kern, plain, lib, 4 * words))

    for width, into3d in ((32, False), (128, False), (32, True), (128, True),
                          (64, False)):
        x = ar(1024, width)
        case("row_copy", f"(1024,{width})[40:56] {'3D' if into3d else '2D'}",
             lambda x=x, f=into3d: row_copy(x, 40, 16, into3d=f),
             lambda x=x: row_copy_plain(x, 40, 16),
             lambda x=x: x[None, 40:56].clone(), 2 * 16 * width)
    x = rnd(4096, 24)
    seg = torch.randint(0, 4096 - 16 - 7, (64,), generator=gen, device=device)
    idx = row_gather_index(7, 16, seg, device)
    case("row_copy", "(4096,24) 64 random segments of 16 rows from s=7",
         lambda x=x, seg=seg: row_copy(x, 7, 16, seg),
         lambda x=x, seg=seg: row_copy_plain(x, 7, 16, seg),
         lambda x=x, idx=idx: x.index_select(0, idx).view(64, 16, 24),
         2 * 64 * 16 * 24 + 2 * 64)          # seg: 2 words a segment
    # a width that is no multiple of 4 words: the kernel's word-wise path
    x = rnd(1000, 5)
    seg = torch.randint(-2, 1000 - 3 - 2, (37,), generator=gen, device=device)
    idx = row_gather_index(2, 3, seg, device)
    case("row_copy", "(1000,5) 37 random segments of 3 rows from s=2",
         lambda x=x, seg=seg: row_copy(x, 2, 3, seg),
         lambda x=x, seg=seg: row_copy_plain(x, 2, 3, seg),
         lambda x=x, idx=idx: x.index_select(0, idx).view(37, 3, 5),
         2 * 37 * 3 * 5 + 2 * 37)

    for x, label in ((ar(128, 8, 32), "(128,8,32)->(32,8,128)"),
                     (rnd(70, 3, 45), "(70,3,45) ragged tiles")):
        case("transpose", label, lambda x=x: transpose3d(x),
             lambda x=x: transpose_plain(x),
             lambda x=x: x.permute(2, 1, 0).contiguous(), 2 * x.numel())

    for name, shape, extra in (
            ("reshape_merge_minor", (16, 16, 8), (5, 7, 3)),
            ("reshape_merge_major", (16, 2, 128), (5, 7, 3)),
            ("squeeze", (16, 1, 128), (37, 1, 11))):
        for x in (ar(*shape), rnd(*extra)):
            case(name, f"{tuple(x.shape)}->{_reshape_shape(name, x.shape)}",
                 lambda x=x, name=name: reshape3d(name, x),
                 lambda x=x, name=name: reshape_plain(name, x),
                 lambda x=x, name=name: x.reshape(
                     _reshape_shape(name, x.shape)).clone(), 2 * x.numel())

    x = ar(16, 128)
    for s in (40, 0, 1, 127, 128, 300, -1, -40, -129):
        case("roll_minor", f"(16,128) s={s}", lambda x=x, s=s: roll_minor(x, s),
             lambda x=x, s=s: roll_plain(x, s, 1),
             lambda x=x, s=s: torch.roll(x, s, 1), 2 * x.numel())
    x = rnd(5, 100)
    case("roll_minor", "(5,100) s=33", lambda x=x: roll_minor(x, 33),
         lambda x=x: roll_plain(x, 33, 1), lambda x=x: torch.roll(x, 33, 1),
         2 * x.numel())

    x = ar(16, 8, 128)
    for s in (3, 0, 7, 8, 11, -1, -3, -9):
        case("roll_middle", f"(16,8,128) s={s}",
             lambda x=x, s=s: roll_middle(x, s),
             lambda x=x, s=s: roll_plain(x, s, 1),
             lambda x=x, s=s: torch.roll(x, s, 1), 2 * x.numel())

    x = ar(16, 128)
    low = x % 8
    one = low.clone()
    one[15, 127] = 8
    high = low.clone()
    high[7, 5] = -1                     # 0xFFFFFFFF: above 7 as unsigned
    # a view 4 bytes off 16-byte alignment (the kernel's word path); a tile
    # of 1651 words, 3 past the last whole 16-byte piece; one of more words
    # than the registers hold
    buf = ar(16 * 128 + 1) % 8
    shifted = buf[1:].view(16, 128)
    shifted[3, 3] = 9
    odd = low[:13, :127].contiguous()
    odd[12, 126] = 8
    big = rnd(9, 700) % 8
    big[8, 699] = 8
    for v, label in ((x, "(16,128) arange: some word > 7"),
                     (low, "(16,128) no word above 7"),
                     (one, "(16,128) only the last word above 7"),
                     (high, "(16,128) one word with the top bit set"),
                     (shifted, "(16,128) view 4 bytes off 16-byte alignment"),
                     (odd, "(13,127) only the last word above 7"),
                     (big, "(9,700) only the last word above 7")):
        case("cond", label, lambda v=v: cond_add_one(v),
             lambda v=v: cond_plain(v), None, 2 * v.numel())

    x = ar(32, 1024)
    for s in (40, 0, 41, 3, 896, 895):
        case("window_copy", f"(32,1024)[:, {s}:{s}+128]",
             lambda x=x, s=s: window_copy(x, s),
             lambda x=x, s=s: window_copy_plain(x, s),
             lambda x=x, s=s: x[:, s:s + 128].contiguous(), 2 * 32 * 128)

    x = ar(16, 128)
    case("loop_dyn", "(16,128) arange: n = 7 mod 7 = 0",
         lambda x=x: loop_dyn(x), lambda x=x: loop_dyn_plain(x), None,
         2 * x.numel())
    for n in range(1, 7):
        v = rnd(16, 128)
        v[0, :8] = torch.tensor([3, 0, 7 * 11 + n, 5, 1, 2, 4, 6],
                                dtype=torch.int32, device=device)
        case("loop_dyn", f"(16,128) random words, n = {n}",
             lambda v=v: loop_dyn(v), lambda v=v: loop_dyn_plain(v), None,
             2 * v.numel())

    for x, label in ((ar(16, 8, 128), "(16,8,128) arange"),
                     (rnd(9, 8, 50), "(9,8,50) random words")):
        for n in (4, 0, 1, 3):
            case("dynslice_sum", f"{label}, {n} terms",
                 lambda x=x, n=n: dynslice_sum(x, n),
                 lambda x=x, n=n: dynslice_sum_plain(x, n),
                 lambda x=x, n=n: x[:, 0:2 * n:2, :].sum(
                     dim=1, dtype=torch.int32),
                 (n + 1) * x.shape[0] * x.shape[2])
    return cases


# ----------------------------------------------------------- measurements

def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rate_inputs(op: str, T: int, gen):
    if op == "mul_f32":                       # stays finite for any K here
        a = torch.rand((CHAINS, T), generator=gen, device="cuda") + 0.5
        b = torch.ones((CHAINS, T), device="cuda")
        b[:, ::2] = 1.0 + 2.0 ** -12
        b[:, 1::2] = 1.0 - 2.0 ** -12
        return a, b
    mk = lambda: torch.randint(-(1 << 31), 1 << 31, (CHAINS, T),
                               generator=gen, device="cuda",
                               dtype=torch.int64).to(torch.int32)
    return mk(), mk()


def measure_rates(T: int = 132 * 2048, K: int = 4096, seed: int = 7) -> list:
    """One row per operation, over T threads x CHAINS chains x K steps:
    whether the kernel's final values equal the plain chain's, the time of
    a launch, G steps/s, and the plain chain's time. Needs the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for op in RATE_OPS:
        a, b = _rate_inputs(op, T, gen)
        got = rate_chain(op, a, b, K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rate_chain_plain(op, a, b, K)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ms = _cuda_ms(lambda: rate_chain(op, a, b, K), 5)
        rows.append({"op": op, "exact": bool(torch.equal(got, want)),
                     "threads": T, "K": K, "steps": CHAINS * T * K, "ms": ms,
                     "gsteps_per_s": CHAINS * T * K / ms / 1e6,
                     "plain_ms": plain_ms})
    return rows


def measure_cios(fks, L: int = 1 << 20, K: int = 64, seed: int = 8) -> list:
    """One row per (field kernel, variant), over L lanes x K chained
    products: exact against the plain chain, the time of a launch, G
    Montgomery products/s and the plain chain's time. ``fks``: FpKernels
    on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for fk in fks:
        top = fk.p >> (16 * (fk.N - 1))

        def rand():
            lo = torch.randint(0, 1 << 16, (fk.N - 1, L), generator=gen,
                               device="cuda", dtype=torch.int32)
            hi = torch.randint(0, top, (1, L), generator=gen, device="cuda",
                               dtype=torch.int32)
            return torch.cat([lo, hi], dim=0)
        a, b = rand(), rand()
        a[:, :3] = fk.encode([0, 1, fk.p - 1], mont=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cios_chain_plain(fk, a, b, K)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for variant in bodies(fk):
            got = cios_chain(fk, variant, a, b, K)
            ms = _cuda_ms(lambda: cios_chain(fk, variant, a, b, K), 5)
            rows.append({"N": fk.N, "bits": fk.p.bit_length(),
                         "variant": variant,
                         "exact": bool(torch.equal(got, want)), "lanes": L,
                         "K": K, "ms": ms,
                         "gproducts_per_s": L * K / ms / 1e6,
                         "wide_mads_per_product": 2 * fk.nw ** 2 + fk.nw,
                         "plain_ms": plain_ms})
    return rows


def measure_product_latency(fks, K: int = 2048, seed: int = 9,
                            variants=None) -> list:
    """One row per (field kernel, variant): K chained products over ONE
    element, so the time over K is the latency of one dependent product
    (one thread for the carry chains, one lane group for ``lanes``), in us;
    exact against the plain chain. variants: the latency bodies of each
    width (``bodies``) by default. Needs the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for fk in fks:
        top = fk.p >> (16 * (fk.N - 1))

        def rand():
            lo = torch.randint(0, 1 << 16, (fk.N - 1, 1), generator=gen,
                               device="cuda", dtype=torch.int32)
            hi = torch.randint(0, top, (1, 1), generator=gen, device="cuda",
                               dtype=torch.int32)
            return torch.cat([lo, hi], dim=0)
        a, b = rand(), rand()
        want = cios_chain_plain(fk, a, b, K)
        for variant in variants or bodies(fk, latency=True):
            got = cios_chain(fk, variant, a, b, K)
            ms = _cuda_ms(lambda: cios_chain(fk, variant, a, b, K), 3)
            rows.append({"N": fk.N, "variant": variant,
                         "exact": bool(torch.equal(got, want)), "K": K,
                         "ms": ms, "latency_us": ms * 1e3 / K})
    return rows


def dep_mad(y: int, K: int) -> torch.Tensor:
    """K dependent wide multiply-adds x = lo(x) y + x in one thread (x
    starts at y | 1), the final x as a one-element int64 tensor on the
    card."""
    out = torch.empty(1, dtype=torch.int64, device="cuda")
    code = cuda_lib.lib("probe").lsn_probe_dep_mad(
        y & _M32, out.data_ptr(), K, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "probe_dep_mad")
    LAUNCHES["probe_dep_mad"] += 1
    return out


def dep_mad_plain(y: int, K: int) -> int:
    x = (y & _M32) | 1
    for _ in range(K):
        x = ((x & _M32) * (y & _M32) + x) & ((1 << 64) - 1)
    return x


def measure_dep_mad(K: int = 1 << 16, y: int = 0x9E3779B9) -> dict:
    """The latency of one dependent wide multiply-add (ns), from one
    thread's chain of K of them; exact against the plain chain."""
    got = dep_mad(y, K)
    ms = _cuda_ms(lambda: dep_mad(y, K), 5)
    want = dep_mad_plain(y, K)
    return {"K": K, "ms": ms, "ns": ms * 1e6 / K,
            "exact": int(got.item()) & ((1 << 64) - 1) == want}


def _empty_launch():
    code = cuda_lib.lib("probe_layout").lsn_layout_empty(
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "probe_layout[empty]")


def launch_floor_ms(reps: int = 200) -> float:
    """Device time per call of an empty kernel launched through the same
    C entry route and replayed in a CUDA graph as ``measure_layout`` times
    the layout kernels: the least time any of them can take. Needs the
    card."""
    return _graph_ms(_empty_launch, reps)


def _graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``reps`` calls replayed as one
    CUDA graph: a call that moves a few KB takes less time on the card than
    its launch takes on the host, so a loop of eager calls would time the
    host. ``fn`` must not wait for the device. A wrapper called during
    the capture records its kernel without running it, so what the capture
    added to ``LAUNCHES`` is taken back and added once per replay, when the
    kernels run."""
    fn()
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    captured = {k: n - before[k] for k, n in LAUNCHES.items()
                if n != before[k]}
    LAUNCHES.update(before)

    def replay():
        graph.replay()
        for k, n in captured.items():
            LAUNCHES[k] += n
    replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure_layout(seed: int = 11, reps: int = 200) -> list:
    """One row per layout probe, at its TPU script's case (the first of its
    ``layout_cases``): ``exact`` says whether the kernel equals its plain
    version in EVERY case of that name. ``ms``, ``plain_ms`` and
    ``library_ms`` (None where no PyTorch call computes the function) are
    device times per call inside a replayed CUDA graph; ``call_ms`` is the
    wrapper called in a loop, which at these sizes is the host's time to
    launch. Then the bytes moved and GB/s, and ``floor_ms``: the empty
    kernel's time in the same kind of graph (``launch_floor_ms``). Needs
    the card."""
    rows = {}
    floor = launch_floor_ms(reps)
    for name, label, kern, plain, lib, nbytes in layout_cases("cuda", seed):
        want = plain()
        same = bool(torch.equal(kern(), want))
        if lib is not None and not torch.equal(lib(), want):
            raise AssertionError(f"{name}, {label}: the PyTorch call timed "
                                 "beside the kernel computes another function")
        if name in rows:
            rows[name]["exact"] &= same
            rows[name]["cases"] += 1
            continue
        ms = _graph_ms(kern, reps)
        rows[name] = {
            "name": name, "case": label, "exact": same, "cases": 1, "ms": ms,
            "call_ms": _cuda_ms(kern, reps),
            "plain_ms": _graph_ms(plain, reps),
            "library_ms": _graph_ms(lib, reps) if lib else None,
            "floor_ms": floor, "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6}
    return [rows[name] for name in LAYOUT_PROBES]


def measure_row_copy(widths=(16, 24, 32, 48), total_rows: int = 1 << 20,
                     seed: int = 12, reps: int = 20) -> list:
    """``row_copy`` over 2^20 rows of a 2^21-row table at the row widths
    ``bucket_reduce`` gathers (2 NW words: 16 and 24 for G1 at 16 and 24
    limbs, 32 and 48 for G2), as segments of R = 1 and R = 16 rows at random
    offsets; beside it the time of the same gather as one
    ``x.index_select`` over row indices built before the timing. One row
    per (width, R), with the bytes (rows read and written once, 8 bytes of
    seg a segment). Needs the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for width in widths:
        x = torch.randint(-(1 << 31), 1 << 31, (2 * total_rows, width),
                          generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.int32)
        for R in (1, 16):
            nseg = total_rows // R
            seg = torch.randint(0, 2 * total_rows - R, (nseg,), generator=gen,
                                device="cuda")
            idx = row_gather_index(0, R, seg, "cuda")
            want = row_copy_plain(x, 0, R, seg)
            got = row_copy(x, 0, R, seg)
            lib = x.index_select(0, idx).view(nseg, R, width)
            if not torch.equal(lib, want):
                raise AssertionError("index_select computes another gather")
            exact = bool(torch.equal(got, want))
            ms = _cuda_ms(lambda: row_copy(x, 0, R, seg, validate=False),
                          reps)
            lib_ms = _cuda_ms(lambda: x.index_select(0, idx), reps)
            nbytes = 2 * 4 * total_rows * width + 8 * nseg
            out.append({"width": width, "R": R, "segments": nseg,
                        "exact": exact, "ms": ms, "library_ms": lib_ms,
                        "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6})
    return out


# ------------------------------------------------------------ machine code

def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(cuda_lib.nvcc_path()).with_name("cuobjdump")
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found beside nvcc")


# opcodes (before the first dot) that say where a kernel's data went:
# global, shared and local memory, shuffles, votes, barriers
MEMORY_OPS = ("LDG", "STG", "LDS", "STS", "LDL", "STL", "SHFL", "VOTE", "BAR")


def _kernel_label(mangled: str):
    m = re.search(r"reshape_kernelILi(\d+)E", mangled)
    if m:
        return f"probe_layout_{RESHAPES[int(m.group(1))]}"
    m = re.search(r"_Z\d+([a-z_]+)_kernel", mangled)
    if m and m.group(1) in LAYOUT_PROBES:
        return f"probe_layout_{m.group(1)}"
    m = re.search(r"rate_kernelILi(\d+)E", mangled)
    if m:
        return f"probe_rate_{RATE_OPS[int(m.group(1))]}"
    m = re.search(r"lanes_chain_kernelILi(\d+)E", mangled)
    if m:
        return f"probe_cios_lanes_n{2 * int(m.group(1))}"
    if "half_chain_kernel" in mangled:
        return f"probe_cios_{HALF_VARIANT}_n19"
    if "dep_mad_kernel" in mangled:
        return "probe_dep_mad"
    m = re.search(r"cios_kernelILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"probe_cios_{CIOS_VARIANTS[int(m.group(2))]}_n{2 * int(m.group(1))}"
    return None


_REG = r"\bU?R\d+\b"


def main_loop(sass: str) -> list:
    """(opcode, is loop control) of each instruction of the longest loop
    (a backward branch and everything between it and its target) of one
    function's ``cuobjdump -sass`` text. The loop's own control is its
    branches, its compares, and its counter steps: an add of an immediate
    into itself of a register that a compare of the loop reads."""
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_.]*)"
        r"([^;]*);", sass)]
    best = (0, 0)
    for addr, opc, rest in ins:
        m = re.search(r"0x([0-9a-f]+)", rest) if opc.startswith("BRA") else None
        if m and int(m.group(1), 16) <= addr and \
                addr - int(m.group(1), 16) > best[1] - best[0]:
            best = (int(m.group(1), 16), addr)
    loop = [(opc, rest) for addr, opc, rest in ins
            if best[0] <= addr <= best[1] and best[1] > 0]
    counters = {r for opc, rest in loop if opc.startswith("ISETP")
                for r in re.findall(_REG, rest)}

    def control(opc, rest):
        if opc.startswith(("BRA", "ISETP")):
            return True
        ops = [o.strip() for o in rest.split(",")]
        return opc.split(".")[0] in ("IADD3", "UIADD3", "VIADD") \
            and len(ops) >= 3 and ops[0] == ops[1] and ops[0] in counters \
            and re.fullmatch(r"-?0x[0-9a-f]+", ops[2]) is not None
    return [(opc, control(opc, rest)) for opc, rest in loop]


def loop_counts(loop: list, control: bool = True) -> dict:
    """Opcode counts of a ``main_loop``, most frequent first; control=False
    leaves out the loop's own control."""
    counts: dict = {}
    for opc, is_control in loop:
        if control or not is_control:
            counts[opc] = counts.get(opc, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def single_wide_mad_loop(steps: dict) -> bool:
    """Whether a rate kernel's main loop, its control left out
    (``loop_counts(loop, control=False)``), is one IMAD.WIDE.U32 a step and
    nothing else: CHAINS x RATE_UNROLL of them, no add beside them."""
    return steps == {"IMAD.WIDE.U32": CHAINS * RATE_UNROLL}


def _sass_functions(dump_to=None):
    """(launch-counter key, ``cuobjdump -sass`` text) of every kernel of the
    two probe libraries. ``dump_to``: a file that gets the whole text."""
    cuda_lib.build_all()
    text = "".join(
        subprocess.run([_cuobjdump(), "-sass", str(cuda_lib.library_path(src))],
                       check=True, capture_output=True, text=True).stdout
        for src in ("probe", "probe_layout"))
    if dump_to is not None:
        Path(dump_to).parent.mkdir(parents=True, exist_ok=True)
        Path(dump_to).write_text(text)
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        label = _kernel_label(part.split("\n", 1)[0])
        if label:
            yield label, part


def sass_loops(dump_to=None) -> dict:
    """Kernel name (the launch-counter key) -> its ``main_loop``, from the
    built probe libraries ([] for a kernel without a loop). Needs the CUDA
    toolkit."""
    return {label: main_loop(part) for label, part in _sass_functions(dump_to)}


def memory_ops(sass: str) -> dict:
    """Counts of the ``MEMORY_OPS`` opcodes in one function's listing; a
    16-byte access counts under its opcode and ".128" (LDG.128)."""
    counts: dict = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?"
                         r"([A-Z][A-Z0-9_]*)([A-Z0-9_.]*)[^;]*;", sass):
        if m.group(1) in MEMORY_OPS:
            key = m.group(1) + (".128" if ".128." in m.group(2) + "."
                                else "")
            counts[key] = counts.get(key, 0) + 1
    return counts


def sass_memory_ops() -> dict:
    """Layout kernel name -> counts of the instructions that say where its
    data went (``MEMORY_OPS``; LDL / STL mean a per-thread array landed in
    local memory). Needs the CUDA toolkit."""
    return {label: memory_ops(part) for label, part in _sass_functions()
            if label.startswith("probe_layout_")}
