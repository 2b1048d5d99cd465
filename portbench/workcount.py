"""The least time of a multi-scalar multiplication on the card, counted
from its inputs alone, and the card's peaks that it divides by.

The count reads the same work whatever implements the MSM: it comes from
the number of points, the field widths and the scalars' values, never
from the program's launches. The least time is the larger of two bounds:

* bytes: each base point and each scalar read once at the field's packed
  width (ceil(bits / 8) bytes a coordinate or scalar), the result written
  once as an affine point, over ``MEM_BYTES_PER_S``;
* compute: the group additions of a signed-digit bucket MSM at its best
  window c for these scalars (one mixed addition per nonzero digit, less
  the first point of each bucket, which is a copy; 2 (k - 1) full
  additions for the running sums of a window whose largest digit is k;
  c doublings a window below the last with a nonzero digit, and one full
  addition to fold each window that has one into the sum), times the field products
  of each addition, times the 32-bit wide multiply-adds of a Montgomery
  product at the field's word count (2 W^2 + W, carries left out), over
  ``WIDE_MADS_PER_S``.

It leaves out endomorphisms (GLV) and precomputed multiples of the bases:
an MSM that uses either does less work than this count, and the count
has to be made again before such a change is measured against it.
"""
from __future__ import annotations

import functools

import numpy as np

# NVIDIA H100 SXM5 (data sheet): HBM3 at 3.35 TB/s; 132 SMs with 64 INT32
# lanes each at a 1.98 GHz boost clock. A 32 x 32 -> 64-bit multiply-add
# (IMAD.WIDE.U32, what a field product is made of) takes two dispatch slots
# of a lane. The repository's mad_wide probe (scripts/probe_h100.py) runs
# at 0.92 of the 8.375e12 that 67 TFLOP/s / 8 gives, on an
# NVIDIA H100 80GB HBM3 at 700 W; this derivation gives 0.14 % less.
MEM_BYTES_PER_S = 3.35e12
SM_COUNT = 132
INT32_LANES_PER_SM = 64
BOOST_CLOCK_HZ = 1.98e9
SLOTS_PER_WIDE_MAD = 2
WIDE_MADS_PER_S = (SM_COUNT * INT32_LANES_PER_SM * BOOST_CLOCK_HZ
                   / SLOTS_PER_WIDE_MAD)

# field products (a squaring counted as a product) of each group
# operation in Jacobian coordinates with a = 0: mixed addition
# madd-2007-bl 7M + 4S, addition add-2007-bl 11M + 5S, doubling
# dbl-2009-l 2M + 5S. Over Fq2 a product takes 3 base products
# (Karatsuba) and a squaring 2.
GROUP_OP_PRODUCTS = {
    1: {"madd": 11, "add": 16, "dbl": 7},
    2: {"madd": 7 * 3 + 4 * 2, "add": 11 * 3 + 5 * 2, "dbl": 2 * 3 + 5 * 2},
}


def words(bits: int) -> int:
    return -(-bits // 32)


def wide_mads_per_product(field_bits: int) -> int:
    """32-bit wide multiply-adds of one Montgomery product (CIOS)."""
    W = words(field_bits)
    return 2 * W * W + W


def scalar_words(scalars, scalar_bits: int) -> np.ndarray:
    """(W, n) uint64 little-endian words of Python int scalars."""
    nw = -(-scalar_bits // 64)
    buf = b"".join(int(s).to_bytes(8 * nw, "little") for s in scalars)
    return np.ascontiguousarray(
        np.frombuffer(buf, dtype="<u8").reshape(-1, nw).T)


def _window(w: np.ndarray, offset: int, c: int) -> np.ndarray:
    """Bits offset .. offset + c - 1 of each scalar (c <= 32)."""
    q, s = divmod(offset, 64)
    nw = w.shape[0]
    lo = w[q] >> np.uint64(s) if q < nw else np.zeros(w.shape[1], np.uint64)
    if s + c > 64 and q + 1 < nw:
        lo = lo | (w[q + 1] << np.uint64(64 - s))
    return lo & np.uint64((1 << c) - 1)


def digit_counts(w: np.ndarray, scalar_bits: int, c: int) -> tuple:
    """The signed-digit recoding at window c (digits in [-2^(c-1),
    2^(c-1)], a carry into the next window where a digit passes
    2^(c-1)): (windows up to the last with a nonzero digit, nonzero
    digits, nonempty buckets, windows with a nonzero digit, additions of
    the running sums: 2 (k - 1) in a window whose largest digit is k)."""
    carry = np.zeros(w.shape[1], np.int64)
    half = 1 << (c - 1)
    top = nonzero = buckets = live = run_adds = 0
    offset = window = 0
    while offset < scalar_bits or carry.any():
        d = _window(w, offset, c).astype(np.int64) + carry
        carry = (d > half).astype(np.int64)
        d = np.abs(d - (carry << c))
        nz = int(np.count_nonzero(d))
        window += 1
        offset += c
        if not nz:
            continue
        used = np.flatnonzero(np.bincount(d)[1:])
        nonzero += nz
        buckets += len(used)
        live += 1
        run_adds += 2 * int(used[-1])
        top = window
    return top, nonzero, buckets, live, run_adds


class DigitCounts:
    """The digit counts of one set of scalars, made at each window c when
    first asked for."""

    def __init__(self, scalars, scalar_bits: int):
        self.w = scalar_words(scalars, scalar_bits)
        self.n = self.w.shape[1]
        self.bits = scalar_bits
        self._at = {}

    def at(self, c: int) -> tuple:
        if c not in self._at:
            self._at[c] = digit_counts(self.w, self.bits, c)
        return self._at[c]


@functools.lru_cache(maxsize=None)
def uniform_counts(n: int, r: int) -> DigitCounts:
    """The digit counts of n uniform scalars below r from a fixed stream:
    the stand-in for scalars that the program derives and the benchmark
    does not (the witness map's H, the opening's quotient)."""
    gen = np.random.Generator(np.random.PCG64(n))
    width = (r.bit_length() + 64 + 7) // 8
    buf = gen.bytes(width * n)
    sc = [int.from_bytes(buf[i:i + width], "little") % r
          for i in range(0, width * n, width)]
    return DigitCounts(sc, r.bit_length())


def _products(counts: DigitCounts, c: int, per: dict) -> int:
    top, nonzero, buckets, live, run_adds = counts.at(c)
    madd = nonzero - buckets
    add = run_adds + max(0, live - 1)
    dbl = max(0, top - 1) * c
    return madd * per["madd"] + add * per["add"] + dbl * per["dbl"]


def msm_bound(counts: DigitCounts, field_bits: int, ext: int) -> dict:
    """The least time of one MSM over the scalars of ``counts`` and as many
    points over a field of field_bits (coordinates in Fq^ext): seconds of
    both bounds, the window that sets the compute bound, and which bound
    is the larger. The best window is found by a walk from
    log2(n) - 3, where the count of field products falls on one side and
    rises on the other."""
    per = GROUP_OP_PRODUCTS[ext]
    c = max(2, counts.n.bit_length() - 4)
    best = _products(counts, c, per)
    for step in (1, -1):
        while c + step >= 2:
            p = _products(counts, c + step, per)
            if p >= best:
                break
            best, c = p, c + step
    mads = best * wide_mads_per_product(field_bits)
    coord = (field_bits + 7) // 8
    n = counts.n
    nbytes = n * (2 * ext * coord + (counts.bits + 7) // 8) + 2 * ext * coord
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = mads / WIDE_MADS_PER_S
    return {"seconds": max(t_bytes, t_ops), "bytes_s": t_bytes,
            "compute_s": t_ops, "window": c,
            "bound": "bytes" if t_bytes >= t_ops else "compute"}
