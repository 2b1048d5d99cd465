"""Host <-> device packed-limb conversions.

Field elements are ``LIMB_BITS``-bit (16) limbs, **limb axis leading,
batch axes trailing**: an Fp array has shape ``(num_limbs, *batch)``.
Extension fields stack coefficients in front (``(2, num_limbs, *batch)``);
Jacobian points are (X, Y, Z) tuples of such arrays. This is the JAX
package's layout (libsnark_tpu/ops/limbs.py); it is also the coalesced
layout for one-thread-per-element CUDA kernels, where limb k of element t
sits at ``k * L + t``.

On the host the limbs are numpy uint32 (the JAX package's dtype); on the
torch side they are ``torch.int32``, which holds the same bits for values
below 2^16 (torch's uint32 has partial operator coverage).

``ints_to_limbs`` / ``limbs_to_ints`` convert on the host through the
native codec (``libsnark_tpu_torch/native``, built with g++ at first use).
``limbs_to_words`` / ``words_to_limbs`` convert to and from the CUDA
kernels' register layout, 32-bit words (two limbs each) carried as int32
bit patterns: the packed row table that ``bucket_reduce`` gathers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..native import limbcodec

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, n: int) -> np.ndarray:
    """Single int -> (n,) uint32 limb vector (little-endian limbs)."""
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)],
                    dtype=np.uint32)


def ints_to_limbs(xs, n: int, p: int = None) -> np.ndarray:
    """Iterable of non-negative ints < 2^(16 n) (Python or numpy integers)
    -> (n, len(xs)) uint32, through the native codec (``native``; built at
    first use, raises if it cannot be). OverflowError for a negative int or
    one of 2^(16 n) or more. With a modulus p, the limbs of x % p: the
    codec reduces only an int that is negative or at least p."""
    xs = xs if isinstance(xs, (list, tuple)) else list(xs)
    buf = (limbcodec().encode(xs, n) if p is None
           else limbcodec().encode(xs, n, p))
    # a bytearray: the array is writable without a copy
    return np.frombuffer(buf, dtype=np.uint32).reshape(n, len(xs))


def _ints_to_limbs_py(xs, n: int, p: int = None) -> np.ndarray:
    """The Python form of ``ints_to_limbs`` (``x % p`` per element where p
    is given, ``int.to_bytes`` per element and one numpy view), kept as the
    codec's reference."""
    xs = list(xs) if p is None else [int(x) % p for x in xs]
    if not xs:
        return np.zeros((n, 0), dtype=np.uint32)
    nbytes = 2 * n
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    limbs = np.frombuffer(buf, dtype="<u2").reshape(len(xs), n)
    return np.ascontiguousarray(limbs.T).astype(np.uint32)


def limbs_to_int(a) -> int:
    """(n,) limb vector -> int."""
    a = np.asarray(a)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a))


def limbs_to_ints(a) -> list:
    """(n, B) limb array -> list of B ints (the low 16 bits of each limb),
    through the native codec."""
    a = np.ascontiguousarray(np.asarray(a), dtype=np.uint32)
    n, b = a.shape
    return limbcodec().decode(a, n, b)


def _limbs_to_ints_py(a) -> list:
    """The Python form of ``limbs_to_ints``, kept as the codec's
    reference."""
    a = np.asarray(a)
    n, b = a.shape
    raw = np.ascontiguousarray(a.T.astype("<u2")).tobytes()
    nbytes = 2 * n
    return [int.from_bytes(raw[j * nbytes:(j + 1) * nbytes], "little")
            for j in range(b)]


def to_torch(a, device) -> torch.Tensor:
    """numpy uint32 limbs (or bool masks) -> torch tensor on ``device``
    (int32 for limbs, bool for masks)."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return torch.from_numpy(
        np.ascontiguousarray(a.astype(np.int32))).to(device)


def from_torch(t: torch.Tensor) -> np.ndarray:
    """torch limb tensor -> numpy uint32 (bool masks stay bool)."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.bool_:
        return a
    return a.astype(np.uint32)


def limbs_to_words(a: torch.Tensor) -> torch.Tensor:
    """(2K, *batch) int32 16-bit limbs -> (K, *batch) int32 words: word k
    holds limb 2k in its low and limb 2k + 1 in its high 16 bits, its 32
    bits carried as an int32 bit pattern."""
    return (a[0::2] & LIMB_MASK) | (a[1::2] << LIMB_BITS)


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """The inverse of ``limbs_to_words``: (K, *batch) int32 words -> (2K,
    *batch) int32 limbs."""
    out = torch.empty((2 * w.shape[0],) + tuple(w.shape[1:]),
                      dtype=torch.int32, device=w.device)
    out[0::2] = w & LIMB_MASK
    out[1::2] = (w >> LIMB_BITS) & LIMB_MASK
    return out
