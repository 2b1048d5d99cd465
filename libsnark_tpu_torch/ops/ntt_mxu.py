"""The NTT as integer matrix products on the tensor cores (the port of
libsnark_tpu/ops/ntt_mxu.py, the JAX package's MXU NTT).

The radix-2 core in ops/ntt.py issues a product and two additions a level
over the whole array. This module recasts the transform as recursive
four-step Cooley-Tukey with radix 16 (Bailey), where each radix-R DFT is
ONE shared integer matrix product:

  * Field elements (Montgomery form, 16-bit limbs) are split into 4-bit
    nibbles; multiplication by the CONSTANT DFT matrix W_R[k,j] = w^(jk) is
    linear over the nibbles, so the whole "sum of field products" is one
    (lanes, 4N R) x (4N R, 8N R) int8 product with int32 accumulation,
    exact: a column sums at most 225 * 4N R < 2^24.
  * A second small "fold" product compresses each level's wide result (8N
    nibble columns) back to 4N nibbles mod p, and the per-level twiddle
    product doubles as the reduction to canonical form: ``FpKernel.mul_wide``
    (the ``mul_wide`` kernel on the card) against the PLAIN twiddle table,
    an (N + 2)-limb Montgomery product.
  * The 2^(-16 (N + 2)) factor of each level is cancelled by one final
    constant, which also absorbs 1/m for the inverse transform and any
    coset / divide-by-Z scalar.

The products: on the card ``torch._int_mm`` (int8 x int8 -> int32) for the
``"int8"`` form, and ``torch.mm`` of bfloat16 operands with a float32 result
for the ``"bf16"`` form (a bfloat16 result would round; the float32 one is
exact under the 2^24 bound). These are the plain large matrix products the
JAX package computes with ``jax.lax.dot_general`` outside any Pallas kernel.
On the CPU both forms take the same float32 product (exact under the same
bound), so they differ only on the card.

Behavioural parity target: libfqfft basic_radix2_domain FFT / iFFT (natural
order in and out); every value is canonical, so the output is bit-identical
to the radix-2 core's and to the JAX package's MxDft.
"""
from __future__ import annotations

import numpy as np
import torch

from .limbs import LIMB_BITS, LIMB_MASK, ints_to_limbs
from .ntt import powers_table

DTYPES = ("int8", "bf16")

# the matrix products run on the card, by form (the launches of the path)
MATMULS = dict.fromkeys(DTYPES, 0)


def _dft_digit_matrix(p: int, w: int, R: int, N: int,
                      ldiag=None, rdiag=None) -> np.ndarray:
    """Nibble-expanded DFT matrix for radix R, root w (order R) mod p.

    Returns AM (TO*R, D*R) uint8 with D = 4N input nibbles per element
    and TO = 2*D output nibble positions:
      AM[t*R + k, d*R + j] = nibble_{t-d}( ldiag[k] * w^(jk) * rdiag[j] )
    so that for canonical inputs v_j = sum_d nib[d,j] 2^(4d):
      out[t, k] = sum_{d,j} AM[tR+k, dR+j] * nib[d, j]
                = nibble-column t of  sum_j W[k,j] * v_j  (exact).
    ldiag/rdiag (length-R plain ints) fold coset scalings into the
    matrix for free.
    """
    D = 4 * N
    TO = 2 * D
    W = np.zeros((R, R), dtype=object)
    for k in range(R):
        for j in range(R):
            v = pow(w, (j * k) % R, p)
            if ldiag is not None:
                v = v * ldiag[k] % p
            if rdiag is not None:
                v = v * rdiag[j] % p
            W[k, j] = v
    nib = np.zeros((D, R, R), dtype=np.uint8)
    for d in range(D):
        for k in range(R):
            for j in range(R):
                nib[d, k, j] = (W[k, j] >> (4 * d)) & 15
    AM = np.zeros((TO * R, D * R), dtype=np.uint8)
    t_idx = np.arange(TO)[:, None]
    d_idx = np.arange(D)[None, :]
    delta = t_idx - d_idx
    ok = (delta >= 0) & (delta < D)
    for k in range(R):
        for j in range(R):
            block = np.zeros((TO, D), dtype=np.uint8)
            block[ok] = nib[delta[ok], k, j]
            AM[k::R, j::R] = block
    return AM


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, cols - x.shape[1],
                                       0, rows - x.shape[0]))


class _Weights:
    """One constant nibble matrix M (rows, k) on one device, in the operand
    form of its product: int8 or bfloat16 on the card (zero-padded for
    ``_int_mm``'s shape rules), float32 on the CPU."""

    def __init__(self, M: np.ndarray, device: torch.device, dtype: str):
        self.rows, self.k = M.shape
        t = torch.from_numpy(M.astype(np.int16))
        if device.type != "cuda":
            self.w = t.to(torch.float32)
        elif dtype == "int8":
            # _int_mm on CUDA wants k and the result's columns multiples of
            # 8 (zero rows and columns add nothing to a sum)
            self.w = _pad2(t, _round_up(self.rows, 8),
                           _round_up(self.k, 8)).to(torch.int8).to(device)
        else:
            self.w = t.to(torch.bfloat16).to(device)
        self.dtype = dtype

    def matmul(self, xT: torch.Tensor) -> torch.Tensor:
        """xT (B, k) nibble values (any integer dtype) -> (B, rows) int32,
        the exact product xT M^T."""
        B = xT.shape[0]
        if not xT.is_cuda:
            out = torch.mm(xT.to(torch.float32), self.w.t())
            return out.to(torch.int32)
        MATMULS[self.dtype] += 1
        if self.dtype == "int8":
            # _int_mm on CUDA: more than 16 rows, k a multiple of 8; M's
            # transpose is the view of a contiguous (rows, k) tensor, the
            # layout its int8 path takes
            rows_p, k_p = self.w.shape
            x = _pad2(xT.to(torch.int8), max(24, _round_up(B, 8)), k_p)
            return torch._int_mm(x, self.w.t())[:B, :self.rows]
        out = torch.mm(xT.to(torch.bfloat16), self.w.t(),
                       out_dtype=torch.float32)
        return out.to(torch.int32)


def carry_propagate(cols: torch.Tensor, out_len: int) -> torch.Tensor:
    """Sequential carry propagation of non-negative int64 columns -> out_len
    limbs < 2^16 (the JAX package's ``_carry_propagate``); int32."""
    out = []
    carry = torch.zeros_like(cols[0])
    for k in range(out_len):
        v = cols[k] + carry if k < cols.shape[0] else carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return torch.stack(out).to(torch.int32)


class MxDft:
    """DFT of size n = 2^logn over Fr via digit matrix products.

    Drop-in for Radix2Domain's transform semantics (natural order in/out,
    Y[k] = sum_j x[j] w^(jk), Montgomery limbs in and out). ``scale`` is an
    extra plain-int factor folded into the final correction (1/m for the
    inverse transform, coset constants, ...). ``dtype``: ``"int8"`` or
    ``"bf16"``, the operand type of the products on the card.
    """

    def __init__(self, fk, logn: int, omega: int, scale: int = 1,
                 dtype: str = "int8", coset_in: int = None,
                 coset_out: int = None):
        """coset_in=g folds the input scaling x[j] *= g^j into the DFT
        matrices (cosetFFT); coset_out=h folds the output scaling
        Y[k] *= h^k (icosetFFT's post-multiply)."""
        if dtype not in DTYPES:
            raise ValueError(f"unknown MXU dtype {dtype!r}; available: "
                             f"{DTYPES}")
        self.fk = fk
        p = fk.p
        N = fk.N
        assert 4 + 2 * p.bit_length() <= 32 * N, \
            "wide product must fit 2N limbs"
        self.logn = logn
        self.n = 1 << logn
        self.omega = omega
        self.dtype = dtype
        # level sizes: peel radix 16 until the leaf (<= 16)
        sizes = [self.n]
        while sizes[-1] > 16:
            sizes.append(sizes[-1] // 16)
        self.sizes = sizes
        # per-level OUTER-DFT matrices (radix 16, the leaf's for the last);
        # the order-R root is omega^(n/R) at every level. Coset diagonals:
        # level l's input index j1 carries g^(16^l * j1); its output index
        # k1 carries h^((nl/16) * k1), with h^(k2) delegated to the child.
        self._AM_levels = []
        cache = {}
        for l, nl in enumerate(sizes):
            R = min(nl, 16)
            wR = pow(omega, self.n // R, p)
            ld = rd = None
            if coset_in is not None:
                gl = pow(coset_in, 16 ** l, p)
                rd = tuple(pow(gl, j, p) for j in range(R))
            if coset_out is not None:
                hl = coset_out if nl <= 16 else pow(coset_out, nl // 16, p)
                ld = tuple(pow(hl, k, p) for k in range(R))
            key = (R, wR, ld, rd)
            if key not in cache:
                cache[key] = _dft_digit_matrix(p, wR, R, N, ld, rd)
            self._AM_levels.append(cache[key])
        # fold matrix: F[d, t*5+s] = nib_d(2^(4(t+s)) % p) -- each int32
        # nibble column splits into 5 four-bit planes
        D = 4 * N
        TO = 2 * D
        F = np.zeros((D, TO * 5), dtype=np.uint8)
        for t in range(TO):
            for s in range(5):
                v = pow(2, 4 * (t + s), p)
                for d in range(D):
                    F[d, t * 5 + s] = (v >> (4 * d)) & 15
        self._fold = F
        self._wa = N + 2
        # final correction: cancel one 2^(-16*Wa) per level, apply scale
        c = pow(2, 16 * self._wa * len(sizes), p) * (scale % p) % p
        self._final_int = c
        self._tables = {}

    # ------------------------------------------------------------- tables
    def device_tables(self, device=None):
        """The matrices in their operand form, the plain twiddle tables
        ((N, 16, n2) a level, built on the device from the root's powers:
        TW[j1, k2] = w_l^(j1 k2)) and the final constant, once per device."""
        device = torch.device(device or self.fk.device)
        if device.type == "cuda" and device.index is None:
            # "cuda" and "cuda:0" (a tensor's device) are one key
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        if key not in self._tables:
            fk, p = self.fk, self.fk.p
            uniq = {}
            for m in self._AM_levels:
                if id(m) not in uniq:
                    uniq[id(m)] = _Weights(m, device, self.dtype)
            tw = []
            for nl in self.sizes[:-1]:
                wl = pow(self.omega, self.n // nl, p)
                n2 = nl // 16
                pw = powers_table(fk, wl, nl, device=device)
                idx = (torch.arange(16, device=device)[:, None]
                       * torch.arange(n2, device=device)[None, :])
                tw.append(fk.from_mont(pw[:, idx]))
            final = torch.from_numpy(ints_to_limbs(
                [self._final_int], fk.N).astype(np.int32)).to(device)
            self._tables[key] = {
                "AM": tuple(uniq[id(m)] for m in self._AM_levels),
                "tw": tuple(tw),
                "fold": _Weights(self._fold, device, self.dtype),
                "final": final,
            }
        return self._tables[key]

    # ------------------------------------------------------------ products
    def _matmul(self, v, AM, R: int):
        """One radix-R DFT along the LAST axis of v (canonical Montgomery
        limbs (N, *batch, R)) as one digit product. Returns wide nibble
        columns (TO, *batch, R) int32."""
        N = self.fk.N
        D = 4 * N
        # nibbles as int8 from the start: the copies below move a quarter
        # of the bytes
        ds = torch.stack([((v >> (4 * s)) & 15).to(torch.int8)
                          for s in range(4)], dim=1)
        ds = ds.reshape((D,) + tuple(v.shape[1:]))       # d = 4 i + s
        batch = tuple(v.shape[1:-1])
        xT = ds.movedim(0, -2).reshape(-1, D * R)        # cols d R + j
        out = AM.matmul(xT)                              # cols t R + k
        out = out.reshape(batch + (2 * D, R))
        return out.movedim(-2, 0)                        # (TO, *batch, R)

    def _mulw(self, dig, table, tables):
        """Wide nibble columns -> canonical Montgomery limbs, times the
        PLAIN table (twiddles or the final constant): the fold product
        compresses the 8N nibble columns (< 2^20) to 4N (< 2^18), value
        kept mod p, so the product runs N + 2 limbs instead of 2N."""
        N = self.fk.N
        TO = dig.shape[0]
        batch = tuple(dig.shape[1:])
        planes = torch.stack([((dig >> (4 * s)) & 15).to(torch.int8)
                              for s in range(5)], dim=-1)  # (TO, *batch, 5)
        xT = planes.movedim(0, -2).reshape(-1, TO * 5)   # cols t 5 + s
        out = tables["fold"].matmul(xT).to(torch.int64)  # (B, 4N)
        q = out.reshape(-1, N, 4)
        cols = (q[..., 0] + (q[..., 1] << 4) + (q[..., 2] << 8)
                + (q[..., 3] << 12))                     # (B, N)
        cols = cols.t().reshape((N,) + batch)
        wide = carry_propagate(cols, self._wa)
        return self.fk.mul_wide(wide, table)

    # --------------------------------------------------------- recursion
    def _rec(self, v, li: int, post, tables):
        """DFT of size sizes[li] along v's last axis; `post` is the plain
        table the caller wants multiplied into the output (its own
        twiddles, or the final constant at the top)."""
        nl = self.sizes[li]
        if nl <= 16:
            t = self._matmul(v, tables["AM"][li], nl)
            return self._mulw(t, post, tables)
        n2 = nl // 16
        # x[j1 + 16*j2] -> (*, j1, j2): child DFT over j2 batched by j1
        v2 = v.reshape(tuple(v.shape[:-1]) + (n2, 16)).transpose(-1, -2)
        A = self._rec(v2, li + 1, tables["tw"][li], tables)
        C = self._matmul(A.transpose(-1, -2), tables["AM"][li], 16)
        D = C.transpose(-1, -2)                          # (TO, *b, 16, n2)
        D = D.reshape(tuple(D.shape[:-2]) + (nl,))       # k = k2 + n2 k1
        return self._mulw(D, post, tables)

    def apply(self, v, tables=None):
        """v: (N, *batch, n) canonical Montgomery limbs -> DFT, same
        shape and form."""
        if tables is None:
            tables = self.device_tables(v.device)
        return self._rec(v, 0, tables["final"], tables)
