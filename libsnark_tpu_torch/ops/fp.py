"""Batched prime-field arithmetic over limb tensors (the port of
libsnark_tpu/ops/fp.py).

Values are ``(N, *batch)`` int32 tensors of 16-bit limbs, limbs leading,
in Montgomery form x*R mod p with R = 2^(16 N), exactly the JAX package's
layout and form. N is one of ``cuda_lib.FIELD_LIMBS``: 12 (edwards), 16
(alt_bn128, BLS12-377's Fr), 19 (MNT4, MNT6), 24 (BLS12-377's Fq,
BW6-761's Fr) or 48 (BW6-761's Fq); another N is refused at construction.
Every operation returns canonical limbs (< p), so the results are
bit-identical to the JAX ``FpKernel``'s.

``mul`` goes through ``ops/cuda_fp.mont_mul``: the CUDA kernel for tensors
on the card, its plain version for CPU tensors; ``add`` and ``sub`` (and
``neg``, ``double``) through ``cuda_fp.add_sub`` on the card, their plain
versions (torch ops over int64 limbs: carry passes and one conditional
correction by p) on the CPU. A kernel built with ``plain=True`` (see
:meth:`FpKernel.as_plain`) always takes the plain versions; it is what the
EC and MSM kernels are held against.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .cuda_fp import (add_sub, cond_sub_p, ints_lanes, lane_ints,
                      lanes_shape, mont_mul, mont_mul_plain, mul_wide,
                      mul_wide_plain, normalize, redc, small_lanes)
from .limbs import LIMB_BITS, LIMB_MASK, int_to_limbs, ints_to_limbs

I32 = torch.int32
I64 = torch.int64


class FpKernel:
    """Batched modular arithmetic for one prime modulus.

    params: a ``FieldParams`` (curves/curve.py); device: where the
    constructors allocate (``"cuda"`` unless the caller asks for the CPU).
    """

    def __init__(self, params, device="cuda", plain: bool = False):
        self.params = params
        self.p = params.p
        self.N = params.num_limbs
        self.n0inv = int(params.n0inv)
        self.device = cuda_lib.resolve_device(device)
        self.plain = plain
        self.one_mont = params.R % params.p
        self.nw = cuda_lib.words_of(self.N)     # raises on an unbuilt N
        self.mod = cuda_lib.make_mod(self.p, self.N)
        self._consts = {}
        self._plain_twin = None

    def __hash__(self):
        return hash((self.p, self.N))

    def __eq__(self, other):
        return isinstance(other, FpKernel) and other.p == self.p

    def as_plain(self) -> "FpKernel":
        """The same field whose ``mul`` always runs the plain version."""
        if self.plain:
            return self
        if self._plain_twin is None:
            self._plain_twin = FpKernel(self.params, self.device, plain=True)
        return self._plain_twin

    # ------------------------------------------------------------------ utils
    def p_col(self, device, batch_ndim: int, width: int = None):
        """p as an int64 (width, 1, ..) column (zero-padded to width)."""
        width = width or self.N
        key = ("p", str(device), width)
        if key not in self._consts:
            limbs = [int(v) for v in int_to_limbs(self.p, self.N)]
            limbs += [0] * (width - self.N)
            self._consts[key] = torch.tensor(limbs, dtype=I64, device=device)
        return self._consts[key].reshape((width,) + (1,) * batch_ndim)

    def nprime_col(self, device, batch_ndim: int, low: int = None):
        """-p^-1 mod 2^(16 low) as an int64 (low, 1, ..) column (for REDC;
        low = N, the field's R, by default)."""
        low = low or self.N
        key = ("nprime", str(device), low)
        if key not in self._consts:
            R = 1 << (LIMB_BITS * low)
            npr = (-pow(self.p, -1, R)) % R
            self._consts[key] = torch.tensor(
                [int(v) for v in int_to_limbs(npr, low)], dtype=I64,
                device=device)
        return self._consts[key].reshape((low,) + (1,) * batch_ndim)

    def const(self, x: int, batch_ndim: int = 0, device=None) -> torch.Tensor:
        """A host int's canonical limbs as an int32 (N, 1, ..) tensor."""
        t = torch.tensor([int(v) for v in int_to_limbs(x % self.p, self.N)],
                         dtype=I32, device=device or self.device)
        return t.reshape((self.N,) + (1,) * batch_ndim)

    def zeros(self, batch_shape, device=None):
        return torch.zeros((self.N,) + tuple(batch_shape), dtype=I32,
                           device=device or self.device)

    def one(self, batch_shape, device=None):
        c = self.const(self.one_mont, len(batch_shape), device)
        return c.expand((self.N,) + tuple(batch_shape)).contiguous()

    # --------------------------------------------------------------- arithmetic
    def add(self, a, b):
        if a.is_cuda and not self.plain:
            return add_sub(self, a, b, False)
        if small_lanes(a, b):
            vals = lane_ints(self, a, b)
            if vals is not None:        # the value the limb columns give
                p = self.p
                return ints_lanes(self, [x + y - p if x + y >= p else x + y
                                         for x, y in zip(*vals)],
                                  lanes_shape(a, b))
        r, c = normalize(a.to(I64) + b.to(I64))
        r = torch.cat([r, c.unsqueeze(0)], dim=0)
        return cond_sub_p(self, r).to(I32)

    def sub(self, a, b):
        if a.is_cuda and not self.plain:
            return add_sub(self, a, b, True)
        if small_lanes(a, b):
            vals = lane_ints(self, a, b)
            if vals is not None:        # the value the limb columns give
                p = self.p
                return ints_lanes(self, [x - y + p if x < y else x - y
                                         for x, y in zip(*vals)],
                                  lanes_shape(a, b))
        d, c = normalize(a.to(I64) - b.to(I64))
        p = self.p_col(d.device, d.dim() - 1)
        fixed, _ = normalize(d + p)
        return torch.where((c < 0).unsqueeze(0), fixed, d).to(I32)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def is_zero(self, a):
        return torch.all(a == 0, dim=0)

    def eq(self, a, b):
        """Batch-shaped bool: every limb of a equals b's (canonical limbs)."""
        return torch.all(a == b, dim=0)

    def select(self, cond, a, b):
        """cond: batch-shaped bool; picks a where True."""
        return torch.where(cond.unsqueeze(0), a, b)

    @staticmethod
    def stack(xs):
        return torch.stack(xs, dim=1)

    @staticmethod
    def unstack(a):
        return [a[:, i] for i in range(a.shape[1])]

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p; b broadcasts against a."""
        if self.plain:
            return mont_mul_plain(self, a, b)
        return mont_mul(self, a, b)

    def mul_wide(self, a, b):
        """Montgomery product for a WIDE first operand: a (Wa, *batch) with
        Wa >= N 16-bit limbs (value < 2^(16 Wa)), b (N, *bb) < p,
        broadcasting against a's batch from the right. Returns canonical
        a*b*2^(-16 Wa) mod p; the caller tracks the extra 2^(-16 (Wa - N))
        against ``mul``'s R^-1. The ``mul_wide`` kernel on the card."""
        if self.plain:
            return mul_wide_plain(self, a, b)
        return mul_wide(self, a, b)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small(self, a, k: int):
        """a * k mod p for a python-int constant k (any size)."""
        enc = self.const(int(k) * self.params.R, a.dim() - 1, a.device)
        return self.mul(a, enc)

    # -- lazy reductions -------------------------------------------------------
    def reduce_lazy(self, cols):
        """Reduce lazy column sums (value < 2^16 * p) to canonical form.

        cols: (K, *batch) integer columns with K <= 2N+1 (e.g. index_add_
        sums of Montgomery-form values). Returns the exact sum mod p, still
        in Montgomery form: REDC, then one product with R^2."""
        cols = cols.to(I64)
        if cols.shape[0] > 2 * self.N:
            raise ValueError("reduce_lazy takes at most 2N columns")
        red = redc(self, cols).to(I32)
        return self.mul(red, self.const(self.params.R2, red.dim() - 1,
                                        red.device))

    # -- exponentiation / inversion ----------------------------------------------
    def pow_const(self, a, e: int):
        """a^e for a fixed python-int exponent (square and multiply)."""
        if e == 0:
            return self.one(a.shape[1:], a.device)
        out = a
        for i in range(e.bit_length() - 2, -1, -1):
            out = self.sqr(out)
            if (e >> i) & 1:
                out = self.mul(out, a)
        return out

    def inv(self, a):
        """Batched inversion via Fermat: a^(p-2). a must be nonzero."""
        return self.pow_const(a, self.p - 2)

    # -- Montgomery form conversion (device side) ----------------------------------
    def to_mont(self, a):
        return self.mul(a, self.const(self.params.R2, a.dim() - 1, a.device))

    def from_mont(self, a):
        return self.mul(a, self.const(1, a.dim() - 1, a.device))

    # -- host conversions -------------------------------------------------------------
    def encode(self, xs, mont=True, device=None):
        """Python ints -> (N, len(xs)) int32 limbs on the kernel's device
        (Montgomery form unless mont=False). The host codec reduces mod p
        (only an int that is negative or at least p) and packs limbs; the
        Montgomery form is one ``to_mont`` product
        (a mont_mul launch on the card, the plain product on the CPU)."""
        arr = ints_to_limbs(xs, self.N, self.p)
        out = torch.from_numpy(arr.astype("int32")).to(device or self.device)
        return self.to_mont(out) if mont and out.shape[1] else out

    def encode_scalar(self, x, mont=True, device=None):
        """One Python int -> (N,) int32 limbs on the kernel's device, the
        layout of one lane of ``encode`` (Montgomery form unless
        mont=False), converted on the host."""
        x = int(x) % self.p
        if mont:
            x = x * self.params.R % self.p
        return torch.from_numpy(int_to_limbs(x, self.N).astype("int32")).to(
            device or self.device)

    def decode(self, arr, mont=True):
        """(N, *batch) limb tensor -> list (flat, batch order) of ints."""
        from .limbs import limbs_to_ints
        a = arr.detach().cpu().reshape(self.N, -1).numpy()
        vals = limbs_to_ints(a)
        if mont:
            rinv = pow(self.params.R, -1, self.p)
            vals = [v * rinv % self.p for v in vals]
        return vals
