"""Radix-2 evaluation domains: NTT / iNTT / coset transforms over Fr (the
port of libsnark_tpu/ops/ntt.py).

Iterative Cooley-Tukey over (N, *batch, m) Montgomery limb tensors: a
bit-reversal permutation, then log2(m) stages, each one batched field
product (the ``mont_mul`` kernel on the card) plus an add and a sub over
the whole array. Twiddle, coset and power tables are built on the device
by doubling (log2(n) products), so no table of size m is computed by
Python on the host.

The JAX package's MXU digit-matmul path and its compile-lean gather form
for small m are TPU/XLA strategies; both compute the same DFT, and since
every value is canonical the outputs here are bit-identical to them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def batch_inverse(xs, p):
    """Montgomery batch inversion: one modular inverse for the whole list."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % p
    inv_all = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % p
        inv_all = inv_all * xs[i] % p
    return out


def _bit_reverse_perm(logn: int) -> np.ndarray:
    n = 1 << logn
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def powers_table(fk, g: int, n: int, device=None) -> torch.Tensor:
    """[g^0 .. g^(n-1)] in Montgomery form as an (N, n) tensor, built by
    doubling: out[k:2k] = out[:k] * g^k (one batched product per step)."""
    p = fk.p
    out = fk.encode([1], device=device)
    while out.shape[-1] < n:
        k = out.shape[-1]
        step = fk.encode([pow(g, k, p)], device=device)
        out = torch.cat([out, fk.mul(out, step)], dim=-1)
    return out[:, :n].contiguous()


def _bcast_table(fk, tbl, a):
    """(N, n) table -> broadcastable against a (N, *batch, n)."""
    return tbl.reshape((fk.N,) + (1,) * (a.dim() - 2) + (tbl.shape[-1],))


class Radix2Domain:
    """Evaluation domain of size m = 2^logm over the scalar field
    (libfqfft basic_radix2_domain)."""

    def __init__(self, fr_kernel, params, logm: int):
        assert logm <= params.two_adicity, \
            f"domain 2^{logm} exceeds field two-adicity {params.two_adicity}"
        self.fk = fr_kernel
        self.params = params
        self.logm = logm
        self.m = 1 << logm
        p = params.p
        self.p = p
        self.omega = pow(params.root_of_unity,
                         1 << (params.two_adicity - logm), p)
        self.omega_inv = pow(self.omega, -1, p)
        self.m_inv = pow(self.m, -1, p)
        self.generator = params.multiplicative_generator
        self.generator_inv = pow(self.generator, -1, p)
        self._tables = None

    def device_tables(self):
        """Root powers (forward/inverse), the bit-reversal permutation and
        the g / g^-1 coset powers, built once on the kernel's device."""
        if self._tables is None:
            fk, m = self.fk, self.m
            half = max(1, m // 2)
            self._tables = {
                "roots": powers_table(fk, self.omega, half),
                "roots_inv": powers_table(fk, self.omega_inv, half),
                "perm": torch.from_numpy(_bit_reverse_perm(self.logm))
                .to(fk.device),
                "coset": powers_table(fk, self.generator, m),
                "coset_inv": powers_table(fk, self.generator_inv, m),
            }
        return self._tables

    # ------------------------------------------------------------------ core
    def _fft_core(self, a, roots):
        """In-order input -> in-order output iterative CT NTT.

        a: (N, *batch, m) Montgomery limbs; roots: (N, m/2) powers of the
        transform's root, so stage s uses roots[:, j * (m >> s)]."""
        fk = self.fk
        m, logm = self.m, self.logm
        a = a[..., self.device_tables()["perm"]]
        shp = a.shape[:-1]
        for s in range(1, logm + 1):
            half = 1 << (s - 1)
            blocks = m >> s
            v = a.reshape(shp + (blocks, 2, half))
            u = v[..., 0, :]
            w = v[..., 1, :]
            tw = roots[:, ::m >> s][:, :half]
            tw = tw.reshape((fk.N,) + (1,) * (len(shp) - 1) + (1, half))
            wt = fk.mul(w, tw)
            a = torch.stack([fk.add(u, wt), fk.sub(u, wt)],
                            dim=-2).reshape(shp + (m,))
        return a

    def fft(self, a):
        """Evaluate: coefficients -> values on the domain (natural order)."""
        return self._fft_core(a, self.device_tables()["roots"])

    def ifft(self, a):
        """Interpolate: values -> coefficients, scaled by 1/m."""
        out = self._fft_core(a, self.device_tables()["roots_inv"])
        return self.fk.mul_small(out, self.m_inv)

    # ------------------------------------------------------------- coset forms
    def _mul_by_table(self, a, tbl):
        return self.fk.mul(a, _bcast_table(self.fk, tbl, a))

    def coset_fft(self, a):
        """Evaluate on the coset g * domain (g the multiplicative
        generator)."""
        return self.fft(self._mul_by_table(a, self.device_tables()["coset"]))

    def icoset_fft(self, a):
        return self._mul_by_table(self.ifft(a),
                                  self.device_tables()["coset_inv"])

    # --------------------------------------------------------- vanishing poly
    def vanishing_eval(self, t: int) -> int:
        """Z(t) = t^m - 1 (host int)."""
        return (pow(t, self.m, self.p) - 1) % self.p

    def divide_by_z_on_coset(self, a):
        """a[i] /= Z(g * w^i); on the coset Z is the constant g^m - 1."""
        zi = pow(self.vanishing_eval(self.generator), -1, self.p)
        return self.fk.mul_small(a, zi)

    def icoset_fft_divz(self, a):
        """icosetFFT(divide_by_Z_on_coset(a))."""
        return self.icoset_fft(self.divide_by_z_on_coset(a))

    def z_sparse(self):
        """Vanishing polynomial as sparse (index, int_coeff) pairs."""
        return [(self.m, 1), (0, self.p - 1)]

    # ----------------------------------------------------- lagrange (host side)
    def lagrange_coeffs_at(self, t: int) -> list:
        """L_i(t) for all i, host ints (libfqfft
        evaluate_all_lagrange_polynomials)."""
        p, m = self.p, self.m
        t %= p
        zt = self.vanishing_eval(t)
        if zt == 0:
            out = [0] * m
            x = 1
            for i in range(m):
                if x == t:
                    out[i] = 1
                x = x * self.omega % p
            return out
        # L_i(t) = Z(t) * w^i / (m * (t - w^i)); batch-invert the (t - w^i)
        xs, diffs = [], []
        x = 1
        for i in range(m):
            xs.append(x)
            diffs.append((t - x) % p)
            x = x * self.omega % p
        invs = batch_inverse(diffs, p)
        zt_minv = zt * self.m_inv % p
        return [zt_minv * xs[i] % p * invs[i] % p for i in range(m)]

    def domain_elements_mont(self):
        """[w^0 .. w^(m-1)] as an (N, m) Montgomery tensor on the kernel's
        device, from the root table: w^(i + m/2) = -w^i."""
        roots = self.device_tables()["roots"]
        if self.m == 1:
            return roots
        return torch.cat([roots, self.fk.neg(roots)], dim=-1)


@functools.lru_cache(maxsize=None)
def get_domain_size(n: int) -> int:
    """Smallest power-of-two >= n (force_pow_2_domain semantics)."""
    return 1 << max(1, (n - 1)).bit_length() if n > 1 else 1
