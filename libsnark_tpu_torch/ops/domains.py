"""Evaluation-domain selection: basic / extended / step radix-2 domains (the
port of libsnark_tpu/ops/domains.py).

libfqfft's ``get_evaluation_domain(min_size)`` picks, in order:
basic_radix2 (m a power of two within the field's two-adicity),
extended_radix2 and step_radix2 (m = 2^k + 2^r). The QAP degree -- and so
the keys and the proof -- follow the selected m, so the choice below is
the JAX package's exactly (``_domain_shape``).

Both non-basic domains are one construction, the two-part CRT domain
S = V(x^n1 - 1) u V(x^n2 - c2) with n2 | n1: evaluation folds
coefficients mod each binomial and runs two radix-2 NTTs; interpolation
runs the two inverse NTTs and recombines by CRT, where x^n1 - 1 mod
(x^n2 - c2) is the constant k0 = c2^(n1/n2) - 1.
"""
from __future__ import annotations

import functools

import torch

from .ntt import Radix2Domain, _bcast_table, batch_inverse, powers_table


class TwoPartDomain:
    """Union of the roots of x^n1 - 1 and a disjoint coset of the n2-th
    roots of unity (n2 | n1). Elements are ordered
    [w1^0 .. w1^(n1-1), shift*w2^0 .. shift*w2^(n2-1)]."""

    def __init__(self, fk, params, log1: int, log2: int):
        assert log2 <= log1
        self.fk = fk
        self.params = params
        self.p = p = params.p
        self.n1 = 1 << log1
        self.n2 = 1 << log2
        self.m = self.n1 + self.n2
        self.kind = "extended" if log1 == log2 else "step"
        self.dom1 = Radix2Domain(fk, params, log1)
        self.dom2 = Radix2Domain(fk, params, log2)
        self.generator = params.multiplicative_generator
        self.generator_inv = pow(self.generator, -1, p)
        if self.kind == "extended":
            self.shift = self.generator * self.generator % p
        else:
            assert log1 + 1 <= params.two_adicity, \
                "step domain needs a 2*n1-th root of unity"
            self.shift = pow(params.root_of_unity,
                             1 << (params.two_adicity - (log1 + 1)), p)
        self.shift_inv = pow(self.shift, -1, p)
        self.c2 = pow(self.shift, self.n2, p)
        self.k0 = (pow(self.c2, self.n1 // self.n2, p) - 1) % p
        assert self.k0 != 0, "domain parts are not coprime"
        self.k0_inv = pow(self.k0, -1, p)
        self.K = self.m // self.n2          # fold chunks for r mod M2
        self._tables = None

    # --------------------------------------------------------------- tables
    def device_tables(self):
        if self._tables is None:
            fk = self.fk
            self._tables = {
                "w_fold_full": powers_table(fk, self.c2, self.K),
                "w_fold_r1": powers_table(fk, self.c2, self.n1 // self.n2),
                "shift_pw": powers_table(fk, self.shift, self.n2),
                "shift_ipw": powers_table(fk, self.shift_inv, self.n2),
                "coset": powers_table(fk, self.generator, self.m),
                "coset_inv": powers_table(fk, self.generator_inv, self.m),
                "zc_inv": self._divz_table(),
            }
        return self._tables

    def _divz_table(self):
        """1/Z(g*x_i) over the g-coset of the domain: over the part-1 coset
        Z cycles with period n1/n2; over part 2 it is constant."""
        p, g = self.p, self.generator
        per = self.n1 // self.n2
        f1 = (pow(g, self.n1, p) - 1) % p
        w1n2 = pow(self.dom1.omega, self.n2, p)
        gn2 = pow(g, self.n2, p)
        vals, x = [], gn2
        for _ in range(per):
            vals.append(f1 * ((x - self.c2) % p) % p)
            x = x * w1n2 % p
        gs = g * self.shift % p
        zc2 = (pow(gs, self.n1, p) - 1) % p \
            * ((pow(gs, self.n2, p) - self.c2) % p) % p
        invs = self.fk.encode(batch_inverse(vals + [zc2], p))
        part1 = invs[:, :per].repeat(1, self.n1 // per)
        part2 = invs[:, per:].expand(self.fk.N, self.n2)
        return torch.cat([part1, part2], dim=-1).contiguous()

    def _mul_table(self, a, tbl):
        return self.fk.mul(a, _bcast_table(self.fk, tbl, a))

    def _fold_mod_binomial(self, a, w, K: int):
        """a (.., K*n2) -> a mod (x^n2 - c2) (.., n2): chunk-weighted sums
        in int64 lazy columns, reduced once (exact for any K here)."""
        fk = self.fk
        n2 = self.n2
        ch = a.reshape(a.shape[:-1] + (K, n2))
        wt = w[:, :K].reshape((fk.N,) + (1,) * (a.dim() - 2) + (K, 1))
        weighted = fk.mul(ch, wt)
        return fk.reduce_lazy(weighted.to(torch.int64).sum(dim=-2))

    # ------------------------------------------------------------ transforms
    def fft(self, a):
        """coefficients (deg < m) -> values on the domain."""
        fk = self.fk
        dt = self.device_tables()
        n1, n2 = self.n1, self.n2
        low = fk.add(a[..., :n2], a[..., n1:])
        r1 = torch.cat([low, a[..., n2:n1]], dim=-1)
        v1 = self.dom1.fft(r1)
        r2 = self._fold_mod_binomial(a, dt["w_fold_full"], self.K)
        v2 = self.dom2.fft(self._mul_table(r2, dt["shift_pw"]))
        return torch.cat([v1, v2], dim=-1)

    def ifft(self, a):
        """values on the domain -> coefficients (deg < m), via CRT."""
        fk = self.fk
        dt = self.device_tables()
        n1, n2 = self.n1, self.n2
        r1 = self.dom1.ifft(a[..., :n1])
        r2 = self._mul_table(self.dom2.ifft(a[..., n1:]), dt["shift_ipw"])
        r1m = self._fold_mod_binomial(r1, dt["w_fold_r1"], n1 // n2)
        t = fk.mul_small(fk.sub(r2, r1m), self.k0_inv)
        low = fk.sub(r1[..., :n2], t)
        return torch.cat([low, r1[..., n2:], t], dim=-1)

    def coset_fft(self, a):
        return self.fft(self._mul_table(a, self.device_tables()["coset"]))

    def icoset_fft(self, a):
        return self._mul_table(self.ifft(a),
                               self.device_tables()["coset_inv"])

    # ------------------------------------------------- vanishing polynomial
    def vanishing_eval(self, t: int) -> int:
        return (pow(t, self.n1, self.p) - 1) \
            * ((pow(t, self.n2, self.p) - self.c2) % self.p) % self.p

    def divide_by_z_on_coset(self, a):
        return self._mul_table(a, self.device_tables()["zc_inv"])

    def icoset_fft_divz(self, a):
        return self.icoset_fft(self.divide_by_z_on_coset(a))

    def z_sparse(self):
        """Z = (x^n1 - 1)(x^n2 - c2) as sparse (index, coeff) pairs."""
        p = self.p
        if self.n1 == self.n2:
            return [(self.m, 1), (self.n1, (-(1 + self.c2)) % p),
                    (0, self.c2 % p)]
        return [(self.m, 1), (self.n1, (-self.c2) % p),
                (self.n2, p - 1), (0, self.c2 % p)]

    # -------------------------------------------------------- host lagrange
    def domain_elements(self):
        p = self.p
        out = [1] * self.n1
        for i in range(1, self.n1):
            out[i] = out[i - 1] * self.dom1.omega % p
        y = self.shift
        for _ in range(self.n2):
            out.append(y)
            y = y * self.dom2.omega % p
        return out

    def lagrange_coeffs_at(self, t: int):
        """L_i(t) for the union domain: part-1 basis polys are the
        subdomain's scaled by M2(t)/M2(x_i); part-2 scaled by
        M1(t)/M1(y_j) = M1(t)/k0 (constant)."""
        p, n1, n2 = self.p, self.n1, self.n2
        t %= p
        if self.vanishing_eval(t) == 0:
            els = self.domain_elements()
            return [1 if x == t else 0 for x in els]
        m1_t = (pow(t, n1, p) - 1) % p
        m2_t = (pow(t, n2, p) - self.c2) % p
        n1_inv = pow(n1, -1, p)
        xs, den = [], []
        x = 1
        w1n2 = pow(self.dom1.omega, n2, p)
        m2x = 1
        for i in range(n1):
            xs.append(x)
            den.append((t - x) % p * ((m2x - self.c2) % p) % p)
            x = x * self.dom1.omega % p
            m2x = m2x * w1n2 % p
        ys = []
        y = self.shift
        for j in range(n2):
            ys.append(y)
            den.append((t - y) % p)
            y = y * self.dom2.omega % p
        invs = batch_inverse(den, p)
        out = []
        s1 = m1_t * n1_inv % p * m2_t % p
        for i in range(n1):
            out.append(s1 * xs[i] % p * invs[i] % p)
        s2 = m2_t * pow(n2 * self.c2 % p, -1, p) % p \
            * m1_t % p * self.k0_inv % p
        for j in range(n2):
            out.append(s2 * ys[j] % p * invs[n1 + j] % p)
        return out


def add_scaled_z(fk, domain, out, coeff_m):
    """out += coeff * Z(x) for a device scalar coeff_m ((N, 1) Montgomery
    limbs); Z taken sparse from the domain."""
    out = out.clone()
    for idx, c in domain.z_sparse():
        term = coeff_m if c == 1 else fk.mul_small(coeff_m, c)
        out[..., idx] = fk.add(out[..., idx], term[..., 0])
    return out


def sub_constant_term(fk, out, d_m):
    """out with the device scalar d_m ((N, 1) Montgomery limbs) subtracted
    from coefficient 0, as a new tensor: out and its views are not
    written."""
    return torch.cat([fk.sub(out[..., :1], d_m), out[..., 1:]], dim=-1)


@functools.lru_cache(maxsize=None)
def _domain_shape(min_size: int, two_adicity: int, force_pow_2: bool):
    """(log1, log2) with log2 < 0 meaning a basic radix-2 domain of size
    2^log1. Mirrors libfqfft's get_evaluation_domain selection."""
    assert min_size >= 1
    if min_size <= 2:
        return (1, -1)
    ceil_log = (min_size - 1).bit_length()
    if force_pow_2:
        assert ceil_log <= two_adicity, "domain exceeds two-adicity"
        return (ceil_log, -1)
    if min_size == (1 << ceil_log):                     # exact power of 2
        if ceil_log <= two_adicity:
            return (ceil_log, -1)                       # basic
        if ceil_log == two_adicity + 1:
            return (ceil_log - 1, ceil_log - 1)         # extended
        raise ValueError(f"no domain of size {min_size}")
    big_log = ceil_log - 1
    small = min_size - (1 << big_log)
    small_log = (small - 1).bit_length() if small > 1 else 0
    if (1 << big_log) + (1 << small_log) == min_size \
            and big_log + 1 <= two_adicity:
        return (big_log, small_log)                     # exact step
    # round up: basic(2^ceil) if it fits, else step(big + 2^small_log)
    if small_log >= big_log:
        if ceil_log <= two_adicity:
            return (ceil_log, -1)
        if ceil_log == two_adicity + 1:
            return (ceil_log - 1, ceil_log - 1)
        raise ValueError(f"no domain of size {min_size}")
    if big_log + 1 <= two_adicity:
        return (big_log, small_log)
    raise ValueError(f"no domain of size {min_size}")


def get_evaluation_domain(fk, params, min_size: int,
                          force_pow_2: bool = False):
    """libfqfft get_evaluation_domain equivalent: smallest supported
    domain with size >= min_size."""
    log1, log2 = _domain_shape(int(min_size), params.two_adicity,
                               bool(force_pow_2))
    if log2 < 0:
        return Radix2Domain(fk, params, log1)
    return TwoPartDomain(fk, params, log1, log2)
