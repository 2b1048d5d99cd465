"""Multi-device NTT: Bailey's four-step factorization over a
``torch.distributed`` process group (the port of
libsnark_tpu/parallel/ntt_sharded.py).

The domain size m = n1 * n2 (n1 = 2^floor(logm / 2)) is factored; the
size-m transform of a (.., m) array viewed as A[j1, j2] = a[n2 j1 + j2]
becomes
  1) n2 independent length-n1 NTTs    (local: each rank its n2-shard),
  2) the twiddle product by w^(k1 j2)  (local, elementwise),
  3) the exchange to the n1-shard: one ``all_to_all_single``,
  4) n1 independent length-n2 NTTs    (local),
  5) the transpose to natural order k = k2 n1 + k1: one more
     ``all_to_all_single`` leaves each rank the contiguous shard
     [r m/D, (r+1) m/D) of the output, which one ``all_gather`` makes
     whole on every rank (the witness map's pointwise steps and the MSMs'
     own lane shards read it).
A step whose factor does not split over the D ranks runs replicated (the
transform stays exact, it is just not distributed there).

The SPMD contract: every rank calls with the same (replicated) input and
gets the same output. The local transforms are the radix-2 sub-domains'
``fft`` / ``ifft``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.domains import TwoPartDomain
from ..ops.ntt import Radix2Domain, _bcast_table, powers_table


def _world(group):
    return dist.get_world_size(group), dist.get_rank(group)


class FourStepDomain:
    """Distributed evaluation domain of size m = 2^logm = n1 * n2 over the
    ranks of ``group`` (None: the world group)."""

    def __init__(self, fr_kernel, params, logm: int, group=None):
        self.fk = fr_kernel
        self.params = params
        self.logm = logm
        self.m = 1 << logm
        self.group = group
        log1 = logm // 2
        self.n1 = 1 << log1
        self.n2 = 1 << (logm - log1)
        self.dom1 = Radix2Domain(fr_kernel, params, log1)
        self.dom2 = Radix2Domain(fr_kernel, params, logm - log1)
        self.p = params.p
        self.omega = pow(params.root_of_unity,
                         1 << (params.two_adicity - logm), self.p)
        self.omega_inv = pow(self.omega, -1, self.p)
        self.generator = params.multiplicative_generator
        self._tables = None

    # --------------------------------------------------------------- tables
    def device_tables(self):
        """The twiddles w^(k1 j2) (forward and inverse) of this rank's
        columns, (N, n1, n2 / D) Montgomery limbs (all n2 columns when n2
        does not split), gathered from the root's m powers built on the
        device by doubling; the coset powers g^i, g^-i over the domain."""
        if self._tables is None:
            fk, dev = self.fk, self.fk.device
            D, r = _world(self.group)
            cols = torch.arange(self.n2, device=dev)
            if self.n2 % D == 0:
                s = self.n2 // D
                cols = cols[r * s:(r + 1) * s]
            idx = torch.arange(self.n1, device=dev)[:, None] * cols[None, :]
            self._tables = {
                "tw": powers_table(fk, self.omega, self.m)[:, idx],
                "tw_inv": powers_table(fk, self.omega_inv, self.m)[:, idx],
                "coset": powers_table(fk, self.generator, self.m),
                "coset_inv": powers_table(
                    fk, pow(self.generator, -1, self.p), self.m),
            }
        return self._tables

    # ------------------------------------------------------------------ core
    @staticmethod
    def _along(fn, A, axis: int):
        """fn (a sub-domain's fft / ifft, along the last axis) applied along
        ``axis`` of A."""
        return fn(A.transpose(axis, -1)).transpose(axis, -1)

    def _all_to_all(self, A, split: int, join: int):
        """Exchange: A's axis ``split`` is cut into D chunks, chunk q goes to
        rank q; the chunks received are joined along ``join`` (rank order).
        A collective of the group."""
        D, _ = _world(self.group)
        parts = [c.contiguous() for c in A.chunk(D, dim=split)]
        send = torch.stack(parts)                  # (D, *chunk)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return torch.cat(list(recv.unbind(0)), dim=join)

    def _all_gather(self, A, join: int):
        D, _ = _world(self.group)
        A = A.contiguous()
        parts = [torch.empty_like(A) for _ in range(D)]
        dist.all_gather(parts, A, group=self.group)
        return torch.cat(parts, dim=join)

    def _four_step(self, a, fwd: bool):
        fk = self.fk
        N, n1, n2 = fk.N, self.n1, self.n2
        D, r = _world(self.group)
        lead = tuple(a.shape[1:-1])
        # A[j1, j2] = a[n2 j1 + j2]: (N, *lead, n1, n2)
        A = a.reshape((N,) + lead + (n1, n2))
        split2, split1 = n2 % D == 0, n1 % D == 0
        if split2:                      # this rank's columns
            s = n2 // D
            A = A[..., r * s:(r + 1) * s]
        # step 1: length-n1 transforms along the rows' axis
        A = self._along(self.dom1.fft if fwd else self.dom1.ifft, A, -2)
        # step 2: twiddle
        tw = self.device_tables()["tw" if fwd else "tw_inv"]
        A = fk.mul(A, tw.reshape((N,) + (1,) * len(lead) + tw.shape[1:]))
        # step 3: to the n1-shard (every column, this rank's rows)
        if split2 and split1:
            A = self._all_to_all(A, split=-2, join=-1)
        elif split2:
            A = self._all_gather(A, join=-1)
        elif split1:
            s = n1 // D
            A = A[..., r * s:(r + 1) * s, :]
        # step 4: length-n2 transforms along the columns' axis
        A = (self.dom2.fft if fwd else self.dom2.ifft)(A)
        if not split1:                  # replicated: A is whole
            return A.transpose(-1, -2).reshape((N,) + lead + (self.m,))
        # step 5: natural order k = k2 n1 + k1; this rank's contiguous
        # shard holds its n2 / D values of k2 for every k1
        A = self._all_to_all(A, split=-1, join=-2)     # (.., n1, n2 / D)
        out = A.transpose(-1, -2).reshape((N,) + lead + (self.m // D,))
        return self._all_gather(out, join=-1)

    def fft(self, a):
        """Evaluate: coefficients -> values (natural order); a collective
        of the group, the same on every rank."""
        return self._four_step(a, fwd=True)

    def ifft(self, a):
        """Interpolate: values -> coefficients (1/m included: each
        sub-domain's inverse scales by its 1/n)."""
        return self._four_step(a, fwd=False)

    # -------------------------------------------------------- coset forms
    def _mul_table(self, a, tbl):
        return self.fk.mul(a, _bcast_table(self.fk, tbl, a))

    def coset_fft(self, a):
        return self.fft(self._mul_table(a, self.device_tables()["coset"]))

    def icoset_fft(self, a):
        return self._mul_table(self.ifft(a),
                               self.device_tables()["coset_inv"])

    def divide_by_z_on_coset(self, a):
        """a[i] /= Z(g w^i) = g^m - 1, constant on the coset."""
        zi = pow((pow(self.generator, self.m, self.p) - 1) % self.p, -1,
                 self.p)
        return self.fk.mul_small(a, zi)

    def icoset_fft_divz(self, a):
        """The surface of Radix2Domain.icoset_fft_divz (the witness map
        calls it on whichever domain it is handed)."""
        return self.icoset_fft(self.divide_by_z_on_coset(a))

    def vanishing_eval(self, t: int) -> int:
        return (pow(t, self.m, self.p) - 1) % self.p

    def lagrange_coeffs_at(self, t: int):
        return Radix2Domain(self.fk, self.params,
                            self.logm).lagrange_coeffs_at(t)

    def domain_elements(self):
        out = [1] * self.m
        for i in range(1, self.m):
            out[i] = out[i - 1] * self.omega % self.p
        return out


class ShardedTwoPartDomain(TwoPartDomain):
    """The distributed extended / step domain: the TwoPartDomain's two
    radix-2 parts become four-step distributed NTTs over the group; the
    binomial folds and the CRT lift are elementwise, replicated. This lets
    ``prover_sharded`` keep the reference's default domain selection
    (libfqfft get_evaluation_domain, r1cs_to_qap.tcc:40-41).

    A part is distributed only when n >= 4 D^2 (its four-step factors then
    split over the ranks); smaller parts run replicated radix-2."""

    def __init__(self, fk, params, log1: int, log2: int, group=None):
        super().__init__(fk, params, log1, log2)
        self.group = group
        D, _ = _world(group)
        if self.n1 >= 4 * D * D:
            self.dom1 = FourStepDomain(fk, params, log1, group)
        if self.n2 >= 4 * D * D and log2 != log1:
            self.dom2 = FourStepDomain(fk, params, log2, group)
        elif log2 == log1:
            self.dom2 = self.dom1
