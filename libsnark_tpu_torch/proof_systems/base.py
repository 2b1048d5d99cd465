"""Shared kernel bundle for pairing-based proof systems (the port of
libsnark_tpu/proof_systems/base.py) over a curve with G1 over Fq and G2
over Fq2 (alt_bn128, BLS12-377).

Fixed-base window-table exponentiation at setup (libff get_window_table /
batch_exp, r1cs_gg_ppzksnark.tcc:316-398) and variable-base Pippenger MSM
at prove time, over the port's field, curve and MSM code.
"""
from __future__ import annotations

import random
import secrets
import time
from typing import Optional

import torch

from ..ops import cuda_lib
from ..ops.ec import CurveKernel
from ..ops.fp import FpKernel
from ..ops.fp2 import Fp2Kernel
from ..ops.limbs import ints_to_limbs
from ..ops.msm import MSMKernel
from ..profiling import enter_block


class PhaseClock:
    """Wall time per phase, each ended by a device synchronize; inert when
    the caller passes no dict."""

    def __init__(self, out: Optional[dict], device):
        self.out = out
        self.device = device
        self.t = time.perf_counter()

    def lap(self, name: str):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = now - self.t
        self.t = now


class PairingSystem:
    """Device kernel bundle over a named curve (G2 over an Fq2 tower).

    device: ``"cuda"`` (the default) or ``"cpu"``, where every kernel
    wrapper runs its plain PyTorch version. msm_strategy: the bucket
    accumulation of both MSM kernels (``ops/msm.py``: ``"segments"``, the
    default, or ``"dense"``); it changes no affine result."""

    def __init__(self, curve, device="cuda", msm_strategy="segments"):
        self.curve = curve
        self.device = cuda_lib.resolve_device(device)
        self.fr = FpKernel(curve.fr_params, self.device)
        self.fq = FpKernel(curve.fq_params, self.device)
        # a = 0: the group law runs on the kernels; a curve with an
        # a-coefficient would take the torch formulas
        a_int = int(getattr(curve, "a", 0))
        g1_mul_a = ((lambda x, fk=self.fq, k=a_int: fk.mul_small(x, k))
                    if a_int else None)
        self.g1 = CurveKernel(self.fq, f"{curve.name}.G1",
                              mul_by_a=g1_mul_a, a_tag=str(a_int))
        if getattr(curve, "g2_field_degree", 2) != 2:
            raise NotImplementedError("the port has G2 over Fq2 only")
        self.fq2 = Fp2Kernel(self.fq, int(curve.Fq2.NON_RESIDUE))
        self.g2 = CurveKernel(self.fq2, f"{curve.name}.G2")
        sbits = curve.r.bit_length()
        self.msm_g1 = MSMKernel(self.g1, sbits, strategy=msm_strategy)
        self.msm_g2 = MSMKernel(self.g2, sbits, strategy=msm_strategy)
        self.scalar_limbs = -(-sbits // 16)
        self._fixed_tables = {}
        self._domains = {}

    # mirrors the reference's force_pow_2_domain option
    force_pow_2 = False

    def domain_for(self, domain_fn, sizes):
        """domain_fn(fr, fr_params, sizes, force_pow_2) (qap_domain,
        sap_domain, ssp_domain: they read sizes.num_constraints and
        sizes.num_inputs), kept with its device tables."""
        key = (domain_fn.__name__, sizes.num_constraints, sizes.num_inputs,
               self.force_pow_2)
        if key not in self._domains:
            self._domains[key] = domain_fn(self.fr, self.curve.fr_params,
                                           sizes, self.force_pow_2)
        return self._domains[key]

    # -- randomness -------------------------------------------------------
    def _rng(self, seed: Optional[int]):
        r = self.curve.r
        if seed is None:
            return lambda: secrets.randbelow(r - 1) + 1
        rng = random.Random(seed)
        return lambda: rng.randrange(1, r)

    # -- host <-> device conversions ---------------------------------------
    def scalars_to_dev(self, xs):
        arr = ints_to_limbs([x % self.curve.r for x in xs], self.scalar_limbs)
        return torch.from_numpy(arr.astype("int32")).to(self.device)

    # Power-of-two shape buckets, as in the JAX package: pad slots hold
    # scalar 0 / the point at infinity (exact no-ops for batch-exp and
    # Pippenger: zero digits land in the never-accumulated bucket 0).
    @staticmethod
    def bucket(n: int) -> int:
        return max(16, 1 << max(0, n - 1).bit_length())

    @staticmethod
    def pad_to(arr, target: int):
        """Pad the last axis with zeros up to `target` lanes."""
        pad = target - arr.shape[-1]
        if pad <= 0:
            return arr
        return torch.nn.functional.pad(arr, (0, pad))

    def fixed_base_g1(self, base_host, scalars):
        """[s * base for s in scalars] as device affine G1 (x, y, inf),
        padded to the enclosing power-of-two bucket (pad = infinity)."""
        if self.host_keygen:
            return self._fixed_base_host(self.g1, base_host, scalars)
        return self._fixed_base(self.g1, self.msm_g1, base_host, scalars)

    def fixed_base_g2(self, base_host, scalars):
        if self.host_keygen:
            return self._fixed_base_host(self.g2, base_host, scalars)
        return self._fixed_base(self.g2, self.msm_g2, base_host, scalars)

    # Pure-Python fixed-base path for tiny circuits (`host_keygen = True`),
    # as in the JAX package; the same affine points as the device path.
    host_keygen = False

    def _fixed_base_host(self, ck, base_host, scalars, c=8):
        """Windowed fixed-base on the host: one shared table, then
        ~ceil(bits/c) table adds per scalar."""
        r = self.curve.r
        W = -(-r.bit_length() // c)
        zero = base_host.group.zero()
        table = []
        B = base_host
        for _ in range(W):
            row = [zero]
            acc = zero
            for _ in range((1 << c) - 1):
                acc = acc + B
                row.append(acc)
            table.append(row)
            B = acc + B
        mask = (1 << c) - 1
        pts = []
        for s in scalars:
            s = int(s) % r
            acc = zero
            w = 0
            while s:
                d = s & mask
                if d:
                    acc = acc + table[w][d]
                s >>= c
                w += 1
            pts.append(acc)
        pts += [zero] * (self.bucket(len(pts)) - len(pts))
        return ck.encode_points(pts, jacobian=False)

    def _window_table_affine(self, ck, mk, base_host, c: int):
        """Affine fixed-base table of base_host and its packed rows (what
        ``batch_exp`` reads), built once per (group, base, c) on the device
        (dbl + add kernels) and kept: every query of a keygen shares the
        generator of its group."""
        key = (ck.name, str(base_host), c)
        if key not in self._fixed_tables:
            W = -(-self.curve.r.bit_length() // c)
            baff = ck.encode_points([base_host], jacobian=False)
            taff = ck.to_affine(mk.window_table((baff[0], baff[1]), c, W))
            self._fixed_tables[key] = (taff, mk.fixed_base_rows(taff))
        return self._fixed_tables[key]

    def _fixed_base(self, ck, mk, base_host, scalars):
        """Device path: the affine window table, then batch exp (one
        ``madd_windows`` launch for every window) and one batched
        to_affine, each a ``keygen.fixed_base.*`` block of the port's
        profiler. The window width (8, as in the JAX package, from 2^12
        scalars up; 4 below, where the table would outweigh the batch)
        changes no output bit."""
        scalars = list(scalars)
        scalars += [0] * (self.bucket(len(scalars)) - len(scalars))
        c = 8 if len(scalars) >= 1 << 12 else 4
        with enter_block("keygen.fixed_base.encode", sync=self.device):
            sc = self.scalars_to_dev(scalars)
        with enter_block("keygen.fixed_base.table", sync=self.device):
            taff, rows = self._window_table_affine(ck, mk, base_host, c)
        with enter_block("keygen.fixed_base.batch_exp", sync=self.device):
            P = mk.batch_exp(taff, sc, c, rows)
        with enter_block("keygen.fixed_base.to_affine", sync=self.device):
            return ck.to_affine(P)

    def msm_affine(self, which: str, q, scalars, c: int):
        mk = self.msm_g1 if which == "g1" else self.msm_g2
        return mk.ck.to_affine(mk.msm(q, scalars, c))

    def decode_g1(self, aff, lane=0):
        return self._decode_affine(self.g1, aff, self.curve.G1, lane)

    def decode_g2(self, aff, lane=0):
        return self._decode_affine(self.g2, aff, self.curve.G2, lane)

    @staticmethod
    def _decode_affine(ck, aff, group, lane=0):
        x, y, inf = aff
        one = tuple(a[..., lane:lane + 1] for a in (x, y))
        return ck.decode_affine((one[0], one[1],
                                 inf.reshape(-1)[lane:lane + 1]), group)[0]
