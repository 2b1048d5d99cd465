"""Shared kernel bundle for pairing-based proof systems (the port of
libsnark_tpu/proof_systems/base.py) over a curve with G1 over Fq and G2
over Fq2 (alt_bn128, BLS12-377, MNT4), over Fq3 (MNT6, edwards) or over Fq
itself (BW6-761).

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
from ..ops.fp3 import Fp3Kernel
from ..ops.limbs import ints_to_limbs
from ..ops.msm import MSMKernel
from ..profiling import enter_block


def _int_madd(group):
    """acc + Q over a prime field on plain integers, madd-2007-bl (no
    inversion; it holds for any curve coefficient a): acc a Jacobian (X,
    Y, Z) (None: infinity), Q affine (x, y) (None: infinity). Where acc ==
    Q the doubling is the host's affine one."""
    p = group.F.modulus

    def madd(acc, Q):
        if Q is None:
            return acc
        if acc is None:
            return (Q[0], Q[1], 1)
        X1, Y1, Z1 = acc
        Z1Z1 = Z1 * Z1 % p
        H = (Q[0] * Z1Z1 - X1) % p
        r = 2 * (Q[1] * Z1 % p * Z1Z1 - Y1) % p
        if H == 0:
            if r:
                return None                    # acc == -Q
            P = _to_affine_host(group, [acc])[0]
            P = P + group.point(*Q)            # acc == Q: the doubling
            return None if P.is_zero() else (int(P.x), int(P.y), 1)
        HH = H * H % p
        I = 4 * HH % p
        J = H * I % p
        V = X1 * I % p
        X3 = (r * r - J - 2 * V) % p
        return (X3, (r * (V - X3) - 2 * Y1 * J) % p,
                ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % p)
    return madd


def _to_affine_host(group, jac) -> list:
    """Jacobian integer triples over a prime field (None: infinity) ->
    affine host points, the Z inverses by one batched inversion
    (Montgomery's trick): the points are unique, so the same as affine
    additions give."""
    p = group.F.modulus
    live = [j for j in jac if j is not None]
    prefix, acc = [], 1
    for _, _, Z in live:
        prefix.append(acc)
        acc = acc * Z % p
    inv = pow(acc, -1, p) if live else None
    zinv = [None] * len(live)
    for i in range(len(live) - 1, -1, -1):
        zinv[i] = inv * prefix[i] % p
        inv = inv * live[i][2] % p
    out, k = [], 0
    for j in jac:
        if j is None:
            out.append(group.zero())
            continue
        zi = zinv[k]
        k += 1
        zi2 = zi * zi % p
        out.append(group.point(j[0] * zi2 % p, j[1] * zi2 % p * zi % p))
    return out


def _host_window_table(base, c: int, W: int) -> list:
    """The fixed-base table rows T[w][j] = j 2^(c w) base (j < 2^c) over a
    prime field, each row summed in Jacobian form on integers and made
    affine by one batched inversion: entries (x, y) (None: infinity)."""
    group = base.group
    madd = _int_madd(group)
    rows, B = [], base
    for _ in range(W):
        Bq = (int(B.x), int(B.y))
        jac, acc = [None], None
        for _ in range((1 << c) - 1):
            acc = madd(acc, Bq)
            jac.append(acc)
        aff = _to_affine_host(group, jac + [madd(acc, Bq)])
        rows.append([None if P.is_zero() else (int(P.x), int(P.y))
                     for P in aff[:-1]])
        B = aff[-1]                            # 2^c B, the next row's
    return rows


def _host_window_table_affine(base, c: int, W: int) -> list:
    """The same table by affine host additions (extension fields)."""
    zero = base.group.zero()
    rows, B = [], base
    for _ in range(W):
        row, acc = [zero], zero
        for _ in range((1 << c) - 1):
            acc = acc + B
            row.append(acc)
        rows.append(row)
        B = acc + B
    return rows


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
    """Device kernel bundle over a named curve (G2 over an Fq2 or Fq3
    tower, or over Fq for an embedding-degree-6 curve).

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
        # a-coefficient (MNT4, MNT6, edwards) takes the torch formulas over
        # the product kernel
        a_int = int(getattr(curve, "a", 0))
        g1_mul_a = ((lambda x, fk=self.fq, k=a_int: fk.mul_small(x, k))
                    if a_int else None)
        self.g1 = CurveKernel(self.fq, f"{curve.name}.G1",
                              mul_by_a=g1_mul_a, a_tag=str(a_int),
                              a_coeffs=(a_int,) if a_int else None)
        deg = getattr(curve, "g2_field_degree", 2)
        if deg == 1:
            # k = 6 (BW6-761): G2 lies over Fq itself, a2 = 0, so its group
            # law takes the same kernels as G1 (ext = 1)
            self.fq2 = None
            self.g2 = CurveKernel(self.fq, f"{curve.name}.G2", a_tag="0")
        elif deg in (2, 3):
            # G2 over Fq2 (the a = 0 curves, MNT4) or Fq3 (MNT6, edwards:
            # the quadratic twist); a2 = a * the twist's constant
            if deg == 2:
                self.fq2 = Fp2Kernel(self.fq, int(curve.Fq2.NON_RESIDUE))
            else:
                self.fq2 = Fp3Kernel(self.fq, int(curve.Fq3.NON_RESIDUE))
            a2 = getattr(curve, "a2", None)
            ks = (tuple(int(getattr(a2, f"c{i}")) for i in range(deg))
                  if a2 is not None else (0,) * deg)
            mul_a2 = ((lambda x, fk=self.fq2, k=ks: fk.mul_by_const(x, *k))
                      if any(ks) else None)
            self.g2 = CurveKernel(self.fq2, f"{curve.name}.G2",
                                  mul_by_a=mul_a2,
                                  a_tag=str(ks) if any(ks) else "",
                                  a_coeffs=ks if any(ks) else None)
        else:
            raise NotImplementedError(f"G2 over a field of degree {deg}")
        sbits = curve.r.bit_length()
        self.msm_g1 = MSMKernel(self.g1, sbits, strategy=msm_strategy)
        self.msm_g2 = MSMKernel(self.g2, sbits, strategy=msm_strategy)
        self.scalar_limbs = -(-sbits // 16)
        self._fixed_tables = {}
        self._domains = {}

    def first_unsatisfied(self, r1cs_dev, pb) -> Optional[str]:
        """Protoboard.first_unsatisfied's verdict and message, checked on
        the device R1CS of the board's constraint system (a proving key's
        ``r1cs_dev``): "constraint {i}: {annotation}" for the first
        unsatisfied constraint, or None."""
        if r1cs_dev.num_constraints != pb.num_constraints or \
                r1cs_dev.num_variables != pb.num_variables:
            raise ValueError("the device R1CS is not the board's: "
                             f"{r1cs_dev.num_constraints} constraints and "
                             f"{r1cs_dev.num_variables} variables against "
                             f"{pb.num_constraints} and {pb.num_variables}")
        r = self.curve.r
        full = [1] + [v % r for v in pb.full_assignment()[1:]]
        i = r1cs_dev.first_unsatisfied_row(self.fr, self.fr.encode(full))
        return None if i is None else f"constraint {i}: {pb.constraints[i][3]}"

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
        arr = ints_to_limbs(xs, self.scalar_limbs, self.curve.r)
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

    def fixed_base_points_g1(self, base_host, scalars) -> list:
        """[s * base for s in scalars] as host G1 points, through
        fixed_base_g1 (the device path unless host_keygen)."""
        aff = self.fixed_base_g1(base_host, scalars)
        n = len(scalars)
        return self.g1.decode_affine(tuple(a[..., :n] for a in aff),
                                     self.curve.G1)

    def fixed_base_g2(self, base_host, scalars):
        if self.host_keygen:
            return self._fixed_base_host(self.g2, base_host, scalars)
        return self._fixed_base(self.g2, self.msm_g2, base_host, scalars)

    # Pure-Python fixed-base path for tiny circuits (`host_keygen = True`),
    # as in the JAX package; the same affine points as the device path.
    host_keygen = False

    def _fixed_base_host(self, ck, base_host, scalars):
        """Windowed fixed-base on the host: one shared table, then
        ~ceil(bits/c) table adds per scalar. The window c (2-10) takes the
        fewest adds for this many scalars, about W 2^c for the table and W
        a scalar: any c gives the same points."""
        r = self.curve.r
        scalars = list(scalars)
        bits = r.bit_length()
        c = min(range(2, 11), key=lambda c: -(-bits // c) * (
            (1 << c) + len(scalars)))
        W = -(-bits // c)
        group = base_host.group
        zero = group.zero()
        mask = (1 << c) - 1
        # over a prime field the table and the sums run in Jacobian form on
        # plain integers, each made affine by one batched inversion; over
        # an extension field in affine host points
        prime = group.F.degree == 1
        table = (_host_window_table(base_host, c, W) if prime
                 else _host_window_table_affine(base_host, c, W))
        madd = _int_madd(group) if prime else (
            lambda acc, Q: (zero if acc is None else acc) + Q)
        sums = []
        for s in scalars:
            s = int(s) % r
            acc = None
            w = 0
            while s:
                d = s & mask
                if d:
                    acc = madd(acc, table[w][d])
                s >>= c
                w += 1
            sums.append(acc)
        pts = (_to_affine_host(group, sums) if prime else
               [zero if P is None else P for P in sums])
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
