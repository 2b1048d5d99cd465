#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (libsnark_tpu_torch) on one NVIDIA card.

1. Prints the card (torch.cuda.get_device_name and nvidia-smi's name and
   power limit).
2. Builds the CUDA kernels from libsnark_tpu_torch/csrc (nvcc, sm_90a, one
   process per source, both field widths in each) and prints ptxas's
   registers, stack frames and spills per kernel and width.
3. Runs the two probes (32-bit operation rates; Montgomery-product bodies
   at 16 and 24 limbs), each exact against its plain version, and prints
   the instructions of each probe kernel's main loop (cuobjdump -sass).
4. For alt_bn128 (16-limb Fq) and BLS12-377 (24-limb Fq), G1 and G2,
   holds every kernel against its plain PyTorch version on the card at
   main-path shapes, bit-exact (tolerance 0): mont_mul at 2^20 lanes;
   dbl / add / madd / aadd at 2^16 lanes with planted infinity, P == Q
   and P == -Q lanes; bucket_reduce on the signed-digit buckets of a
   2^16-point MSM with all-equal points in one bucket; horner_combine;
   and the dense strategy's window sums against the default strategy's on
   a 2^16-point MSM, with random scalars and with 4096 all-equal scalars
   (the chunk loop). Times each (CUDA events).
5. Cross-checks a 20-constraint seeded Groth16 proof made on the card with
   the same proof made by the plain versions on the CPU.
6. Runs seeded Groth16 generator -> prover -> verifier through the entry
   points: over alt_bn128 and over BLS12-377, both at 2^20 constraints
   (generate_r1cs_example(r, 2^k - 3, 2), generator(seed=5) on the device
   fixed-base path, prover(seed=9)), each proved with the default and with
   the dense MSM strategy. The two proofs must be equal, the proof must
   verify, and a corrupted proof and a wrong input must be rejected. Every
   kernel of a path must have launched in it; aadd must launch under the
   dense strategy and never under the default one.

Prints the kernel table as one JSON line, the card line, and last the
line {"ok": true, "device": {...}}. Each row of the table names in "path"
the run its "launches" were counted in: the alt_bn128 or the bls12_377 main
path (keygen + both proves), or "probe" (one run of probes.measure_rates /
measure_cios). Any failed check raises: exit code 1.

    python3 chip_smoke.py                     # needs one CUDA card
    python3 chip_smoke.py --log2 14 --bn-log2 12     # smaller circuits
"""
from __future__ import annotations

import argparse
import json
import random
import re
import subprocess
import sys
import time

import torch

# H100 SXM peaks. Memory: 3.35 TB/s HBM3 (NVIDIA data sheet). The data
# sheet lists no integer rate. INT32_LANE_OPS_PER_S is one 32-bit integer
# instruction per lane and clock (64 lanes x 132 SMs x 1.98 GHz = 67e12 / 4,
# the FP32 figure over the INT32 lanes); scripts/probe_h100.py measures
# mul.lo and mad.lo at 94-96 % of it on an NVIDIA H100 80GB HBM3 at 700 W.
# INT32_OPS_PER_S, the peak that the kernels' operation bounds use, is half
# of that: a 32x32->64-bit multiply-add (IMAD.WIDE.U32, what the field
# products are made of) writes two registers and is taken as two such
# instructions. The probe can neither confirm nor raise it: the compiler
# puts at least one add beside every IMAD.WIDE.U32, and its mad.wide chain
# (one IMAD.WIDE.U32, one IADD3 and half an IADD3.X per step) runs at
# 5.5e12 to 5.8e12 steps per second (this script measures it again and
# prints it), so the bound stands on the optimistic side of the measurement.
MEM_BYTES_PER_S = 3.35e12
INT32_LANE_OPS_PER_S = 67e12 / 4
INT32_OPS_PER_S = INT32_LANE_OPS_PER_S / 2
# an f32 multiply (67 TFLOP/s counts a fused multiply-add as two)
F32_MUL_PER_S = 67e12 / 2
PRODUCTS = {"aadd": 6, "dbl": 7, "madd": 11, "add": 16}  # base-field products


def wide_mads(fk) -> int:
    """Wide multiply-adds of one Montgomery product over NW = N/2 words:
    NW^2 (a*b) + NW (m) + NW^2 (m*p)."""
    nw = fk.N // 2
    return 2 * nw * nw + nw


TPU_KERNEL = {
    "mont_mul": "libsnark_tpu/ops/pallas_fp.py:291",
    "dbl": "libsnark_tpu/ops/pallas_ec.py:355",
    "madd": "libsnark_tpu/ops/pallas_ec.py:255",
    "add": "libsnark_tpu/ops/pallas_ec.py:290",
    "aadd": "libsnark_tpu/ops/pallas_ec.py:322",
    "bucket_reduce": "libsnark_tpu/ops/pallas_bucket.py:72",
    "horner_combine": "libsnark_tpu/ops/pallas_bucket.py:212",
    "probe_rate": "scripts/probe_vpu_ops.py:49",
    "probe_cios": "scripts/probe_cios.py:98",
}
SOURCE = {
    "mont_mul": "libsnark_tpu_torch/csrc/fp.cu",
    "dbl": "libsnark_tpu_torch/csrc/ec.cu",
    "madd": "libsnark_tpu_torch/csrc/ec.cu",
    "add": "libsnark_tpu_torch/csrc/ec.cu",
    "aadd": "libsnark_tpu_torch/csrc/ec.cu",
    "bucket_reduce": "libsnark_tpu_torch/csrc/bucket.cu",
    "horner_combine": "libsnark_tpu_torch/csrc/bucket.cu",
    "probe_rate": "libsnark_tpu_torch/csrc/probe.cu",
    "probe_cios": "libsnark_tpu_torch/csrc/probe.cu",
}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over reps calls (after one warm-up)."""
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


def max_abs_err(xs, ys) -> int:
    err = 0
    for x, y in zip(xs, ys):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
        err = max(err, int(d))
    return err


class Kernels:
    """Collects one row per (kernel, coordinate field, width) for the JSON
    table; the row's key is the kernel's launch-counter key."""

    def __init__(self):
        self.rows = {}

    def add(self, name, key, err, ms, plain_ms, nbytes, ops,
            ops_per_s=INT32_OPS_PER_S):
        b, by = bound_ms(nbytes, ops, ops_per_s)
        self.rows[key] = {
            "name": key, "route": "cuda", "source": SOURCE[name],
            "replaces": TPU_KERNEL[name], "launches": None, "path": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None}
        if err != 0:
            raise AssertionError(f"{key}: kernel differs from its plain "
                                 f"version (max abs limb error {err})")
        log(f"  {key}: bit-exact; kernel {ms:.4f} ms, plain {plain_ms:.2f} "
            f"ms, bound {b:.4f} ms ({by})")


def ptxas_summary(logs: dict):
    """One line per kernel: registers, stack frame, spill stores / loads."""
    for unit, text in logs.items():
        entry, frame = None, ("?", "?", "?")
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # name<template integers>: <NW, ext>, <NW>, <NW, variant>
                # or <op> as the kernel declares them
                entry = re.sub(r".*'_Z\d+([a-z_]+).*", r"\1", line.strip())
                targs = re.search(r"'_Z\d+[a-z_]+I((?:Li\d+E)+)E", line)
                if targs:
                    entry += "<" + ", ".join(
                        re.findall(r"Li(\d+)E", targs.group(1))) + ">"
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                frame = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                log(f"  ptxas[{unit}] {entry}: {m.group(1)} registers, "
                    f"stack {frame[0]} B, spill stores/loads "
                    f"{frame[1]}/{frame[2]} B")
                entry = None


# ------------------------------------------------------------------ inputs

def rand_field(fk, shape, gen):
    """Uniform canonical limbs: top limb below p's top limb, so < p."""
    N = fk.N
    top = (fk.p >> (16 * (N - 1)))
    lo = torch.randint(0, 1 << 16, (N - 1,) + tuple(shape), generator=gen,
                       device="cuda", dtype=torch.int32)
    hi = torch.randint(0, top, (1,) + tuple(shape), generator=gen,
                       device="cuda", dtype=torch.int32)
    return torch.cat([lo, hi], dim=0)


def plant_edges(fk, a):
    """Lanes 0..2 of a field tensor get 0, 1 and p - 1."""
    a = a.clone()
    a[:, :3] = fk.encode([0, 1, fk.p - 1], mont=False)
    return a


def host_points(curve, group, k: int, rng):
    G = group.one()
    return [G * rng.randrange(1, curve.r) for _ in range(k)]


def jacobian_lanes(ck, fk_rand, aff, idx):
    """Affine host-encoded points gathered to lanes idx, lifted to
    Jacobian with random Z (X = x Z^2, Y = y Z^3)."""
    fk = ck.fk
    x, y = aff[0][..., idx], aff[1][..., idx]
    Z = fk_rand(idx.shape)
    Z2 = fk.sqr(Z)
    return [fk.mul(x, Z2), fk.mul(y, fk.mul(Z2, Z)), Z]


def groups_of(curve, g16):
    return ((g16.g1, g16.msm_g1, curve.G1, 1), (g16.g2, g16.msm_g2, curve.G2, 2))


# ------------------------------------------------------------ kernel checks

def check_probes(K, fqs):
    """Both probes through the functions scripts/probe_h100.py calls; the
    counts are read over exactly this run."""
    from libsnark_tpu_torch import probes
    for k in probes.LAUNCHES:
        probes.LAUNCHES[k] = 0
    log("probe: 32-bit operation rates (8 chains x 270336 threads x 4096 steps)")
    for r in probes.measure_rates():
        per_s = (F32_MUL_PER_S if r["op"] == "mul_f32"
                 else INT32_LANE_OPS_PER_S)
        key = f"probe_rate_{r['op']}"
        K.add("probe_rate", key, 0 if r["exact"] else 1, r["ms"],
              r["plain_ms"], 12 * r["steps"] / r["K"], r["steps"], per_s)
        log(f"    {r['op']}: {r['gsteps_per_s']:.1f} G steps/s")
        if r["op"] == "mad_wide":
            log(f"    mad.wide step measured {r['gsteps_per_s'] / 1e3:.3f}e12/s; "
                f"the bounds use INT32_OPS_PER_S = {INT32_OPS_PER_S:.4g}")
    log("probe: Montgomery-product bodies (2^20 lanes x 64 chained products)")
    for r in probes.measure_cios(fqs):
        key = f"probe_cios_{r['variant']}_n{r['N']}"
        ops = r["lanes"] * r["K"] * r["wide_mads_per_product"]
        K.add("probe_cios", key, 0 if r["exact"] else 1, r["ms"],
              r["plain_ms"], 3 * 4 * r["N"] * r["lanes"], ops)
        log(f"    N={r['N']} {r['variant']}: {r['gproducts_per_s']:.3f} G "
            f"products/s = {ops / r['ms'] / 1e9:.3f}e12 wide mads/s")
    for key, n in probes.LAUNCHES.items():
        if n == 0:
            raise AssertionError(f"probe kernel not launched: {key}")
        K.rows[key]["launches"] = n
        K.rows[key]["path"] = "probe"
    log("probe: instructions in each kernel's main loop (cuobjdump -sass)")
    for key, loop in probes.sass_loops().items():
        log(f"    {key}: {sum(loop.values())} instructions: "
            + ", ".join(f"{n} {opc}" for opc, n in loop.items()))


def check_mont_mul(fr, fq, K, gen):
    from libsnark_tpu_torch.ops import cuda_fp
    L = 1 << 20
    log(f"mont_mul: {L} lanes, Fq (N={fq.N}) and Fr (N={fr.N})")
    for fk in (fq, fr):
        a = plant_edges(fk, rand_field(fk, (L,), gen))
        b = plant_edges(fk, rand_field(fk, (L,), gen)).flip(-1).contiguous()
        out = cuda_fp.mont_mul(fk, a, b)
        plain = cuda_fp.mont_mul_plain(fk, a, b)
        err = max_abs_err([out], [plain])
        key = f"mont_mul_n{fk.N}"
        if fk is fq and key not in K.rows:
            ms = cuda_ms(lambda: cuda_fp.mont_mul(fk, a, b), 50)
            pms = cuda_ms(lambda: cuda_fp.mont_mul_plain(fk, a, b), 2)
            K.add("mont_mul", key, err, ms, pms, 3 * 4 * fk.N * L,
                  wide_mads(fk) * L)
        elif err:
            raise AssertionError(f"mont_mul ({key}) differs: {err}")


def ec_inputs(curve, ck, group, L, gen, rng):
    """Lanes of P, Q (Jacobian), P and Q affine with planted cases:
    0..7 P = inf, 8..15 Q = inf, 16..23 P == Q, 24..31 P == -Q,
    32..39 both inf; the rest random."""
    fk = ck.fk
    ext = 2 if hasattr(fk, "fp") else 1
    pts = host_points(curve, group, 64, rng)
    aff = ck.encode_points(pts, jacobian=False, device="cuda")
    base = fk.fp if ext == 2 else fk

    def frand(shape):
        if ext == 2:
            return torch.stack([rand_field(base, shape, gen),
                                rand_field(base, shape, gen)])
        return rand_field(base, shape, gen)

    i1 = torch.randint(0, 64, (L,), generator=gen, device="cuda")
    i2 = torch.randint(0, 64, (L,), generator=gen, device="cuda")
    i2[16:32] = i1[16:32]
    P = jacobian_lanes(ck, frand, aff, i1)
    Q = jacobian_lanes(ck, frand, aff, i2)
    Q[1][..., 24:32] = fk.neg(Q[1][..., 24:32])
    for T, lanes in ((P, slice(0, 8)), (Q, slice(8, 16)),
                     (P, slice(32, 40)), (Q, slice(32, 40))):
        T[2][..., lanes] = 0
    qx, qy = aff[0][..., i2].clone(), aff[1][..., i2].clone()
    qy[..., 24:32] = fk.neg(qy[..., 24:32])
    q_inf = torch.zeros(L, dtype=torch.bool, device="cuda")
    q_inf[8:16] = True
    q_inf[32:40] = True
    p_inf = torch.zeros(L, dtype=torch.bool, device="cuda")
    p_inf[0:8] = True
    p_inf[32:40] = True
    Pa = (aff[0][..., i1].clone(), aff[1][..., i1].clone(), p_inf)
    valid = torch.rand(L, generator=gen, device="cuda") < 0.9
    valid[:40] = True
    return tuple(P), tuple(Q), Pa, (qx, qy, q_inf), valid


def check_ec(curve, g16, K, gen, rng):
    from libsnark_tpu_torch.ops import cuda_ec
    L = 1 << 16
    for ck, _, group, ext in groups_of(curve, g16):
        fk = ck.fk
        FW = ext * fk.N
        log(f"dbl / add / madd / aadd: {L} lanes, ext={ext}, N={fk.N}")
        P, Q, Pa, Qa, valid = ec_inputs(curve, ck, group, L, gen, rng)
        # (kernel, plain, field tensors read and written per lane)
        cases = {
            "dbl": (lambda: cuda_ec.dbl(fk, P),
                    lambda: cuda_ec.dbl_plain(fk, P), 6),
            "add": (lambda: cuda_ec.add(fk, P, Q),
                    lambda: cuda_ec.add_plain(fk, P, Q), 9),
            "madd": (lambda: cuda_ec.madd(fk, P, Qa, valid),
                     lambda: cuda_ec.madd_plain(fk, P, Qa, valid), 8),
            "aadd": (lambda: cuda_ec.aadd(fk, Pa, Qa),
                     lambda: cuda_ec.aadd_plain(fk, Pa, Qa), 7),
        }
        for name, (kern, plain, nfield) in cases.items():
            err = max_abs_err(kern(), plain())
            ms = cuda_ms(kern, 20)
            pms = cuda_ms(plain, 1)
            ops = PRODUCTS[name] * (3 if ext == 2 else 1) * wide_mads(fk) * L
            nbytes = nfield * FW * 4 * L + (2 * L if name in ("madd", "aadd")
                                            else 0)
            K.add(name, cuda_ec.counter_key(name, fk), err, ms, pms, nbytes,
                  ops)
        # the planted lanes really hit the exceptional cases
        for out in (ck.to_affine(cuda_ec.add(fk, P, Q)),
                    ck.to_affine(cuda_ec.aadd(fk, Pa, Qa))):
            if not bool(out[2][24:40].all()) or bool(out[2][:24].any()):
                raise AssertionError("P == -Q and both-infinity lanes must "
                                     "give infinity, and no other planted lane")


def msm_inputs(curve, g16, ck, group, m, gen, rng):
    """64 distinct points spread over m lanes: lanes 0..63 one point with
    one scalar (P == Q inside a bucket), 64..71 infinity, 72..79 zero
    scalars."""
    pts = host_points(curve, group, 64, rng)
    aff = ck.encode_points(pts, jacobian=False, device="cuda")
    idx = torch.randint(0, 64, (m,), generator=gen, device="cuda")
    idx[:64] = 0
    inf = torch.zeros(m, dtype=torch.bool, device="cuda")
    inf[64:72] = True
    sc = rand_field(g16.fr, (m,), gen)
    sc[:, :64] = sc[:, :1]
    sc[:, 72:80] = 0
    return (aff[0][..., idx], aff[1][..., idx], inf), sc


def check_bucket_and_horner(curve, g16, K, gen, rng):
    from libsnark_tpu_torch.ops import cuda_bucket
    from libsnark_tpu_torch.ops.cuda_ec import counter_key
    from libsnark_tpu_torch.ops.msm import default_window_bits
    m = 1 << 16
    for ck, mk, group, ext in groups_of(curve, g16):
        fk = mk.fk
        FW = ext * fk.N
        c = default_window_bits(m)
        points, sc = msm_inputs(curve, g16, ck, group, m, gen, rng)
        seg = mk.bucket_segments(sc, c)
        args = (mk.row_table(points), seg["gidx"], seg["seg_start"],
                seg["seg_count"])
        counts = seg["seg_count"]
        log(f"bucket_reduce: {m}-point MSM, ext={ext}, N={fk.N}, c={c}, "
            f"{seg['num_buckets']} buckets in {counts.numel()} segments, "
            f"deepest segment {int(counts.max())}")
        out = cuda_bucket.bucket_reduce(fk, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = cuda_bucket.bucket_reduce_plain(fk, *args)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3       # one call: it is slow
        err = max_abs_err(out, plain)
        ms = cuda_ms(lambda: cuda_bucket.bucket_reduce(fk, *args), 5)
        # data-dependent work: one madd per row in a bucket run
        n_madd = int(counts.sum())
        ops = n_madd * PRODUCTS["madd"] * (3 if ext == 2 else 1) * wide_mads(fk)
        nbytes = (args[0].numel() * 4 + args[1].numel() * 4
                  + args[2].numel() * 8 + args[3].numel() * 4
                  + 3 * FW * 4 * counts.numel())
        K.add("bucket_reduce", counter_key("bucket_reduce", fk), err, ms, pms,
              nbytes, ops)

        # Horner at the 2^20 main path's window count and width, over
        # the first of these segment sums
        c = default_window_bits(1 << 20)
        Wh = mk.num_windows(c)
        S = tuple(a[:, :Wh].contiguous() for a in out)
        hk = cuda_bucket.horner_combine(fk, S, c)
        hp = cuda_bucket.horner_combine_plain(fk, S, c)
        err = max_abs_err(hk, hp)
        ms = cuda_ms(lambda: cuda_bucket.horner_combine(fk, S, c), 5)
        pms = cuda_ms(lambda: cuda_bucket.horner_combine_plain(fk, S, c), 1)
        prods = (Wh - 1) * (c * PRODUCTS["dbl"] + PRODUCTS["add"])
        ops = prods * (3 if ext == 2 else 1) * wide_mads(fk)
        K.add("horner_combine", counter_key("horner_combine", fk), err, ms,
              pms, 4 * 3 * FW * (Wh + 1), ops)


def check_dense_window_sums(curve, g16, gen, rng):
    """The dense strategy's window sums equal the default strategy's as
    affine points on a 2^16-point MSM: random scalars (planted cases as in
    msm_inputs), then 4096 all-equal scalars, which put 4096 points into
    one bucket of every window and send the chunk loop through it."""
    from libsnark_tpu_torch.ops import cuda_ec
    from libsnark_tpu_torch.ops.msm import MSMKernel, default_window_bits
    m = 1 << 16
    c = default_window_bits(m)
    lanes = lambda S: tuple(a.movedim(0, -2) for a in S)       # (.., W, 1)
    for ck, mk, group, ext in groups_of(curve, g16):
        dense = MSMKernel(ck, mk.scalar_bits, strategy="dense")
        key = cuda_ec.counter_key("aadd", mk.fk)
        points, sc = msm_inputs(curve, g16, ck, group, m, gen, rng)
        equal = sc.clone()
        equal[:, :4096] = sc[:, :1]
        for label, scalars in (("random scalars", sc),
                               ("4096 all-equal scalars", equal)):
            before = cuda_ec.LAUNCHES[key]
            t0 = time.perf_counter()
            want = ck.to_affine(lanes(mk.window_sums(points, scalars, c)))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if cuda_ec.LAUNCHES[key] != before:
                raise AssertionError("aadd launched by the default strategy")
            got = ck.to_affine(lanes(dense.window_sums(points, scalars, c)))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n_aadd = cuda_ec.LAUNCHES[key] - before
            live = ~want[2]
            same = torch.equal(got[2], want[2]) and all(
                torch.equal(a[..., live], b[..., live])
                for a, b in zip(got[:2], want[:2]))
            if not same or n_aadd == 0:
                raise AssertionError(f"dense window sums differ from the "
                                     f"default strategy's ({label}, ext={ext})")
            log(f"dense window sums == default: {m} points, ext={ext}, "
                f"N={mk.fk.N}, c={c}, {label}: {n_aadd} aadd launches; "
                f"default {t1 - t0:.3f} s, dense {t2 - t1:.3f} s")


# ------------------------------------------------------------- end to end

def small_cross_check(curve):
    """20 constraints: proof on the card == proof from the plain versions
    on the CPU, and it verifies."""
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.relations.examples import generate_r1cs_example
    proofs = []
    for device in ("cuda", "cpu"):
        cs, primary, aux = generate_r1cs_example(curve.r, 20, 2)
        g = Groth16(curve, device=device)
        kp = g.generator(cs, seed=5)
        proofs.append(g.prover(kp.pk, primary, aux, seed=9))
        if not g.verifier_strong_IC(kp.vk, primary, proofs[-1]):
            raise AssertionError(f"20-constraint proof ({device}) rejected")
    if proofs[0] != proofs[1]:
        raise AssertionError("card proof != CPU plain proof (20 constraints)")
    log("20-constraint seeded proof: card == CPU plain, verifies")


def main_path(curve, log2: int) -> dict:
    """Keygen, prove (default strategy), prove (dense strategy), verify.
    Counts are set to 0 just before each phase and read just after; returns
    the path's launches per kernel (the three phases added up)."""
    from libsnark_tpu_torch.ops import launch_counts, reset_launch_counts
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.relations.examples import generate_r1cs_example
    n = (1 << log2) - 3
    t0 = time.perf_counter()
    cs, primary, aux = generate_r1cs_example(curve.r, n, 2)
    log(f"main path {curve.name}: generate_r1cs_example(r, 2^{log2} - 3, 2): "
        f"{time.perf_counter() - t0:.2f} s (host)")
    systems = {"segments": Groth16(curve),                 # device="cuda"
               "dense": Groth16(curve, msm_strategy="dense")}
    phases, proofs = {}, {}

    def run(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        timings = {}
        t0 = time.perf_counter()
        out = fn(timings)
        wall = time.perf_counter() - t0
        phases[label] = {k: v for k, v in launch_counts().items() if v}
        log(f"  {label} {wall:.3f} s: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()))
        log(f"  {label}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            + json.dumps(phases[label]))
        return out

    g16 = systems["segments"]
    kp = run("keygen", lambda t: g16.generator(cs, seed=5, timings=t))
    log(f"  domain m = {g16._domain(cs.num_constraints, cs.num_inputs).m}")
    for strategy, g in systems.items():
        proofs[strategy] = run(f"prove[{strategy}]", lambda t: g.prover(
            kp.pk, primary, aux, seed=9, timings=t))
    if proofs["segments"] != proofs["dense"]:
        raise AssertionError("the dense strategy's proof differs from the "
                             "default strategy's")
    proof = proofs["dense"]
    t0 = time.perf_counter()
    ok = g16.verifier_strong_IC(kp.vk, primary, proof)
    bad_input = list(primary)
    bad_input[0] = (bad_input[0] + 1) % curve.r
    rej_input = not g16.verifier_strong_IC(kp.vk, bad_input, proof)
    tam = type(proof)(g_A=proof.g_A, g_B=proof.g_B,
                      g_C=proof.g_C + curve.G1.one())
    rej_proof = not g16.verifier_strong_IC(kp.vk, primary, tam)
    log(f"  proofs equal under both strategies; verify "
        f"{time.perf_counter() - t0:.2f} s (host): accepted={ok} "
        f"wrong-input-rejected={rej_input} corrupted-proof-rejected={rej_proof}")
    if not (ok and rej_input and rej_proof):
        raise AssertionError("Groth16 verification checks failed")

    aadd = [k for k in launch_counts() if k.startswith("aadd_")]
    if any(phases[p].get(k) for k in aadd for p in ("keygen", "prove[segments]")):
        raise AssertionError("aadd launched outside the dense strategy")
    total = {}
    for counts in phases.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    nq = g16.fq.N
    path = [f"mont_mul_n{nq}", f"mont_mul_n{g16.fr.N}"] + [
        f"{k}_{f}_n{nq}" for k in ("dbl", "add", "madd", "aadd",
                                   "bucket_reduce", "horner_combine")
        for f in ("fp", "fp2")]
    missing = [k for k in path if not total.get(k)]
    if missing:
        raise AssertionError(f"kernels not launched on the {curve.name} "
                             f"main path: {missing}")
    return total


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2", type=int, default=20,
                    help="BLS12-377 circuit: 2^log2 - 3 constraints (20)")
    ap.add_argument("--bn-log2", type=int, default=20,
                    help="alt_bn128 circuit: 2^k - 3 constraints (20)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.ops import cuda_lib
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16

    t_start = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    card = card_line()
    log(f"nvidia-smi: {card}")
    cuda_lib.build_all()
    log(f"kernels built in {cuda_lib.build_seconds:.1f} s "
        f"({len(cuda_lib.SOURCES)} libraries in parallel)")
    ptxas_summary(cuda_lib.build_logs)

    curves = {"alt_bn128": args.bn_log2, "bls12_377": args.log2}
    systems = {name: Groth16(get_curve(name)) for name in curves}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rng = random.Random(1234)
    K = Kernels()
    check_probes(K, [g.fq for g in systems.values()])
    for name, g16 in systems.items():
        log(f"--- kernels against their plain versions: {name}")
        check_mont_mul(g16.fr, g16.fq, K, gen)
        check_ec(g16.curve, g16, K, gen, rng)
        check_bucket_and_horner(g16.curve, g16, K, gen, rng)
        check_dense_window_sums(g16.curve, g16, gen, rng)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
    small_cross_check(get_curve("alt_bn128"))
    del systems
    for name, log2 in curves.items():
        counts = main_path(get_curve(name), log2)
        for key, n in counts.items():
            # Fr is 16 limbs on both curves: mont_mul_n16 keeps the count of
            # the alt_bn128 path, where Fq and Fr both run through it
            if K.rows[key]["launches"] is None:
                K.rows[key]["launches"] = n
                K.rows[key]["path"] = name
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
    unread = [k for k, row in K.rows.items() if row["launches"] is None]
    if unread:
        raise AssertionError(f"kernels with no main-path count: {unread}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(K.rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
