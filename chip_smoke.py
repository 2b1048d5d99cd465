#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (libsnark_tpu_torch) on one NVIDIA card.

1. Prints the card (torch.cuda.get_device_name and nvidia-smi's name and
   power limit).
2. Builds the CUDA kernels from libsnark_tpu_torch/csrc (nvcc, sm_90a, one
   process per source, both field widths in each) and prints ptxas's
   registers, stack frames and spills per kernel and width.
3. Runs the probes, each exact against its plain version: the 32-bit
   operation rates and the Montgomery-product bodies at 16 and 24 limbs,
   with the instructions of each kernel's main loop (cuobjdump -sass); and
   the eleven layout and row-copy kernels in every case of
   probes.layout_cases (the TPU scripts' shapes, odd offsets, shifts
   outside [0, axis), tiles with no word above 7, trip counts 1..6), with
   where each kernel's data went (shared, local memory, barriers), an
   empty kernel's time as the launch floor, and the row-copy rates at the
   row widths bucket_reduce gathers beside one index_select; and the latency
   of one dependent product (one thread, one lane group).
4. For alt_bn128 (16-limb Fq) and BLS12-377 (24-limb Fq), G1 and G2,
   holds every kernel against its plain PyTorch version on the card at
   main-path shapes, bit-exact (tolerance 0): mont_mul at 2^20 lanes;
   dbl / add / madd / aadd at 2^16 lanes with planted infinity, P == Q
   and P == -Q lanes, add also at 294,930 lanes (one suffix-scan launch of
   a 2^20-point MSM); bucket_reduce on the packed rows and length-ordered
   segments of a 2^16-point MSM with all-equal points in one bucket;
   horner_combine at W in {1, 2, 18} windows and c in {1, 15, 16} on
   planted window sums (an infinity window, an infinity top window, a
   first add that meets P == Q, a sum at infinity),
   timed at the path's 18 windows of c = 15 beside its latency bound (the
   critical path (W - 1)(3 c + 5) times the least product latency that the
   probes measured);
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
   dense strategy and never under the default one. Then one more default
   prove under torch.profiler (CUDA activity): each hand-written kernel's
   device time summed by __global__ name, its launches (checked against
   the wrappers' counters), its work (the wrappers' WORK counters) and the
   bound of that work, device busy time and idle share; and the device
   time of a 2^20-point G1 and G2 MSM split into sort, bucket_reduce, add,
   horner_combine and the rest, with bucket_reduce's warp efficiency in
   bucket order and in length order.
7. Runs KZG10 through its entry points: over BLS12-377 at degree 2^22 - 1
   and over alt_bn128 at 2^20 - 1: setup(seed=3) on the device, then for a
   seeded random polynomial commit, create_evaluation_witness,
   verify_evaluation (accepted; a wrong value and a wrong point rejected)
   and verify_poly (accepted; a changed coefficient rejected), each phase
   timed between device synchronisations by the port's Profiler, with peak
   device memory. The same for all-equal coefficients, for mostly-zero
   coefficients, for the zero polynomial and for a short polynomial under
   the long SRS; the commitment of 2^16 coefficients under the dense MSM
   strategy must equal the default strategy's. Over alt_bn128 also the
   batched two-point opening and the BDFG21 opening of a few polynomials
   of degree 2^12 - 1, each accepted and rejected after tampering. Every
   G1 kernel of the path must have launched in it. Over BLS12-377 the
   random polynomial is committed and opened once more under the profiler,
   as the provers above.
8. Ranks the kernels by device time - bound over those three profiled
   paths (the order of the redesign PRs).

Prints the kernel table as one JSON line, the card line, and last the
line {"ok": true, "device": {...}}. Each row of the table names in "path"
the run its "launches" were counted in: the alt_bn128 or the bls12_377
Groth16 path (keygen + both proves), or "probe" (the kernels that ran in
one probes.measure_rates / measure_cios / measure_layout /
measure_row_copy: every case once, the timing loops, and the replays of
the CUDA graphs the layout kernels are timed in); "paths" holds the
row's launches in every path that ran it, the KZG paths (kzg_bls12_377,
kzg_alt_bn128: setup + commit + opening) among them; "path_ms" and
"path_bound_ms" the device time and bound of its launches in each
profiled path (prove_alt_bn128, prove_bls12_377, kzg_bls12_377). Any
failed check raises: exit code 1.

    python3 chip_smoke.py                     # needs one CUDA card
    python3 chip_smoke.py --log2 14 --bn-log2 12 --kzg-log2 14   # small sizes
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
# lanes of one add launch of the suffix scan of a 2^20-point MSM: 18 windows
# of c = 15, 2^14 + 1 buckets each
SCAN_LANES = 18 * ((1 << 14) + 1)
# least latency of one dependent base-field product at each width (N limbs,
# ms), over the one-thread carry chains and the lane-split product, as
# check_probes measures it in this run: horner_combine's latency bound is its
# critical path (W - 1)(3 c + 5) products times this
PRODUCT_LATENCY_MS = {}


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
    "row_copy": "scripts/probe_mosaic_dma.py:47",
    "transpose": "scripts/probe_mosaic_ops.py:49",
    "reshape_merge_minor": "scripts/probe_mosaic_ops.py:61",
    "reshape_merge_major": "scripts/probe_mosaic_ops.py:73",
    "squeeze": "scripts/probe_mosaic_ops.py:85",
    "roll_minor": "scripts/probe_mosaic_ops.py:97",
    "roll_middle": "scripts/probe_mosaic_ops.py:114",
    "cond": "scripts/probe_mosaic_ops.py:131",
    "window_copy": "scripts/probe_mosaic_ops.py:145",
    "loop_dyn": "scripts/probe_mosaic_ops.py:168",
    "dynslice_sum": "scripts/probe_mosaic_ops.py:185",
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
SOURCE.update({name: "libsnark_tpu_torch/csrc/probe_layout.cu"
               for name in TPU_KERNEL if name not in SOURCE})


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
            ops_per_s=INT32_OPS_PER_S, library_ms=None, **extra):
        """extra: further keys of the row. Two of them raise the bound a
        time is read against (the row's "bound_ms" stays bytes and
        operations): latency_bound_ms (horner_combine's critical path times
        the product latency) and launch_floor_ms (an empty kernel launched
        the same way, for the launch-bound probes)."""
        b, by = bound_ms(nbytes, ops, ops_per_s)
        self.rows[key] = {
            "name": key, "route": "cuda", "source": SOURCE[name],
            "replaces": TPU_KERNEL[name], "launches": None, "path": None,
            "paths": {}, "path_ms": {}, "path_bound_ms": {},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms, **extra}
        if err != 0:
            raise AssertionError(f"{key}: kernel differs from its plain "
                                 f"version (max abs limb error {err})")
        floor = max([b] + [extra[k] for k in ("latency_bound_ms",
                                              "launch_floor_ms") if k in extra])
        log(f"  {key}: bit-exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {b:.3g} ms ({by})"
            + "".join(f", {k} {extra[k]:.4g}" for k in
                      ("latency_bound_ms", "launch_floor_ms") if k in extra)
            + (f" -> {ms / floor:.2f}x max(bounds)" if floor > b else "")
            + (f", library call {library_ms:.4f} ms" if library_ms else ""))

    def count(self, key, path, n):
        """Record the launches of one run; the first run that reaches a row
        is the one its "launches" and "path" name."""
        row = self.rows[key]
        row["paths"][path] = n
        if row["launches"] is None:
            row["launches"], row["path"] = n, path


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

def check_layout(K):
    """The eleven layout kernels in every case of probes.layout_cases, the
    machine code's account of each, and the row-copy rates."""
    from libsnark_tpu_torch import probes
    log("probe: layout and row-copy kernels (times: device time per call "
        "in a replayed CUDA graph; call: the wrapper in a loop; floor: an "
        "empty kernel launched and replayed the same way)")
    for r in probes.measure_layout():
        log(f"  {'OK  ' if r['exact'] else 'FAIL'} {r['name']}: {r['cases']} "
            f"cases; {r['case']}: {r['ms'] * 1e3:.2f} us "
            f"(call {r['call_ms'] * 1e3:.2f} us, floor "
            f"{r['floor_ms'] * 1e3:.2f} us), {r['bytes']} bytes, "
            f"{r['gb_per_s']:.2f} GB/s")
        K.add(r["name"], f"probe_layout_{r['name']}", 0 if r["exact"] else 1,
              r["ms"], r["plain_ms"], r["bytes"], 0,
              library_ms=r["library_ms"], launch_floor_ms=r["floor_ms"])
    log("probe: where each layout kernel's data went (cuobjdump -sass)")
    for key, ops in probes.sass_memory_ops().items():
        log(f"    {key}: " + ", ".join(f"{n} {opc}" for opc, n in ops.items()))
    log("probe: row_copy over 2^20 rows at bucket_reduce's row widths "
        "(segments of R rows at random offsets; torch: one index_select)")
    rates = []
    for r in probes.measure_row_copy():
        b = r["bytes"] / MEM_BYTES_PER_S * 1e3
        log(f"    {r['width']} words, R={r['R']}: "
            f"{'exact' if r['exact'] else 'FAIL'}, {r['ms']:.4f} ms, "
            f"{r['gb_per_s']:.1f} GB/s ({b / r['ms']:.1%} of the byte bound "
            f"{b:.4f} ms); torch index_select {r['library_ms']:.4f} ms")
        if not r["exact"]:
            raise AssertionError("row_copy differs from its plain version at "
                                 f"{r['width']} words, R={r['R']}")
        rates.append({k: r[k] for k in ("width", "R", "ms", "library_ms",
                                        "gb_per_s")} | {"bound_ms": b})
    K.rows["probe_layout_row_copy"]["row_copy_rates"] = rates


def check_probes(K, fqs):
    """The probes through the functions scripts/probe_h100.py calls; the
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
    log("probe: latency of one dependent product (K chained products over "
        "one element: one thread, or one lane group for 'lanes')")
    for r in probes.measure_product_latency(fqs):
        if not r["exact"]:
            raise AssertionError(f"product latency probe N={r['N']} "
                                 f"{r['variant']} differs from its plain chain")
        ms = r["latency_us"] / 1e3
        PRODUCT_LATENCY_MS[r["N"]] = min(PRODUCT_LATENCY_MS.get(r["N"], ms), ms)
        log(f"    N={r['N']} {r['variant']}: {r['latency_us']:.4f} us a product "
            f"({r['K']} products in {r['ms']:.4f} ms)")
    check_layout(K)
    for key, n in probes.LAUNCHES.items():
        if n == 0:
            raise AssertionError(f"probe kernel not launched: {key}")
        K.count(key, "probe", n)
    log("probe: instructions in each kernel's main loop (cuobjdump -sass)")
    for key, loop in probes.sass_loops().items():
        log(f"    {key}: {sum(loop.values())} instructions: "
            + (", ".join(f"{n} {opc}" for opc, n in loop.items())
               or "no loop"))


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
        # add at the shape of one suffix-scan launch of a 2^20 MSM
        # (W = 18 windows x (B + 1) = 16,385 buckets), planted lanes as above
        L2 = SCAN_LANES
        P2, Q2, _, _, _ = ec_inputs(curve, ck, group, L2, gen, rng)
        err = max_abs_err(cuda_ec.add(fk, P2, Q2), cuda_ec.add_plain(fk, P2, Q2))
        if err:
            raise AssertionError(f"add differs from its plain version at "
                                 f"{L2} lanes ({fk.N} limbs, ext={ext})")
        ms = cuda_ms(lambda: cuda_ec.add(fk, P2, Q2), 10)
        key = cuda_ec.counter_key("add", fk)
        b = work_bound_ms(key, L2)
        K.rows[key].update({"scan_lanes": L2, "scan_ms": ms,
                            "scan_bound_ms": b})
        log(f"  {key} at {L2} lanes: bit-exact; kernel {ms:.4f} ms, bound "
            f"{b:.3g} ms")
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
                seg["seg_count"], seg["seg_order"])
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
                  + args[4].numel() * 8 + 3 * FW * 4 * counts.numel())
        K.add("bucket_reduce", counter_key("bucket_reduce", fk), err, ms, pms,
              nbytes, ops)

        check_horner(curve, ck, group, K, gen, rng, mk.num_windows(
            default_window_bits(1 << 20)), default_window_bits(1 << 20))


def rand_fe(fk, shape, gen):
    """Uniform canonical elements of fk (Fp, or Fp2 as two Fp)."""
    if hasattr(fk, "fp"):
        return torch.stack([rand_field(fk.fp, shape, gen),
                            rand_field(fk.fp, shape, gen)])
    return rand_field(fk, shape, gen)


def horner_windows(group, W: int, c: int, r: int, rng):
    """Planted window sums S_0 .. S_(W-1) for horner_combine, as (label,
    host points): random; an infinity window (in the middle, or S_0 at W =
    2); an infinity top window; S_(W-2) = 2^c S_(W-1), so that the first add
    meets P == Q; S_0 = -(sum of the rest), a result at infinity. W = 1:
    random and infinity."""
    G = group.one()
    rnd = lambda: [G * rng.randrange(1, r) for _ in range(W)]
    if W == 1:
        return [("random", rnd()), ("infinity", [group.zero()])]
    cases = [("random", rnd())]
    pts = rnd()
    pts[W // 2 if W > 2 else 0] = group.zero()
    cases.append(("an infinity window", pts))
    pts = rnd()
    pts[W - 1] = group.zero()
    cases.append(("infinity top window", pts))
    pts = rnd()
    pts[W - 2] = pts[W - 1] * (1 << c)
    cases.append(("P == Q at the first add", pts))
    pts = rnd()
    rest = group.zero()
    for w in range(1, W):
        rest = rest + pts[w] * (1 << (c * w))
    pts[0] = -rest
    cases.append(("result at infinity", pts))
    return cases


def check_horner(curve, ck, group, K, gen, rng, W_path: int, c_path: int):
    """horner_combine at W in {1, 2, W_path} and c in {1, c_path, 16} on the
    planted windows of horner_windows (Jacobian, random Z), bit-exact
    against the plain version run over all cases of a (W, c) at once; the
    result of a random case equals the host's sum and the planted infinity
    result has Z = 0. Then the time at the path's shape (W_path, c_path), with the
    bounds: throughput (bound_ms) and latency (the critical path
    (W - 1)(3 c + 5) times the least product latency)."""
    from libsnark_tpu_torch.ops import cuda_bucket
    from libsnark_tpu_torch.ops.cuda_ec import counter_key, ext_of
    fk = ck.fk
    ext = ext_of(fk)
    FW = ext * fk.N
    one = (2, fk.N, 1) if ext == 2 else (fk.N, 1)       # one point's shape
    key = counter_key("horner_combine", fk)
    timed = None
    for W in (1, 2, W_path):
        for c in (1, c_path, 16):
            cases = horner_windows(group, W, c, curve.r, rng)
            S = []
            for _, pts in cases:
                X, Y, Z = ck.encode_points(pts, device="cuda")
                z = rand_fe(fk, (W,), gen)
                z2 = fk.sqr(z)
                S.append([a.reshape(FW, W) for a in (
                    fk.mul(X, z2), fk.mul(Y, fk.mul(z2, z)), fk.mul(Z, z))])
            batch = tuple(torch.stack([s[i] for s in S], dim=-1)
                          for i in range(3))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cuda_bucket.horner_combine_plain(fk, batch, c)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            for b, (label, pts) in enumerate(cases):
                got = cuda_bucket.horner_combine(fk, S[b], c)
                if max_abs_err(got, [a[:, b:b + 1] for a in want]):
                    raise AssertionError(f"{key} differs from its plain "
                                         f"version: W={W}, c={c}, {label}")
                if label == "result at infinity" and bool(got[2].any()):
                    raise AssertionError(f"{key}: a sum at infinity with Z != 0")
                if label == "random" and (W <= 2 or c == c_path):
                    host = group.zero()
                    for w, P in enumerate(pts):
                        host = host + P * (1 << (c * w))
                    dec = ck.decode_points(
                        tuple(a.reshape(one) for a in got), group)[0]
                    if dec != host:
                        raise AssertionError(f"{key}: W={W}, c={c}: the "
                                             "result is not the host's sum")
                if (W, c, label) == (W_path, c_path, "random"):
                    timed = (S[b], pms, len(cases))
            log(f"  {key}: W={W}, c={c}: {len(cases)} planted cases: "
                "bit-exact")
    Sr, pms, ncase = timed
    ms = cuda_ms(lambda: cuda_bucket.horner_combine(fk, Sr, c_path), 5)
    prods = (W_path - 1) * (c_path * PRODUCTS["dbl"] + PRODUCTS["add"])
    ops = prods * (3 if ext == 2 else 1) * wide_mads(fk)
    lat = latency_bound_ms(key, (W_path - 1) * (3 * c_path + 5))
    log(f"  {key} at W={W_path}, c={c_path}: {ms:.4f} ms; latency bound "
        f"{lat:.4f} ms; plain over {ncase} chains {pms:.1f} ms")
    K.add("horner_combine", key, 0, ms, pms, 4 * 3 * FW * (W_path + 1), ops,
          latency_bound_ms=lat)


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


def main_path(curve, log2: int, paths: dict) -> dict:
    """Keygen, prove (default strategy), prove (dense strategy), verify.
    Counts are set to 0 just before each phase and read just after; returns
    the path's launches per kernel (the three phases added up). Then one
    more default prove under the device profiler (paths["prove_<curve>"])
    and the device time of its G1 and G2 MSMs by part."""
    from libsnark_tpu_torch.ops import launch_counts, reset_launch_counts
    from libsnark_tpu_torch.ops.msm import default_window_bits
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

    timed = path_timing(f"prove_{curve.name}", lambda: g16.prover(
        kp.pk, primary, aux, seed=9), paths)
    if timed != proof:
        raise AssertionError("the profiled proof differs")
    gen = torch.Generator(device="cuda").manual_seed(77)
    c = default_window_bits(kp.pk.r1cs_dev.num_variables + 1)
    for which, q in (("g1", kp.pk.H_query), ("g2", kp.pk.B_query_g2)):
        m = q[0].shape[-1]
        sc = rand_field(g16.fr, (m,), gen)
        msm_breakdown(f"{curve.name} {which}, {m} points, c={c}",
                      lambda which=which, q=q, sc=sc: g16.msm_affine(
                          which, q, sc, c))
        if which == "g1":
            seg = g16.msm_g1.bucket_segments(sc, c)
            counts = seg["seg_count"]
            order = seg.get("seg_order")
            if order is None:
                order = torch.argsort(counts, descending=True, stable=True)
            log(f"  bucket_reduce warp efficiency at {m} points: "
                f"{warp_efficiency(counts):.3f} in bucket order, "
                f"{warp_efficiency(counts[order]):.3f} in length order "
                f"({counts.numel()} segments, {int(counts.sum())} rows)")

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


def seeded_coeffs(r: int, n: int, seed: int) -> list:
    """n seeded integers below r, cut from one seeded byte string 64 bits
    wider than r per integer (fast at 2^22; the reduction is near uniform)."""
    nb = (r.bit_length() + 7) // 8 + 8
    raw = random.Random(seed).randbytes(nb * n)
    return [int.from_bytes(raw[nb * i:nb * (i + 1)], "little") % r
            for i in range(n)]


def kzg_open_and_verify(kzg, srs, coeffs, z, label):
    """commit, open at z and verify; returns (commitment, value, witness).
    A non-constant polynomial must also reject a wrong value and a wrong
    point."""
    r = kzg.curve.r
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    C = kzg.commit(srs, coeffs)
    t1 = time.perf_counter()
    peak_commit = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    v, W = kzg.create_evaluation_witness(srs, coeffs, z)
    t2 = time.perf_counter()
    peak_open = torch.cuda.max_memory_allocated()
    ok = kzg.verify_evaluation(srs, C, z, v, W)
    checks = {"accepted": ok}
    if any(c % r for c in coeffs[1:]):
        checks["wrong-value-rejected"] = not kzg.verify_evaluation(
            srs, C, z, (v + 1) % r, W)
        checks["wrong-point-rejected"] = not kzg.verify_evaluation(
            srs, C, (z + 1) % r, v, W)
    log(f"  {label} ({len(coeffs)} coefficients): commit {t1 - t0:.3f} s "
        f"(peak {peak_commit / 2**30:.2f} GiB), open {t2 - t1:.3f} s "
        f"(peak {peak_open / 2**30:.2f} GiB), verify "
        f"{time.perf_counter() - t2:.2f} s (host): "
        + " ".join(f"{k}={v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"KZG10 checks failed ({label}): {checks}")
    return C, v, W


def kzg_batched_and_bdfg21(kzg, srs, log2: int):
    """The batched two-point opening and the BDFG21 opening of a few
    seeded polynomials of degree 2^log2 - 1: accepted, and rejected after
    one evaluation is changed."""
    from libsnark_tpu_torch.polynomial_commitments.bdfg21 import BDFG21
    from libsnark_tpu_torch.polynomial_commitments.kzg10_batched import (
        KZG10Batched2Point)
    r = kzg.curve.r
    n = 1 << log2
    rng = random.Random(77)
    polys = [seeded_coeffs(r, n - k, 30 + k) for k in range(5)]
    z_1, z_2, gamma_1, gamma_2, r_rand = (rng.randrange(1, r)
                                          for _ in range(5))
    t0 = time.perf_counter()
    fs, gs = polys[:3], polys[3:]
    batched = KZG10Batched2Point(kzg)
    evals = batched.evaluate_polynomials(fs, gs, z_1, z_2)
    cm_1s = [kzg.commit(srs, f) for f in fs]
    cm_2s = [kzg.commit(srs, g) for g in gs]
    wit = batched.create_evaluation_witness(fs, gs, z_1, z_2, evals, srs,
                                            gamma_1, gamma_2)
    ok = batched.verify_evaluations(z_1, z_2, evals, srs, gamma_1, gamma_2,
                                    wit, cm_1s, cm_2s, r_rand)
    bad = type(evals)(s_1s=[(evals.s_1s[0] + 1) % r] + evals.s_1s[1:],
                      s_2s=evals.s_2s)
    rej = not batched.verify_evaluations(z_1, z_2, bad, srs, gamma_1, gamma_2,
                                         wit, cm_1s, cm_2s, r_rand)
    log(f"  batched two-point opening, 3 + 2 polynomials of degree "
        f"2^{log2} - 1: {time.perf_counter() - t0:.2f} s, accepted={ok} "
        f"tampered-rejected={rej}")
    if not (ok and rej):
        raise AssertionError("batched KZG10 checks failed")

    t0 = time.perf_counter()
    f_sets, cm_sets = [fs, gs], [cm_1s, cm_2s]
    T = [z_1, z_2]
    gamma, z = gamma_1, rng.randrange(1, r)
    b = BDFG21(kzg)
    ev = b.evaluate_polynomials(f_sets, T)
    ph1 = b.create_evaluation_witness_phase_1(f_sets, T, ev, srs, gamma)
    w = b.create_evaluation_witness(f_sets, T, ev, srs, gamma, ph1, z)
    ok = b.verify_evaluations(T, ev, srs, gamma, z, w, cm_sets)
    bad = [list(e) for e in ev]
    bad[1][0] = (bad[1][0] + 1) % r
    rej = not b.verify_evaluations(T, bad, srs, gamma, z, w, cm_sets)
    log(f"  BDFG21 opening of the same sets: {time.perf_counter() - t0:.2f} "
        f"s, accepted={ok} tampered-rejected={rej}")
    if not (ok and rej):
        raise AssertionError("BDFG21 checks failed")


def kzg_path(curve, log2: int, small_log2=None, paths=None) -> dict:
    """KZG10 through its entry points at degree 2^log2 - 1. Counts are set
    to 0 just before setup and read just after the first polynomial's
    opening: the path's launches per kernel. small_log2: also run the
    batched and BDFG21 openings at that degree. paths: also commit and
    open that polynomial once more under the device profiler
    (paths["kzg_<curve>"])."""
    from libsnark_tpu_torch.ops import launch_counts, reset_launch_counts
    from libsnark_tpu_torch.polynomial_commitments.kzg10 import KZG10
    from libsnark_tpu_torch.profiling import PROFILER, start_profiling
    r = curve.r
    n = 1 << log2
    log(f"KZG path {curve.name}: degree 2^{log2} - 1")
    kzg = KZG10(curve)                                     # device="cuda"
    rng = random.Random(21)
    t0 = time.perf_counter()
    coeffs = seeded_coeffs(r, n, 20)
    log(f"  {n} seeded coefficients: {time.perf_counter() - t0:.2f} s (host)")

    start_profiling()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    srs = kzg.setup(n - 1, seed=3)
    torch.cuda.synchronize()
    log(f"  setup {time.perf_counter() - t0:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the SRS "
        f"holds {sum(a.numel() * a.element_size() for a in srs.alpha_powers_g1) / 2**20:.0f} MiB on the card")
    C, _, _ = kzg_open_and_verify(kzg, srs, coeffs, rng.randrange(r),
                                  "random polynomial")
    counts = {k: v for k, v in launch_counts().items() if v}
    PROFILER.enabled = False
    log("  phases (s, each ended by a device synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in PROFILER.totals.items()))
    log("  launches " + json.dumps(counts))
    nq = kzg.fq.N
    path = [f"mont_mul_n{nq}", f"mont_mul_n{kzg.fr.N}"] + [
        f"{k}_fp_n{nq}" for k in ("dbl", "add", "madd", "bucket_reduce",
                                  "horner_combine")]
    missing = [k for k in path if not counts.get(k)]
    if missing:
        raise AssertionError(f"kernels not launched on the {curve.name} KZG "
                             f"path: {missing}")
    if paths is not None:
        z = rng.randrange(r)
        path_timing(f"kzg_{curve.name}", lambda: (
            kzg.commit(srs, coeffs),
            kzg.create_evaluation_witness(srs, coeffs, z)), paths)

    t0 = time.perf_counter()
    changed = [(coeffs[0] + 1) % r] + coeffs[1:]
    ok = kzg.verify_poly(srs, C, coeffs)
    rej = not kzg.verify_poly(srs, C, changed)
    log(f"  verify_poly {time.perf_counter() - t0:.2f} s: accepted={ok} "
        f"changed-coefficient-rejected={rej}")
    if not (ok and rej):
        raise AssertionError("KZG10 verify_poly checks failed")

    # what a Groth16 witness never showed the MSM
    k = min(1000, n // 4)
    sparse = coeffs[:k] + [0] * (n - 2 * k) + coeffs[:k]
    for label, cs in (("all-equal coefficients", [coeffs[0]] * n),
                      ("mostly-zero coefficients", sparse),
                      ("zero polynomial", [0] * n),
                      ("short polynomial under the long SRS",
                       coeffs[:max(2, n // 1000)])):
        kzg_open_and_verify(kzg, srs, cs, rng.randrange(r), label)

    m = min(n, 1 << 16)
    dense = KZG10(curve, msm_strategy="dense")
    t0 = time.perf_counter()
    same = dense.commit(srs, coeffs[:m]).point == kzg.commit(srs,
                                                             coeffs[:m]).point
    log(f"  commitment of 2^{m.bit_length() - 1} coefficients under the dense "
        f"strategy == the default strategy's: {same} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not same:
        raise AssertionError("the dense strategy's commitment differs")
    if small_log2 is not None:
        kzg_batched_and_bdfg21(kzg, srs, min(small_log2, log2))
    return counts


# ------------------------------------------------------- device time by kernel

# profiler kernel names (demangled or mangled) -> launch-counter families
_KERNEL_NAME = re.compile(r"(?:^|[\s:]|_Z\d+)([a-z_]+)_kernel(?:<(\d+)(?:, (\d+))?"
                          r"(?:, \d+)*>|ILi(\d+)E(?:Li(\d+)E)?)")
_FAMILY = {"mont_mul": "mont_mul", "dbl": "dbl", "add": "add", "madd": "madd",
           "aadd": "aadd", "bucket_reduce": "bucket_reduce",
           "horner": "horner_combine"}


def kernel_key(name: str):
    """The launch-counter key of a path kernel's profiler name, else None."""
    m = _KERNEL_NAME.search(name)
    if not m or m.group(1) not in _FAMILY:
        return None
    fam = _FAMILY[m.group(1)]
    nw = int(m.group(2) or m.group(4))
    if fam == "mont_mul":
        return f"mont_mul_n{2 * nw}"
    ext = int(m.group(3) or m.group(5))
    return f"{fam}_{'fp2' if ext == 2 else 'fp'}_n{2 * nw}"


def unit_cost(key: str):
    """(bytes, wide multiply-adds) of one unit of a wrapper's work count:
    a lane (mont_mul: one product; dbl: one doubling), a bucket_reduce
    madd row (a packed row and its index), a horner_combine product."""
    fam, f, n = re.match(r"(.+?)_(?:(fp2?)_)?n(\d+)$", key).groups()
    N = int(n)
    wm = 2 * (N // 2) ** 2 + N // 2
    e = 2 if f == "fp2" else 1
    FW, per = e * N, (3 if e == 2 else 1)
    if fam == "mont_mul":
        return 12 * N, wm
    if fam == "bucket_reduce":
        return 4 * FW + 4, PRODUCTS["madd"] * per * wm
    if fam == "horner_combine":      # throughput; latency: latency_bound_ms
        return 0, per * wm
    nfield = {"dbl": 6, "add": 9, "madd": 8, "aadd": 7}[fam]
    return (nfield * FW * 4 + (2 if fam in ("madd", "aadd") else 0),
            PRODUCTS[fam] * per * wm)


def work_bound_ms(key: str, work: int) -> float:
    """Least device time of ``work`` units: every launch's bound is linear
    in its work, so the sum over launches is that of the total."""
    nbytes, ops = unit_cost(key)
    return bound_ms(nbytes * work, ops * work)[0]


def latency_bound_ms(key: str, depth: int) -> float:
    """Least time of a chain of ``depth`` dependent base-field products at
    the key's width: depth times the least product latency measured in this
    run (0 for a kernel that is no chain)."""
    n = int(key.rsplit("_n", 1)[1])
    return depth * PRODUCT_LATENCY_MS.get(n, 0.0)


def device_profile(fn):
    """fn() under torch.profiler (CUDA activity), ended by a synchronize.
    Returns (result, {kernel name: [launches, device ms]}, device busy ms,
    wall ms). Raises if the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        row = per.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += us / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        raise AssertionError("torch.profiler recorded no device activity")
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return out, per, busy / 1e3, wall


def profiled_rows(fn):
    """fn() under the device profiler, with the counts set to 0 just before:
    (result, {path kernel key: row}, busy ms, wall ms, the keys whose
    profiled kernels differ in number from the wrappers' launches)."""
    from libsnark_tpu_torch.ops import (depth_counts, launch_counts,
                                        reset_launch_counts, work_counts)
    reset_launch_counts()
    out, per, busy, wall = device_profile(fn)
    launches, work, depth = launch_counts(), work_counts(), depth_counts()
    rows = {}
    for name, (n, ms) in per.items():
        key = kernel_key(name)
        if key is None:
            continue
        r = rows.setdefault(key, {"launches": launches[key], "profiled": 0,
                                  "ms": 0.0, "work": work[key]})
        r["profiled"] += n
        r["ms"] += ms
    for key, r in rows.items():
        # horner_combine: the larger of its throughput and latency bounds
        r["throughput_bound_ms"] = work_bound_ms(key, r["work"])
        r["latency_bound_ms"] = latency_bound_ms(key, depth.get(key, 0))
        r["bound_ms"] = max(r["throughput_bound_ms"], r["latency_bound_ms"])
    differ = {k: (r["profiled"], r["launches"]) for k, r in rows.items()
              if r["profiled"] != r["launches"]}
    differ.update({k: (0, n) for k, n in launches.items()
                   if n and k not in rows})
    return out, rows, busy, wall, differ


def path_timing(label: str, fn, paths: dict):
    """fn() as one measured path: the device time of each path kernel
    (profiler, summed by __global__ name), its launches (the wrappers'
    counts, checked against the profiler's), its work and the bound of that
    work; device busy time and wall time. Stored in paths[label]. The
    profiler has recorded one kernel fewer than the wrapper launched (one
    of a BLS12-377 prove's 74 mont_mul_n16 launches, on an H100, in a run
    whose every other count agreed); a path whose counts differ is
    profiled once more, and it fails if they differ again."""
    out, rows, busy, wall, differ = profiled_rows(fn)
    if differ:
        log(f"  path {label}: profiled / launched differ {differ}; "
            "profiling the path once more")
        out, rows, busy, wall, differ = profiled_rows(fn)
    if differ:
        raise AssertionError(f"{label}: profiled kernels / wrapper launches "
                             f"differ twice: {differ}")
    kern = sum(r["ms"] for r in rows.values())
    paths[label] = {"kernels": rows, "busy_ms": busy, "wall_ms": wall}
    log(f"  path {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1 - busy / wall:.3f}), hand-written kernels "
        f"{kern:.1f} ms:")
    for key, r in sorted(rows.items(), key=lambda kv: -kv[1]["ms"]):
        log(f"    {key}: {r['launches']} launches, {r['ms']:.3f} ms, work "
            f"{r['work']}, bound {r['bound_ms']:.3f} ms"
            + (f" (latency {r['latency_bound_ms']:.3f}, throughput "
               f"{r['throughput_bound_ms']:.3g})" if r["latency_bound_ms"]
               else ""))
    return out


def msm_breakdown(label: str, fn):
    """Device time of one MSM by part: the sort, bucket_reduce, add,
    horner_combine and the rest (digits, bounds, gathers, to_affine's
    products, copies)."""
    out, per, busy, wall = device_profile(fn)
    parts = dict.fromkeys(("sort", "bucket_reduce", "add", "horner_combine",
                           "rest"), 0.0)
    for name, (_, ms) in per.items():
        key = kernel_key(name)
        fam = key and key.split("_fp")[0]
        if fam in parts:
            parts[fam] += ms
        elif "sort" in name.lower():
            parts["sort"] += ms
        else:
            parts["rest"] += ms
    log(f"  MSM breakdown {label}: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
        + " ms")
    return out


def warp_efficiency(counts) -> float:
    """sum(counts) / (32 * sum over warps of the warp's longest count): the
    share of a warp's madd steps that do work when consecutive threads take
    consecutive entries."""
    c = counts.to(torch.int64)
    c = torch.cat([c, c.new_zeros((-c.numel()) % 32)]).reshape(-1, 32)
    return float(c.sum()) / max(1, 32 * int(c.max(dim=1).values.sum()))


def redesign_ranking(K, paths: dict):
    """Rows 1-7 by device time - bound over the measured paths (one default
    prove per curve, the KZG commit and opening at full degree), each
    kernel's time and bound those of its launches there (horner_combine:
    the larger of its throughput and latency bounds)."""
    family = {}
    for label, p in paths.items():
        for key, r in p["kernels"].items():
            fam = key.split("_fp")[0].split("_n")[0]
            f = family.setdefault(fam, {"excess": 0.0, "ms": 0.0,
                                        "bound": 0.0, "launches": 0})
            f["excess"] += r["ms"] - r["bound_ms"]
            f["ms"] += r["ms"]
            f["bound"] += r["bound_ms"]
            f["launches"] += r["launches"]
            row = K.rows.get(key)
            if row is not None:
                row["path_ms"][label] = r["ms"]
                row["path_bound_ms"][label] = r["bound_ms"]
    log("kernels by device time - bound over the measured paths ("
        + ", ".join(paths) + "), ms:")
    for fam, f in sorted(family.items(), key=lambda kv: -kv[1]["excess"]):
        log(f"  {fam}: {f['excess']:.1f} = {f['ms']:.1f} - {f['bound']:.1f} "
            f"({f['launches']} launches)")


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
    ap.add_argument("--kzg-log2", type=int, default=22,
                    help="KZG10 over BLS12-377: degree 2^k - 1 (22); over "
                         "alt_bn128 the degree is 2^min(k, 20) - 1")
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
    for line in cuda_lib.ptxas_summary():
        log(f"  {line}")

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
    paths = {}
    for name, log2 in curves.items():
        counts = main_path(get_curve(name), log2, paths)
        for key, n in counts.items():
            # Fr is 16 limbs on both curves: mont_mul_n16 keeps the count of
            # the alt_bn128 path, where Fq and Fr both run through it
            K.count(key, name, n)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
    for name, log2, small in (("bls12_377", args.kzg_log2, None),
                              ("alt_bn128", min(args.kzg_log2, 20), 12)):
        measured = paths if name == "bls12_377" else None
        for key, n in kzg_path(get_curve(name), log2, small,
                               measured).items():
            K.count(key, f"kzg_{name}", n)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
    unread = [k for k, row in K.rows.items() if row["launches"] is None]
    if unread:
        raise AssertionError(f"kernels with no main-path count: {unread}")
    redesign_ranking(K, paths)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(K.rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
