#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (libsnark_tpu_torch) on one NVIDIA card.

1. Prints the card (torch.cuda.get_device_name and nvidia-smi's name and
   power limit).
2. Builds the CUDA kernels from libsnark_tpu_torch/csrc (nvcc, sm_90a, one
   process per source, both field widths in each) and prints ptxas's
   registers, stack frames and spills per kernel and width.
3. Runs the probes, each exact against its plain version: the 32-bit
   operation rates (each with its bound from the instructions its step
   needs, and beside it the time of the instructions a step of its main
   loop holds, cuobjdump -sass, IMAD.WIDE counted as one lane instruction
   and as two; mad_wide's loop must be one IMAD.WIDE.U32 a step and
   nothing else) and the Montgomery-product bodies at 16 and 24
   limbs, with the instructions of each kernel's main loop; and
   the eleven layout and row-copy kernels in every case of
   probes.layout_cases (the TPU scripts' shapes, odd offsets, shifts
   outside [0, axis), tiles with no word above 7, trip counts 1..6), with
   where each kernel's data went (shared, local memory, barriers, 16-byte
   accesses; cond_kernel must move 16-byte pieces), an
   empty kernel's time as the launch floor, and the row-copy rates at the
   row widths bucket_reduce gathers beside one index_select; and the latency
   of one dependent product (one thread, one lane group).
4. For alt_bn128 (16-limb Fq) and BLS12-377 (24-limb Fq), G1 and G2,
   holds every kernel against its plain PyTorch version on the card at
   main-path shapes, bit-exact (tolerance 0): mont_mul at 2^20 lanes;
   dbl / add / madd / aadd at 2^16 lanes with planted infinity, P == Q
   and P == -Q lanes, add also at 294,930 lanes (one suffix-scan launch of
   a 2^20-point MSM), timed in a replayed CUDA graph (the wrapper called
   in a loop takes longer on the host than the kernel on the card); bucket_reduce on the packed rows and length-ordered
   segments of a 2^16-point MSM with all-equal points in one bucket;
   horner_combine at W in {1, 2, 18} windows and c in {1, 15, 16} on
   planted window sums (an infinity window, an infinity top window, a
   first add that meets P == Q, a sum at infinity),
   timed at the path's 18 windows of c = 15 beside its latency bound (the
   critical path (W - 1)(3 c + 5) times the least product latency that the
   probes measured); madd_win (the fixed-base scan in one launch) at the
   keygen's 2^20 lanes on its table, c = 8 (32 windows), with planted
   scalars, against its plain version and the per-window madd kernel loop
   it replaced, timed beside that loop; dbl_chain (a window table's bases
   in one block) at the keygen's W = 32, c = 8 against its plain version
   and the per-window dbl_n loop it replaced, timed beside that loop and
   its latency bound (3 c (W - 1) dependent products); aadd_rows (the
   dense MSM's level 0 from the packed row table) on one dense chunk of a
   2^20-point MSM (c = 15, the full windows at the chunk depth the dense
   strategy picks), against its plain version (window by window) and the
   gathered form it replaced (row gather, limb split, infinity mask, the
   aadd kernel), each timed in a replayed CUDA graph and between CUDA
   events; host encoding of 2^20 values, the
   Python Montgomery form against FpKernel.encode (mont_mul on the card);
   ints_to_limbs and limbs_to_ints of 2^20 values at 16 and 24 limbs
   through the native codec against their Python forms;
   and the dense strategy's window sums against the default strategy's on
   a 2^16-point MSM, with random scalars and with 4096 all-equal scalars
   (the chunk loop). Times each (CUDA events).
5. Cross-checks a 20-constraint seeded proof made on the card with the
   same proof made by the plain versions on the CPU, for Groth16, BCTV14,
   GM17, DFGK14, BACS (19 gates and an output: 20 constraints) and TBCS (8
   gates: 19 constraints); the CPU proofs run in worker processes, all at
   once, beside the card's. Each card proof must verify; BCTV14's, GM17's
   and DFGK14's with one point moved must not.
6. Runs seeded Groth16 generator -> prover -> verifier through the entry
   points: over alt_bn128 and over BLS12-377, both at 2^20 constraints
   (generate_r1cs_example(r, 2^k - 3, 2), generator(seed=5) on the device
   fixed-base path, prover(seed=9)), each proved with the default and with
   the dense MSM strategy. The two proofs must be equal, the proof must
   verify, and a corrupted proof and a wrong input must be rejected. Every
   kernel of a path must have launched in it; aadd_rows must launch under
   the dense strategy and never under the default one, and neither the
   public dbl nor the public aadd may launch. Then one more default
   prove under torch.profiler (CUDA activity): each hand-written kernel's
   device time summed by __global__ name, its launches (checked against
   the wrappers' counters), its work (the wrappers' WORK counters) and the
   bound of that work, device busy time and idle share; the same for the
   keygen (profiled as it runs, with the parts of its fixed-base phase:
   host encoding, window table, batch exp, to_affine) and for one more
   dense prove, and that dense prove once more with its level 0 in the
   gathered form (the yardstick: its device time, peak memory and the
   public aadd's launches); the five largest device operations of each
   profiled path that are no hand-written kernel; over BLS12-377 one more
   default prove under torch.profiler with each torch call labelled by the
   port functions on its Python stack (PortCallers), the device time of
   torch's own operations grouped by the function of the port that issued
   them (caller_split); four more default proves with the prove's limbs
   packed by the Python form and by the native codec in turns, each
   proof equal (prove_encode_in_turns); the keygen's window
   tables once more with their bases by the per-window dbl_n loop and by
   dbl_chain (equal tables; the public dbl's launches); the device time of
   a 2^20-point G1 and G2 MSM split into
   sort, bucket_reduce, add, horner_combine and the rest, with
   bucket_reduce's warp efficiency in bucket order and in length order;
   and the keygen's five fixed-base queries again with the per-window madd
   loop (before madd_windows) and with madd_windows: equal points, the
   parts of the phase and the madd family's device time (CUDA events
   around each call) - bound of each.
6b. Runs BCTV14, GM17 and DFGK14 over alt_bn128 through their entry
   points, each witness map on a domain of 2^20: BCTV14 on
   generate_r1cs_example(r, 2^20 - 3, 2) (QAP), GM17 on
   generate_r1cs_example(r, 2^19 - 3, 2) (SAP, 2n + 2k + 1 = 2^20 - 1 rows),
   DFGK14 on generate_uscs_example(r, 2^20, 2) (SSP). Each: a seeded keygen
   (device fixed-base path) under torch.profiler with its phases, one
   prove with its phases and one more under the profiler (the proofs must
   be equal), peak device memory, verify accepted and a wrong input
   rejected; mont_mul, dbl_chain, madd_win, add, bucket_reduce and
   horner_combine (G1 and G2) must each have launched on the path. Then
   BACS and TBCS round trips at 2^12 gates.
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
   of degree 2^12 - 1, each accepted and rejected after tampering; the
   2^22 commit and opening once more under caller_split. Every
   G1 kernel of the path must have launched in it, and the public dbl
   never. Over BLS12-377 the
   setup runs under the profiler, the random polynomial is committed and
   opened once more under it, as the provers above, and the setup's batch
   exp at 2^22 lanes is timed (CUDA events) as the per-window madd loop
   and as madd_windows (equal limbs).
8. Ranks the kernels by device time - bound over the profiled paths
   (keygen, default and dense prove of each curve; KZG setup and commit +
   opening at 2^22): the order of the redesign PRs.

Prints the kernel table as one JSON line, the card line, and last the
line {"ok": true, "device": {...}}. Each row of the table names in "path"
the run its "launches" were counted in: the alt_bn128 or the bls12_377
Groth16 path (keygen + both proves), "<system>_alt_bn128" (the BCTV14,
GM17 and DFGK14 paths: keygen + prove), "fixed_base_loop_<curve>" (the
single-launch madd: the keygen's fixed base as the per-window loop),
"window_table_loop_<curve>" (the public dbl: the keygen's window tables
with their bases by the per-window dbl_n loop),
"prove_dense_gathered_<curve>" (the public aadd: a dense prove with level
0 in the gathered form), or
"probe" (the kernels that ran in
one probes.measure_rates / measure_cios / measure_layout /
measure_row_copy: every case once, the timing loops, and the replays of
the CUDA graphs the layout kernels are timed in); "paths" holds the
row's launches in every path that ran it, the KZG paths (kzg_bls12_377,
kzg_alt_bn128: setup + commit + opening) among them; "path_ms" and
"path_bound_ms" the device time and bound of its launches in each
profiled path (keygen_<curve>, prove_<curve>, prove_dense_<curve>,
keygen_<system>_alt_bn128, prove_<system>_alt_bn128, kzg_setup_bls12_377,
kzg_bls12_377). Any failed check raises: exit
code 1.

    python3 chip_smoke.py                     # needs one CUDA card
    python3 chip_smoke.py --log2 14 --bn-log2 12 --systems-log2 14 --kzg-log2 14
                                              # small sizes
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import random
import re
import subprocess
import sys
import time

import torch
from torch.overrides import TorchFunctionMode

# H100 SXM peaks. Memory: 3.35 TB/s HBM3 (NVIDIA data sheet). The data
# sheet lists no integer rate. INT32_LANE_OPS_PER_S is one 32-bit integer
# instruction per lane and clock (64 lanes x 132 SMs x 1.98 GHz = 67e12 / 4,
# the FP32 figure over the INT32 lanes); scripts/probe_h100.py measures
# mul.lo and mad.lo at 94-96 % of it on an NVIDIA H100 80GB HBM3 at 700 W.
# INT32_OPS_PER_S, the peak that the kernels' operation bounds use, is half
# of that: a 32x32->64-bit multiply-add (IMAD.WIDE.U32, what the field
# products are made of) takes two issue slots. Measured: the mad_wide
# probe, whose main loop is one IMAD.WIDE.U32 a step with its 64-bit
# addend inside and nothing else (checked below), runs at 7.73e12 to
# 7.78e12 steps per second (0.92-0.93 of this constant), and one row of the
# carry-chain product (mad_cc, IMAD.WIDE.U32.X) at 8.25e12 to 8.32e12, on an
# NVIDIA H100 80GB HBM3 at 700 W (scripts/probe_h100.py; this script
# measures both again and prints them).
MEM_BYTES_PER_S = 3.35e12
INT32_LANE_OPS_PER_S = 67e12 / 4
INT32_OPS_PER_S = INT32_LANE_OPS_PER_S / 2
# an f32 multiply (67 TFLOP/s counts a fused multiply-add as two)
F32_MUL_PER_S = 67e12 / 2
# lane instructions an IMAD.WIDE takes under INT32_OPS_PER_S
WIDE_SLOTS = INT32_LANE_OPS_PER_S / INT32_OPS_PER_S
# the instructions one step of each rate probe needs, whatever else the
# toolchain puts beside them: its bound (add64: two steps in one IADD3 and
# one IADD3.X, a three-input add taking two addends at once)
RATE_STEP = {"mul_lo": {"IMAD": 1}, "mad_lo": {"IMAD": 1},
             "mad_hi": {"IMAD.HI.U32": 1},
             "mad_wide": {"IMAD.WIDE.U32": 1},
             "add64": {"IADD3": 0.5, "IADD3.X": 0.5},
             "shift_and": {"SHF.R.U32.HI": 1, "LOP3.LUT": 1},
             "mul_f32": {"FMUL": 1},
             "mad_wide_split": {"IMAD.WIDE.U32": 1},
             "mad_cc": {"IMAD.WIDE.U32.X": 1}}
# base-field products a lane (aadd_rows: an output lane; dbl_chain: a doubling)
PRODUCTS = {"aadd": 6, "dbl": 7, "madd": 11, "add": 16, "aadd_rows": 6,
            "dbl_chain": 7}
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
    # the fixed-base scan of the JAX batch_exp (libsnark_tpu/ops/msm.py:
    # 946-983), this Pallas kernel once a window
    "madd_win": "libsnark_tpu/ops/pallas_ec.py:255",
    "add": "libsnark_tpu/ops/pallas_ec.py:290",
    "aadd": "libsnark_tpu/ops/pallas_ec.py:322",
    # level 0 of the JAX window_sums_dense (libsnark_tpu/ops/msm.py:476-493):
    # a row gather and this Pallas kernel
    "aadd_rows": "libsnark_tpu/ops/pallas_ec.py:322",
    # the bases scan of the JAX window_table (libsnark_tpu/ops/msm.py:
    # 914-920): this Pallas kernel once a window
    "dbl_chain": "libsnark_tpu/ops/pallas_ec.py:355",
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
    "madd_win": "libsnark_tpu_torch/csrc/ec.cu",
    "add": "libsnark_tpu_torch/csrc/ec.cu",
    "aadd": "libsnark_tpu_torch/csrc/ec.cu",
    "aadd_rows": "libsnark_tpu_torch/csrc/ec.cu",
    "dbl_chain": "libsnark_tpu_torch/csrc/bucket.cu",
    "bucket_reduce": "libsnark_tpu_torch/csrc/bucket.cu",
    "horner_combine": "libsnark_tpu_torch/csrc/bucket.cu",
    "probe_rate": "libsnark_tpu_torch/csrc/probe.cu",
    "probe_cios": "libsnark_tpu_torch/csrc/probe.cu",
}
SOURCE.update({name: "libsnark_tpu_torch/csrc/probe_layout.cu"
               for name in TPU_KERNEL if name not in SOURCE})


def log(*a):
    print(*a, flush=True)


def rate_bound_ms(per_step: dict, steps: int, wide: float) -> float:
    """Least time of ``steps`` steps of a rate probe of ``per_step``
    instructions (opcode -> count) a step: each at the lane rate (an f32
    one at the f32 rate), an IMAD.WIDE as ``wide`` of them."""
    lane = sum(n * (wide if opc.startswith("IMAD.WIDE") else 1)
               for opc, n in per_step.items() if not opc.startswith("F"))
    f32 = sum(n for opc, n in per_step.items() if opc.startswith("F"))
    return steps * (lane / INT32_LANE_OPS_PER_S + f32 / F32_MUL_PER_S) * 1e3


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
    log("probe: where each layout kernel's data went (cuobjdump -sass; "
        ".128: 16-byte accesses)")
    for key, ops in probes.sass_memory_ops().items():
        log(f"    {key}: " + ", ".join(f"{n} {opc}" for opc, n in ops.items()))
        if key == "probe_layout_cond" and not (ops.get("LDG.128")
                                               and ops.get("STG.128")):
            raise AssertionError("cond_kernel has no 16-byte loads and "
                                 f"stores: {ops}")
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
    loops = probes.sass_loops()
    steps_of = {k: probes.loop_counts(loop, control=False)
                for k, loop in loops.items()}
    if not probes.single_wide_mad_loop(steps_of["probe_rate_mad_wide"]):
        raise AssertionError(
            "the mad_wide loop is not one IMAD.WIDE.U32 a step and nothing "
            f"else: {steps_of['probe_rate_mad_wide']}")
    per_pass = probes.CHAINS * probes.RATE_UNROLL
    log("probe: 32-bit operation rates (8 chains x 270336 threads x 4096 "
        "steps); bound: the instructions a step needs (RATE_STEP) at the "
        "lane rate, an IMAD.WIDE at INT32_OPS_PER_S; beside it the "
        "instructions a step of the main loop holds (its control left out) "
        "at the lane rate, IMAD.WIDE as one instruction and as two")
    for r in probes.measure_rates():
        key = f"probe_rate_{r['op']}"
        listing = {opc: n / per_pass for opc, n in steps_of[key].items()}
        b = rate_bound_ms(RATE_STEP[r["op"]], r["steps"], WIDE_SLOTS)
        one, two = (rate_bound_ms(listing, r["steps"], w)
                    for w in (1, WIDE_SLOTS))
        K.add("probe_rate", key, 0 if r["exact"] else 1, r["ms"],
              r["plain_ms"], 12 * r["steps"] / r["K"],
              b * 1e-3 * INT32_LANE_OPS_PER_S, INT32_LANE_OPS_PER_S,
              gsteps_per_s=r["gsteps_per_s"], step_needs=RATE_STEP[r["op"]],
              step_listing=listing, listing_ms_wide_as_one=one,
              listing_ms_wide_as_two=two)
        log(f"    {r['op']}: {r['gsteps_per_s']:.1f} G steps/s; bound "
            f"{b:.4f} ms ({b / r['ms']:.1%}) from "
            + " + ".join(f"{n:g} {opc}" for opc, n in RATE_STEP[r["op"]].items())
            + f" a step; the listing's {sum(listing.values()):.3f} "
            "instructions a step ("
            + ", ".join(f"{n:g} {opc}" for opc, n in listing.items())
            + f") at the lane rate {one:.4f} ms (IMAD.WIDE as one: "
            f"{one / r['ms']:.1%}), {two:.4f} ms (as two: {two / r['ms']:.1%})")
        if r["op"] in ("mad_wide", "mad_cc"):
            log(f"    {r['op']}: one wide multiply-add a step, measured "
                f"{r['gsteps_per_s'] / 1e3:.4f}e12/s = "
                f"{r['gsteps_per_s'] * 1e9 / INT32_OPS_PER_S:.3f} x "
                f"INT32_OPS_PER_S ({INT32_OPS_PER_S:.4g})")
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
    for key, loop in loops.items():
        log(f"    {key}: {len(loop)} instructions: "
            + (", ".join(f"{n} {opc}" for opc, n in
                         probes.loop_counts(loop).items()) or "no loop"))


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
    """Group ops at 2^16 lanes (add also at SCAN_LANES), each timed in a
    replayed CUDA graph (probes._graph_ms): at that size the wrapper takes
    longer on the host to launch than the kernel on the card."""
    from libsnark_tpu_torch import probes
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
            ms = probes._graph_ms(kern, 20)
            call_ms = cuda_ms(kern, 20)
            pms = cuda_ms(plain, 1)
            ops = PRODUCTS[name] * (3 if ext == 2 else 1) * wide_mads(fk) * L
            nbytes = nfield * FW * 4 * L + (2 * L if name in ("madd", "aadd")
                                            else 0)
            K.add(name, cuda_ec.counter_key(name, fk), err, ms, pms, nbytes,
                  ops, call_ms=call_ms)
            log(f"    (the wrapper called in a loop: {call_ms:.4f} ms a call)")
        # add at the shape of one suffix-scan launch of a 2^20 MSM
        # (W = 18 windows x (B + 1) = 16,385 buckets), planted lanes as above
        L2 = SCAN_LANES
        P2, Q2, _, _, _ = ec_inputs(curve, ck, group, L2, gen, rng)
        err = max_abs_err(cuda_ec.add(fk, P2, Q2), cuda_ec.add_plain(fk, P2, Q2))
        if err:
            raise AssertionError(f"add differs from its plain version at "
                                 f"{L2} lanes ({fk.N} limbs, ext={ext})")
        ms = probes._graph_ms(lambda: cuda_ec.add(fk, P2, Q2), 10)
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


def check_dbl_chain(curve, g16, K, rng):
    """dbl_chain at the keygen's window table (W = 32 windows of c = 8) on
    a random point of each group: bit-exact against its plain version (run
    on a CPU copy of the point: one lane's 248 doublings of small torch ops
    take 3-12 s on the card, a fraction of that on the host) and the
    per-window dbl_n loop it replaced (31 single-lane launches), both
    timed in a replayed CUDA graph, beside the latency bound of its 3 c (W
    - 1) dependent product levels at the least product latency measured
    in this run."""
    from libsnark_tpu_torch import probes
    from libsnark_tpu_torch.ops import cuda_bucket
    c, W = 8, 32
    for ck, mk, group, ext in groups_of(curve, g16):
        fk = mk.fk
        FW = ext * fk.N
        key = cuda_bucket.counter_key("dbl_chain", fk)
        P = ck.encode_points([group.one() * rng.randrange(1, curve.r)],
                             device="cuda")
        kern = lambda: cuda_bucket.dbl_chain(fk, P, c, W)
        loop = lambda: mk.window_bases_loop(P, c, W)
        got = kern()
        t0 = time.perf_counter()
        plain = cuda_bucket.dbl_chain_plain(fk, tuple(a.cpu() for a in P), c,
                                            W)
        pms = (time.perf_counter() - t0) * 1e3           # one call, host
        err = max(max_abs_err([a.cpu() for a in got], plain),
                  max_abs_err(got, loop()))
        ms = probes._graph_ms(kern, 10)
        loop_ms = probes._graph_ms(loop, 10)
        dbls = c * (W - 1)
        ops = dbls * PRODUCTS["dbl"] * (3 if ext == 2 else 1) * wide_mads(fk)
        lat = latency_bound_ms(key, 3 * dbls)
        log(f"dbl_chain: W={W}, c={c}, ext={ext}, N={fk.N}: {dbls} doublings; "
            f"per-window dbl_n loop {loop_ms:.4f} ms")
        K.add("dbl_chain", key, err, ms, pms, 4 * 3 * FW * (W + 1), ops,
              latency_bound_ms=lat, loop_ms=loop_ms, windows=W, c=c)
        log(f"  {key}: {loop_ms / ms:.2f}x the loop; {ms / dbls * 1e3:.2f} us "
            f"a doubling ({lat / dbls * 1e3:.2f} at the latency bound)")


def dense_chunk(mk, points, sc, c: int):
    """The dense layout of an MSM as window_sums_dense builds it, and its
    first chunk of the full windows: (runs, chunk) for aadd_rows."""
    m = sc.shape[-1]
    B = 1 << (c - 1)
    digits, signs = mk.signed_digits(sc, c)
    W = digits.shape[0]
    gidx, starts, counts = (t.to(torch.int32) for t in
                            mk._sort_signed_bounds(digits, signs, m, B))
    W_full = min(W, mk.scalar_bits // c)
    R = mk.dense_depth(m, B, W * B, W_full * (B + 1))
    runs = (mk.row_table(points, signed=True), gidx.reshape(-1), starts,
            counts, m)
    return runs, (0, R // 2, 0, W_full, B + 1)


def check_aadd_rows(curve, g16, K, gen, rng):
    """aadd_rows on the first dense chunk of a 2^20-point MSM (c = 15: the
    full windows at the chunk depth dense_depth picks there), points of
    msm_inputs (64 points, one point and scalar in lanes 0-63: P == Q at
    level 0 and a bucket deeper than the chunk; infinity bases; zero
    scalars): bit-exact against its plain version, run window by window (a
    whole chunk of plain limb products does not fit), and against the
    gathered form it replaced (MSMKernel.dense_level0_composed: row gather,
    limb split, infinity mask, the aadd kernel); each form timed in a
    replayed CUDA graph and between CUDA events (the level-0 device time of
    one chunk, old form against new)."""
    from libsnark_tpu_torch import probes
    from libsnark_tpu_torch.ops import cuda_ec
    from libsnark_tpu_torch.ops.msm import default_window_bits
    m = 1 << 20
    c = default_window_bits(m)
    for ck, mk, group, ext in groups_of(curve, g16):
        fk = mk.fk
        FW = ext * fk.N
        key = cuda_ec.counter_key("aadd_rows", fk)
        points, sc = msm_inputs(curve, g16, ck, group, m, gen, rng)
        runs, chunk = dense_chunk(mk, points, sc, c)
        base, half, w_lo, Wn, nb = chunk
        kern = lambda: cuda_ec.aadd_rows(fk, *runs, *chunk)
        gathered = lambda: mk.dense_level0_composed(*runs, *chunk)
        got = kern()
        err = max_abs_err(got, gathered())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = [cuda_ec.aadd_rows_plain(fk, *runs, base, half, w, 1, nb)
                 for w in range(w_lo, w_lo + Wn)]
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        err = max(err, max_abs_err(got, [torch.cat(a, dim=-1)
                                         for a in zip(*plain)]))
        del plain
        ms = probes._graph_ms(kern, 3)
        gathered_ms = probes._graph_ms(gathered, 3)
        ev_ms = cuda_ms(kern, 3)
        ev_gathered_ms = cuda_ms(gathered, 3)
        L = half * Wn * nb
        ct = runs[3][w_lo:w_lo + Wn, :nb].to(torch.int64)
        live = int((ct - base).clamp(0, 2 * half).sum())
        pairs = int((ct - base - half).clamp(0, half).sum())
        # products: the lanes whose two depths are live run the formula
        ops = pairs * PRODUCTS["aadd"] * (3 if ext == 2 else 1) * wide_mads(fk)
        log(f"aadd_rows: {m}-point MSM, ext={ext}, N={fk.N}, c={c}: chunk "
            f"depth {2 * half} x {Wn} windows x {nb} buckets = {L} lanes "
            f"({live} of {2 * L} depths live, {pairs} lanes add two live "
            "rows); gathered form (graph) "
            f"{gathered_ms:.4f} ms; level 0 between CUDA events: gathered "
            f"{ev_gathered_ms:.4f} ms, aadd_rows {ev_ms:.4f} ms "
            f"({ev_ms / ev_gathered_ms:.3f} of before)")
        K.add("aadd_rows", key, err, ms, pms, L * (20 * FW + 8), ops,
              gathered_ms=gathered_ms, events_ms=ev_ms,
              gathered_events_ms=ev_gathered_ms, lanes=L, live_lanes=pairs,
              m=m, c=c)


def planted_scalar_limbs(r: int, c: int, W: int, rng):
    """(16, 7) int32 scalar limbs on the card: 0, 1, r - 1, every window
    2^c - 1 (all 256 bits set), digit 0 in every odd / every even window,
    only the top window nonzero."""
    from libsnark_tpu_torch.ops.limbs import ints_to_limbs
    full = (1 << 256) - 1
    digits = lambda keep: sum(rng.randrange(1, 1 << c) << (c * w)
                              for w in range(W) if keep(w)) & full
    top = ((rng.randrange(1 << c) | 1) << (c * (W - 1))) & full
    xs = [0, 1, r - 1, full, digits(lambda w: w % 2 == 0),
          digits(lambda w: w % 2 == 1), top or 1 << 255]
    return torch.from_numpy(ints_to_limbs(xs, 16).astype("int32")).cuda()


def fixed_base_madds(fk, scalars, c: int, W: int) -> int:
    """The madds a fixed-base scan of these scalars needs: a nonzero digit
    after a lane's first nonzero one (that one lifts the table row, a zero
    digit adds nothing)."""
    from libsnark_tpu_torch.ops.cuda_ec import window_digit
    sc = scalars.to(torch.int64)
    nz = torch.zeros((W, sc.shape[1]), dtype=torch.bool, device=sc.device)
    for w in range(W):
        d = window_digit(sc, c, w)
        if d is not None:
            nz[w] = d != 0
    return int(nz.sum()) - int(nz.any(dim=0).sum())


def check_madd_windows(curve, g16, K, gen, rng):
    """madd_win at the keygen's shape: 2^20 lanes, c = 8 (W = 32 windows)
    on the keygen's own table of each group, random scalars below r with
    planted lanes (planted_scalar_limbs): bit-exact against its plain
    version and against the per-window madd kernel loop that batch_exp ran
    before it (timed beside it), with the bound of the madds these scalars
    need."""
    from libsnark_tpu_torch.ops import cuda_ec
    m, c = 1 << 20, 8
    for ck, mk, group, ext in groups_of(curve, g16):
        fk = mk.fk
        FW = ext * fk.N
        key = cuda_ec.counter_key("madd_win", fk)
        taff, rows = g16._window_table_affine(ck, mk, group.one(), c)
        W = rows.shape[0] >> c
        sc = rand_field(g16.fr, (m,), gen)
        planted = planted_scalar_limbs(curve.r, c, W, rng)
        sc[:, :planted.shape[1]] = planted
        kern = lambda: cuda_ec.madd_windows(fk, rows, sc, c)
        loop = lambda: mk.batch_exp_loop(taff, sc, c)
        got = kern()
        err = max_abs_err(got, loop())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = cuda_ec.madd_windows_plain(fk, rows, sc, c)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3           # one call: it is slow
        err = max(err, max_abs_err(got, plain))
        del plain
        inf = fk.is_zero(got[2])
        if not bool(inf[0]) or bool(inf[1:planted.shape[1]].any()):
            raise AssertionError(f"{key}: planted lanes at infinity wrong")
        ms = cuda_ms(kern, 5)
        loop_ms = cuda_ms(loop, 2)
        n_madd = fixed_base_madds(fk, sc, c, W)
        ops = n_madd * PRODUCTS["madd"] * (3 if ext == 2 else 1) * wide_mads(fk)
        nbytes = 4 * (sc.numel() + rows.numel() + 3 * FW * m)
        log(f"madd_win: {m} lanes, ext={ext}, N={fk.N}, c={c}, W={W}, "
            f"{n_madd} madds; per-window madd loop {loop_ms:.4f} ms")
        K.add("madd_win", key, err, ms, pms, nbytes, ops, loop_ms=loop_ms,
              lanes=m, windows=W, madds=n_madd)
        b = K.rows[key]["bound_ms"]
        log(f"  {key}: {loop_ms / ms:.2f}x the per-window loop; "
            f"{b / ms:.1%} of the product bound (loop {b / loop_ms:.1%})")


def encode_python_form(fk, xs):
    """The host encoding that FpKernel.encode replaced: the Montgomery form
    int(x) R mod p per element in Python, then the limbs to the card."""
    from libsnark_tpu_torch.ops.limbs import ints_to_limbs
    R, p = fk.params.R, fk.p
    arr = ints_to_limbs([int(x) * R % p for x in xs], fk.N)
    return torch.from_numpy(arr.astype("int32")).cuda()


def check_encode(fk, label: str):
    """FpKernel.encode (reduce and pack on the host, Montgomery form by one
    mont_mul launch) against the Python form it replaced, on the same 2^20
    seeded values: equal limbs; wall time of each (host to card, ended by a
    synchronize), in turns."""
    xs = seeded_coeffs(fk.p, 1 << 20, 50)
    times = {"python": [], "card": []}
    for form in ("python", "card", "card", "python"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode_python_form(fk, xs) if form == "python" else fk.encode(xs)
        torch.cuda.synchronize()
        times[form].append(time.perf_counter() - t0)
        if form == "card":
            got = out
        else:
            want = out
    if not torch.equal(got, want):
        raise AssertionError(f"encode of {label} differs from the Python form")
    log(f"encode {label} (N={fk.N}), 2^20 values: Python Montgomery form "
        + " / ".join(f"{t:.3f}" for t in times["python"])
        + " s, reduce + pack + mont_mul on the card "
        + " / ".join(f"{t:.3f}" for t in times["card"]) + " s: equal limbs")


def check_limb_codec():
    """ints_to_limbs and limbs_to_ints of 2^20 seeded values at 16 and 24
    limbs through the native codec against their Python forms: equal
    limbs and ints; host wall time of each, in turns."""
    from libsnark_tpu_torch.ops import limbs
    for N in (16, 24):
        xs = seeded_coeffs(1 << (16 * N), 1 << 20, 51)
        times = {k: [] for k in ("enc_py", "enc", "dec_py", "dec")}
        out = {}
        for form in ("py", "codec", "codec", "py"):
            enc, dec = ((limbs._ints_to_limbs_py, limbs._limbs_to_ints_py)
                        if form == "py" else
                        (limbs.ints_to_limbs, limbs.limbs_to_ints))
            suffix = "_py" if form == "py" else ""
            t0 = time.perf_counter()
            arr = enc(xs, N)
            t1 = time.perf_counter()
            back = dec(arr)
            t2 = time.perf_counter()
            times["enc" + suffix].append(t1 - t0)
            times["dec" + suffix].append(t2 - t1)
            out[form] = arr
            if back != xs:
                raise AssertionError(f"limbs_to_ints ({form}, N={N}) does not "
                                     "give back the values")
        if not (out["py"] == out["codec"]).all():
            raise AssertionError(f"the codec's limbs differ from the Python "
                                 f"form's at N={N}")
        fmt = lambda k: " / ".join(f"{t:.3f}" for t in times[k])
        log(f"limb codec N={N}, 2^20 values (host s, in turns): "
            f"ints_to_limbs Python form {fmt('enc_py')}, codec {fmt('enc')}; "
            f"limbs_to_ints Python form {fmt('dec_py')}, codec {fmt('dec')}: "
            "equal")


def prove_encode_in_turns(g16, kp, primary, aux, proof, label: str):
    """Four more default proves, their limbs packed by the Python form of
    ints_to_limbs and by the native codec in turns (Python, codec, codec,
    Python): each proof equal to the path's; the prove's host encoding
    (its prove_encode phase) under each."""
    from unittest import mock
    from libsnark_tpu_torch.ops import fp, limbs
    times = {"python": [], "codec": []}
    for form in ("python", "codec", "codec", "python"):
        enc = (limbs._ints_to_limbs_py if form == "python"
               else limbs.ints_to_limbs)
        t = {}
        with mock.patch.object(fp, "ints_to_limbs", enc):
            if g16.prover(kp.pk, primary, aux, seed=9, timings=t) != proof:
                raise AssertionError(f"the proof with the {form} limb "
                                     "packing differs")
        times[form].append(t["prove_encode"])
    log(f"  prove_encode {label} in turns (s): Python form "
        + " / ".join(f"{x:.3f}" for x in times["python"]) + ", codec "
        + " / ".join(f"{x:.3f}" for x in times["codec"]))


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
        key = cuda_ec.counter_key("aadd_rows", mk.fk)
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
                raise AssertionError("aadd_rows launched by the default "
                                     "strategy")
            got = ck.to_affine(lanes(dense.window_sums(points, scalars, c)))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n_level0 = cuda_ec.LAUNCHES[key] - before
            live = ~want[2]
            same = torch.equal(got[2], want[2]) and all(
                torch.equal(a[..., live], b[..., live])
                for a, b in zip(got[:2], want[:2]))
            if not same:
                raise AssertionError(f"dense window sums differ from the "
                                     f"default strategy's ({label}, ext={ext})")
            if n_level0 == 0:
                raise AssertionError(f"the dense strategy launched no "
                                     f"aadd_rows ({label}, ext={ext})")
            log(f"dense window sums == default: {m} points, ext={ext}, "
                f"N={mk.fk.N}, c={c}, {label}: {n_level0} aadd_rows launches; "
                f"default {t1 - t0:.3f} s, dense {t2 - t1:.3f} s")


# ------------------------------------------------------------- end to end

def small_systems(r: int):
    """The 20-constraint cross-check of each pairing system: (label, class,
    the circuit's generator, keygen, prover, verifier, corrupt (a proof
    with one point moved, or None))."""
    from libsnark_tpu_torch.proof_systems.bacs_ppzksnark import BACSPpzksnark
    from libsnark_tpu_torch.proof_systems.bctv14 import BCTV14
    from libsnark_tpu_torch.proof_systems.dfgk14 import DFGK14
    from libsnark_tpu_torch.proof_systems.gm17 import GM17
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.proof_systems.tbcs_ppzksnark import TBCSPpzksnark
    from libsnark_tpu_torch.relations import examples as ex

    def moved(field):
        def corrupt(proof, one):
            return dataclasses.replace(proof, **{field: getattr(
                proof, field) + one})
        return corrupt

    r1cs = lambda: ex.generate_r1cs_example(r, 20, 2)
    plain = (lambda ps, c: ps.generator(c, seed=5),
             lambda ps, kp, p, a: ps.prover(kp.pk, p, a, seed=9),
             lambda ps, kp, p, proof: ps.verifier_strong_IC(kp.vk, p, proof))
    return (
        ("Groth16", Groth16, r1cs) + plain + (None,),
        ("BCTV14", BCTV14, r1cs) + plain + (moved("g_H"),),
        ("GM17", GM17, r1cs) + plain + (moved("C"),),
        ("DFGK14", DFGK14, lambda: ex.generate_uscs_example(r, 20, 2))
        + plain + (moved("H_g1"),),
        # 19 gates and one output constraint: 20 constraints
        ("BACS", BACSPpzksnark, lambda: ex.generate_bacs_example(r, 19, 2),
         lambda ps, c: ps.bacs_generator(c, seed=5),
         lambda ps, kp, p, a: ps.bacs_prover(kp.pk, p, a, seed=9),
         lambda ps, kp, p, proof: ps.verifier_strong_IC(kp.vk, p, proof),
         None),
        # 8 gates: 8 + 10 wires + 1 output = 19 constraints (2g + 3 is odd)
        ("TBCS", TBCSPpzksnark, lambda: ex.generate_tbcs_example(8, 2),
         lambda ps, c: ps.tbcs_generator(c, seed=5),
         lambda ps, kp, p, a: ps.tbcs_prover(kp.pk, p, a, seed=9),
         lambda ps, kp, p, proof: ps.tbcs_verifier_strong_IC(kp.vk, p, proof),
         None))


def proof_coords(x):
    """A proof's points (G1, G2, knowledge commitments, dataclasses of
    them) as plain integer coordinates, None for infinity: what a worker
    process can hand back."""
    if dataclasses.is_dataclass(x):
        return tuple(proof_coords(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if hasattr(x, "g") and hasattr(x, "h"):              # KnowledgeCommitment
        return (proof_coords(x.g), proof_coords(x.h))
    if x.is_zero():
        return None
    if hasattr(x.x, "c0"):
        return ((int(x.x.c0), int(x.x.c1)), (int(x.y.c0), int(x.y.c1)))
    return (int(x.x), int(x.y))


def cpu_proof(label: str, curve_name: str):
    """small_systems' 20-constraint proof of ``label``, made by the plain
    versions on the CPU (one thread; run in a worker process), as integer
    coordinates. The keys come from the host fixed-base path (the same
    affine points as the device path)."""
    from libsnark_tpu_torch import get_curve
    torch.set_num_threads(1)
    curve = get_curve(curve_name)
    for name, cls, make, keygen, prove, _, _ in small_systems(curve.r):
        if name == label:
            circuit, primary, aux = make()
            ps = cls(curve, device="cpu")
            ps.host_keygen = True
            return proof_coords(prove(ps, keygen(ps, circuit), primary, aux))
    raise KeyError(label)


def small_cross_check(curve):
    """About 20 constraints, for Groth16, BCTV14, GM17, DFGK14, BACS and
    TBCS: the proof on the card (keygen on the device fixed-base path) ==
    the proof made by the plain versions on the CPU (cpu_proof, one worker
    process each, all at once beside the card's work), and it verifies;
    for BCTV14, GM17 and DFGK14 a proof with one point moved is
    rejected."""
    systems = small_systems(curve.r)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(systems),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = {label: pool.submit(cpu_proof, label, curve.name)
               for label, *_ in systems}
        for label, cls, make, keygen, prove, verify, corrupt in systems:
            t1 = time.perf_counter()
            circuit, primary, aux = make()
            ps = cls(curve)                                # device="cuda"
            kp = keygen(ps, circuit)
            proof = prove(ps, kp, primary, aux)
            if not verify(ps, kp, primary, proof):
                raise AssertionError(f"{label}: 20-constraint card proof "
                                     "rejected")
            rejected = corrupt is not None and not verify(
                ps, kp, primary, corrupt(proof, curve.G1.one()))
            if corrupt is not None and not rejected:
                raise AssertionError(f"{label}: a corrupted 20-constraint "
                                     "proof was accepted")
            t_card = time.perf_counter() - t1
            if proof_coords(proof) != cpu[label].result():
                raise AssertionError(f"{label}: card proof != CPU plain "
                                     "proof (20 constraints)")
            log(f"20-constraint seeded {label} proof: card == CPU plain, "
                "verifies" + (", corrupted proof rejected" if rejected
                              else "")
                + f" (card side {t_card:.1f} s, elapsed "
                  f"{time.perf_counter() - t0:.1f} s)")


def main_path(curve, log2: int, paths: dict):
    """Keygen (under the device profiler, paths["keygen_<curve>"], and the
    port's phase blocks), prove (default strategy), prove (dense strategy),
    verify. Counts are set to 0 just before each phase and read just after.
    Then one more prove of each strategy under the device profiler
    (paths["prove_<curve>"], paths["prove_dense_<curve>"]), the keygen's
    fixed-base phase again with the per-window madd loop and with
    madd_windows (fixed_base_before_after), and the device time of a G1 and
    a G2 MSM by part. Returns the path's launches per kernel (the three
    phases added up) and {run: launches} of the yardstick runs that count
    the kernels the path replaced (the single madd, the public dbl and
    aadd)."""
    from libsnark_tpu_torch.ops import launch_counts
    from libsnark_tpu_torch.ops.msm import default_window_bits
    from libsnark_tpu_torch.profiling import PROFILER, start_profiling
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
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
        return timed_phase(phases, label, fn)

    g16 = systems["segments"]
    # a system of its own for each profiled try: a second try of the same
    # system would find the window tables built and launch no dbl or add
    start_profiling()
    kp = run("keygen", lambda t: path_timing(
        f"keygen_{curve.name}", lambda: Groth16(curve).generator(
            cs, seed=5, timings=t), paths))
    PROFILER.enabled = False
    log("  keygen_fixed_base by part (s, port profiler blocks): "
        + fixed_base_parts(PROFILER))
    log(f"  domain m = {g16.domain_for(qap_domain, cs).m}")
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

    for strategy, label in (("segments", "prove"), ("dense", "prove_dense")):
        timed = path_timing(f"{label}_{curve.name}", lambda: systems[
            strategy].prover(kp.pk, primary, aux, seed=9), paths)
        if timed != proof:
            raise AssertionError(f"the profiled proof ({strategy}) differs")
    if curve.name == "bls12_377":
        if caller_split(f"prove_{curve.name}", lambda: g16.prover(
                kp.pk, primary, aux, seed=9), paths) != proof:
            raise AssertionError("the proof under PortCallers differs")
    prove_encode_in_turns(g16, kp, primary, aux, proof, curve.name)
    # the kernels the path no longer runs count where their forms still do
    yardsticks = {
        f"prove_dense_gathered_{curve.name}": dense_gathered_prove(
            curve, systems["dense"], kp, primary, aux, proof),
        f"fixed_base_loop_{curve.name}": {
            k: n for k, n in fixed_base_before_after(
                curve, g16, kp.pk.H_query[0].shape[-1]).items()
            if k.startswith("madd_fp")},
        f"window_table_loop_{curve.name}": window_table_before_after(curve,
                                                                     g16)}
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

    level0 = [k for k in launch_counts() if k.startswith("aadd_rows_")]
    if any(phases[p].get(k) for k in level0
           for p in ("keygen", "prove[segments]")):
        raise AssertionError("aadd_rows launched outside the dense strategy")
    total = {}
    for counts in phases.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    replaced = [k for k in total if k.startswith(("dbl_fp", "aadd_fp"))]
    if replaced:
        raise AssertionError(f"the public dbl / aadd launched on the "
                             f"{curve.name} path: {replaced}")
    nq = g16.fq.N
    path = [f"mont_mul_n{nq}", f"mont_mul_n{g16.fr.N}"] + [
        f"{k}_{f}_n{nq}" for k in ("dbl_chain", "add", "madd_win",
                                   "aadd_rows", "bucket_reduce",
                                   "horner_combine")
        for f in ("fp", "fp2")]
    missing = [k for k in path if not total.get(k)]
    if missing:
        raise AssertionError(f"kernels not launched on the {curve.name} "
                             f"main path: {missing}")
    return total, yardsticks


def timed_phase(phases: dict, label: str, fn):
    """fn(timings) with the counts set to 0 just before and read just after
    (phases[label]); logs its wall time, its phases, the peak device memory
    and the launches."""
    from libsnark_tpu_torch.ops import launch_counts, reset_launch_counts
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


def make_circuit(conn, kind: str, r: int, n: int):
    """generate_r1cs_example(r, n, 2) ("r1cs") or generate_uscs_example(r,
    n, 2) ("uscs") in a worker process: sends (circuit, host seconds) on
    ``conn``, which blocks until the parent reads it."""
    from libsnark_tpu_torch.relations import examples as ex
    make = ex.generate_uscs_example if kind == "uscs" else \
        ex.generate_r1cs_example
    t0 = time.perf_counter()
    out = make(r, n, 2)
    conn.send((out, time.perf_counter() - t0))
    conn.close()


def systems_circuits(r: int, log2: int) -> dict:
    """The circuits of proof_systems_path, each made in a worker process
    of its own while the earlier paths run: {system: (process, the pipe's
    read end)}. A circuit crosses to this process only when
    receive_circuit reads it (a background receiver would unpickle it
    under the interpreter lock in the middle of another path)."""
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for name, kind, n in (("bctv14", "r1cs", (1 << log2) - 3),
                          ("gm17", "r1cs", (1 << (log2 - 1)) - 3),
                          ("dfgk14", "uscs", 1 << log2)):
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=make_circuit, args=(send, kind, r, n),
                           daemon=True)
        proc.start()
        send.close()
        out[name] = (proc, recv)
    return out


def receive_circuit(entry):
    """((cs, primary, aux), host seconds) from systems_circuits' worker;
    the worker has ended when this returns."""
    proc, recv = entry
    try:
        return recv.recv()
    finally:
        recv.close()
        proc.join()


def stop_workers(circuits: dict):
    """End the circuit workers that were never read (a failed run)."""
    for proc, recv in circuits.values():
        recv.close()
        if proc.is_alive():
            proc.terminate()
        proc.join()


def proof_systems_path(curve, log2: int, paths: dict,
                       circuits: dict) -> dict:
    """BCTV14, GM17 and DFGK14 through their entry points, each with its
    witness map on a domain of 2^log2: BCTV14 on generate_r1cs_example(r,
    2^log2 - 3, 2) (QAP, n + k + 1 = 2^log2), GM17 on
    generate_r1cs_example(r, 2^(log2-1) - 3, 2) (SAP, 2n + 2k + 1 =
    2^log2 - 1) and DFGK14 on generate_uscs_example(r, 2^log2, 2) (SSP),
    each circuit from ``circuits`` (systems_circuits). For each: a seeded keygen under the device profiler
    (paths["keygen_<system>_<curve>"]) with its phases, one prove (default
    strategy) with its phases, one more under the profiler
    (paths["prove_<system>_<curve>"]), equal proofs, verify accepted and a
    wrong input rejected; every path kernel must have launched. Then BACS
    and TBCS round trips at 2^12 gates. Returns {"<system>_<curve>":
    launches per kernel (keygen and prove added up)}."""
    from libsnark_tpu_torch.proof_systems.bacs_ppzksnark import BACSPpzksnark
    from libsnark_tpu_torch.proof_systems.bctv14 import BCTV14
    from libsnark_tpu_torch.proof_systems.dfgk14 import DFGK14
    from libsnark_tpu_torch.proof_systems.gm17 import GM17
    from libsnark_tpu_torch.proof_systems.tbcs_ppzksnark import TBCSPpzksnark
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    from libsnark_tpu_torch.reductions.r1cs_to_sap import sap_domain
    from libsnark_tpu_torch.reductions.uscs_to_ssp import ssp_domain
    from libsnark_tpu_torch.relations import examples as ex
    r = curve.r
    specs = (
        ("bctv14", BCTV14, qap_domain, "r1cs_dev",
         f"generate_r1cs_example(r, 2^{log2} - 3, 2)"),
        ("gm17", GM17, sap_domain, "sap_dev",
         f"generate_r1cs_example(r, 2^{log2 - 1} - 3, 2)"),
        ("dfgk14", DFGK14, ssp_domain, "ssp_dev",
         f"generate_uscs_example(r, 2^{log2}, 2)"))
    out = {}
    for name, cls, domain_fn, dev_field, what in specs:
        label = f"{name}_{curve.name}"
        t0 = time.perf_counter()
        (cs, primary, aux), made = receive_circuit(circuits[name])
        log(f"{name} path {curve.name}: {what}: {made:.2f} s (host, a "
            f"worker process), {time.perf_counter() - t0:.2f} s to receive")
        phases = {}
        # a fresh system for each profiled try: a second try of one system
        # would find its window tables built
        kp = timed_phase(phases, "keygen", lambda t: path_timing(
            f"keygen_{label}", lambda: cls(curve).generator(
                cs, seed=5, timings=t), paths))
        ps = cls(curve)                                    # device="cuda"
        domain = ps.domain_for(domain_fn, getattr(kp.pk, dev_field))
        log(f"  domain {type(domain).__name__}, m = {domain.m}")
        proof = timed_phase(phases, "prove", lambda t: ps.prover(
            kp.pk, primary, aux, seed=9, timings=t))
        if path_timing(f"prove_{label}", lambda: ps.prover(
                kp.pk, primary, aux, seed=9), paths) != proof:
            raise AssertionError(f"{name}: the profiled proof differs")
        t0 = time.perf_counter()
        ok = ps.verifier_strong_IC(kp.vk, primary, proof)
        bad = [(primary[0] + 1) % r] + primary[1:]
        rej = not ps.verifier_strong_IC(kp.vk, bad, proof)
        log(f"  proofs equal; verify {time.perf_counter() - t0:.2f} s "
            f"(host, two calls): accepted={ok} wrong-input-rejected={rej}")
        if not (ok and rej):
            raise AssertionError(f"{name} verification checks failed")
        total = {}
        for counts in phases.values():
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        nq = ps.fq.N
        need = [f"mont_mul_n{nq}", f"mont_mul_n{ps.fr.N}"] + [
            f"{k}_{f}_n{nq}" for k in ("dbl_chain", "add", "madd_win",
                                       "bucket_reduce", "horner_combine")
            for f in ("fp", "fp2")]
        missing = [k for k in need if not total.get(k)]
        replaced = [k for k in total if k.startswith(("dbl_fp", "aadd_fp"))]
        if missing or replaced:
            raise AssertionError(f"{label}: kernels not launched {missing}, "
                                 f"public dbl / aadd launched {replaced}")
        out[label] = total
        del cs, kp, ps, domain
        torch.cuda.empty_cache()

    gates = 1 << 12
    for name, cls in (("BACS", BACSPpzksnark), ("TBCS", TBCSPpzksnark)):
        t0 = time.perf_counter()
        ps = cls(curve)
        if name == "BACS":
            circuit, primary, aux = ex.generate_bacs_example(r, gates, 2)
            kp = ps.bacs_generator(circuit, seed=5)
            proof = ps.bacs_prover(kp.pk, primary, aux, seed=9)
            ok = ps.verifier_strong_IC(kp.vk, primary, proof)
        else:
            circuit, primary, aux = ex.generate_tbcs_example(gates, 2)
            kp = ps.tbcs_generator(circuit, seed=5)
            proof = ps.tbcs_prover(kp.pk, primary, aux, seed=9)
            ok = ps.tbcs_verifier_strong_IC(kp.vk, primary, proof)
        log(f"{name} {curve.name}, {gates} gates: keygen, prove, verify "
            f"{time.perf_counter() - t0:.2f} s: accepted={ok}")
        if not ok:
            raise AssertionError(f"{name} round trip rejected")
    return out


def fixed_base_parts(profiler) -> str:
    """The keygen.fixed_base.* blocks of the port's profiler, seconds."""
    return ", ".join(f"{k.rsplit('.', 1)[1]} {v:.3f}" for k, v in
                     profiler.totals.items()
                     if k.startswith("keygen.fixed_base."))


class KernelEvents:
    """CUDA events around every call of a module's kernel wrapper while
    the context is open: each call's device time, however many kernels
    the profiler would keep a record of."""

    def __init__(self, module, name: str):
        self.module, self.name, self.events = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def fixed_base_before_after(curve, g16, m: int) -> dict:
    """The keygen's fixed-base phase once more: its five queries (four G1,
    one G2) of m seeded scalars through PairingSystem.fixed_base_g1 / _g2
    on tables built before, first with batch_exp as the per-window madd
    loop it was before madd_windows, then as it is. Both give the same
    affine points. Prints the parts of the phase (the port's profiler
    blocks) and the madd family's device time (CUDA events around each
    madd / madd_windows call) against the bound of its work, for each.
    Returns the loop's launch counts (the single-launch madd's path)."""
    from libsnark_tpu_torch.ops import (cuda_ec, launch_counts, msm,
                                        reset_launch_counts, work_counts)
    from libsnark_tpu_torch.profiling import PROFILER, start_profiling
    G1, G2 = curve.G1.one(), curve.G2.one()
    for ck, mk, group, _ in groups_of(curve, g16):
        g16._window_table_affine(ck, mk, group.one(), 8)
    scalars = seeded_coeffs(curve.r, m, 40)
    queries = lambda: ([g16.fixed_base_g1(G1, scalars) for _ in range(4)]
                       + [g16.fixed_base_g2(G2, scalars)])
    mks = (g16.msm_g1, g16.msm_g2)
    outs, loss, counts = {}, {}, {}
    for form, (module, name) in (("loop", (cuda_ec, "madd")),
                                 ("windows", (msm, "madd_windows"))):
        if form == "loop":
            for mk in mks:
                mk.batch_exp = (lambda t, sc, c, rows=None, mk=mk:
                                mk.batch_exp_loop(t, sc, c))
        torch.cuda.synchronize()
        reset_launch_counts()
        start_profiling()
        try:
            with KernelEvents(module, name) as ev:
                outs[form] = queries()
                ms = ev.ms()
        finally:
            PROFILER.enabled = False
            for mk in mks:
                mk.__dict__.pop("batch_exp", None)
        counts[form] = {k: v for k, v in launch_counts().items() if v}
        work = work_counts()
        fam = [k for k in counts[form] if k.startswith("madd_")]
        bound = sum(work_bound_ms(k, work[k]) for k in fam)
        loss[form] = ms - bound
        log(f"  fixed base {curve.name}, {form}: five queries of {m} scalars "
            f"by part (s): {fixed_base_parts(PROFILER)}; madd family "
            f"({', '.join(f'{k} x{counts[form][k]}' for k in fam)}) "
            f"{ms:.2f} ms of device time, bound {bound:.2f}, loss "
            f"{ms - bound:.2f} ms")
    for a, b in zip(outs["loop"], outs["windows"]):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("fixed base: madd_windows and the per-window "
                                 "madd loop give different points")
    log(f"  fixed base {curve.name}: equal points; the madd family's device "
        f"time - bound {loss['loop']:.2f} -> {loss['windows']:.2f} ms "
        f"({loss['windows'] / loss['loop']:.3f} of before)")
    return counts["loop"]


def window_table_before_after(curve, g16) -> dict:
    """The keygen's window tables (c = 8, both groups) built once more with
    their bases by the per-window dbl_n loop (the form before dbl_chain)
    and by dbl_chain: equal tables; the device time of the bases (CUDA
    events) of each form. Returns the loop's launch counts (the public
    dbl's path)."""
    from libsnark_tpu_torch.ops import launch_counts, reset_launch_counts
    c = 8
    W = -(-curve.r.bit_length() // c)
    counts = {}
    for ck, mk, group, _ in groups_of(curve, g16):
        aff = ck.encode_points([group.one()], jacobian=False, device="cuda")
        base = (aff[0], aff[1], mk.fk.one((1,), "cuda"))
        tables, ms = {}, {}
        for form in ("loop", "chain"):
            if form == "loop":
                mk.window_bases = mk.window_bases_loop
            torch.cuda.synchronize()
            reset_launch_counts()
            try:
                tables[form] = mk.window_table(aff[:2], c, W)
                if form == "loop":
                    counts.update({k: v for k, v in launch_counts().items()
                                   if v and k.startswith("dbl_fp")})
                ms[form] = cuda_ms(lambda: mk.window_bases(base, c, W), 3)
            finally:
                mk.__dict__.pop("window_bases", None)
        if max_abs_err(tables["loop"], tables["chain"]):
            raise AssertionError("window table: dbl_chain and the dbl_n loop "
                                 "give different tables")
        log(f"  window table {curve.name} {ck.name}, c={c}, W={W}: equal "
            f"tables; bases by the dbl_n loop {ms['loop']:.4f} ms, by "
            f"dbl_chain {ms['chain']:.4f} ms of device time "
            f"({ms['loop'] / ms['chain']:.2f}x)")
    return counts


def dense_gathered_prove(curve, g_dense, kp, primary, aux, proof) -> dict:
    """One more dense prove with level 0 in the gathered form it had before
    aadd_rows (MSMKernel.dense_level0_composed), under the device profiler
    and with its peak device memory: the same proof. Returns its launch
    counts of the public aadd (that kernel's path)."""
    from libsnark_tpu_torch.ops import launch_counts
    mks = (g_dense.msm_g1, g_dense.msm_g2)
    for mk in mks:
        mk.dense_level0 = mk.dense_level0_composed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        out, rows, busy, wall, _, _, _ = profiled_rows(
            lambda: g_dense.prover(kp.pk, primary, aux, seed=9))
        counts = {k: v for k, v in launch_counts().items()
                  if v and k.startswith("aadd_fp")}
    finally:
        for mk in mks:
            mk.__dict__.pop("dense_level0", None)
    if out != proof:
        raise AssertionError("the dense proof with the gathered level 0 "
                             "differs")
    log(f"  prove_dense_gathered_{curve.name} (level 0 as row gather + limb "
        f"split + aadd): wall {wall:.1f} ms, device busy {busy:.1f} ms, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        + ", ".join(f"{k} {r['launches']} launches {r['ms']:.3f} ms"
                    for k, r in sorted(rows.items()) if k.startswith("aadd")))
    return counts


def kzg_batch_exp_before_after(kzg, n: int):
    """KZG10.setup's batch exp at n lanes on its own table (c = 8), random
    scalars below r: the per-window madd loop and madd_windows, each timed
    between CUDA events; equal Jacobian limbs."""
    c = 8
    taff, rows = kzg._window_table_affine(kzg.g1, kzg.msm, kzg.curve.G1.one(),
                                          c)
    gen = torch.Generator(device="cuda").manual_seed(91)
    sc = rand_field(kzg.fr, (n,), gen)
    out = {}
    for form, fn in (("loop", lambda: kzg.msm.batch_exp_loop(taff, sc, c)),
                     ("windows", lambda: kzg.msm.batch_exp(taff, sc, c,
                                                           rows))):
        out[form] = fn()
        log(f"  kzg.setup.batch_exp at {n} lanes, {form}: "
            f"{cuda_ms(fn, 2):.2f} ms of device time a call")
    if max_abs_err(out["loop"], out["windows"]):
        raise AssertionError("KZG setup: madd_windows and the per-window "
                             "madd loop differ")


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
    batched and BDFG21 openings at that degree. paths: run the setup under
    the device profiler (paths["kzg_setup_<curve>"]), commit and open that
    polynomial once more under it (paths["kzg_<curve>"]), and time the
    setup's batch exp as the per-window madd loop and as madd_windows."""
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
    if paths is None:
        srs = kzg.setup(n - 1, seed=3)
    else:       # a fresh system each try, as the keygen's
        srs = path_timing(f"kzg_setup_{curve.name}",
                          lambda: KZG10(curve).setup(n - 1, seed=3), paths)
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
        f"{k}_fp_n{nq}" for k in ("dbl_chain", "add", "madd_win",
                                  "bucket_reduce", "horner_combine")]
    if any(k.startswith("dbl_fp") for k in counts):
        raise AssertionError(f"the public dbl launched on the {curve.name} "
                             "KZG path")
    missing = [k for k in path if not counts.get(k)]
    if missing:
        raise AssertionError(f"kernels not launched on the {curve.name} KZG "
                             f"path: {missing}")
    if paths is not None:
        z = rng.randrange(r)
        timed = path_timing(f"kzg_{curve.name}", lambda: (
            kzg.commit(srs, coeffs),
            kzg.create_evaluation_witness(srs, coeffs, z)), paths)
        if caller_split(f"kzg_{curve.name}", lambda: (
                kzg.commit(srs, coeffs),
                kzg.create_evaluation_witness(srs, coeffs, z)),
                paths) != timed:
            raise AssertionError("the commitment or witness under "
                                 "PortCallers differs")
        kzg_batch_exp_before_after(kzg, n)

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
           "madd_windows": "madd_win", "aadd": "aadd",
           "aadd_rows": "aadd_rows", "dbl_chain": "dbl_chain",
           "bucket_reduce": "bucket_reduce", "horner": "horner_combine"}


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
    a lane (mont_mul: one product; dbl: one doubling; aadd_rows: an output
    lane, two packed rows and their indices in, the products counted over
    its live lanes: work_bound_ms), a bucket_reduce madd row
    (a packed row and its index), a horner_combine product, a dbl_chain
    doubling, a madd_win madd (a lane's windows after its first)."""
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
    if fam == "dbl_chain":           # the same
        return 0, PRODUCTS["dbl"] * per * wm
    if fam == "aadd_rows":
        return 8 * FW + 8 + 12 * FW, PRODUCTS["aadd"] * per * wm
    if fam == "madd_win":
        # a lane reads its 16 scalar limbs and writes 3 elements over the
        # 31 madds of W = 32 windows (c = 8 on a 253- or 254-bit r, the
        # fixed-base paths' width); the products outweigh the bytes ~100x.
        # Zero digits (1 / 2^c of them) count as work they skip.
        return (4 * 16 + 12 * FW) / 31, PRODUCTS["madd"] * per * wm
    nfield = {"dbl": 6, "add": 9, "madd": 8, "aadd": 7}[fam]
    return (nfield * FW * 4 + (2 if fam in ("madd", "aadd") else 0),
            PRODUCTS[fam] * per * wm)


def work_bound_ms(key: str, work: int, live: int = None) -> float:
    """Least device time of ``work`` units: every launch's bound is linear
    in its work, so the sum over launches is that of the total. live: the
    units that run the products, where fewer do (aadd_rows: the lanes
    whose two depths are live)."""
    nbytes, ops = unit_cost(key)
    return bound_ms(nbytes * work, ops * (work if live is None else live))[0]


def latency_bound_ms(key: str, depth: int) -> float:
    """Least time of a chain of ``depth`` dependent base-field products at
    the key's width: depth times the least product latency measured in this
    run (0 for a kernel that is no chain)."""
    n = int(key.rsplit("_n", 1)[1])
    return depth * PRODUCT_LATENCY_MS.get(n, 0.0)


PROFILE_WARMUP_LAUNCHES = 32


def unmatched_launches(prof):
    """The runtime API's kernel launches (cudaLaunchKernel and kin) whose
    correlation id no device event carries: kernels the profiler's records
    lost. None if the profiler's raw events do not say."""
    try:
        launches, device = set(), set()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.add(e.correlation_id())
            elif "LaunchKernel" in e.name():
                launches.add(e.correlation_id())
        return len(launches - device)
    except (AttributeError, RuntimeError, TypeError):
        return None


def device_profile(fn):
    """fn() under torch.profiler (CUDA activity), ended by a synchronize.
    Returns (result, {kernel name: [launches, device ms]}, device busy ms,
    wall ms, unmatched_launches). Raises if the profiler saw no device
    work."""
    from torch.profiler import ProfilerActivity, profile
    from libsnark_tpu_torch import probes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the profiler has kept no record of the first kernels it was to see
        # (the first madd_windows of a fixed-base run, the first one-lane
        # products of a KZG setup): empty kernels first, left out below
        for _ in range(PROFILE_WARMUP_LAUNCHES):
            probes._empty_launch()
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per, spans, warm = {}, [], 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "empty_kernel" in e.name:
            warm += 1
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
    lost = unmatched_launches(prof)
    if lost is not None:        # not the warm-up's own lost records
        lost -= PROFILE_WARMUP_LAUNCHES - warm
    return out, per, busy / 1e3, wall, lost


def profiled_rows(fn):
    """fn() under the device profiler, with the counts set to 0 just before:
    (result, {path kernel key: row}, busy ms, wall ms, the keys whose
    profiled kernels differ in number from the wrappers' launches, the
    runtime's kernel launches the profiler kept no device record of, the
    device operations that are no hand-written kernel as (ms, launches,
    name), largest first)."""
    from libsnark_tpu_torch.ops import (depth_counts, launch_counts,
                                        live_pair_counts, reset_launch_counts,
                                        work_counts)
    reset_launch_counts()
    out, per, busy, wall, lost = device_profile(fn)
    launches, work, depth = launch_counts(), work_counts(), depth_counts()
    live = live_pair_counts()
    rows, others = {}, []
    for name, (n, ms) in per.items():
        key = kernel_key(name)
        if key is None:
            others.append((ms, n, name))
            continue
        r = rows.setdefault(key, {"launches": launches[key], "profiled": 0,
                                  "ms": 0.0, "work": work[key]})
        r["profiled"] += n
        r["ms"] += ms
    for key, r in rows.items():
        # horner_combine: the larger of its throughput and latency bounds
        r["throughput_bound_ms"] = work_bound_ms(key, r["work"],
                                                 live.get(key))
        r["latency_bound_ms"] = latency_bound_ms(key, depth.get(key, 0))
        r["bound_ms"] = max(r["throughput_bound_ms"], r["latency_bound_ms"])
    differ = {k: (r["profiled"], r["launches"]) for k, r in rows.items()
              if r["profiled"] != r["launches"]}
    differ.update({k: (0, n) for k, n in launches.items()
                   if n and k not in rows})
    return out, rows, busy, wall, differ, lost, sorted(others, reverse=True)


def path_timing(label: str, fn, paths: dict):
    """fn() as one measured path: the device time of each path kernel
    (profiler, summed by __global__ name), its launches (the wrappers'
    counts, checked against the profiler's), its work and the bound of that
    work; device busy time and wall time. Stored in paths[label].

    The profiler loses a kernel's record now and then: in a prove of some
    15,000 launches on an H100 it has kept no device record of one or two
    launches that the CUDA runtime made (mont_mul_n16 among them). A path
    whose counts differ is profiled once more. If they differ again, each
    difference must be kernels the wrappers launched and the profiler did
    not record, no more in all than the runtime's launches that have no
    device record; else it fails. A wrapper that counts a launch it did
    not make (the runtime sees no launch) or launches without counting
    still fails."""
    out, rows, busy, wall, differ, lost, others = profiled_rows(fn)
    if differ:
        log(f"  path {label}: profiled / launched differ {differ}; runtime "
            f"kernel launches without a device record: {lost}; profiling "
            "the path once more")
        out, rows, busy, wall, differ, lost, others = profiled_rows(fn)
    if differ:
        unrecorded = sum(n - p for p, n in differ.values())
        if lost is None or unrecorded > lost or any(
                p > n for p, n in differ.values()):
            raise AssertionError(
                f"{label}: profiled kernels / wrapper launches differ twice: "
                f"{differ}; runtime kernel launches without a device record: "
                f"{lost}")
        log(f"  path {label}: profiled / launched differ again {differ}, "
            f"within the {lost} runtime kernel launches the profiler kept no "
            "device record of; their device time is missing from the rows")
    kern = sum(r["ms"] for r in rows.values())
    paths[label] = {"kernels": rows, "busy_ms": busy, "wall_ms": wall,
                    "unrecorded_launches": lost,
                    "other_ms": sum(o[0] for o in others),
                    "other_ops": [{"name": name[:120], "launches": n, "ms": ms}
                                  for ms, n, name in others[:5]]}
    log(f"  path {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1 - busy / wall:.3f}), hand-written kernels "
        f"{kern:.1f} ms:")
    for key, r in sorted(rows.items(), key=lambda kv: -kv[1]["ms"]):
        log(f"    {key}: {r['launches']} launches, {r['ms']:.3f} ms, work "
            f"{r['work']}, bound {r['bound_ms']:.3f} ms"
            + (f" (latency {r['latency_bound_ms']:.3f}, throughput "
               f"{r['throughput_bound_ms']:.3g})" if r["latency_bound_ms"]
               else ""))
    log(f"  path {label}: the five largest device operations that are no "
        f"hand-written kernel (of {len(others)}, {sum(o[0] for o in others):.1f}"
        " ms in all):")
    for ms, n, name in others[:5]:
        log(f"    {ms:.3f} ms, {n} launches: {name[:160]}")
    return out


_PORT_FILE = re.compile(r"libsnark_tpu_torch/(.+\.py)$")
PORT_LABEL = "port: "
PORT_DEPTH = 3          # port functions a PortCallers label names
CALLER_TOP = 10         # callers caller_split prints


class PortCallers(TorchFunctionMode):
    """While active, runs every torch call made under a function of the
    port inside a torch.profiler.record_function range named after the
    innermost PORT_DEPTH functions of the port on the Python stack
    (PORT_LABEL + "ops/cuda_fp.py:normalize < ops/fp.py:add < ..."), so
    that a profile can charge each device operation to the port function
    that issued it. (torch.profiler's own with_stack records no Python
    frame with the card machine's torch 2.11: empty stacks and no Python
    function events.) Calls that torch makes inside a call run outside the
    mode, so each operation carries one label."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        frames, f = [], sys._getframe(1)
        while f is not None and len(frames) < PORT_DEPTH:
            m = _PORT_FILE.search(f.f_code.co_filename)
            key = m and f"{m.group(1)}:{f.f_code.co_name}"
            if key and key not in frames:
                frames.append(key)
            f = f.f_back
        if not frames:
            return func(*args, **kwargs)
        with torch.profiler.record_function(PORT_LABEL + " < ".join(frames)):
            return func(*args, **kwargs)


def port_callers(event) -> list:
    """The port functions a PortCallers label above a profiler event
    names, innermost first ([] without one)."""
    parent = event.cpu_parent
    while parent is not None:
        if parent.name.startswith(PORT_LABEL):
            return parent.name[len(PORT_LABEL):].split(" < ")
        parent = parent.cpu_parent
    return []


def caller_split(label: str, fn, paths: dict):
    """fn() under torch.profiler (CPU and CUDA activity) and PortCallers:
    the device time of every operation that is no hand-written kernel
    (torch's own kernels, copies), grouped by the innermost function of
    the port above the operator that launched it, with the two port
    functions above that one. Prints the CALLER_TOP largest beside the same
    operations' device time in the path's own profile (paths[label],
    path_timing); returns fn()."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with PortCallers():
            out = fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    split = {}
    for e in events:
        # operators only: the profiler's own records may share an
        # operator's id and carry its kernels too
        if e.device_type != torch.autograd.DeviceType.CPU \
                or "::" not in e.name or not e.kernels:
            continue
        ks = [k for k in e.kernels if kernel_key(k.name) is None]
        if not ks:
            continue
        callers = port_callers(e) or ["(no port function)"]
        row = split.setdefault(callers[0], [0.0, 0, {}])
        ms = sum(k.duration for k in ks) / 1e3
        row[0] += ms
        row[1] += len(ks)
        outer = " < ".join(callers[1:]) or "-"
        row[2][outer] = row[2].get(outer, 0.0) + ms
    attributed = sum(r[0] for r in split.values())
    log(f"  {label}: torch's own device operations by the port function that "
        f"issued them (torch.profiler, PortCallers; wall {wall:.0f} ms under "
        f"them; {attributed:.1f} ms in all, {paths[label]['other_ms']:.1f} in "
        f"the path's own profile), the {CALLER_TOP} largest:")
    for key, (ms, n, outer) in sorted(split.items(),
                                      key=lambda kv: -kv[1][0])[:CALLER_TOP]:
        log(f"    {ms:.3f} ms, {n} launches: {key} (called from "
            + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                outer.items(), key=lambda kv: -kv[1])[:3]) + ")")
    return out


def msm_breakdown(label: str, fn):
    """Device time of one MSM by part: the sort, bucket_reduce, add,
    horner_combine and the rest (digits, bounds, gathers, to_affine's
    products, copies)."""
    out, per, busy, wall, _ = device_profile(fn)
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
    """The path kernels by device time - bound over the measured paths
    (keygen, default and dense prove per curve, the KZG setup and the
    commit and opening at full degree), each kernel's time and bound those
    of its launches there (horner_combine and dbl_chain: the larger of
    their throughput and latency bounds)."""
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
    ap.add_argument("--bn-log2", type=int, default=18,
                    help="alt_bn128 Groth16 circuit: 2^k - 3 constraints "
                         "(18: the run's time limit leaves 2^20 to "
                         "BLS12-377 and to the proof-systems path)")
    ap.add_argument("--systems-log2", type=int, default=20,
                    help="BCTV14, GM17 and DFGK14 over alt_bn128: witness "
                         "map on a domain of 2^k (20)")
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
        check_madd_windows(g16.curve, g16, K, gen, rng)
        check_dbl_chain(g16.curve, g16, K, rng)
        check_aadd_rows(g16.curve, g16, K, gen, rng)
        check_encode(g16.fr, f"{name} Fr")
        check_bucket_and_horner(g16.curve, g16, K, gen, rng)
        check_dense_window_sums(g16.curve, g16, gen, rng)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
    check_limb_codec()
    small_cross_check(get_curve("alt_bn128"))
    del systems
    paths = {}
    # the proof-systems path's circuits are made beside the Groth16 paths
    circuits = systems_circuits(get_curve("alt_bn128").r, args.systems_log2)
    try:
        for name, log2 in curves.items():
            counts, yardsticks = main_path(get_curve(name), log2, paths)
            for key, n in counts.items():
                # Fr is 16 limbs on both curves: mont_mul_n16 keeps the count
                # of the alt_bn128 path, where Fq and Fr both run through it
                K.count(key, name, n)
            # the single-launch madd, the public dbl and the public aadd run
            # where the path ran them before madd_windows, dbl_chain and
            # aadd_rows
            for label, yard in yardsticks.items():
                for key, n in yard.items():
                    K.count(key, label, n)
            log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
        for label, counts in proof_systems_path(
                get_curve("alt_bn128"), args.systems_log2, paths,
                circuits).items():
            for key, n in counts.items():
                K.count(key, label, n)
    finally:
        stop_workers(circuits)
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
