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
   limbs (and at 19 and 12: fp_mul_half alone at 19), with the
   instructions of each kernel's main loop; the latency of one dependent
   wide multiply-add, and each body's latency against the chain of 4 NW of
   them that every body runs in order; and
   the eleven layout and row-copy kernels in every case of
   probes.layout_cases (the TPU scripts' shapes, odd offsets, shifts
   outside [0, axis), tiles with no word above 7, trip counts 1..6), with
   where each kernel's data went (shared, local memory, barriers, 16-byte
   accesses; cond_kernel must move 16-byte pieces), an
   empty kernel's time as the launch floor, and the row-copy rates at the
   row widths bucket_reduce gathers beside one index_select; and the latency
   of one dependent product (one thread, one lane group).
4. For alt_bn128 (16-limb Fq), BLS12-377 (24-limb Fq) and BW6-761 (48-limb
   Fq, G2 over Fq: its G2 checks run the G1 kernels again), G1 and G2,
   holds every kernel against its plain PyTorch version on the card at
   main-path shapes, bit-exact (tolerance 0; at 48 limbs the plain
   versions run on part of a check: mont_mul, fp_addsub and madd_win on
   2^16 of the
   lanes, dbl_chain over the first 8 bases, aadd_rows over the chunk's
   first 4 windows, bucket_reduce on a 2^14-point MSM): mont_mul at 2^20
   lanes; fp_addsub (the field addition and subtraction, what FpKernel.add
   and sub launch on the card) at 2^20 lanes and on 4096 lanes of any
   16-bit limbs;
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
   GM17, DFGK14, BACS (19 gates and an output: 20 constraints), TBCS (8
   gates: 19 constraints) and ADSNARK (Schnorr) over alt_bn128 and Groth16
   over BW6-761, MNT4, MNT6 and edwards, and the RAM ppzkSNARK over
   alt_bn128 on the 4,765-constraint universal circuit (TinyRAM w = 16, k
   = 4, boot-trace and time bounds 5); the CPU proofs run in worker
   processes, all at once, beside the card's (each line gives the
   worker's seconds and the wait for it). Each card proof must verify
   (ADSNARK: both verifiers); BCTV14's, GM17's, DFGK14's, ADSNARK's, the
   RAM ppzkSNARK's and the Groth16 proofs over BW6-761, MNT4, MNT6 and
   edwards with one point moved must not.
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
   around each call) - bound of each. Over BLS12-377 also the
   multi-device prover on the path's keypair, witness and seed
   (sharded_phase: a one-rank NCCL group, prover_sharded twice, each proof
   equal to the path's and verified, a changed input rejected; the
   four-step NTT at 2^20 against the radix-2 forms; msm_simple on 2^12
   points against Pippenger's sum) and the MXU NTT (mxu_phase: fft, ifft
   and icoset_fft_divz at 2^20 in int8 and bf16, and fft over BW6-761's
   Fr, each equal to the radix-2 form and timed beside it with its
   launches; the shares of the matrix products and of mul_wide in the
   profiled fft; the products alone at the top level's shapes); mul_wide
   is held against its plain version at 2^20 lanes at 16 and 24 limbs in
   step 4.
6b. Runs BCTV14, GM17 and DFGK14 over alt_bn128 through their entry
   points, each witness map on a domain of 2^k (--systems-log2, 17): BCTV14
   on generate_r1cs_example(r, 2^k - 3, 2) (QAP), GM17 on
   generate_r1cs_example(r, 2^(k-1) - 3, 2) (SAP, 2n + 2k + 1 = 2^k - 1
   rows), DFGK14 on generate_uscs_example(r, 2^k, 2) (SSP). Each: a seeded keygen
   (device fixed-base path) under torch.profiler with its phases, one
   prove with its phases and one more under the profiler (the proofs must
   be equal), peak device memory, verify accepted and a wrong input
   rejected; mont_mul, dbl_chain, madd_win, add, bucket_reduce and
   horner_combine (G1 and G2) must each have launched on the path. Then
   BACS and TBCS round trips at 2^12 gates.
6c. Runs ADSNARK over alt_bn128 through its entry points on
   generate_r1cs_example(r, 2^17 - 3, 16) (--adsnark-log2; a worker
   process makes it):
   the authority's seeded keys and the 16 inputs' signed data, a seeded
   keygen under torch.profiler with its phases, a prove with its phases
   and one more under the profiler (equal proofs), peak device memory;
   verifier_sec and verifier_pub accept, verifier_pub rejects the proof
   made over the same input from a changed input's authenticated data and
   verifier_sec the proof under wrong labels; every path kernel must have
   launched; then an Ed25519 round trip at 20 constraints. Then Groth16
   over BW6-761 on generate_r1cs_example(r, 2^19 - 3, 2) (--new-log2; a
   worker process makes it) as in 6, both strategies with equal proofs, verified and
   rejected, profiled, with the keygen's fixed base and window tables once
   more in their earlier forms and a dense prove with the gathered level
   0 (the yardsticks of the public madd, dbl and aadd at 48 limbs).
   Then the mnt path (mnt_path), the curves with an a-coefficient, whose
   group law is the torch formulas over the product and add kernels:
   mont_mul and fp_addsub at 19 limbs (MNT4's and MNT6's Fq and Fr, R =
   2^304) and at 12 limbs (edwards) on 2^20 lanes against their plain
   versions, bit-exact; then
   Groth16 over MNT4 and MNT6 at 2^16 - 3 constraints (--mnt-log2; at
   2^18 - 3 MNT6's witness map takes its extended domain of 2 x 2^17)
   and over edwards at 2^15 - 3 (--edwards-log2), each with 2 inputs (a
   worker process makes the circuit): one scalar_mul_const a group
   against the host, a seeded keygen and a prove under the default
   strategy name, each profiled as in 6 (the prove takes the dense layout
   and the Horner loop: no bucket_reduce or horner_combine launches),
   verified and a wrong input rejected (the verifier calls run in workers
   beside the next curves' paths); mont_mul and fp_addsub must launch and
   no group kernel may (bucket_reduce, horner_combine, dbl_chain, madd_win,
   aadd_rows and the public dbl, add, madd, aadd hard-code a = 0). Their
   20-constraint card proofs are held against the CPU's in 5.
6d. Runs a two-step SpPCD over BLS12-377 -> BW6-761 through its entry
   points (pcd_path): the tally compliance predicate of arity 2, the
   generator (device keygen of the inner key over BLS12-377 and of the
   outer key of the aggregation circuit over BW6-761: 139,054 constraints,
   2,024 inputs, a 2^18 domain) with its phases, two real inner step
   proofs (each verified), the prover folding both into one outer proof
   with its phases (circuit rebuild, the verifier gadgets' witness, the
   outer prove), and the verifier accepting it and rejecting it for a
   changed statement element; peak device memory of each phase; the
   outer prove's launches are the kernel table's "pcd" counts.
6d'. Runs the single-predicate PCD over the MNT4 -> MNT6 cycle through
   its entry points (pcd_cycle_path): CycleSpPCD with the tally predicate
   of arity 1; the generator (the compliance circuit over Fr(MNT4):
   110,298 constraints, a 2^17 domain; the translation circuit over
   Fr(MNT6): 28,305 constraints, 2^15; device keygen of both Groth16 keys)
   with its phases and both circuits' sizes; a base step (depth 0) and a
   step consuming its translation proof (depth 1), each a compliance
   prove over MNT4 and a translation prove over MNT6 with its phases (the
   generator's boards re-witnessed, each checked on its key's device
   R1CS), the second under the profiler (prove_pcd_cycle); the verifier
   accepting the depth-1 proof and rejecting it for a changed payload
   element. mont_mul and fp_addsub at 19 limbs must launch, no group
   kernel may (the table's "pcd_cycle" counts). The path runs in a
   spawned process of its own (PathProcess: its own launch counters,
   profiler, device memory statistics and two verifier workers), started
   after the Groth16 paths of 6, beside 6b, 6c, 6d and 6e, all
   host-bound. The two processes take turns on the card (card_turn): the
   parent holds the card for each of its timed or profiled phases and
   yardsticks, the path's process for each Groth16 call that runs there
   (a keygen's from its QAP at t to its last fixed-base query as one
   turn), its profiled step included, so no measured phase shares the
   card; host work overlaps. Its log lines are printed when it ends,
   after 6e, and a failure there fails the run.
6e. Runs the RAM systems through their entry points (ram_path), TinyRAM
   with 16 registers of 32 bits: the RAM ppzkSNARK (the universal circuit
   under BCTV14) over alt_bn128 on gen_ram_example_complex with
   boot-trace bound 102 and time bound 128 (216,799 constraints, a 2^18
   domain): the circuit's host build alone (ram.build), ram_generator
   under the profiler, ram_prover with its phases and once more under the
   profiler (equal proofs), ram_verifier accepting and rejecting a
   changed boot-input element, and the prover refusing the unsatisfiable
   example; then the one-layer RAM zkSNARK over BLS12-377 (the full 32-bit
   delegated address space: a predicate of 78,912 constraints) on
   gen_ram_example_complex with boot-trace bound 12 and --ram-steps (8)
   steps: generator under the profiler, prover (one inner Groth16 proof a
   step) under the profiler, verify_transcript accepting the message
   chain and rejecting a changed middle message and a false final claim.
   Peak device memory and launches of each phase; every kernel of each
   system must have launched (the table's "ram_ppzksnark_alt_bn128" and
   "ram_zksnark_bls12_377" counts).
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

Every verifier call (the paths' proof systems, the PCDs and KZG10's
verify_evaluation) runs whole in one of six worker processes
(VerifierPool), on a system made over the same curves on the CPU: the
calls of one check (a proof accepted, each rejection) run at once, and
each verdict comes back as a plain bool, read before the time it is
logged under is taken.

Prints the kernel table as one JSON line, the card line, and last the
line {"ok": true, "device": {...}}. Each row of the table names in "path"
the run its "launches" were counted in: the alt_bn128, the bls12_377 or the
bw6_761 Groth16 path (keygen + both proves), the mnt4 or edwards Groth16
path (the n19 and n12 rows: keygen + both proves), "<system>_alt_bn128" (the
BCTV14, GM17, DFGK14 and ADSNARK paths: keygen + prove), "pcd" (the
SpPCD's outer prove over BW6-761), "pcd_cycle" (the cycle PCD's
generator and two steps over MNT4 and MNT6), "ram_ppzksnark_alt_bn128" and
"ram_zksnark_bls12_377" (the RAM systems: keygen + prove),
"fixed_base_loop_<curve>" (the
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
keygen_<system>_alt_bn128, prove_<system>_alt_bn128, prove_pcd,
prove_pcd_cycle,
keygen_ram_ppzksnark_alt_bn128, prove_ram_ppzksnark_alt_bn128,
keygen_ram_zksnark_bls12_377, prove_ram_zksnark_bls12_377,
kzg_setup_bls12_377, kzg_bls12_377). Any failed check raises: exit
code 1.

    python3 chip_smoke.py                     # needs one CUDA card
    python3 chip_smoke.py --log2 14 --bn-log2 12 --systems-log2 14 \
        --new-log2 14 --adsnark-log2 14 --kzg-log2 14
                                              # small sizes (the PCD
                                              # circuit keeps its size)
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import multiprocessing
import pickle
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
    """Wide multiply-adds of one Montgomery product over NW = ceil(N/2)
    words: NW^2 (a*b) + NW (m) + NW^2 (m*p)."""
    nw = -(-fk.N // 2)
    return 2 * nw * nw + nw


TPU_KERNEL = {
    "mont_mul": "libsnark_tpu/ops/pallas_fp.py:291",
    # the field addition and subtraction: jnp code that XLA fuses on the
    # TPU (FpKernel.add / sub), no Pallas kernel
    "fp_addsub": "libsnark_tpu/ops/fp.py:144",
    # the product with a wide operand of the MXU NTT: a jnp scan on the TPU
    # (FpKernel.mul_wide), no Pallas kernel
    "mul_wide": "libsnark_tpu/ops/fp.py:258",
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
    "fp_addsub": "libsnark_tpu_torch/csrc/fp.cu",
    "mul_wide": "libsnark_tpu_torch/csrc/fp.cu",
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


# set in a path's own process (PathProcess): log() keeps the lines there
# for the parent to print
LOG_LINES = None


def log(*a):
    if LOG_LINES is not None:
        LOG_LINES.append(" ".join(map(str, a)))
        return
    print(*a, flush=True)


# The card's turns while a path runs in a process of its own (PathProcess):
# one lock of the two processes. The parent holds it for each of its timed
# or profiled phases, the path's process for each of its calls that run on
# the card (on_card) and for its profiled phase, so no measured phase
# shares the card with the other process; their host work overlaps.
CARD = None             # (lock, "the path's process waits" event, the
                        # other process), or None while one process runs
IN_PATH_PROCESS = False
_TURN_DEPTH = 0         # nested turns hold the lock once
TURN_WAITED = 0.0       # seconds this process has waited for its turns


@contextlib.contextmanager
def card_turn():
    """Holds the card's turn (a no-op while no path runs in a process of
    its own). The parent gives way to the path's process when that one
    waits; either fails if the other process ends while it waits."""
    global _TURN_DEPTH, TURN_WAITED
    if CARD is None or _TURN_DEPTH:
        _TURN_DEPTH += 1
        try:
            yield
        finally:
            _TURN_DEPTH -= 1
        return
    lock, waiting, peer = CARD
    t0 = time.perf_counter()
    if IN_PATH_PROCESS:
        waiting.set()
    try:
        while not IN_PATH_PROCESS and waiting.is_set() and peer.is_alive():
            time.sleep(0.005)
        while not lock.acquire(timeout=1.0):
            if not peer.is_alive():
                raise AssertionError("the card's turn: the other process "
                                     "ended while holding it")
    finally:
        if IN_PATH_PROCESS:
            waiting.clear()
    TURN_WAITED += time.perf_counter() - t0
    _TURN_DEPTH += 1
    try:
        yield
    finally:
        _TURN_DEPTH -= 1
        lock.release()


def on_card(fn):
    """fn, each call in the card's turn."""
    @functools.wraps(fn)
    def turn(*a, **kw):
        with card_turn():
            return fn(*a, **kw)
    return turn


class HeldTurn:
    """One card turn over a stretch of calls: ``begin(fn)`` wraps the call
    that opens it (the turn is taken before fn runs, unless it is held
    already), ``end(fn)`` the one that closes it (released when fn
    returns or raises); a failure in the opening call releases it too.
    Calls between them that take a turn of their own (on_card) nest inside
    it. The cycle process holds one such turn from a Groth16 keygen's QAP
    at t to its last fixed-base query, instead of one turn a call: each of
    those short calls waited for a whole parent phase."""

    def __init__(self):
        self.stack = None

    def release(self):
        if self.stack is not None:
            stack, self.stack = self.stack, None
            stack.close()

    def begin(self, fn):
        @functools.wraps(fn)
        def opened(*a, **kw):
            if self.stack is None:
                stack = contextlib.ExitStack()
                stack.enter_context(card_turn())
                self.stack = stack
            try:
                return fn(*a, **kw)
            except BaseException:
                self.release()
                raise
        return opened

    def end(self, fn):
        @functools.wraps(fn)
        def closed(*a, **kw):
            try:
                return fn(*a, **kw)
            finally:
                self.release()
        return closed


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
        if err != 0:
            raise AssertionError(f"{key}: kernel differs from its plain "
                                 f"version (max abs limb error {err})")
        if key in self.rows:
            # G2 over Fq (BW6-761) runs G1's kernel: one row, G2's check
            # beside it
            self.rows[key].setdefault("also", []).append({
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": by, **extra})
            log(f"  {key} (again, G2 over Fq): bit-exact; kernel {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, bound {b:.3g} ms ({by})")
            return
        self.rows[key] = {
            "name": key, "route": "cuda", "source": SOURCE[name],
            "replaces": TPU_KERNEL[name], "launches": None, "path": None,
            "paths": {}, "path_ms": {}, "path_bound_ms": {},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms, **extra}
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


POOL_POINTS = 64
_POINT_POOL = {}


def point_pool(curve, group) -> list:
    """POOL_POINTS seeded random points of the group, made once a run and
    drawn from by the kernel checks' inputs (a host scalar multiplication
    takes milliseconds, tens of them at BW6-761's 761 bits)."""
    key = (curve.name, group is curve.G2)
    if key not in _POINT_POOL:
        rng = random.Random(f"{curve.name} G{2 if key[1] else 1}")
        G = group.one()
        _POINT_POOL[key] = [G * rng.randrange(1, curve.r)
                            for _ in range(POOL_POINTS)]
    return _POINT_POOL[key]


def host_points(curve, group, k: int, rng):
    """k distinct random points of the group (k <= POOL_POINTS)."""
    return rng.sample(point_pool(curve, group), k)


def jacobian_lanes(ck, fk_rand, aff, idx):
    """Affine host-encoded points gathered to lanes idx, lifted to
    Jacobian with random Z (X = x Z^2, Y = y Z^3)."""
    fk = ck.fk
    x, y = aff[0][..., idx], aff[1][..., idx]
    Z = fk_rand(idx.shape)
    Z2 = fk.sqr(Z)
    return [fk.mul(x, Z2), fk.mul(y, fk.mul(Z2, Z)), Z]


def groups_of(curve, g16, g1_only: bool = False):
    """(curve kernel, MSM kernel, host group, coordinate field degree) of
    G1 and G2 (G2 over Fq2, or over Fq for BW6-761), or of G1 alone."""
    from libsnark_tpu_torch.ops.cuda_ec import ext_of
    out = ((g16.g1, g16.msm_g1, curve.G1, 1),
           (g16.g2, g16.msm_g2, curve.G2, ext_of(g16.g2.fk)))
    return out[:1] if g1_only else out


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
    from libsnark_tpu_torch.ops import cuda_lib
    log("probe: Montgomery-product bodies (2^20 lanes x 64 chained products; "
        "at 19 and 12 limbs 2^16 lanes x 16, fp_mul_half alone at 19: the "
        "plain chain there takes ~0.25 s a product on 2^16 lanes)")
    new = [fk for fk in fqs if fk.N in (12, 19)]
    rows = probes.measure_cios([fk for fk in fqs if fk not in new
                                and fk.nw in cuda_lib.PROBE_WIDTHS])
    rows += probes.measure_cios(new, L=1 << 16, K=16)
    for r in rows:
        key = f"probe_cios_{r['variant']}_n{r['N']}"
        ops = r["lanes"] * r["K"] * r["wide_mads_per_product"]
        K.add("probe_cios", key, 0 if r["exact"] else 1, r["ms"],
              r["plain_ms"], 3 * 4 * r["N"] * r["lanes"], ops)
        log(f"    N={r['N']} {r['variant']}: {r['gproducts_per_s']:.3f} G "
            f"products/s = {ops / r['ms'] / 1e9:.3f}e12 wide mads/s")
    dep = probes.measure_dep_mad()
    if not dep["exact"]:
        raise AssertionError("the dependent multiply-add probe differs from "
                             "its plain chain")
    log(f"probe: one dependent wide multiply-add (IMAD.WIDE.U32, one thread, "
        f"{dep['K']} in a chain): {dep['ns']:.4f} ns")
    log("probe: latency of one dependent product (K chained products over "
        "one element: one thread, or one lane group for 'lanes'); its "
        "latency bound: the multiply-adds every body runs one after another "
        "(probes.dependent_mads: 4 NW) times that latency")
    for r in probes.measure_product_latency(fqs):
        if not r["exact"]:
            raise AssertionError(f"product latency probe N={r['N']} "
                                 f"{r['variant']} differs from its plain chain")
        ms = r["latency_us"] / 1e3
        PRODUCT_LATENCY_MS[r["N"]] = min(PRODUCT_LATENCY_MS.get(r["N"], ms), ms)
        chain = probes.dependent_mads(-(-r["N"] // 2))
        bound_us = chain * dep["ns"] / 1e3
        key = f"probe_cios_{r['variant']}_n{r['N']}"
        if key in K.rows:
            K.rows[key].update(latency_us=r["latency_us"],
                               latency_bound_us=bound_us,
                               dependent_mads=chain)
        log(f"    N={r['N']} {r['variant']}: {r['latency_us']:.4f} us a product "
            f"({r['K']} products in {r['ms']:.4f} ms); latency bound "
            f"{bound_us:.4f} us ({chain} dependent wide multiply-adds) -> "
            f"{r['latency_us'] / bound_us:.2f}x")
    check_layout(K)
    for key, n in probes.LAUNCHES.items():
        if n == 0:
            raise AssertionError(f"probe kernel not launched: {key}")
        if key in K.rows:       # the latency probe alone at 48 limbs: no row
            K.count(key, "probe", n)
    log("probe: instructions in each kernel's main loop (cuobjdump -sass)")
    for key, loop in loops.items():
        log(f"    {key}: {len(loop)} instructions: "
            + (", ".join(f"{n} {opc}" for opc, n in
                         probes.loop_counts(loop).items()) or "no loop"))


def check_mont_mul(fr, fq, K, gen, plain_lanes=None):
    """mont_mul at 2^20 lanes against its plain version on the first
    plain_lanes of them (all by default; lanes are independent)."""
    from libsnark_tpu_torch.ops import cuda_fp
    L = 1 << 20
    P = plain_lanes or L
    log(f"mont_mul: {L} lanes, Fq (N={fq.N}) and Fr (N={fr.N}); plain "
        f"version on {P} lanes")
    for fk in (fq, fr):
        a = plant_edges(fk, rand_field(fk, (L,), gen))
        b = plant_edges(fk, rand_field(fk, (L,), gen)).flip(-1).contiguous()
        out = cuda_fp.mont_mul(fk, a, b)
        plain_in = (a[:, :P].contiguous(), b[:, :P].contiguous())
        plain = cuda_fp.mont_mul_plain(fk, *plain_in)
        err = max_abs_err([out[:, :P]], [plain])
        key = f"mont_mul_n{fk.N}"
        if fk is fq and key not in K.rows:
            ms = cuda_ms(lambda: cuda_fp.mont_mul(fk, a, b), 50)
            pms = cuda_ms(lambda: cuda_fp.mont_mul_plain(fk, *plain_in), 2)
            K.add("mont_mul", key, err, ms, pms, 3 * 4 * fk.N * L,
                  wide_mads(fk) * L, plain_lanes=P)
        elif err:
            raise AssertionError(f"mont_mul ({key}) differs: {err}")


def check_fp_addsub(fr, fq, K, gen, plain_lanes=None):
    """fp_addsub (add and subtract) at 2^20 lanes against its plain version
    (FpKernel.add / sub over int64 limb passes) on the first plain_lanes of
    them (all by default), with 0, 1 and p - 1 planted, and once on limbs
    outside [0, p) (any 16-bit limbs: the same single correction by p);
    the row times the add."""
    from libsnark_tpu_torch.ops import cuda_fp
    L = 1 << 20
    P = plain_lanes or L
    for fk in (fq, fr):
        key = f"fp_addsub_n{fk.N}"
        a = plant_edges(fk, rand_field(fk, (L,), gen))
        b = plant_edges(fk, rand_field(fk, (L,), gen)).flip(-1).contiguous()
        wild = torch.randint(0, 1 << 16, (fk.N, 1 << 12), generator=gen,
                             device="cuda", dtype=torch.int32)
        plain = fk.as_plain()
        err = 0
        for sub in (False, True):
            op = "sub" if sub else "add"
            err = max(err, max_abs_err(
                [cuda_fp.add_sub(fk, a, b, sub)[:, :P]],
                [getattr(plain, op)(a[:, :P], b[:, :P])]))
            err = max(err, max_abs_err(
                [cuda_fp.add_sub(fk, wild, wild.flip(-1), sub)],
                [getattr(plain, op)(wild, wild.flip(-1))]))
        if key in K.rows:
            if err:
                raise AssertionError(f"fp_addsub ({key}) differs: {err}")
            continue
        ms = cuda_ms(lambda: cuda_fp.add_sub(fk, a, b, False), 50)
        pms = cuda_ms(lambda: plain.add(a[:, :P], b[:, :P]), 2)
        K.add("fp_addsub", key, err, ms, pms, 3 * 4 * fk.N * L, 0,
              plain_lanes=P)


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
        row = K.rows[key]
        (row["also"][-1] if "scan_ms" in row else row).update(
            {"scan_lanes": L2, "scan_ms": ms, "scan_bound_ms": b})
        log(f"  {key} at {L2} lanes: bit-exact; kernel {ms:.4f} ms, bound "
            f"{b:.3g} ms")
        # the planted lanes really hit the exceptional cases
        for out in (ck.to_affine(cuda_ec.add(fk, P, Q)),
                    ck.to_affine(cuda_ec.aadd(fk, Pa, Qa))):
            if not bool(out[2][24:40].all()) or bool(out[2][:24].any()):
                raise AssertionError("P == -Q and both-infinity lanes must "
                                     "give infinity, and no other planted lane")


def check_dbl_chain(curve, g16, K, rng, plain_windows=None,
                    g1_only=False):
    """dbl_chain at the keygen's window table (W = 32 windows of c = 8 at a
    254-bit r, 48 at 377 bits) on a random point of each group: bit-exact
    against its plain version (run on a CPU copy of the point: one lane's
    248 doublings of small torch ops take 3-12 s on the card, a fraction of
    that on the host; over the first plain_windows bases, all by default:
    a chain's first bases do not depend on its length) and the per-window
    dbl_n loop it replaced (W - 1 single-lane launches), both timed in a
    replayed CUDA graph, beside the latency bound of its 3 c (W - 1)
    dependent product levels at the least product latency measured in this
    run."""
    from libsnark_tpu_torch import probes
    from libsnark_tpu_torch.ops import cuda_bucket
    c = 8
    W = -(-curve.r.bit_length() // c)
    Wp = min(W, plain_windows or W)
    for ck, mk, group, ext in groups_of(curve, g16, g1_only):
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
                                            Wp)
        pms = (time.perf_counter() - t0) * 1e3           # one call, host
        err = max(max_abs_err([a[..., :Wp].cpu() for a in got], plain),
                  max_abs_err(got, loop()))
        ms = probes._graph_ms(kern, 10)
        loop_ms = probes._graph_ms(loop, 10)
        dbls = c * (W - 1)
        ops = dbls * PRODUCTS["dbl"] * (3 if ext == 2 else 1) * wide_mads(fk)
        lat = latency_bound_ms(key, 3 * dbls)
        log(f"dbl_chain: W={W}, c={c}, ext={ext}, N={fk.N}: {dbls} doublings; "
            f"per-window dbl_n loop {loop_ms:.4f} ms; plain version over "
            f"{Wp} bases")
        K.add("dbl_chain", key, err, ms, pms, 4 * 3 * FW * (W + 1), ops,
              latency_bound_ms=lat, loop_ms=loop_ms, windows=W, c=c,
              plain_windows=Wp)
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


def check_aadd_rows(curve, g16, K, gen, rng, plain_windows=None,
                    g1_only=False):
    """aadd_rows on the first dense chunk of a 2^20-point MSM (c = 15: the
    full windows at the chunk depth dense_depth picks there), points of
    msm_inputs (64 points, one point and scalar in lanes 0-63: P == Q at
    level 0 and a bucket deeper than the chunk; infinity bases; zero
    scalars): bit-exact against its plain version, run window by window (a
    whole chunk of plain limb products does not fit), and against the
    gathered form it replaced (MSMKernel.dense_level0_composed: row gather,
    limb split, infinity mask, the aadd kernel); each form timed in a
    replayed CUDA graph and between CUDA events (the level-0 device time of
    one chunk, old form against new). plain_windows: hold the plain version
    on the chunk's first windows only (all by default)."""
    from libsnark_tpu_torch import probes
    from libsnark_tpu_torch.ops import cuda_ec
    from libsnark_tpu_torch.ops.msm import default_window_bits
    m = 1 << 20
    c = default_window_bits(m)
    for ck, mk, group, ext in groups_of(curve, g16, g1_only):
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
        Wp = min(Wn, plain_windows or Wn)
        plain = [cuda_ec.aadd_rows_plain(fk, *runs, base, half, w, 1, nb)
                 for w in range(w_lo, w_lo + Wp)]
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        # outputs (.., half, Wn nb): the first Wp windows' columns
        err = max(err, max_abs_err([a[..., :Wp * nb] for a in got],
                                   [torch.cat(a, dim=-1)
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
            f"(plain version over {Wp} windows) "
            f"({live} of {2 * L} depths live, {pairs} lanes add two live "
            "rows); gathered form (graph) "
            f"{gathered_ms:.4f} ms; level 0 between CUDA events: gathered "
            f"{ev_gathered_ms:.4f} ms, aadd_rows {ev_ms:.4f} ms "
            f"({ev_ms / ev_gathered_ms:.3f} of before)")
        K.add("aadd_rows", key, err, ms, pms, L * (20 * FW + 8), ops,
              gathered_ms=gathered_ms, events_ms=ev_ms,
              gathered_events_ms=ev_gathered_ms, lanes=L, live_lanes=pairs,
              m=m, c=c, plain_windows=Wp)


def planted_scalar_limbs(r: int, c: int, W: int, rng, nl: int = 16):
    """(nl, 7) int32 scalar limbs on the card: 0, 1, r - 1, every window
    2^c - 1 (all 16 nl bits set), digit 0 in every odd / every even window,
    only the top window nonzero."""
    from libsnark_tpu_torch.ops.limbs import ints_to_limbs
    full = (1 << (16 * nl)) - 1
    digits = lambda keep: sum(rng.randrange(1, 1 << c) << (c * w)
                              for w in range(W) if keep(w)) & full
    top = ((rng.randrange(1 << c) | 1) << (c * (W - 1))) & full
    xs = [0, 1, r - 1, full, digits(lambda w: w % 2 == 0),
          digits(lambda w: w % 2 == 1), top or 1 << (16 * nl - 1)]
    return torch.from_numpy(ints_to_limbs(xs, nl).astype("int32")).cuda()


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


def check_madd_windows(curve, g16, K, gen, rng, plain_lanes=None,
                       g1_only=False):
    """madd_win at the keygen's shape: 2^20 lanes, c = 8 (W = 32 windows at
    a 254-bit r, 48 at 377 bits) on the keygen's own table of each group,
    random scalars below r with planted lanes (planted_scalar_limbs):
    bit-exact against its plain version (on the first plain_lanes lanes,
    all by default: the lanes are independent) and against the per-window
    madd kernel loop that batch_exp ran before it (timed beside it), with
    the bound of the madds these scalars need."""
    from libsnark_tpu_torch.ops import cuda_ec
    m, c = 1 << 20, 8
    P = plain_lanes or m
    for ck, mk, group, ext in groups_of(curve, g16, g1_only):
        fk = mk.fk
        FW = ext * fk.N
        key = cuda_ec.counter_key("madd_win", fk)
        taff, rows = g16._window_table_affine(ck, mk, group.one(), c)
        W = rows.shape[0] >> c
        sc = rand_field(g16.fr, (m,), gen)
        planted = planted_scalar_limbs(curve.r, c, W, rng, g16.fr.N)
        sc[:, :planted.shape[1]] = planted
        kern = lambda: cuda_ec.madd_windows(fk, rows, sc, c)
        loop = lambda: mk.batch_exp_loop(taff, sc, c)
        got = kern()
        err = max_abs_err(got, loop())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = cuda_ec.madd_windows_plain(fk, rows,
                                           sc[:, :P].contiguous(), c)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3           # one call: it is slow
        err = max(err, max_abs_err([a[..., :P] for a in got], plain))
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
            f"{n_madd} madds; per-window madd loop {loop_ms:.4f} ms; plain "
            f"version on {P} lanes")
        MADD_WIN_LANE[key] = (g16.fr.N, W - 1)
        K.add("madd_win", key, err, ms, pms, nbytes, ops, loop_ms=loop_ms,
              lanes=m, windows=W, madds=n_madd, plain_lanes=P)
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
    ints_to_limbs (x % p a value in Python, then int.to_bytes) and by the
    native codec (which reduces only what needs it) in turns (Python,
    codec, codec, Python): each proof equal to the path's; the prove's
    host encoding (its prove_encode phase) under each."""
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


def check_bucket_and_horner(curve, g16, K, gen, rng, m=1 << 16,
                            plain_segments=None, g1_only=False):
    """bucket_reduce on an m-point MSM (msm_inputs) at the path's window
    bits for m, bit-exact against its plain version on plain_segments of
    its segments (all by default; the segments are independent): the
    longest half of them and a random half of the rest. Then check_horner
    at the 2^20-point MSM's windows."""
    from libsnark_tpu_torch.ops import cuda_bucket
    from libsnark_tpu_torch.ops.cuda_ec import counter_key
    from libsnark_tpu_torch.ops.msm import default_window_bits
    for ck, mk, group, ext in groups_of(curve, g16, g1_only):
        fk = mk.fk
        FW = ext * fk.N
        c = default_window_bits(m)
        points, sc = msm_inputs(curve, g16, ck, group, m, gen, rng)
        seg = mk.bucket_segments(sc, c)
        args = (mk.row_table(points), seg["gidx"], seg["seg_start"],
                seg["seg_count"], seg["seg_order"])
        counts = seg["seg_count"]
        nseg = counts.numel()
        sel = torch.arange(nseg, device=counts.device)
        if plain_segments is not None and plain_segments < nseg:
            half = plain_segments // 2
            order = seg["seg_order"]
            rest = order[half:][torch.randperm(
                nseg - half, generator=gen, device=counts.device)]
            sel = torch.sort(torch.cat([order[:half],
                                        rest[:plain_segments - half]]))[0]
        log(f"bucket_reduce: {m}-point MSM, ext={ext}, N={fk.N}, c={c}, "
            f"{seg['num_buckets']} buckets in {nseg} segments, deepest "
            f"segment {int(counts.max())}; plain version on {sel.numel()} "
            "segments")
        out = cuda_bucket.bucket_reduce(fk, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = cuda_bucket.bucket_reduce_plain(
            fk, args[0], args[1], args[2][sel], args[3][sel])
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3       # one call: it is slow
        err = max_abs_err([a[:, sel] for a in out], plain)
        del plain
        ms = cuda_ms(lambda: cuda_bucket.bucket_reduce(fk, *args), 5)
        # data-dependent work: one madd per row in a bucket run
        n_madd = int(counts.sum())
        ops = n_madd * PRODUCTS["madd"] * (3 if ext == 2 else 1) * wide_mads(fk)
        nbytes = (args[0].numel() * 4 + args[1].numel() * 4
                  + args[2].numel() * 8 + args[3].numel() * 4
                  + args[4].numel() * 8 + 3 * FW * 4 * nseg)
        K.add("bucket_reduce", counter_key("bucket_reduce", fk), err, ms, pms,
              nbytes, ops, points=m, c=c, segments=nseg,
              plain_segments=sel.numel())

        check_horner(curve, ck, group, K, gen, rng, mk.num_windows(
            default_window_bits(1 << 20)), default_window_bits(1 << 20))


def rand_fe(fk, shape, gen):
    """Uniform canonical elements of fk (Fp, or Fp2 as two Fp)."""
    if hasattr(fk, "fp"):
        return torch.stack([rand_field(fk.fp, shape, gen),
                            rand_field(fk.fp, shape, gen)])
    return rand_field(fk, shape, gen)


def horner_windows(curve, group, W: int, c: int, rng):
    """Planted window sums S_0 .. S_(W-1) for horner_combine, as (label,
    host points): random (distinct points of point_pool); an infinity
    window (in the middle, or S_0 at W = 2); an infinity top window;
    S_(W-2) = 2^c S_(W-1), so that the first add meets P == Q; S_0 = -(sum
    of the rest), a result at infinity. W = 1: random and infinity."""
    rnd = lambda: host_points(curve, group, W, rng)
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
    result has Z = 0 (the plain version runs on CPU copies: its chains of
    small torch ops are launch-bound on the card). Then the time at the
    path's shape (W_path, c_path), with the
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
            cases = horner_windows(curve, group, W, c, rng)
            S = []
            for _, pts in cases:
                X, Y, Z = ck.encode_points(pts, device="cuda")
                z = rand_fe(fk, (W,), gen)
                z2 = fk.sqr(z)
                S.append([a.reshape(FW, W) for a in (
                    fk.mul(X, z2), fk.mul(Y, fk.mul(z2, z)), fk.mul(Z, z))])
            # the plain version on the host: one chain of small torch ops
            # a case, launch-bound on the card
            batch = tuple(torch.stack([s[i] for s in S], dim=-1).cpu()
                          for i in range(3))
            t0 = time.perf_counter()
            want = cuda_bucket.horner_combine_plain(fk, batch, c)
            pms = (time.perf_counter() - t0) * 1e3
            for b, (label, pts) in enumerate(cases):
                got = cuda_bucket.horner_combine(fk, S[b], c)
                if max_abs_err([a.cpu() for a in got],
                               [a[:, b:b + 1] for a in want]):
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
        f"{lat:.4f} ms; plain over {ncase} chains (host) {pms:.1f} ms")
    K.add("horner_combine", key, 0, ms, pms, 4 * 3 * FW * (W_path + 1), ops,
          latency_bound_ms=lat)


def check_dense_window_sums(curve, g16, gen, rng, g1_only=False):
    """The dense strategy's window sums equal the default strategy's as
    affine points on a 2^16-point MSM: random scalars (planted cases as in
    msm_inputs), then 4096 all-equal scalars, which put 4096 points into
    one bucket of every window and send the chunk loop through it."""
    from libsnark_tpu_torch.ops import cuda_ec
    from libsnark_tpu_torch.ops.msm import MSMKernel, default_window_bits
    m = 1 << 16
    c = default_window_bits(m)
    lanes = lambda S: tuple(a.movedim(0, -2) for a in S)       # (.., W, 1)
    for ck, mk, group, ext in groups_of(curve, g16, g1_only):
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

def auth_labels(k: int) -> list:
    """The labels of ADSNARK's k authenticated inputs."""
    return [f"input{i}".encode() for i in range(k)]


def adsnark_keygen(ps, circuit, timings=None):
    """ADSNARK's seeded authority keys (kept on ps) and keypair."""
    ps.auth_keys = ps.auth_generator(seed=3)
    return ps.generator(circuit, ps.auth_keys.pap, seed=5, timings=timings)


def adsnark_prove(ps, kp, primary, aux, timings=None):
    """The inputs' authenticated data (seeded, kept on ps) and the proof."""
    ps.auth_data = ps.auth_sign(primary, ps.auth_keys.sak,
                                auth_labels(len(primary)), seed=4)
    return ps.prover(kp.pk, primary, aux, ps.auth_data, seed=9,
                     timings=timings)


def adsnark_verify(ps, kp, primary, proof) -> list:
    """The calls of both verifiers, symmetric and public, on the data
    adsnark_prove authenticated."""
    labels = auth_labels(len(primary))
    return [("verifier_sec", (kp.vk, proof, ps.auth_keys.sak, labels)),
            ("verifier_pub", (kp.vk, ps.auth_data, proof, ps.auth_keys.pak,
                              labels))]


def ram_arith_program():
    """tests/test_ram_universal.py's arithmetic program: r0 = 9 + 33 - 42,
    answer r0 (accepted)."""
    from libsnark_tpu_torch.relations.tinyram import Opcode, TinyRAMProgram
    prog = TinyRAMProgram()
    prog.add(Opcode.MOV, True, 0, 0, 9)
    prog.add(Opcode.ADD, True, 0, 0, 33)
    prog.add(Opcode.SUB, True, 0, 0, 42)
    prog.add(Opcode.ANSWER, False, 0, 0, 0)
    return prog


def ram_prove(ps, kp, program, aux):
    """ram_prover's proof; its boot input (the statement) kept on ps."""
    proof, ps.ram_boot = ps.ram_prover(kp.pk, program, [], aux, seed=9)
    return proof


def small_systems(curve_name: str, r: int):
    """The cross-check of each pairing system over the curve: (label,
    class, the circuit's generator, keygen, prover, verifier calls (the
    (method, args) whose verdicts must all be true), corrupt (a proof with
    one point moved, or None)). alt_bn128: Groth16, BCTV14, GM17, DFGK14,
    BACS, TBCS, ADSNARK (Schnorr) at about 20 constraints, and the RAM
    ppzkSNARK on the universal circuit of TinyRAM with w = 16, k = 4,
    boot-trace and time bounds 5 (4,765 constraints); BW6-761: Groth16;
    MNT4, MNT6, edwards: Groth16."""
    from libsnark_tpu_torch.proof_systems.adsnark import ADSNARK
    from libsnark_tpu_torch.proof_systems.bacs_ppzksnark import BACSPpzksnark
    from libsnark_tpu_torch.proof_systems.bctv14 import BCTV14
    from libsnark_tpu_torch.proof_systems.dfgk14 import DFGK14
    from libsnark_tpu_torch.proof_systems.gm17 import GM17
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.proof_systems.ram_ppzksnark import RAMPpzksnark
    from libsnark_tpu_torch.proof_systems.tbcs_ppzksnark import TBCSPpzksnark
    from libsnark_tpu_torch.relations import examples as ex
    from libsnark_tpu_torch.relations.tinyram import TinyRAMParams

    def moved(field):
        def corrupt(proof, one):
            return dataclasses.replace(proof, **{field: getattr(
                proof, field) + one})
        return corrupt

    r1cs = lambda: ex.generate_r1cs_example(r, 20, 2)
    plain = (lambda ps, c: ps.generator(c, seed=5),
             lambda ps, kp, p, a: ps.prover(kp.pk, p, a, seed=9),
             lambda ps, kp, p, proof: [("verifier_strong_IC",
                                        (kp.vk, p, proof))])
    if curve_name in ("bw6_761",) + GENERIC_A_CURVES:
        return (("Groth16", Groth16, r1cs) + plain + (moved("g_C"),),)
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
         lambda ps, kp, p, proof: [("verifier_strong_IC",
                                    (kp.vk, p, proof))],
         None),
        # 8 gates: 8 + 10 wires + 1 output = 19 constraints (2g + 3 is odd)
        ("TBCS", TBCSPpzksnark, lambda: ex.generate_tbcs_example(8, 2),
         lambda ps, c: ps.tbcs_generator(c, seed=5),
         lambda ps, kp, p, a: ps.tbcs_prover(kp.pk, p, a, seed=9),
         lambda ps, kp, p, proof: [("tbcs_verifier_strong_IC",
                                    (kp.vk, p, proof))],
         None),
        ("ADSNARK", ADSNARK, r1cs, adsnark_keygen, adsnark_prove,
         adsnark_verify, moved("g_H")),
        ("RAM", RAMPpzksnark,
         lambda: ((TinyRAMParams(w=16, k=4), 5, 5), ram_arith_program(), []),
         lambda ps, c: ps.ram_generator(*c, seed=5), ram_prove,
         lambda ps, kp, p, proof: [("ram_verifier",
                                    (kp.vk, ps.ram_boot, proof))],
         moved("g_H")))


# the curves with an a-coefficient (the mnt path)
GENERIC_A_CURVES = ("mnt4", "mnt6", "edwards")
SMALL_CURVES = ("alt_bn128", "bw6_761") + GENERIC_A_CURVES


def proof_coords(x):
    """A proof's points (G1, G2, knowledge commitments, dataclasses of
    them) as plain integer coordinates, None for infinity: what a worker
    process can hand back."""
    if dataclasses.is_dataclass(x):
        return tuple(proof_coords(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if hasattr(x, "g") and hasattr(x, "h"):              # KnowledgeCommitment
        return (proof_coords(x.g), proof_coords(x.h))
    return point_coords(x)


def point_coords(P):
    """A host point of G1 or G2 as integers (None: infinity), what a worker
    process can take: (x, y) over Fq, ((x0, x1), (y0, y1)) over Fq2,
    ((x0, x1, x2), (y0, y1, y2)) over Fq3."""
    if P.is_zero():
        return None
    if hasattr(P.x, "c0"):
        cs = ("c0", "c1", "c2") if hasattr(P.x, "c2") else ("c0", "c1")
        return tuple(tuple(int(getattr(v, c)) for c in cs)
                     for v in (P.x, P.y))
    return (int(P.x), int(P.y))


# the curves whose host points and field elements cross to VerifierPool's
# workers
HOST_CURVES = ("alt_bn128", "bls12_377", "bw6_761") + GENERIC_A_CURVES


def host_field_element(curve_name: str, attr: str, comps):
    """A host field element of get_curve(curve_name).<attr> from an integer
    (a prime field) or its components (an extension)."""
    from libsnark_tpu_torch import get_curve
    F = getattr(get_curve(curve_name), attr)
    return F(*comps) if isinstance(comps, tuple) else F(comps)


def host_point(curve_name: str, attr: str, xy):
    """A point of get_curve(curve_name).<attr> (G1 or G2); xy None is
    infinity."""
    from libsnark_tpu_torch import get_curve
    group = getattr(get_curve(curve_name), attr)
    return group.zero() if xy is None else group.point(*xy)


class HostPickler(pickle.Pickler):
    """Pickles the port's host points and field elements (their classes
    are made at run time, so the default pickler cannot name them) by
    curve, attribute and integers."""

    def __init__(self, f):
        from libsnark_tpu_torch import get_curve
        from libsnark_tpu_torch.curves.host_ec import ECGroup
        super().__init__(f)
        self.names = {}
        for name in HOST_CURVES:
            for attr, v in vars(get_curve(name)).items():
                if isinstance(v, (type, ECGroup)):
                    self.names[id(v)] = (name, attr)

    def reducer_override(self, obj):
        if hasattr(obj, "group") and hasattr(obj, "is_zero"):
            xy = None if obj.is_zero() else (obj.x, obj.y)
            return host_point, self.names[id(obj.group)] + (xy,)
        where = self.names.get(id(type(obj)))
        if where is None:
            return NotImplemented
        comps = tuple(getattr(obj, c) for c in ("c0", "c1", "c2")
                      if hasattr(obj, c))
        return host_field_element, where + (comps or int(obj),)


def host_dumps(obj) -> bytes:
    buf = io.BytesIO()
    HostPickler(buf).dump(obj)
    return buf.getvalue()


# a worker's systems, by (class, curves, keyword arguments)
WORKER_SYSTEMS = {}


def verify_worker(blob: bytes) -> bool:
    """One verifier call in a worker process of VerifierPool: the system,
    made on the CPU over the same curves (the verifiers are host code), and
    its method on the arguments; a plain bool."""
    import importlib
    from libsnark_tpu_torch import get_curve
    module, name, curves, kwargs, method, args = pickle.loads(blob)
    key = (module, name, curves, tuple(sorted(kwargs.items())))
    if key not in WORKER_SYSTEMS:
        cls = getattr(importlib.import_module(module), name)
        WORKER_SYSTEMS[key] = cls(*map(get_curve, curves), device="cpu",
                                  **kwargs)
    return bool(getattr(WORKER_SYSTEMS[key], method)(*args))


class VerifierPool:
    """Runs whole verifier calls in worker processes, so the calls a path
    makes (the accepted proof and each rejection) run at once: each call
    is the port's own verifier, on a system made over the same curves, and
    its verdict comes back as a plain bool."""

    def __init__(self, workers: int):
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"))

    def submit(self, ps, method: str, *args, **system_kwargs):
        """ps.<method>(*args) in a worker (system_kwargs: the keyword
        arguments ps was made with, other than its curves and device): a
        future of its bool."""
        curves = ((ps.inner.name, ps.outer.name) if hasattr(ps, "inner")
                  else (ps.A.name, ps.B.name) if hasattr(ps, "A")
                  else (ps.curve.name,))
        cls = type(ps)
        return self.pool.submit(verify_worker, host_dumps(
            (cls.__module__, cls.__qualname__, curves, system_kwargs,
             method, args)))

    def verdicts(self, ps, calls, **system_kwargs) -> list:
        """[ps.<method>(*args) for (method, args) in calls], all submitted
        before the first is read: a list of bools."""
        futures = [self.submit(ps, method, *args, **system_kwargs)
                   for method, args in calls]
        return [f.result() for f in futures]

    def shutdown(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


# set by main(): the verifier calls of every path go through it
VERIFIERS = None


def cpu_proof(label: str, curve_name: str):
    """small_systems' proof of ``label``, made by the plain versions on the
    CPU (one thread; run in a worker process): (integer coordinates, the
    worker's seconds). The keys come from the host fixed-base path (the
    same affine points as the device path)."""
    from libsnark_tpu_torch import get_curve
    torch.set_num_threads(1)
    curve = get_curve(curve_name)
    for name, cls, make, keygen, prove, _, _ in small_systems(curve_name,
                                                              curve.r):
        if name == label:
            circuit, primary, aux = make()
            ps = cls(curve, device="cpu")
            ps.host_keygen = True
            t0 = time.perf_counter()
            proof = prove(ps, keygen(ps, circuit), primary, aux)
            return proof_coords(proof), time.perf_counter() - t0
    raise KeyError(label)


def start_cpu_proofs():
    """The CPU plain proofs of small_cross_check, one worker process each,
    all started at once: (the pool, {(curve, label): future})."""
    from libsnark_tpu_torch import get_curve
    labels = [(name, entry[0]) for name in SMALL_CURVES
              for entry in small_systems(name, get_curve(name).r)]
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(labels),
        mp_context=multiprocessing.get_context("spawn"))
    return pool, {(name, label): pool.submit(cpu_proof, label, name)
                  for name, label in labels}


def small_cross_check(cpu):
    """small_systems' circuits (about 20 constraints; the RAM ppzkSNARK's
    4,765): the proof on the card (keygen on the device fixed-base path)
    == the proof made by the plain versions on the CPU (cpu:
    start_cpu_proofs' futures, made in worker processes beside the card's
    work; each line gives the worker's seconds and how long this process
    waited for it), and it verifies (ADSNARK: both verifiers); where
    small_systems names a corruption, a proof with one point moved is
    rejected."""
    from libsnark_tpu_torch import get_curve
    systems = [(get_curve(name), entry) for name in SMALL_CURVES
               for entry in small_systems(name, get_curve(name).r)]
    t0 = time.perf_counter()
    for curve, (label, cls, make, keygen, prove, verify,
                corrupt) in systems:
        t1 = time.perf_counter()
        circuit, primary, aux = make()
        ps = cls(curve)                                # device="cuda"
        kp = keygen(ps, circuit)
        proof = prove(ps, kp, primary, aux)
        calls = verify(ps, kp, primary, proof)
        bad = ([] if corrupt is None else
               verify(ps, kp, primary, corrupt(proof, curve.G1.one())))
        verdicts = VERIFIERS.verdicts(ps, calls + bad)
        if not all(verdicts[:len(calls)]):
            raise AssertionError(f"{label}: card proof rejected")
        rejected = corrupt is not None and not all(verdicts[len(calls):])
        if corrupt is not None and not rejected:
            raise AssertionError(f"{label}: a corrupted proof was "
                                 "accepted")
        t_card = time.perf_counter() - t1
        t1 = time.perf_counter()
        cpu_coords, t_cpu = cpu[curve.name, label].result()
        waited = time.perf_counter() - t1
        if proof_coords(proof) != cpu_coords:
            raise AssertionError(f"{label} {curve.name}: card proof != "
                                 "CPU plain proof")
        log(f"seeded {label} {curve.name} proof: card == CPU plain, "
            "verifies" + (", corrupted proof rejected" if rejected
                          else "")
            + f" (card side {t_card:.1f} s, CPU worker {t_cpu:.1f} s, "
              f"waited {waited:.1f} s, elapsed "
              f"{time.perf_counter() - t0:.1f} s)")


def main_path(curve, log2: int, paths: dict, circuit=None,
              extras: bool = True):
    """Keygen (under the device profiler, paths["keygen_<curve>"], and the
    port's phase blocks), prove (default strategy), prove (dense strategy),
    verify. Counts are set to 0 just before each phase and read just after.
    Then one more prove of each strategy under the device profiler
    (paths["prove_<curve>"], paths["prove_dense_<curve>"]), the keygen's
    fixed-base phase again with the per-window madd loop and with
    madd_windows (fixed_base_before_after), its window tables with the
    dbl_n loop (window_table_before_after), a dense prove with the gathered
    level 0 (dense_gathered_prove) and, with extras, the prove's encoding
    in turns and the device time of a G1 and a G2 MSM by part. circuit: the circuit from a
    worker (receive_circuit's entry), else it is made here. Returns the
    path's launches per kernel (the three phases added up) and {run:
    launches} of the yardstick runs that count the kernels the path
    replaced (the single madd, the public dbl and aadd)."""
    from libsnark_tpu_torch.ops.cuda_ec import counter_key
    from libsnark_tpu_torch.ops.msm import default_window_bits
    from libsnark_tpu_torch.profiling import PROFILER, start_profiling
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    from libsnark_tpu_torch.relations.examples import generate_r1cs_example
    n = (1 << log2) - 3
    t0 = time.perf_counter()
    if circuit is None:
        cs, primary, aux = generate_r1cs_example(curve.r, n, 2)
        made = "(host)"
    else:
        (cs, primary, aux), secs = receive_circuit(circuit)
        made = (f"(host, a worker process: {secs:.2f} s), received in")
    log(f"main path {curve.name}: generate_r1cs_example(r, 2^{log2} - 3, 2) "
        f"{made} {time.perf_counter() - t0:.2f} s")
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
    bad_input = list(primary)
    bad_input[0] = (bad_input[0] + 1) % curve.r
    tam = type(proof)(g_A=proof.g_A, g_B=proof.g_B,
                      g_C=proof.g_C + curve.G1.one())
    ok, bad_ok, tam_ok = VERIFIERS.verdicts(g16, [
        ("verifier_strong_IC", (kp.vk, primary, proof)),
        ("verifier_strong_IC", (kp.vk, bad_input, proof)),
        ("verifier_strong_IC", (kp.vk, primary, tam))])
    rej_input, rej_proof = not bad_ok, not tam_ok
    log(f"  proofs equal under both strategies; verify "
        f"{time.perf_counter() - t0:.2f} s (host, three calls in "
        f"workers): accepted={ok} "
        f"wrong-input-rejected={rej_input} corrupted-proof-rejected={rej_proof}")
    if not (ok and rej_input and rej_proof):
        raise AssertionError("Groth16 verification checks failed")

    for strategy, label in (("segments", "prove"), ("dense", "prove_dense")):
        timed = path_timing(f"{label}_{curve.name}", lambda: systems[
            strategy].prover(kp.pk, primary, aux, seed=9), paths)
        if timed != proof:
            raise AssertionError(f"the profiled proof ({strategy}) differs")
    more = {}
    if curve.name == "bls12_377":
        if caller_split(f"prove_{curve.name}", lambda: g16.prover(
                kp.pk, primary, aux, seed=9), paths) != proof:
            raise AssertionError("the proof under PortCallers differs")
        # the multi-device prover (one rank) and the MXU NTT on this path's
        # keypair, witness and seeded proof
        t0 = time.perf_counter()
        more[f"prove_sharded_{curve.name}"] = sharded_phase(
            curve, g16, kp, primary, aux, proof)
        log(f"  sharded phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        more.update(mxu_phase(paths))
        log(f"  mxu phase {time.perf_counter() - t0:.1f} s")
    total = path_totals(phases, curve.name, [
        f"mont_mul_n{g16.fq.N}", f"mont_mul_n{g16.fr.N}"] + [
        counter_key(k, ck.fk) for k in (
            "dbl_chain", "add", "madd_win", "aadd_rows", "bucket_reduce",
            "horner_combine") for ck in (g16.g1, g16.g2)])
    if extras:
        prove_encode_in_turns(g16, kp, primary, aux, proof, curve.name)
    # the kernels the path no longer runs count where their forms still do
    # (their times in the card's turn: the cycle process may be running)
    with card_turn():
        yardsticks = {
            f"prove_dense_gathered_{curve.name}": dense_gathered_prove(
                curve, systems["dense"], kp, primary, aux, proof),
            # (without extras on 2^16 scalars: a yardstick, not the keygen)
            f"fixed_base_loop_{curve.name}": {
                k: n for k, n in fixed_base_before_after(
                    curve, g16, kp.pk.H_query[0].shape[-1] if extras
                    else 1 << 16).items()
                if k.startswith("madd_fp")},
            f"window_table_loop_{curve.name}":
                window_table_before_after(curve, g16),
            **more}
    if not extras:
        return total, yardsticks
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

    return total, yardsticks


def sharded_phase(curve, g16, kp, primary, aux, proof) -> dict:
    """The multi-device prover on the card over a one-rank NCCL group (a
    ``file://`` rendezvous in a temporary directory; the group is destroyed
    whatever happens): prover_sharded with the path's keypair, witness and
    seed, twice (the first builds the four-step tables), each proof equal
    to the path's prover proof bit for bit, verified and rejected for a
    changed primary input; the four-step NTT at the path's domain size
    against its Radix2Domain (fft, ifft, icoset_fft_divz: equal limbs, CUDA-event
    times); msm_simple on 2^12 points of the A query against the Pippenger
    MSM (equal affine limbs). One card: NCCL refuses two ranks on one
    device, so D = 1 here and D > 1 is held by the CPU tests over gloo.
    Returns the launches of its phases."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from libsnark_tpu_torch.ops.cuda_ec import counter_key
    from libsnark_tpu_torch.parallel.msm_sharded import sharded_msm
    from libsnark_tpu_torch.parallel.ntt_sharded import FourStepDomain
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    phases = {}
    tmp = tempfile.mkdtemp(prefix="lsn_nccl_")
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0)
    try:
        log(f"sharded: NCCL process group (world size "
            f"{dist.get_world_size()}) in {time.perf_counter() - t0:.3f} s")
        for label in ("prove_sharded", "prove_sharded[again]"):
            got = timed_phase(phases, label, lambda t: g16.prover_sharded(
                kp.pk, primary, aux, seed=9, timings=t))
            if got != proof:
                raise AssertionError(f"{label}: the sharded proof differs "
                                     "from the path's prover proof")
        bad = [(primary[0] + 1) % curve.r] + list(primary[1:])
        t1 = time.perf_counter()
        ok, bad_ok = VERIFIERS.verdicts(g16, [
            ("verifier_strong_IC", (kp.vk, primary, got)),
            ("verifier_strong_IC", (kp.vk, bad, got))])
        log(f"  sharded proof equal to the path's proof; verify "
            f"{time.perf_counter() - t1:.2f} s: accepted={ok} "
            f"wrong-input-rejected={not bad_ok}")
        if not ok or bad_ok:
            raise AssertionError("the sharded proof's verification failed")
        with card_turn():
            fr = g16.fr
            ref = g16.domain_for(qap_domain, kp.pk.r1cs_dev)
            t1 = time.perf_counter()
            fs = FourStepDomain(fr, curve.fr_params, ref.logm)
            fs.device_tables()
            torch.cuda.synchronize()
            log(f"  four-step domain 2^{ref.logm} (n1 {fs.n1}, n2 {fs.n2}): "
                f"tables {time.perf_counter() - t1:.3f} s")
            gen = torch.Generator(device="cuda").manual_seed(81)
            a = rand_field(fr, (ref.m,), gen)
            for name in ("fft", "ifft", "icoset_fft_divz"):
                got_t = getattr(fs, name)(a)
                if not torch.equal(got_t, getattr(ref, name)(a)):
                    raise AssertionError(f"four-step {name} differs from "
                                         "Radix2Domain's")
                ms = cuda_ms(lambda: getattr(fs, name)(a), 3)
                r2 = cuda_ms(lambda: getattr(ref, name)(a), 3)
                log(f"  four-step {name} at 2^{ref.logm}: equal limbs; "
                    f"{ms:.3f} ms, radix-2 {r2:.3f} ms")
            m = 1 << 12
            P = tuple(x[..., :m] for x in kp.pk.A_query)
            sc = rand_field(fr, (m,), gen)      # canonical: plain scalars
            want = g16.msm_affine("g1", P, sc, 8)
            t1 = time.perf_counter()
            simple = g16.g1.to_affine(g16.msm_g1.msm_simple(P, sc))
            torch.cuda.synchronize()
            t_simple = time.perf_counter() - t1
            if max_abs_err(simple, want):
                raise AssertionError("msm_simple differs from Pippenger")
            got_s = sharded_msm(g16.msm_g1, None, P, sc, c=8, affine=True,
                                method="simple")
            if max_abs_err(got_s, want):
                raise AssertionError("sharded_msm(method=simple) differs")
            log(f"  msm_simple on {m} points: equal to Pippenger's affine "
                f"sum, {t_simple:.3f} s (dbl and madd launches a bit)")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    total = phase_totals(phases)
    require_launched("the sharded prove", total, [
        f"mont_mul_n{g16.fq.N}", f"mont_mul_n{g16.fr.N}"] + [
        counter_key(k, ck.fk) for k in (
            "add", "bucket_reduce", "horner_combine")
        for ck in (g16.g1, g16.g2)])
    return total


_GEMM = re.compile(r"gemm|xmma|cutlass|nvjet|imma|s8s8|bf16", re.I)


def mxu_phase(paths: dict) -> dict:
    """The MXU NTT (ops/ntt_mxu.py) on the card at 2^20 over BLS12-377's
    Fr, both operand types: the domain made with mxu=True against the
    radix-2 forms (fft, ifft, icoset_fft_divz: equal limbs), each timed
    (CUDA events) beside the radix-2 form with its launches (mul_wide,
    matrix products); the forward forms once more under the device
    profiler, the shares of the matrix products (_int_mm / the bf16 mm,
    by kernel name) and of mul_wide in its device time; _int_mm and the
    bf16 product alone at the level's shapes; the forward form over
    BW6-761's Fr (24 limbs) against its radix-2 form. Returns {run:
    launches}."""
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.ops import (launch_counts, ntt_mxu,
                                        reset_launch_counts)
    from libsnark_tpu_torch.ops.fp import FpKernel
    from libsnark_tpu_torch.ops.ntt import Radix2Domain
    counts = {}
    gen = torch.Generator(device="cuda").manual_seed(92)
    for cname, logm, dtypes in (("bls12_377", 20, ("int8", "bf16")),
                                ("bw6_761", 20, ("int8",))):
        curve = get_curve(cname)
        fr = FpKernel(curve.fr_params)
        ref = Radix2Domain(fr, curve.fr_params, logm)
        a = rand_field(fr, (1 << logm,), gen)
        label = f"ntt_mxu_{cname}"
        counts[label] = {}
        names = (("fft", "ifft", "icoset_fft_divz") if cname == "bls12_377"
                 else ("fft",))
        with card_turn():
            for dtype in dtypes:
                mx = Radix2Domain(fr, curve.fr_params, logm, mxu=True,
                                  dtype=dtype)
                t0 = time.perf_counter()
                for kind in ("fwd", "inv", "icoset_divz"):
                    mx.mxdft(kind).device_tables()
                torch.cuda.synchronize()
                log(f"mxu {cname} {dtype} 2^{logm}: tables "
                    f"{time.perf_counter() - t0:.3f} s (three kinds)")
                for name in names:
                    reset_launch_counts()
                    mm0 = ntt_mxu.MATMULS[dtype]
                    got = getattr(mx, name)(a)
                    n = {k: v for k, v in launch_counts().items() if v}
                    mm = ntt_mxu.MATMULS[dtype] - mm0
                    for k, v in n.items():
                        counts[label][k] = counts[label].get(k, 0) + v
                    if not torch.equal(got, getattr(ref, name)(a)):
                        raise AssertionError(f"mxu {cname} {dtype} {name} "
                                             "differs from the radix-2 form")
                    ms = cuda_ms(lambda: getattr(mx, name)(a), 5)
                    r2 = cuda_ms(lambda: getattr(ref, name)(a), 5)
                    log(f"  {name}: equal limbs; {ms:.3f} ms against the "
                        f"radix-2 form's {r2:.3f} ms ({r2 / ms:.2f}x); "
                        f"launches {json.dumps(n)}, {mm} matrix products")
                if cname != "bls12_377":
                    continue
                _, rows, busy, wall, _, _, others = profiled_rows(
                    lambda: mx.fft(a))
                kern = sum(r["ms"] for r in rows.values())
                gemm = sum(ms for ms, _, nm in others if _GEMM.search(nm))
                paths[f"ntt_mxu_{dtype}_{cname}"] = {
                    "kernels": rows, "busy_ms": busy, "wall_ms": wall,
                    "matmul_ms": gemm, "other_ms": sum(o[0] for o in others),
                    "other_ops": [{"name": nm[:120], "launches": k, "ms": ms}
                                  for ms, k, nm in others[:5]]}
                log(f"  fft profiled: wall {wall:.3f} ms, device busy "
                    f"{busy:.3f} ms; matrix products {gemm:.3f} ms "
                    f"({gemm / busy:.1%}), mul_wide {kern:.3f} ms "
                    f"({kern / busy:.1%}), the rest {busy - gemm - kern:.3f}"
                    " ms; largest others: " + "; ".join(
                        f"{nm[:60]} {ms:.3f} ms x{k}"
                        for ms, k, nm in others[:4]))
                # the products alone at the top level's shapes (2^16
                # subproblems of radix 16; the fold over 2^20 lanes)
                mxd = mx.mxdft("fwd")
                tb = mxd.device_tables()
                for what, W, B in (("dft", tb["AM"][0], 1 << (logm - 4)),
                                   ("fold", tb["fold"], 1 << logm)):
                    xT = torch.randint(0, 16, (B, W.k), generator=gen,
                                       device="cuda", dtype=torch.int8)
                    ms = cuda_ms(lambda: W.matmul(xT), 5)
                    ops = 2 * B * W.k * W.rows
                    peak = 1979e12 if dtype == "int8" else 989e12
                    b_ms, by = bound_ms(B * W.k + W.k * W.rows
                                        + 4 * B * W.rows, ops, peak)
                    log(f"  {dtype} product alone ({what}: {B} x {W.k} by "
                        f"{W.k} x {W.rows}): {ms:.4f} ms, bound {b_ms:.4f} ms"
                        f" ({by}), {ops / ms / 1e9:.1f} TOP/s")
        log(f"  launches {label}: {json.dumps(counts[label])}")
    return counts


def phase_totals(phases: dict) -> dict:
    """The launches of a path's phases added up."""
    total = {}
    for counts in phases.values():
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
    return total


def require_launched(label: str, total: dict, need):
    """Fails if a kernel of ``need`` launched in none of the path's phases
    or if the public dbl or aadd launched there."""
    missing = [key for key in need if not total.get(key)]
    replaced = [key for key in total if key.startswith(("dbl_fp", "aadd_fp"))]
    if missing or replaced:
        raise AssertionError(f"{label}: kernels not launched {missing}, "
                             f"public dbl / aadd launched {replaced}")


def path_totals(phases: dict, label: str, need) -> dict:
    """The launches of a Groth16 path's phases (keygen, prove[segments],
    prove[dense]) added up. Fails if a kernel of ``need`` launched in none
    of them, if the public dbl or aadd launched, or if aadd_rows launched
    outside the dense strategy."""
    level0 = [k for p in ("keygen", "prove[segments]")
              for k, v in phases[p].items() if v and
              k.startswith("aadd_rows_")]
    if level0:
        raise AssertionError(f"aadd_rows launched outside the dense "
                             f"strategy: {level0}")
    total = phase_totals(phases)
    require_launched(f"the {label} main path", total, need)
    return total


def timed_phase(phases: dict, label: str, fn):
    """fn(timings) with the counts set to 0 just before and read just after
    (phases[label]); logs its wall time, its phases, the peak device memory
    and the launches."""
    from libsnark_tpu_torch.ops import launch_counts, reset_launch_counts
    waited = TURN_WAITED
    # the path's process takes its turns in the phase, around its calls
    # that run on the card (their waits are in its wall time)
    with contextlib.nullcontext() if IN_PATH_PROCESS else card_turn():
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
    if TURN_WAITED > waited:
        log(f"  {label}: waited {TURN_WAITED - waited:.3f} s for the card's "
            "turn (" + ("in" if IN_PATH_PROCESS else "before") + " its wall "
            "time)")
    log(f"  {label}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        + json.dumps(phases[label]))
    return out


def make_circuit(conn, kind: str, r: int, n: int, k: int = 2):
    """generate_r1cs_example(r, n, k) ("r1cs") or generate_uscs_example(r,
    n, k) ("uscs") in a worker process: sends (circuit, host seconds) on
    ``conn``, which blocks until the parent reads it."""
    from libsnark_tpu_torch.relations import examples as ex
    make = ex.generate_uscs_example if kind == "uscs" else \
        ex.generate_r1cs_example
    t0 = time.perf_counter()
    out = make(r, n, k)
    conn.send((out, time.perf_counter() - t0))
    conn.close()


# ADSNARK's authenticated inputs on its path
ADSNARK_INPUTS = 16
# worker processes of the verifier calls (VerifierPool)
VERIFIER_WORKERS = 6


def systems_circuits(systems_log2: int, new_log2: int,
                     adsnark_log2: int, mnt_log2: int,
                     edwards_log2: int) -> dict:
    """The circuits of proof_systems_path (alt_bn128, domains of
    2^systems_log2), of adsnark_path (alt_bn128, 2^adsnark_log2 - 3
    constraints, 16 inputs), of the BW6-761 Groth16 path (2^new_log2 -
    3 constraints) and of the mnt path (MNT4 and MNT6 at 2^mnt_log2 - 3
    constraints, edwards at 2^edwards_log2 - 3), each made in a worker
    process of its own while the
    earlier paths run: {name: (process, the pipe's read end)}. A circuit
    crosses to this process only when receive_circuit reads it (a
    background receiver would unpickle it under the interpreter lock in
    the middle of another path)."""
    from libsnark_tpu_torch import get_curve
    ctx = multiprocessing.get_context("spawn")
    r, r6 = get_curve("alt_bn128").r, get_curve("bw6_761").r
    log2 = systems_log2
    out = {}
    for name, kind, rr, n, k in (
            ("bctv14", "r1cs", r, (1 << log2) - 3, 2),
            ("gm17", "r1cs", r, (1 << (log2 - 1)) - 3, 2),
            ("dfgk14", "uscs", r, 1 << log2, 2),
            ("adsnark", "r1cs", r, (1 << adsnark_log2) - 3,
             ADSNARK_INPUTS),
            ("bw6_761", "r1cs", r6, (1 << new_log2) - 3, 2)) + tuple(
                (name, "r1cs", get_curve(name).r,
                 (1 << (edwards_log2 if name == "edwards" else mnt_log2))
                 - 3, 2) for name in GENERIC_A_CURVES):
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=make_circuit, args=(send, kind, rr, n, k),
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


def generic_a_path(curve, log2: int, paths: dict, circuit) -> dict:
    """Groth16 over a curve with an a-coefficient (MNT4, MNT6, edwards) on
    generate_r1cs_example(r, 2^log2 - 3, 2) (circuit: its worker's entry)
    through the entry points: a seeded keygen (device fixed-base path)
    profiled as it runs (paths["keygen_<curve>"]), a prove under the
    default strategy name, which takes the dense layout and the Horner
    loop (bucket_reduce and horner_combine must not launch), profiled
    (paths["prove_<curve>"]), the verifier calls (accepted, a wrong input
    rejected) started in VERIFIERS' workers, and one scalar_mul_const per
    group against the host. The group law is the torch formulas over the product
    and add kernels: mont_mul and fp_addsub at Fq's and Fr's width must
    launch, and no group kernel may. Returns the path's launches per kernel
    and the futures of the two verifier calls (the proof, then a wrong
    input), submitted to VERIFIERS."""
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    (cs, primary, aux), secs = receive_circuit(circuit)
    log(f"mnt path {curve.name}: generate_r1cs_example(r, 2^{log2} - 3, 2) "
        f"(host, a worker process: {secs:.2f} s)")
    g16 = Groth16(curve)            # device="cuda", msm_strategy="segments"
    for ck, group, k in ((g16.g1, curve.G1, 37), (g16.g2, curve.G2, 91)):
        P = ck.encode_points([group.one(), group.zero()])
        with card_turn():
            Pk = ck.decode_points(ck.scalar_mul_const(P, k), group)
        if Pk != [group.one() * k, group.zero()]:
            raise AssertionError(f"scalar_mul_const {curve.name} "
                                 f"{group.name} differs from the host")
    log(f"  scalar_mul_const G1 (37) and G2 (91) == host multiples "
        f"(G2 over Fq{g16.fq2.ext_degree})")
    phases = {}
    kp = timed_phase(phases, "keygen", lambda t: path_timing(
        f"keygen_{curve.name}", lambda: g16.generator(cs, seed=5,
                                                      timings=t), paths))
    domain = g16.domain_for(qap_domain, cs)
    log(f"  domain m = {domain.m} ({type(domain).__name__}"
        + (f", {domain.kind}" if hasattr(domain, "kind") else "") + ")")
    proof = timed_phase(phases, "prove[segments]", lambda t: path_timing(
        f"prove_{curve.name}", lambda: g16.prover(
            kp.pk, primary, aux, seed=9, timings=t), paths))
    bad_input = [(primary[0] + 1) % curve.r] + list(primary[1:])
    # the verdicts are read once the next curve's path has run
    verdicts = [VERIFIERS.submit(g16, "verifier_strong_IC", kp.vk, x, proof)
                for x in (primary, bad_input)]
    total = phase_totals(phases)
    group_kernels = [key for key, n in total.items()
                     if n and not key.startswith(("mont_mul_", "fp_addsub_"))]
    if group_kernels:
        raise AssertionError(f"{curve.name}: group kernels launched for a "
                             f"curve with an a-coefficient: {group_kernels}")
    missing = [key for key in {f"{k}_n{fk.N}" for k in ("mont_mul",
                                                         "fp_addsub")
                               for fk in (g16.fq, g16.fr)}
               if not total.get(key)]
    if missing:
        raise AssertionError(f"kernels not launched on the {curve.name} "
                             f"path: {missing}")
    return total, verdicts


def mnt_path(args, K, gen, paths: dict, circuits: dict) -> dict:
    """The curves with an a-coefficient: mont_mul and fp_addsub at 19 limbs
    (MNT4's and MNT6's Fq and Fr) and 12 limbs (edwards) at 2^20 lanes
    against their plain versions, then generic_a_path over MNT4 and MNT6
    at 2^mnt_log2 - 3 constraints (MNT6's Fr has two-adicity 17: 2^18 is
    its extended domain of two cosets of 2^17) and edwards at
    2^edwards_log2 - 3; the verdicts of every curve's verifier calls are
    read at the end. Returns {curve: the path's launches}."""
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    t0 = time.perf_counter()
    for name in GENERIC_A_CURVES:
        g16 = Groth16(get_curve(name))
        with card_turn():
            check_mont_mul(g16.fr, g16.fq, K, gen)
            check_fp_addsub(g16.fr, g16.fq, K, gen)
    log(f"  check mont_mul and fp_addsub at n19 / n12: "
        f"{time.perf_counter() - t0:.1f} s")
    out, pending = {}, {}
    for name in GENERIC_A_CURVES:
        t1 = time.perf_counter()
        log2 = args.edwards_log2 if name == "edwards" else args.mnt_log2
        out[name], pending[name] = generic_a_path(
            get_curve(name), log2, paths, circuits.pop(name))
        log(f"  mnt path {name}: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    for name, (ok, bad) in pending.items():
        accepted, rejected = ok.result(), not bad.result()
        log(f"  {name}: verify (host, in workers beside the later curves' "
            f"paths): accepted={accepted} wrong-input-rejected={rejected}")
        if not (accepted and rejected):
            raise AssertionError(f"{name}: Groth16 verification checks "
                                 "failed")
    log(f"  verdicts read in {time.perf_counter() - t1:.2f} s")
    log(f"mnt path: {time.perf_counter() - t0:.1f} s")
    return out


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
        bad = [(primary[0] + 1) % r] + primary[1:]
        ok, bad_ok = VERIFIERS.verdicts(ps, [
            ("verifier_strong_IC", (kp.vk, primary, proof)),
            ("verifier_strong_IC", (kp.vk, bad, proof))])
        rej = not bad_ok
        log(f"  proofs equal; verify {time.perf_counter() - t0:.2f} s "
            f"(host, two calls in workers): accepted={ok} "
            f"wrong-input-rejected={rej}")
        if not (ok and rej):
            raise AssertionError(f"{name} verification checks failed")
        total = phase_totals(phases)
        nq = ps.fq.N
        require_launched(label, total, [
            f"mont_mul_n{nq}", f"mont_mul_n{ps.fr.N}"] + [
            f"{k}_{f}_n{nq}" for k in ("dbl_chain", "add", "madd_win",
                                       "bucket_reduce", "horner_combine")
            for f in ("fp", "fp2")])
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
            ok, = VERIFIERS.verdicts(ps, [("verifier_strong_IC",
                                           (kp.vk, primary, proof))])
        else:
            circuit, primary, aux = ex.generate_tbcs_example(gates, 2)
            kp = ps.tbcs_generator(circuit, seed=5)
            proof = ps.tbcs_prover(kp.pk, primary, aux, seed=9)
            ok, = VERIFIERS.verdicts(ps, [("tbcs_verifier_strong_IC",
                                           (kp.vk, primary, proof))])
        log(f"{name} {curve.name}, {gates} gates: keygen, prove, verify "
            f"{time.perf_counter() - t0:.2f} s: accepted={ok}")
        if not ok:
            raise AssertionError(f"{name} round trip rejected")
    return out


def adsnark_path(curve, log2: int, paths: dict, circuit) -> dict:
    """ADSNARK through its entry points on generate_r1cs_example(r, 2^log2
    - 3, 16) (circuit: systems_circuits' entry): the authority's seeded
    keys and the 16 inputs' signed data (Schnorr), a seeded keygen under
    the device profiler (paths["keygen_adsnark_<curve>"]) with its phases,
    one prove with its phases and one more under the profiler
    (paths["prove_adsnark_<curve>"], equal proofs), peak device memory;
    both verifiers accept; the public verifier rejects the proof made over
    the same input from the authenticated data of a changed input, and the
    symmetric one the proof under wrong labels. Every path kernel (G1 and
    G2) must have launched. Then an Ed25519 round trip at 20 constraints.
    Returns {"adsnark_<curve>": launches per kernel (keygen and prove)}."""
    from libsnark_tpu_torch.ops.cuda_ec import counter_key
    from libsnark_tpu_torch.proof_systems.adsnark import ADSNARK
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    from libsnark_tpu_torch.relations import examples as ex
    label = f"adsnark_{curve.name}"
    t0 = time.perf_counter()
    (cs, primary, aux), made = receive_circuit(circuit)
    k = len(primary)
    log(f"adsnark path {curve.name}: generate_r1cs_example(r, 2^{log2} - 3, "
        f"{k}): {made:.2f} s (host, a worker process), "
        f"{time.perf_counter() - t0:.2f} s to receive")
    ps = ADSNARK(curve)                                    # device="cuda"
    labels = auth_labels(k)
    t0 = time.perf_counter()
    keys = ps.auth_generator(seed=3)
    auth = ps.auth_sign(primary, keys.sak, labels, seed=4)
    log(f"  authority keys and {k} signed inputs: "
        f"{time.perf_counter() - t0:.2f} s (host)")
    phases = {}
    kp = timed_phase(phases, "keygen", lambda t: path_timing(
        f"keygen_{label}", lambda: ADSNARK(curve).generator(
            cs, keys.pap, seed=5, timings=t), paths))
    domain = ps.domain_for(qap_domain, kp.pk.r1cs_dev)
    log(f"  domain {type(domain).__name__}, m = {domain.m}; queries of "
        f"{kp.pk.A_query_g[0].shape[-1]} lanes")
    proof = timed_phase(phases, "prove", lambda t: ps.prover(
        kp.pk, primary, aux, auth, seed=9, timings=t))
    if path_timing(f"prove_{label}", lambda: ps.prover(
            kp.pk, primary, aux, auth, seed=9), paths) != proof:
        raise AssertionError("adsnark: the profiled proof differs")
    t0 = time.perf_counter()
    changed = [(primary[0] + 1) % curve.r] + primary[1:]
    bad_auth = ps.auth_sign(changed, keys.sak, labels, seed=7)
    bad = ps.prover(kp.pk, primary, aux, bad_auth, seed=9)
    t1 = time.perf_counter()
    ok_sec, ok_pub, bad_pub, bad_sec = VERIFIERS.verdicts(ps, [
        ("verifier_sec", (kp.vk, proof, keys.sak, labels)),
        ("verifier_pub", (kp.vk, auth, proof, keys.pak, labels)),
        ("verifier_pub", (kp.vk, bad_auth, bad, keys.pak, labels)),
        ("verifier_sec", (kp.vk, proof, keys.sak,
                          [b"x" + l for l in labels]))])
    rej_pub, rej_sec = not bad_pub, not bad_sec
    log(f"  proofs equal; the proof from a changed input's authenticated "
        f"data proved {t1 - t0:.2f} s; verifier_sec and verifier_pub on "
        f"both, and verifier_sec under wrong labels, four calls in workers "
        f"{time.perf_counter() - t1:.2f} s (host): accepted="
        f"{ok_sec and ok_pub}; the changed data's proof rejected by "
        f"verifier_pub={rej_pub}, wrong labels rejected by verifier_sec="
        f"{rej_sec}")
    if not (ok_sec and ok_pub and rej_pub and rej_sec):
        raise AssertionError("adsnark verification checks failed")
    total = phase_totals(phases)
    require_launched(label, total, [f"mont_mul_n{ps.fq.N}"] + [
        counter_key(kern, ck.fk) for kern in (
            "dbl_chain", "add", "madd_win", "bucket_reduce",
            "horner_combine") for ck in (ps.g1, ps.g2)])
    del cs, kp, ps, domain
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ps = ADSNARK(curve, sig_scheme="ed25519")
    cs, primary, aux = ex.generate_r1cs_example(curve.r, 20, 2)
    kp = adsnark_keygen(ps, cs)
    proof = adsnark_prove(ps, kp, primary, aux)
    ok, = VERIFIERS.verdicts(ps, [("verifier_pub", (
        kp.vk, ps.auth_data, proof, ps.auth_keys.pak,
        auth_labels(len(primary))))], sig_scheme="ed25519")
    log(f"adsnark {curve.name} with Ed25519 signatures, 20 constraints: "
        f"keygen, prove, verifier_pub (the one that reads the signatures) "
        f"{time.perf_counter() - t0:.2f} s: accepted={ok}")
    if not ok:
        raise AssertionError("adsnark Ed25519 round trip rejected")
    return {label: total}


def pcd_path(paths: dict) -> dict:
    """A two-step SpPCD over BLS12-377 -> BW6-761 through its entry points:
    the tally compliance predicate (max_arity 2: 5 constraints, a statement
    of 4 inputs); generator(num_proofs=2, seed=77) with device keygen of
    the inner and outer Groth16 keys, its phases and the outer circuit's
    size; two real inner step proofs over BLS12-377 (prove_step: payloads
    [10, 1] and [20, 2] with local [5], then [35, 4] and [7, 1] with local
    [3]), each verified on the host; the prover folding both into one outer
    Groth16 proof over BW6-761, its phases (circuit rebuild, the verifier
    gadgets' witness, the outer prove with its own), under the device
    profiler (paths["prove_pcd"]); the verifier accepts it and rejects it
    with one statement element changed (the verdicts read in the logged
    time). Each phase: counts set to 0 just before and read just after,
    peak device memory. Beside the keygen's phases, the
    host scalar multiplications gamma_ABC took before it came from the
    device fixed base, timed on a sample. Returns {"pcd": the outer prove's
    launches per kernel}; every kernel of that prove must have launched."""
    import gc
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.ops.cuda_ec import counter_key
    from libsnark_tpu_torch.proof_systems.compliance_predicate import (
        PCDLocalData, PCDMessage, TallyCompliancePredicate)
    from libsnark_tpu_torch.proof_systems.pcd import SpPCD
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    bls, bw6 = get_curve("bls12_377"), get_curve("bw6_761")
    # the circuits hold ~10^8 linear terms: the collector's full passes over
    # them would take longer than building them
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        cp = TallyCompliancePredicate(bls.r, max_arity=2)
        cp.generate_r1cs_constraints()
        inner_cs = cp.get_constraint_system()
        log(f"pcd path: TallyCompliancePredicate(max_arity=2) over "
            f"BLS12-377's r: {inner_cs.num_constraints} constraints, "
            f"{inner_cs.num_inputs} inputs")
        pcd = SpPCD(bls, bw6)                              # device="cuda"
        phases, gen_t = {}, {}

        def generator(t):
            out = pcd.generator(cp, num_proofs=2, seed=77, timings=t)
            gen_t.update(t)
            return out

        pk, vk = timed_phase(phases, "generator", generator)
        dev = pk.outer_keypair.pk.r1cs_dev
        domain = pcd.g16_outer.domain_for(qap_domain, dev)
        log(f"  outer circuit: {dev.num_constraints} constraints, "
            f"{dev.num_inputs} inputs, {dev.num_variables} variables, "
            f"{sum(int(m.rows.numel()) for m in (dev.A, dev.B, dev.C))} "
            f"nonzeros, domain {type(domain).__name__} m = {domain.m}")
        # gamma_ABC before: one host scalar multiplication an input
        n_abc = len(vk.outer_vk.gamma_ABC)
        rng = random.Random(77)
        sample = [rng.randrange(bw6.r) for _ in range(64)]
        t0 = time.perf_counter()
        G1 = bw6.G1.one()
        for sc in sample:
            G1 * sc
        host = time.perf_counter() - t0
        log(f"  outer keygen_host_rest "
            f"{gen_t['outer.keygen_host_rest']:.3f} s with gamma_ABC "
            f"from the device fixed base ({n_abc} points); the host form "
            f"it replaced, {len(sample)} host scalar multiplications of "
            f"BW6-761's G1: {host:.3f} s, so ~{host * n_abc / len(sample):.1f}"
            f" s for {n_abc} (estimated from the sample)")
        steps = (([PCDMessage(1, [10, 1]), PCDMessage(1, [20, 2])], [5]),
                 ([PCDMessage(1, [35, 4]), PCDMessage(1, [7, 1])], [3]))
        stmts, proofs = [], []
        for i, (incoming, local) in enumerate(steps):
            stmt, proof = timed_phase(
                phases, f"prove_step[{i}]", lambda t: pcd.prove_step(
                    pk, cp, incoming, PCDLocalData(local), seed=5 + i))
            t0 = time.perf_counter()
            ok, = VERIFIERS.verdicts(pcd.g16_inner, [(
                "verifier_strong_IC", (pk.inner_keypair.vk, stmt, proof))])
            log(f"  step {i}: statement {stmt}; inner proof verified on the "
                f"host in {time.perf_counter() - t0:.2f} s: {ok}")
            if not ok:
                raise AssertionError(f"pcd: inner step proof {i} rejected")
            stmts.append(stmt)
            proofs.append(proof)
        if stmts[0][1:3] != [35, 4] or stmts[1][1:3] != [45, 6]:
            raise AssertionError(f"pcd: tally statements {stmts}")
        proof = timed_phase(phases, "prover", lambda t: path_timing(
            "prove_pcd", lambda: pcd.prover(pk, stmts, proofs, seed=9,
                                            timings=t), paths))
        t0 = time.perf_counter()
        bad = [list(stmts[0]), stmts[1]]
        bad[0][1] = (bad[0][1] + 1) % bls.r
        ok, bad_ok = VERIFIERS.verdicts(pcd, [
            ("verifier", (vk, stmts, proof)),
            ("verifier", (vk, bad, proof))])
        log(f"  verify {time.perf_counter() - t0:.2f} s (host, two calls in "
            f"workers, verdicts read): accepted={ok} "
            f"changed-statement-rejected={not bad_ok}")
        if not ok or bad_ok:
            raise AssertionError("pcd verification checks failed")
    finally:
        gc.enable()
        gc.unfreeze()
    counts = phases["prover"]
    fq, fr = pcd.g16_outer.fq, pcd.g16_outer.fr
    need = [f"mont_mul_n{fq.N}", f"mont_mul_n{fr.N}"] + [
        counter_key(k, fq) for k in ("add", "bucket_reduce",
                                      "horner_combine")]
    require_launched("pcd: the outer prove", counts, need)
    return {"pcd": counts}


def board_size(pb) -> str:
    """A protoboard's constraints, inputs, variables and linear terms."""
    terms = sum(len(a.terms) + len(b.terms) + len(c.terms)
                for a, b, c, _ in pb.constraints)
    return (f"{pb.num_constraints} constraints, {pb.num_inputs} inputs, "
            f"{pb.num_variables} variables, {terms} linear terms")


def pcd_cycle_path(paths: dict) -> dict:
    """The single-predicate PCD over the MNT4 -> MNT6 cycle (CycleSpPCD)
    through its entry points, the shape of scripts/e2e_pcd_cycle.py: the
    tally compliance predicate of arity 1; generator(seed=31) with device
    keygen of the compliance key over MNT4 and the translation key over
    MNT6, its phases (each circuit's host build, each keygen's _host_qap,
    fixed base and _host_rest) and both circuits' sizes; a base step
    (depth 0: local [5], no incoming proof) and a step that consumes the
    base step's translation proof (depth 1: local [10]), each a compliance
    prove over MNT4 and a translation prove over MNT6 with its phases
    (build, witness, the check on the device R1CS, prove), the second under
    the device profiler (paths["prove_pcd_cycle"]); the verifier accepts
    the depth-1 proof and rejects it with one payload element changed (the
    verdicts read in the logged time). Each phase: counts set to 0 just
    before and read just after, peak device memory. mont_mul and fp_addsub
    at 19 limbs must launch, and no group kernel (a != 0 on both curves).
    Returns {"pcd_cycle": the launches of the generator and both steps}."""
    import gc
    from libsnark_tpu_torch.proof_systems.compliance_predicate import (
        PCDLocalData, PCDMessage, TallyCompliancePredicate)
    from libsnark_tpu_torch.proof_systems.pcd_cycle import (
        CyclePCDProof, CycleSpPCD)
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    t_path = time.perf_counter()
    # ~2 x 10^8 linear terms: the collector's full passes over them would
    # take longer than building them
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        pcd = CycleSpPCD()                     # MNT4 -> MNT6, device="cuda"
        A = pcd.A

        def tally():
            h = TallyCompliancePredicate(A.r, max_arity=1)
            h.generate_r1cs_constraints()
            return h

        handler = tally()
        log(f"pcd_cycle path: TallyCompliancePredicate(max_arity=1) over "
            f"MNT4's r: {handler.get_constraint_system().num_constraints} "
            f"constraints; CycleSpPCD over {pcd.A.name} -> {pcd.B.name}")
        phases = {}
        pk, vk = timed_phase(phases, "generator", lambda t: pcd.generator(
            handler, seed=31, timings=t))
        for side, g16, kp, board in (
                ("compliance", pcd.g16_a, pk.kp_a, pcd.compliance_board(
                    pk.handler_cs, pk.max_arity, pk.msg_size, pk.base_case)),
                ("translation", pcd.g16_b, pk.kp_b,
                 pcd.translation_board(pk.kp_a.vk))):
            dev = kp.pk.r1cs_dev
            domain = g16.domain_for(qap_domain, dev)
            log(f"  {side} circuit over {g16.curve.name}'s r: "
                f"{board_size(board['pb'])}; "
                f"{sum(int(m.rows.numel()) for m in (dev.A, dev.B, dev.C))} "
                f"merged nonzeros, domain {type(domain).__name__} m = "
                f"{domain.m}")
        steps = []
        for depth, local in enumerate((5, 10)):
            incoming = steps[-1:]

            def step(t, incoming=incoming, local=local):
                return pcd.prover(pk, tally(), incoming,
                                  PCDLocalData([local]), seed=11 + depth,
                                  timings=t)

            label = f"step[{depth}]"
            if depth == 1:
                proof = timed_phase(phases, label, lambda t: path_timing(
                    "prove_pcd_cycle", lambda: step(t), paths))
            else:
                proof = timed_phase(phases, label, step)
            log(f"  depth {depth}: message type {proof.msg.type}, payload "
                f"{proof.msg.payload}")
            steps.append(proof)
        if [p.msg.payload for p in steps] != [[5, 1], [15, 2]]:
            raise AssertionError(f"pcd_cycle: tally payloads "
                                 f"{[p.msg.payload for p in steps]}")
        proof = steps[-1]
        bad_msg = PCDMessage(proof.msg.type, [proof.msg.payload[0] + 1]
                             + list(proof.msg.payload[1:]))
        bad = CyclePCDProof(msg=bad_msg,
                            translation_proof=proof.translation_proof)
        t0 = time.perf_counter()
        ok, bad_ok = VERIFIERS.verdicts(pcd, [
            ("verifier", (vk, proof.msg, proof)),
            ("verifier", (vk, bad_msg, bad))])
        log(f"  verify {time.perf_counter() - t0:.2f} s (host, two calls in "
            f"workers, verdicts read): accepted={ok} "
            f"changed-payload-rejected={not bad_ok}")
        if not ok or bad_ok:
            raise AssertionError("pcd_cycle verification checks failed")
    finally:
        gc.enable()
        gc.unfreeze()
    total = phase_totals(phases)
    group_kernels = [key for key, n in total.items()
                     if n and not key.startswith(("mont_mul_", "fp_addsub_"))]
    if group_kernels:
        raise AssertionError(f"pcd_cycle: group kernels launched on the MNT "
                             f"cycle (a != 0): {group_kernels}")
    require_launched("pcd_cycle", total, [
        f"mont_mul_n{pcd.g16_a.fq.N}", f"fp_addsub_n{pcd.g16_a.fq.N}"])
    log(f"pcd_cycle path {time.perf_counter() - t_path:.1f} s")
    return {"pcd_cycle": total}


def cycle_path_process(conn, lock, waiting):
    """pcd_cycle_path in a process of its own (PathProcess): the kernels
    the parent built, two verifier workers of its own; Groth16's calls that
    run on the card (the QAP at t, the fixed-base queries, the check on the
    device R1CS, the prove) and the field's Montgomery conversion (the
    device R1CS's coefficients) each take the card's turn (lock, waiting:
    card_turn's), a keygen's from the QAP at t to its last fixed-base query
    as one turn (HeldTurn); only the copies of host arrays to the card run
    outside the turns. Sends ("ok", launches, paths, log lines) or ("error",
    traceback, None, log lines)."""
    global LOG_LINES, VERIFIERS, CARD, IN_PATH_PROCESS
    import traceback
    LOG_LINES = []
    CARD = (lock, waiting, multiprocessing.parent_process())
    IN_PATH_PROCESS = True
    try:
        from libsnark_tpu_torch.ops import cuda_lib
        from libsnark_tpu_torch.ops.fp import FpKernel
        from libsnark_tpu_torch.proof_systems import groth16
        FpKernel.to_mont = on_card(FpKernel.to_mont)
        for name in ("prover", "first_unsatisfied", "fixed_base_g1",
                     "fixed_base_g2"):
            setattr(groth16.Groth16, name,
                    on_card(getattr(groth16.Groth16, name)))
        # a keygen: one turn from the QAP at t to the last fixed-base
        # query (gamma_ABC), its host work between them inside it
        keygen = HeldTurn()
        groth16.qap_instance_map_on_device = keygen.begin(
            groth16.qap_instance_map_on_device)
        groth16.Groth16.fixed_base_points_g1 = keygen.end(on_card(
            groth16.Groth16.fixed_base_points_g1))
        cuda_lib.build_all()
        VERIFIERS = VerifierPool(2)
        try:
            paths = {}
            counts = pcd_cycle_path(paths)
            log(f"  pcd_cycle path: waited {TURN_WAITED:.1f} s in all for "
                "the card's turns")
        finally:
            VERIFIERS.shutdown()
        conn.send(("ok", counts, paths, LOG_LINES))
    except BaseException:
        conn.send(("error", traceback.format_exc(), None, LOG_LINES))
    finally:
        conn.close()


class PathProcess:
    """A path run in a spawned process beside the parent's paths (its own
    launch counters, profiler and device memory statistics), the two
    taking turns on the card (CARD) until result() or stop(); result()
    prints its log lines and returns its (launches, paths), or raises its
    failure; stop() ends it if it is still running."""

    def __init__(self, target):
        global CARD
        ctx = multiprocessing.get_context("spawn")
        self.t0 = time.perf_counter()
        self.conn, child = ctx.Pipe(duplex=False)
        lock, waiting = ctx.Lock(), ctx.Event()
        self.proc = ctx.Process(target=target, args=(child, lock, waiting))
        self.proc.start()
        child.close()
        CARD = (lock, waiting, self.proc)

    def result(self):
        global CARD
        t_wait = time.perf_counter()
        try:
            status, a, b, lines = self.conn.recv()
        except EOFError:
            self.proc.join()
            raise AssertionError(f"{self.proc.name} ended without a result "
                                 f"(exit code {self.proc.exitcode})")
        self.proc.join()
        CARD = None
        log(f"--- from its own process ({time.perf_counter() - self.t0:.1f}"
            f" s from its start to its result, {time.perf_counter() - t_wait:.1f}"
            f" s of them waited for; the parent waited {TURN_WAITED:.1f} s "
            "in all for the card's turns):")
        for line in lines:
            log(line)
        if status != "ok":
            raise AssertionError(f"the path in its own process failed:\n{a}")
        return a, b

    def stop(self):
        global CARD
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        CARD = None


# the RAM path's sizes: TinyRAM with 16 registers of 32 bits; the RAM
# ppzkSNARK's boot-trace bound and time bound (216,799 constraints, a 2^18
# domain); the RAM zkSNARK's boot-trace bound (its predicate, 78,912
# constraints, keeps the reference's full 32-bit address space)
RAM_W, RAM_K = 32, 16
RAM_BOOT, RAM_TIME = 102, 128
RAM_ZK_BOOT = 12


def ram_ppzksnark_part(paths: dict) -> dict:
    """The RAM ppzkSNARK (the TinyRAM universal circuit under BCTV14) over
    alt_bn128 through its entry points: gen_ram_example_complex(ap, 102,
    128, satisfiable=True, seed=13) for w = 32, k = 16; the universal
    circuit's host build alone (phase ram.build: its size, linear terms and
    domain); ram_generator(seed=5) under the device profiler
    (paths["keygen_ram_ppzksnark_alt_bn128"]; it builds the circuit again)
    with its phases; ram_prover(seed=9) with its phases (the build, the
    execution and routing witness, BCTV14's phases) and once more under
    the profiler (paths["prove_ram_ppzksnark_alt_bn128"], equal proofs);
    ram_verifier accepts and rejects the proof with one boot-input element
    changed; ram_prover refuses the satisfiable=False example (its
    AssertionError expected). Returns (the launches of keygen and prove,
    a function that reads the verdicts: the verifier calls run in workers
    beside what follows)."""
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.gadgets.ram_universal import (
        ram_to_r1cs_instance_map)
    from libsnark_tpu_torch.ops.cuda_ec import counter_key
    from libsnark_tpu_torch.proof_systems.ram_ppzksnark import RAMPpzksnark
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    from libsnark_tpu_torch.relations.examples import gen_ram_example_complex
    from libsnark_tpu_torch.relations.tinyram import TinyRAMParams
    curve = get_curve("alt_bn128")
    label = f"ram_ppzksnark_{curve.name}"
    ap = TinyRAMParams(w=RAM_W, k=RAM_K)
    B, T = RAM_BOOT, RAM_TIME
    prog, primary, aux, _ = gen_ram_example_complex(ap, B, T,
                                                    satisfiable=True, seed=13)
    phases = {}
    pb, _ = timed_phase(phases, "ram.build", lambda t: (
        ram_to_r1cs_instance_map(curve.r, ap, B, T)))
    cs = pb.get_constraint_system()
    terms = sum(len(lc.terms) for con in cs.constraints
                for lc in (con.a, con.b, con.c))
    rs = RAMPpzksnark(curve)                               # device="cuda"
    domain = rs.domain_for(qap_domain, cs)
    log(f"  TinyRAM w = {RAM_W}, k = {RAM_K}, boot-trace bound {B}, time "
        f"bound {T}, program of {prog.size} instructions, {len(primary)} "
        f"input words: {cs.num_constraints} constraints, {terms} linear "
        f"terms, {cs.num_inputs} inputs, {cs.num_variables} variables; "
        f"domain {type(domain).__name__}, m = {domain.m}")
    del pb, cs
    kp = timed_phase(phases, "keygen", lambda t: path_timing(
        f"keygen_{label}", lambda: RAMPpzksnark(curve).ram_generator(
            ap, B, T, seed=5, timings=t), paths))
    proof, boot = timed_phase(phases, "prove", lambda t: rs.ram_prover(
        kp.pk, prog, primary, aux, seed=9, timings=t))
    again, boot2 = path_timing(f"prove_{label}", lambda: rs.ram_prover(
        kp.pk, prog, primary, aux, seed=9), paths)
    if again != proof or boot2 != boot:
        raise AssertionError(f"{label}: the profiled proof differs")
    t_verify = time.perf_counter()
    bad = list(boot)
    bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % curve.r
    verdicts = [VERIFIERS.submit(rs, "ram_verifier", kp.vk, b, proof)
                for b in (boot, bad)]

    def verified():
        """Reads the verdicts of the two verifier calls (run in workers
        beside what follows) and fails unless the proof was accepted and
        the changed boot input rejected."""
        ok, bad_ok = (f.result() for f in verdicts)
        log(f"  {label}: verify {time.perf_counter() - t_verify:.2f} s from "
            f"submission to the verdicts read (host, two calls in workers, "
            f"beside the rest of the RAM path): accepted={ok} "
            f"changed-boot-input-rejected={not bad_ok}")
        if not ok or bad_ok:
            raise AssertionError(f"{label} verification checks failed")

    log("  proofs equal; the two verifier calls submitted")
    t0 = time.perf_counter()
    unsat = gen_ram_example_complex(ap, B, T, satisfiable=False, seed=13)
    try:
        rs.ram_prover(kp.pk, *unsat[:3], seed=9)
    except AssertionError as e:
        if "did not accept" not in str(e):
            raise
        log(f"  the satisfiable=False example refused by ram_prover in "
            f"{time.perf_counter() - t0:.2f} s: {e}")
    else:
        raise AssertionError(f"{label}: the prover proved an unsatisfiable "
                             "example")
    total = phase_totals(phases)
    need = [f"mont_mul_n{rs.fq.N}", f"fp_addsub_n{rs.fq.N}"] + [
        counter_key(kern, ck.fk) for kern in (
            "dbl_chain", "add", "madd_win", "bucket_reduce",
            "horner_combine") for ck in (rs.g1, rs.g2)]
    require_launched(label, total, need)
    return total, verified


def ram_zksnark_part(paths: dict, steps: int) -> dict:
    """The one-layer RAM zkSNARK over BLS12-377 through its entry points:
    TinyRAM w = 32, k = 16 with the full 32-bit delegated address space
    (tree depth 32: the predicate has 78,912 constraints);
    gen_ram_example_complex(ap, 12, steps, seed=17); generator(seed=7)
    under the device profiler (paths["keygen_ram_zksnark_bls12_377"]) with
    its phases; prover(seed=9), one inner Groth16 proof a step, under the
    profiler (paths["prove_ram_zksnark_bls12_377"]) with its phases;
    verify_transcript with all messages (run_and_chain's, whose endpoints
    must equal the proof's) accepts, and rejects a middle message with
    pc_addr changed and a final message with has_accepted = 0. Returns the
    launches of keygen and prove."""
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.ops.cuda_ec import counter_key
    from libsnark_tpu_torch.proof_systems.ram_zksnark import (
        RamZkSnark, RamZkSnarkArchParams)
    from libsnark_tpu_torch.reductions.r1cs_to_qap import qap_domain
    from libsnark_tpu_torch.relations.examples import gen_ram_example_complex
    from libsnark_tpu_torch.relations.tinyram import TinyRAMParams
    curve = get_curve("bls12_377")
    label = f"ram_zksnark_{curve.name}"
    arch = RamZkSnarkArchParams(ap=TinyRAMParams(w=RAM_W, k=RAM_K))
    T = steps
    prog, primary, aux, _ = gen_ram_example_complex(arch.ap, RAM_ZK_BOOT, T,
                                                    seed=17)
    rzs = RamZkSnark(curve)                                # device="cuda"
    phases = {}
    kp = timed_phase(phases, "keygen", lambda t: path_timing(
        f"keygen_{label}", lambda: RamZkSnark(curve).generator(
            arch, seed=7, timings=t), paths))
    dev = kp.pk.inner_pk.r1cs_dev
    domain = rzs.g16.domain_for(qap_domain, dev)
    log(f"  predicate (tree depth {arch.tree_depth}): {dev.num_constraints} "
        f"constraints, {dev.num_inputs} inputs, {dev.num_variables} "
        f"variables; domain {type(domain).__name__}, m = {domain.m}")
    proof = timed_phase(phases, "prove", lambda t: path_timing(
        f"prove_{label}", lambda: rzs.prover(kp.pk, prog, primary, T, aux,
                                             seed=9, timings=t), paths))
    t0 = time.perf_counter()
    _, msgs, _ = rzs.run_and_chain(arch, prog, primary, aux, T)
    if [msgs[0], msgs[-1]] != proof.messages or \
            len(proof.inner_proofs) != T:
        raise AssertionError(f"{label}: the message chain differs from the "
                             "proof's endpoints")
    bad_mid = list(msgs)
    mid = len(msgs) // 2
    bad_mid[mid] = dataclasses.replace(bad_mid[mid],
                                       pc_addr=bad_mid[mid].pc_addr + 1)
    bad_end = list(msgs)
    bad_end[-1] = dataclasses.replace(bad_end[-1], has_accepted=0)
    t1 = time.perf_counter()
    ok, mid_ok, end_ok = VERIFIERS.verdicts(rzs, [
        ("verify_transcript", (kp.vk, prog, primary, T, proof, msgs)),
        ("verify_transcript", (kp.vk, prog, primary, T, proof, bad_mid)),
        ("verify_transcript", (kp.vk, prog, primary, T, proof, bad_end))])
    log(f"  message chain {t1 - t0:.2f} s (host); verify_transcript, three "
        f"calls in workers {time.perf_counter() - t1:.2f} s (host, "
        f"verdicts read): accepted={ok} changed-middle-message-rejected="
        f"{not mid_ok} false-final-claim-rejected={not end_ok}")
    if not ok or mid_ok or end_ok:
        raise AssertionError(f"{label} verification checks failed")
    total = phase_totals(phases)
    need = [f"mont_mul_n{rzs.g16.fq.N}", f"mont_mul_n{rzs.g16.fr.N}",
            f"fp_addsub_n{rzs.g16.fq.N}"] + [
        counter_key(kern, ck.fk) for kern in (
            "dbl_chain", "add", "madd_win", "bucket_reduce",
            "horner_combine") for ck in (rzs.g16.g1, rzs.g16.g2)]
    require_launched(label, total, need)
    return total


def ram_path(paths: dict, steps: int) -> dict:
    """The RAM systems (ram_ppzksnark_part, ram_zksnark_part, the first's
    verifier calls in workers beside the second), their host circuits
    built with the collector off. Returns {"ram_ppzksnark_alt_bn128":
    launches, "ram_zksnark_bls12_377": launches}: the kernel table's "ram"
    counts."""
    import gc
    t0 = time.perf_counter()
    # the universal circuit holds ~1.4e6 linear terms and is built four
    # times: the collector's full passes would take longer than that
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        log("ram path: the RAM ppzkSNARK over alt_bn128")
        counts, verified = ram_ppzksnark_part(paths)
        out = {"ram_ppzksnark_alt_bn128": counts}
        torch.cuda.empty_cache()
        log(f"  ram_ppzksnark part {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        log(f"ram path: the RAM zkSNARK (one layer) over BLS12-377, "
            f"{steps} steps")
        out["ram_zksnark_bls12_377"] = ram_zksnark_part(paths, steps)
        torch.cuda.empty_cache()
        log(f"  ram_zksnark part {time.perf_counter() - t1:.1f} s")
        verified()
    finally:
        gc.enable()
        gc.unfreeze()
    log(f"ram path {time.perf_counter() - t0:.1f} s")
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
    # the verifier reads [alpha]_2 alone: the workers get the SRS without
    # its device powers
    host_srs = dataclasses.replace(srs, alpha_powers_g1=None)
    calls = {"accepted": (host_srs, C, z, v, W)}
    if any(c % r for c in coeffs[1:]):
        calls["wrong-value-rejected"] = (host_srs, C, z, (v + 1) % r, W)
        calls["wrong-point-rejected"] = (host_srs, C, (z + 1) % r, v, W)
    verdicts = VERIFIERS.verdicts(kzg, [("verify_evaluation", args)
                                        for args in calls.values()])
    checks = {k: ok if k == "accepted" else not ok
              for k, ok in zip(calls, verdicts)}
    log(f"  {label} ({len(coeffs)} coefficients): commit {t1 - t0:.3f} s "
        f"(peak {peak_commit / 2**30:.2f} GiB), open {t2 - t1:.3f} s "
        f"(peak {peak_open / 2**30:.2f} GiB), verify "
        f"{time.perf_counter() - t2:.2f} s (host, the calls at once in "
        f"workers, verdicts read): "
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
    ok = bool(batched.verify_evaluations(z_1, z_2, evals, srs, gamma_1,
                                         gamma_2, wit, cm_1s, cm_2s, r_rand))
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
    ok = bool(b.verify_evaluations(T, ev, srs, gamma, z, w, cm_sets))
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
    ok = bool(kzg.verify_poly(srs, C, coeffs))
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
_FAMILY = {"mont_mul": "mont_mul", "fp_addsub": "fp_addsub",
           "mul_wide": "mul_wide", "dbl": "dbl",
           "add": "add", "madd": "madd",
           "madd_windows": "madd_win", "aadd": "aadd",
           "aadd_rows": "aadd_rows", "dbl_chain": "dbl_chain",
           "bucket_reduce": "bucket_reduce", "horner": "horner_combine"}


def check_mul_wide(fr, K, gen):
    """mul_wide (the MXU NTT's per-level product) at 2^20 lanes with Wa = N
    + 2 limbs of a (all-0xFFFF and zero lanes planted) and b a whole table
    of canonical values (0, 1, p - 1 planted), against its plain version on
    every lane; timed. Once per width."""
    from libsnark_tpu_torch.ops import cuda_fp
    key = f"mul_wide_n{fr.N}"
    if key in K.rows:
        return
    L, wa = 1 << 20, fr.N + 2
    a = torch.randint(0, 1 << 16, (wa, L), generator=gen, device="cuda",
                      dtype=torch.int32)
    a[:, :2] = (1 << 16) - 1
    a[:, 2] = 0
    b = plant_edges(fr, rand_field(fr, (L,), gen))
    err = max_abs_err([cuda_fp.mul_wide(fr, a, b)],
                      [cuda_fp.mul_wide_plain(fr, a, b)])
    ms = cuda_ms(lambda: cuda_fp.mul_wide(fr, a, b), 50)
    pms = cuda_ms(lambda: cuda_fp.mul_wide_plain(fr, a, b), 1)
    nbytes, ops = unit_cost(key)
    K.add("mul_wide", key, err, ms, pms, nbytes * L, ops * L, wide_limbs=wa)


def kernel_key(name: str):
    """The launch-counter key of a path kernel's profiler name, else None."""
    m = _KERNEL_NAME.search(name)
    if not m or m.group(1) not in _FAMILY:
        return None
    fam = _FAMILY[m.group(1)]
    nw = int(m.group(2) or m.group(4))
    if fam in ("mont_mul", "fp_addsub", "mul_wide"):  # <NW, NL, ..>: NL
        return f"{fam}_n{int(m.group(3) or m.group(5))}"
    ext = int(m.group(3) or m.group(5))
    return f"{fam}_{'fp2' if ext == 2 else 'fp'}_n{2 * nw}"


# madd_win counter key -> (scalar limbs, madds) of one lane at the paths'
# window bits: set by check_madd_windows, which runs before every path
MADD_WIN_LANE = {}


def unit_cost(key: str):
    """(bytes, wide multiply-adds) of one unit of a wrapper's work count:
    a lane (mont_mul: one product; dbl: one doubling; aadd_rows: an output
    lane, two packed rows and their indices in, the products counted over
    its live lanes: work_bound_ms), a bucket_reduce madd row
    (a packed row and its index), a horner_combine product, a dbl_chain
    doubling, a madd_win madd (a lane's windows after its first)."""
    fam, f, n = re.match(r"(.+?)_(?:(fp2?)_)?n(\d+)$", key).groups()
    N = int(n)
    nw = -(-N // 2)
    wm = 2 * nw * nw + nw
    e = 2 if f == "fp2" else 1
    FW, per = e * N, (3 if e == 2 else 1)
    if fam == "mont_mul":
        return 12 * N, wm
    if fam == "fp_addsub":
        return 12 * N, 0
    if fam == "mul_wide":            # the MXU NTT's: Wa = N + 2 limbs of a
        return 4 * (N + 2 + 2 * N), -(-(N + 2) // 2) * (2 * nw + 1)
    if fam == "bucket_reduce":
        return 4 * FW + 4, PRODUCTS["madd"] * per * wm
    if fam == "horner_combine":      # throughput; latency: latency_bound_ms
        return 0, per * wm
    if fam == "dbl_chain":           # the same
        return 0, PRODUCTS["dbl"] * per * wm
    if fam == "aadd_rows":
        return 8 * FW + 8 + 12 * FW, PRODUCTS["aadd"] * per * wm
    if fam == "madd_win":
        # a lane reads its scalar limbs and writes 3 elements over the
        # madds of its windows after the first (MADD_WIN_LANE, recorded by
        # check_madd_windows at the paths' c = 8); the products outweigh
        # the bytes ~100x. Zero digits (1 / 2^c of them) count as work
        # they skip.
        nl, madds = MADD_WIN_LANE[key]
        return (4 * nl + 12 * FW) / madds, PRODUCTS["madd"] * per * wm
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
    lost."""
    launches, device = set(), set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.add(e.correlation_id())
        elif "LaunchKernel" in e.name():
            launches.add(e.correlation_id())
    return len(launches - device)


def device_events(prof) -> list:
    """(name, start us, end us) of every device event of a finished
    torch.profiler run, from its raw records: one pass over the list the
    profiler already holds. Its function events (prof.events()) are built
    first, some thirty times the cost: most of the wall time of a profiled
    path of ~10^5 launches."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


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
    for name, start, end in device_events(prof):
        if "empty_kernel" in name:
            warm += 1
            continue
        row = per.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (end - start) / 1e3
        spans.append((start, end))
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
    # not the warm-up's own lost records
    lost = unmatched_launches(prof) - (PROFILE_WARMUP_LAUNCHES - warm)
    return out, per, busy / 1e3, wall, lost


def profiled_rows(fn):
    """fn() under the device profiler, with the counts set to 0 just before:
    (result, {path kernel key: row}, busy ms, wall ms less the waits for
    the card's turns, the keys whose
    profiled kernels differ in number from the wrappers' launches, the
    runtime's kernel launches the profiler kept no device record of, the
    device operations that are no hand-written kernel as (ms, launches,
    name), largest first)."""
    from libsnark_tpu_torch.ops import (depth_counts, launch_counts,
                                        live_pair_counts, reset_launch_counts,
                                        work_counts)
    reset_launch_counts()
    waited = TURN_WAITED
    out, per, busy, wall, lost = device_profile(fn)
    # in a path's own process fn's card calls wait for their turns: that
    # wait is the other process's time, not the path's
    wall -= (TURN_WAITED - waited) * 1e3
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
    still fails.

    In a path's own process the calls of fn that run on the card take
    their turns themselves (on_card), as in timed_phase: the card is not
    held through the path's host work, and the waits are left out of the
    wall time."""
    with contextlib.nullcontext() if IN_PATH_PROCESS else card_turn():
        out, rows, busy, wall, differ, lost, others = profiled_rows(fn)
        if differ:
            log(f"  path {label}: profiled / launched differ {differ}; "
                f"runtime kernel launches without a device record: {lost}; "
                "profiling the path once more")
            out, rows, busy, wall, differ, lost, others = profiled_rows(fn)
    if differ:
        unrecorded = sum(n - p for p, n in differ.values())
        if unrecorded > lost or any(
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
    ap.add_argument("--systems-log2", type=int, default=17,
                    help="BCTV14, GM17 and DFGK14 over alt_bn128: witness "
                         "map on a domain of 2^k (17: the run's time limit, "
                         "with the sharded and MXU phases)")
    ap.add_argument("--new-log2", type=int, default=19,
                    help="Groth16 over BW6-761: 2^k - 3 constraints (19: "
                         "the run's time limit, with the PCD and mnt "
                         "paths)")
    ap.add_argument("--adsnark-log2", type=int, default=17,
                    help="ADSNARK over alt_bn128 (16 authenticated inputs): "
                         "2^k - 3 constraints (17: the run's time limit, "
                         "with the sharded and MXU phases)")
    ap.add_argument("--mnt-log2", type=int, default=16,
                    help="Groth16 over MNT4 and MNT6: 2^k - 3 constraints "
                         "(16: the run's time limit, with the sharded and "
                         "MXU phases; 18 gives MNT6 its extended domain of "
                         "2 x 2^17)")
    ap.add_argument("--edwards-log2", type=int, default=15,
                    help="Groth16 over edwards: 2^k - 3 constraints (15: "
                         "the run's time limit)")
    ap.add_argument("--ram-steps", type=int, default=8,
                    help="the RAM zkSNARK's time bound: one inner Groth16 "
                         "proof over BLS12-377 a step (8)")
    ap.add_argument("--kzg-log2", type=int, default=22,
                    help="KZG10 over BLS12-377: degree 2^k - 1 (22); over "
                         "alt_bn128 the degree is 2^min(k, 18) - 1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    card = card_line()
    log(f"nvidia-smi: {card}")
    cuda_lib.build_all()
    log(f"kernels built in {cuda_lib.build_seconds:.1f} s "
        f"({len(cuda_lib.SOURCES)} libraries in parallel)")
    # the cross-check's CPU proofs run in worker processes from here on,
    # beside the kernel checks, and the verifier calls in others
    cpu_pool, cpu_proofs = start_cpu_proofs()
    global VERIFIERS
    VERIFIERS = VerifierPool(VERIFIER_WORKERS)
    try:
        K, paths = kernels_and_paths(args, t_start, cpu_pool, cpu_proofs)
    finally:
        cpu_pool.shutdown(wait=True, cancel_futures=True)
        VERIFIERS.shutdown()
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


def kernels_and_paths(args, t_start, cpu_pool, cpu_proofs):
    """The probes, the kernel checks, the cross-check and every path (the
    numbered steps 3-8 of the module doc): (the kernel table, the measured
    paths)."""
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.ops import cuda_lib
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    for line in cuda_lib.ptxas_summary():
        log(f"  {line}")

    curves = {"alt_bn128": args.bn_log2, "bls12_377": args.log2}
    systems = {name: Groth16(get_curve(name))
               for name in list(curves) + ["bw6_761"]}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rng = random.Random(1234)
    K = Kernels()
    from libsnark_tpu_torch.ops.fp import FpKernel
    # the product bodies at 19 and 12 limbs too (MNT4's, edwards' Fq)
    check_probes(K, [g.fq for g in systems.values()] + [
        FpKernel(get_curve(name).fq_params) for name in ("mnt4", "edwards")])
    for name, g16 in systems.items():
        log(f"--- kernels against their plain versions: {name}")
        # at 48 limbs (BW6-761) the plain versions run on part of each
        # check's lanes, windows or segments (all would take minutes),
        # and G2, over Fq there, runs G1's kernels: check_ec holds them on
        # both groups' points, the other checks on G1's
        small = name == "bw6_761"
        checks = [
            ("mont_mul", lambda: check_mont_mul(
                g16.fr, g16.fq, K, gen,
                plain_lanes=1 << 16 if small else None)),
            ("fp_addsub", lambda: check_fp_addsub(
                g16.fr, g16.fq, K, gen,
                plain_lanes=1 << 16 if small else None)),
            # Fr at 16 limbs (alt_bn128, BLS12-377) and 24 (BW6-761)
            ("mul_wide", lambda: check_mul_wide(g16.fr, K, gen)),
            ("ec", lambda: check_ec(g16.curve, g16, K, gen, rng)),
            ("madd_windows", lambda: check_madd_windows(
                g16.curve, g16, K, gen, rng,
                plain_lanes=1 << 16 if small else None, g1_only=small)),
            ("dbl_chain", lambda: check_dbl_chain(
                g16.curve, g16, K, rng, plain_windows=8 if small else None,
                g1_only=small)),
            ("aadd_rows", lambda: check_aadd_rows(
                g16.curve, g16, K, gen, rng,
                plain_windows=4 if small else None, g1_only=small)),
            ("bucket_and_horner", lambda: check_bucket_and_horner(
                g16.curve, g16, K, gen, rng, m=1 << 20 if small else 1 << 16,
                plain_segments=1 << 13 if small else None, g1_only=small)),
            ("dense_window_sums", lambda: check_dense_window_sums(
                g16.curve, g16, gen, rng, g1_only=small))]
        if not small:       # BW6-761's Fr is BLS12-377's Fq: no new field
            checks.insert(5, ("encode", lambda: check_encode(
                g16.fr, f"{name} Fr")))
        for label, check in checks:
            t0 = time.perf_counter()
            check()
            log(f"  check {label} {name}: {time.perf_counter() - t0:.1f} s")
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
    check_limb_codec()
    small_cross_check(cpu_proofs)
    cpu_pool.shutdown()
    del systems
    paths = {}
    # the later paths' circuits are made beside the Groth16 paths
    circuits = systems_circuits(args.systems_log2, args.new_log2,
                                args.adsnark_log2, args.mnt_log2,
                                args.edwards_log2)
    cycle = None
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
        # the cycle PCD path runs in its own process beside the proof-
        # systems, ADSNARK, BW6-761, mnt, PCD and RAM paths (host-bound,
        # 73-99 % idle on the card), the two processes taking turns on the
        # card: started here, it ends before the RAM path does
        log("pcd_cycle path: started in its own process, beside the "
            "systems, adsnark, bw6_761, mnt, pcd and ram paths")
        cycle = PathProcess(cycle_path_process)
        for label, counts in proof_systems_path(
                get_curve("alt_bn128"), args.systems_log2, paths,
                circuits).items():
            for key, n in counts.items():
                K.count(key, label, n)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
        for label, counts in adsnark_path(
                get_curve("alt_bn128"), args.adsnark_log2, paths,
                circuits["adsnark"]).items():
            for key, n in counts.items():
                K.count(key, label, n)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
        counts, yardsticks = main_path(
            get_curve("bw6_761"), args.new_log2, paths,
            circuit=circuits["bw6_761"], extras=False)
        for key, n in counts.items():
            # mont_mul_n24 (BW6-761's Fr) keeps the BLS12-377 path's count
            K.count(key, "bw6_761", n)
        for label, yard in yardsticks.items():
            for key, n in yard.items():
                K.count(key, label, n)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
        for name, counts in mnt_path(args, K, gen, paths, circuits).items():
            for key, n in counts.items():
                # mont_mul_n19 keeps the MNT4 path's count
                K.count(key, name, n)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
        for label, counts in pcd_path(paths).items():
            for key, n in counts.items():
                K.count(key, label, n)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
        for label, counts in ram_path(paths, args.ram_steps).items():
            for key, n in counts.items():
                K.count(key, label, n)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
        cycle_counts, cycle_paths = cycle.result()
    finally:
        stop_workers(circuits)
        if cycle is not None:
            cycle.stop()
    paths.update(cycle_paths)
    for label, counts in cycle_counts.items():
        for key, n in counts.items():
            K.count(key, label, n)
    log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
    for name, log2, small in (("bls12_377", args.kzg_log2, None),
                              ("alt_bn128", min(args.kzg_log2, 18), 12)):
        measured = paths if name == "bls12_377" else None
        for key, n in kzg_path(get_curve(name), log2, small,
                               measured).items():
            K.count(key, f"kzg_{name}", n)
        log(f"  elapsed {time.perf_counter() - t_start:.1f} s")
    return K, paths


if __name__ == "__main__":
    sys.exit(main())
