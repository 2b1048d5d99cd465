#!/usr/bin/env python3
"""Time add, madd, madd_win, bucket_reduce, aadd, aadd_rows and dbl of the
PyTorch/CUDA port under each register budget and form of the field
product, on one NVIDIA card.

Builds csrc/ec.cu and csrc/bucket.cu once per variant of ``VARIANTS``
(nvcc, one process per library, all started together, into
libsnark_tpu_torch/build/sweep/), against the built-in values: ``blocks
k`` sets every __launch_bounds__ minimum of ec.cuh that a -D sets
(LSN_ADD_BLOCKS_N16/_N24/_N48, LSN_MADD_BLOCKS_N16/_N24/_N48/_G2,
LSN_MADD_WIN_BLOCKS_N16/_N24/_N48/_G2_N16/_G2_N24,
LSN_BUCKET_BLOCKS_N16/_N24/_N48,
LSN_AADD_BLOCKS_N16/_N24/_N48/_G2_N16/_G2_N24,
LSN_DBL_BLOCKS_N16/_N24/_N48/_G2) to k, i.e. a budget of 65536 / (128 k)
registers a thread; ``product unrolled at 16 limbs`` / ``product
unrolled`` run the carry-chain product of field.cuh with its rounds
unrolled at 16 limbs / at every width instead of in its loop of two
rounds (LSN_CHAIN_ROLL_NW).

For each variant it prints ptxas's registers, stack frame and spills of
add_kernel, madd_kernel, madd_windows_kernel, bucket_reduce_kernel,
aadd_kernel, aadd_rows_kernel and dbl_kernel,
then the device time (mean of several launches: replayed in a CUDA graph
for the group ops, between CUDA events for bucket_reduce) of G1 and G2
add at 2^16 lanes (the kernel check's shape) and at 294,930 lanes (one
suffix-scan launch of a 2^20-point MSM), of madd at 2^16 lanes, of
madd_win (the windowed fixed-base madd) at 2^20 lanes on the keygen's
table (c = 8, 32 windows), and of bucket_reduce on the length-ordered
segments of a 2^16-point MSM (c = 11) and of a 2^20-point MSM (c = 15,
the path's shape), of aadd and dbl at 2^16 lanes (the kernel check's
shape) and of aadd_rows on the first dense chunk of a 2^20-point MSM
(c = 15, the dense prove's level 0), for alt_bn128 (16 limbs) and
BLS12-377 (24 limbs), or the curves ``--curves`` names (BW6-761: 48
limbs, G1 and G2 both over Fq; madd_win there has 48 windows).
Points are 64 distinct ones spread over the lanes (a madd's work does not
depend on which point it adds). Every variant's results are held
bit-exact against the built-in one. Last, one JSON line with every time
and the card's name and power limit.

    python3 scripts/sweep_launch_bounds.py                 # needs one card
    python3 scripts/sweep_launch_bounds.py --variants "blocks 3"
    python3 scripts/sweep_launch_bounds.py --kernels madd madd_win
    python3 scripts/sweep_launch_bounds.py --kernels aadd aadd_rows dbl \
        --variants "blocks 1" "blocks 2" "blocks 3" "blocks 4"
    python3 scripts/sweep_launch_bounds.py --curves bw6_761 \
        --kernels add madd_win bucket_reduce aadd_rows
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCES = ("ec", "bucket")
_BLOCKS = ("LSN_ADD_BLOCKS_N16", "LSN_ADD_BLOCKS_N24", "LSN_MADD_BLOCKS_N16",
           "LSN_MADD_BLOCKS_N24", "LSN_MADD_BLOCKS_G2",
           "LSN_MADD_WIN_BLOCKS_N16", "LSN_MADD_WIN_BLOCKS_N24",
           "LSN_MADD_WIN_BLOCKS_G2_N16", "LSN_MADD_WIN_BLOCKS_G2_N24",
           "LSN_BUCKET_BLOCKS_N16",
           "LSN_BUCKET_BLOCKS_N24", "LSN_AADD_BLOCKS_N16",
           "LSN_AADD_BLOCKS_N24", "LSN_AADD_BLOCKS_G2_N16",
           "LSN_AADD_BLOCKS_G2_N24", "LSN_DBL_BLOCKS_N16",
           "LSN_DBL_BLOCKS_N24", "LSN_DBL_BLOCKS_G2", "LSN_ADD_BLOCKS_N48",
           "LSN_MADD_BLOCKS_N48", "LSN_MADD_WIN_BLOCKS_N48",
           "LSN_BUCKET_BLOCKS_N48", "LSN_AADD_BLOCKS_N48",
           "LSN_DBL_BLOCKS_N48")
KERNELS = ("add", "madd", "madd_win", "bucket_reduce", "aadd", "aadd_rows",
           "dbl")
# variant -> its -D flags
VARIANTS = {f"blocks {k}": [f"-D{m}={k}" for m in _BLOCKS] for k in (1, 2, 3, 4)}
VARIANTS.update({"product unrolled at 16 limbs": ["-DLSN_CHAIN_ROLL_NW=12"],
                 "product unrolled": ["-DLSN_CHAIN_ROLL_NW=99"]})


def build_variants(names, sources=SOURCES):
    """{variant: {source: (ctypes library, ptxas log)}}; raises if nvcc
    fails. 'built-in' is the library cuda_lib builds."""
    from libsnark_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    out = {"built-in": {s: (cuda_lib.lib(s), cuda_lib.build_logs.get(s, ""))
                        for s in sources}}
    bdir = cuda_lib.BUILD_DIR / "sweep"
    bdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        for src in sources:
            tag = "".join(ch for ch in name if ch.isalnum())
            so = bdir / f"lib{src}-{tag}-{os.getpid()}.so"
            cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, *VARIANTS[name],
                   "-o", str(so), str(cuda_lib.CSRC / f"{src}.cu")]
            procs[(name, src)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    for (name, src), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({name}, {src}):\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in cuda_lib._ARGTYPES[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        out.setdefault(name, {})[src] = (lib, log)
    return out


def cuda_ms(fn, reps):
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


CURVES = ("alt_bn128", "bls12_377")


def cases(kernels=KERNELS, seed=5, curves=CURVES):
    """(label, callable returning the kernel's outputs) for every timed
    launch of the given kernels, on the card; the callables go through the
    port's wrappers."""
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.ops import cuda_bucket, cuda_ec
    from libsnark_tpu_torch.proof_systems.base import PairingSystem
    from chip_smoke import (SCAN_LANES, dense_chunk, ec_inputs, msm_inputs,
                            rand_field)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = random.Random(seed)
    out = []
    for name in curves:
        ps = PairingSystem(get_curve(name), device="cuda")
        for ck, mk, group in ((ps.g1, ps.msm_g1, ps.curve.G1),
                              (ps.g2, ps.msm_g2, ps.curve.G2)):
            fk = ck.fk
            tag = f"{'G2' if ck is ps.g2 else 'G1'} N={fk.N}"
            for L in (1 << 16, SCAN_LANES):
                P, Q, Pa, Qa, valid = ec_inputs(ps.curve, ck, group, L, gen,
                                                rng)
                if "add" in kernels:
                    out.append((f"add {tag} {L} lanes",
                                lambda fk=fk, P=P, Q=Q: cuda_ec.add(fk, P, Q)))
                if L != 1 << 16:
                    continue
                if "madd" in kernels:
                    out.append((f"madd {tag} {L} lanes",
                                lambda fk=fk, P=P, Qa=Qa, v=valid:
                                cuda_ec.madd(fk, P, Qa, v)))
                if "aadd" in kernels:
                    out.append((f"aadd {tag} {L} lanes",
                                lambda fk=fk, Pa=Pa, Qa=Qa:
                                cuda_ec.aadd(fk, Pa, Qa)))
                if "dbl" in kernels:
                    out.append((f"dbl {tag} {L} lanes",
                                lambda fk=fk, P=P: cuda_ec.dbl(fk, P)))
            if "aadd_rows" in kernels:
                pts, sc = msm_inputs(ps.curve, ps, ck, group, 1 << 20, gen, rng)
                runs, chunk = dense_chunk(mk, pts, sc, 15)
                out.append((f"aadd_rows {tag} {1 << 20} points c=15",
                            lambda fk=fk, runs=runs, chunk=chunk:
                            cuda_ec.aadd_rows(fk, *runs, *chunk)))
            if "madd_win" in kernels:
                _, rows = ps._window_table_affine(ck, mk, group.one(), 8)
                sc = rand_field(ps.fr, (1 << 20,), gen)
                out.append((f"madd_win {tag} {1 << 20} lanes c=8",
                            lambda fk=fk, rows=rows, sc=sc:
                            cuda_ec.madd_windows(fk, rows, sc, 8)))
            if "bucket_reduce" not in kernels:
                continue
            for m, c in ((1 << 16, 11), (1 << 20, 15)):
                pts, sc = msm_inputs(ps.curve, ps, ck, group, m, gen, rng)
                seg = mk.bucket_segments(sc, c)
                args = (mk.row_table(pts), seg["gidx"], seg["seg_start"],
                        seg["seg_count"], seg["seg_order"])
                out.append((f"bucket_reduce {tag} {m} points c={c}",
                            lambda fk=fk, args=args:
                            cuda_bucket.bucket_reduce(fk, *args)))
    return out


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS),
                    choices=list(KERNELS))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--curves", nargs="+", default=list(CURVES),
                    choices=("alt_bn128", "bls12_377", "bw6_761"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_launch_bounds: no CUDA device available", file=sys.stderr)
        return 2
    from libsnark_tpu_torch import probes
    from libsnark_tpu_torch.ops import cuda_lib
    card = card_line()
    print(f"card: {card}", flush=True)
    variants = build_variants(args.variants, ("ec", "bucket") if
                              "bucket_reduce" in args.kernels else ("ec",))
    for name, libs in variants.items():
        for line in cuda_lib.ptxas_summary({s: log for s, (_, log)
                                            in libs.items()}):
            if any(f" {k}_kernel<" in line for k in
                   ("add", "madd", "madd_windows", "bucket_reduce", "aadd",
                    "aadd_rows", "dbl")):
                print(f"  [{name}] {line}", flush=True)
    timed = cases(args.kernels, curves=args.curves)
    want = {label: fn() for label, fn in timed}
    builtin = {s: lib for s, (lib, _) in variants["built-in"].items()}
    table = {}
    for name, libs in variants.items():
        for s, (lib, _) in libs.items():
            cuda_lib._libs[s] = lib
        for label, fn in timed:
            if not all(torch.equal(a, b) for a, b in zip(fn(), want[label])):
                raise AssertionError(f"{name}: {label} differs from the "
                                     "built-in kernel")
            # the group ops in a replayed CUDA graph: at 2^16 lanes the
            # wrapper called in a loop takes longer on the host than the
            # kernel on the card
            graph = ("add", "madd", "madd_win", "aadd", "dbl")
            ms = (probes._graph_ms(fn, args.reps)
                  if label.split()[0] in graph else cuda_ms(fn, args.reps))
            table.setdefault(label, {})[name] = ms
            print(f"  [{name}] {label}: {ms:.4f} ms", flush=True)
        cuda_lib._libs.update(builtin)
    print("fastest variant per case:")
    for label, row in table.items():
        best = min(row, key=row.get)
        print(f"  {label}: {best} ({row[best]:.4f} ms; built-in "
              f"{row['built-in']:.4f})")
    print(json.dumps({"card": card, "ms": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
