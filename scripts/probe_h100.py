#!/usr/bin/env python3
"""Print the card's 32-bit operation rates and Montgomery-product rates.

Runs the two probe kernels of the PyTorch/CUDA port
(libsnark_tpu_torch/probes.py, csrc/probe.cu) on one NVIDIA card:

* the integer-rate probe: 8 independent dependent-chains per thread of
  mul.lo, mad.lo, mad.hi, mad.wide (the 32x32->64 multiply-add of CIOS),
  a 64-bit add, shift+and and an f32 multiply; final values checked
  against the plain int64 chain, then G steps/s, with the instructions of
  each kernel's main loop read from the built library (cuobjdump -sass), so
  that a step's rate can be told from an instruction's;
* the CIOS-variant probe: K chained Montgomery products per lane at 8 and
  12 words (alt_bn128 Fq, BLS12-377 Fq) in the CIOS body of csrc/field.cuh
  and a separated operand-scanning body; each checked against the plain
  Montgomery product, then G products/s.

chip_smoke.py's kernel bounds take half the 32-bit lane rate as the peak
of the wide multiply-add (INT32_OPS_PER_S there); the mad.wide row and its
loop's instruction counts show how near the toolchain's chain comes.

    python3 scripts/probe_h100.py          # needs one CUDA card and nvcc
    python3 scripts/probe_h100.py --sass out/probe.sass    # keep the listing

Prints one table per probe, the main-loop instruction counts, then one JSON
line with every row and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", default=None,
                    help="write the probe library's cuobjdump -sass text here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_h100: no CUDA device available", file=sys.stderr)
        return 2
    from libsnark_tpu_torch import get_curve, probes
    from libsnark_tpu_torch.ops.fp import FpKernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    rates = probes.measure_rates()
    print(f"{'op':<10} {'exact':<6} {'ms':>9} {'G steps/s':>11}")
    for r in rates:
        print(f"{r['op']:<10} {str(r['exact']):<6} {r['ms']:9.4f} "
              f"{r['gsteps_per_s']:11.1f}", flush=True)
    fks = [FpKernel(get_curve(c).fq_params)
           for c in ("alt_bn128", "bls12_377")]
    cios = probes.measure_cios(fks)
    print(f"{'limbs':<6} {'variant':<8} {'exact':<6} {'ms':>9} "
          f"{'G products/s':>13} {'G wide mads/s':>14}")
    for r in cios:
        print(f"{r['N']:<6} {r['variant']:<8} {str(r['exact']):<6} "
              f"{r['ms']:9.4f} {r['gproducts_per_s']:13.3f} "
              f"{r['gproducts_per_s'] * r['wide_mads_per_product']:14.1f}",
              flush=True)
    loops = probes.sass_loops(dump_to=args.sass)
    print("main loop of each kernel (cuobjdump -sass):")
    for key, loop in loops.items():
        print(f"  {key}: {sum(loop.values())} instructions: "
              + ", ".join(f"{n} {opc}" for opc, n in loop.items()), flush=True)
    print(json.dumps({"card": card, "rates": rates, "cios": cios,
                      "main_loops": loops}))
    bad = [r for r in rates + cios if not r["exact"]]
    if bad:
        print(f"probe_h100: {len(bad)} kernels differ from their plain "
              f"versions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
