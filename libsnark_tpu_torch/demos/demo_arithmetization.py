"""TinyRAM arithmetization demo (reference reductions/ram_to_r1cs/
examples/demo_arithmetization.cpp): load a preprocessed TinyRAM program,
architecture params, computation bounds and input tapes from files, build
the universal circuit (ram_to_r1cs instance map), execute and route the
program (auxiliary input map) and report whether the R1CS is satisfied,
on the host and on the device R1CS (three mat-vecs, a product and a
subtraction on the card; the plain versions with ``--device cpu``).

usage: python -m libsnark_tpu_torch.demos.demo_arithmetization
         --assembly f.s --processed_assembly f.txt
         --architecture_params ap.txt --computation_bounds cb.txt
         --primary_input pi.txt --auxiliary_input ai.txt
         [--device cuda|cpu]
File formats: see ``demos/_ram_files.py``.
"""
import sys

from ._ram_files import parse_ram_files, read_ram_files
from ..ops import cuda_lib
from ..profiles._common import profiling
from ..profiling import enter_block


def main(argv=None) -> int:
    from .. import get_curve
    from ..gadgets.ram_universal import ram_to_r1cs_instance_map
    from ..proof_systems.base import PairingSystem
    from ..relations.r1cs import R1CSDevice
    args = parse_ram_files(argv)
    dev = cuda_lib.resolve_device(args.device)
    print("=" * 79)
    print("TinyRAM example loader")
    print("=" * 79 + "\n")
    ap, bounds, program, primary, auxiliary = read_ram_files(args)
    input_size_bound, program_size_bound, time_bound = bounds
    print(f"Will run on {ap.k} register machine (word size = {ap.w})")
    print(f"Program: {program.size} instructions "
          f"(raw assembly at {args.assembly})")
    boot_trace_size_bound = program_size_bound + input_size_bound
    curve = get_curve("alt_bn128")
    with profiling():
        with enter_block("Build universal circuit (ram_to_r1cs instance "
                         "map)"):
            pb, g = ram_to_r1cs_instance_map(
                curve.r, ap, boot_trace_size_bound, time_bound)
        print(f"universal R1CS: {pb.num_constraints} constraints, "
              f"{pb.num_variables} variables")
        with enter_block("Execute program (auxiliary input map)"):
            answer, accepted = g.generate_r1cs_witness(program, primary,
                                                       auxiliary)
        print(f"program answer = {answer}, accepted = {accepted}")
        ok = pb.is_satisfied()
        print(f"R1CS satisfied: {ok}")
        system = PairingSystem(curve, device=dev)
        with enter_block(f"Check the R1CS on {dev.type}", sync=dev):
            r1cs_dev = R1CSDevice.build(pb.get_constraint_system(),
                                        system.fr)
            bad = system.first_unsatisfied(r1cs_dev, pb)
    print(f"first unsatisfied constraint on {dev.type}: {bad}")
    return 0 if (ok and accepted and bad is None) else 1


if __name__ == "__main__":
    sys.exit(main())
