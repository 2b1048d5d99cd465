"""Combined TinyRAM ppzkSNARK demo (reference zk_proof_systems/
ppzksnark/ram_ppzksnark/examples/demo_ram_ppzksnark.cpp): one process
doing generator -> prover -> verifier on a program, bounds and tapes read
from files (demo_arithmetization's file contract; the three split demos
demo_ram_ppzksnark_{generator,prover,verifier} exchange keys and proofs
through files).

usage: python -m libsnark_tpu_torch.demos.demo_ram_ppzksnark
         --assembly f.s --processed_assembly f.txt
         --architecture_params ap.txt --computation_bounds cb.txt
         --primary_input pi.txt --auxiliary_input ai.txt
         [--device cuda|cpu]
"""
import sys

from ._ram_files import parse_ram_files, read_ram_files
from ..ops import cuda_lib
from ..profiles._common import profiling
from ..profiling import enter_block


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.ram_ppzksnark import RAMPpzksnark
    args = parse_ram_files(argv)
    dev = cuda_lib.resolve_device(args.device)
    ap, bounds, program, primary, auxiliary = read_ram_files(args)
    input_size_bound, program_size_bound, time_bound = bounds
    ps = RAMPpzksnark(get_curve("alt_bn128"), device=dev)
    boot_bound = program_size_bound + input_size_bound
    with profiling():
        with enter_block("RAM ppzkSNARK generator", sync=dev):
            kp = ps.ram_generator(ap, boot_bound, time_bound)
        with enter_block("RAM ppzkSNARK prover", sync=dev):
            proof, boot_primary = ps.ram_prover(kp.pk, program, primary,
                                                auxiliary)
        with enter_block("RAM ppzkSNARK verifier"):
            ok = ps.ram_verifier(kp.vk, boot_primary, proof)
    print(f"* The verification result is: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
