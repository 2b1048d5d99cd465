"""RAM ppzkSNARK profiling front-end (reference profile_ram_ppzksnark.cpp):
the universal TinyRAM circuit (w = 16, k = 4) over alt_bn128 at a given
time bound, generator -> prover -> verifier under timers, on a program
that stores and loads a word and then answers 0.

usage: python -m libsnark_tpu_torch.profiles.profile_ram_ppzksnark
           [time_bound] [boot_bound] [--device cuda|cpu]   (4, 8)
"""
import sys

from ._common import check, split_device, profiling
from ..ops import cuda_lib
from ..profiling import enter_block


def main(argv=None, result=None) -> int:
    """result: optional dict that receives "keypair", "proof" and
    "boot_input"."""
    from .. import get_curve
    from ..proof_systems.ram_ppzksnark import RAMPpzksnark
    from ..relations.tinyram import Opcode, TinyRAMParams, TinyRAMProgram
    device, args = split_device(argv)
    T = int(args[0]) if len(args) > 0 else 4
    B = int(args[1]) if len(args) > 1 else 8
    dev = cuda_lib.resolve_device(device)
    prog = TinyRAMProgram()
    prog.add(Opcode.MOV, True, 0, 0, 7)
    prog.add(Opcode.STOREW, True, 0, 0, 64)
    prog.add(Opcode.LOADW, True, 1, 0, 64)
    prog.add(Opcode.ANSWER, True, 0, 0, 0)
    ps = RAMPpzksnark(get_curve("alt_bn128"), device=dev)
    with profiling():
        with enter_block("Generator (universal circuit)", sync=dev):
            kp = ps.ram_generator(TinyRAMParams(w=16, k=4), B, T, seed=1)
        with enter_block("Prover", sync=dev):
            proof, boot_primary = ps.ram_prover(kp.pk, prog, [], [], seed=2)
        with enter_block("Verifier"):
            ok = ps.ram_verifier(kp.vk, boot_primary, proof)
    print(f"verification result: {'PASS' if ok else 'FAIL'}")
    check(ok, "the proof was rejected")
    if result is not None:
        result.update(keypair=kp, proof=proof, boot_input=boot_primary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
