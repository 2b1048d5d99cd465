"""TinyRAM demo, step 2 of 3: read the proving key (``pk.pt``) onto the
device, run and prove a TinyRAM program, and write ``proof.txt`` and
``boot_input.txt`` in the text grammar of ``serialization.Codec``.

usage: python -m libsnark_tpu_torch.demos.demo_ram_ppzksnark_prover
         [dir] [program.txt] [--device cuda|cpu]
Program format: one instruction a line, ``OPCODE imm des arg1 arg2``;
without a program argument ``<dir>/program.txt`` is read (and written
first with the default store/load program if it is not there).
"""
import os
import sys

from ._ram_files import DEFAULT_PROGRAM, default_dir, load_program
from ..profiles._common import split_device, profiling
from ..ops import cuda_lib
from ..profiling import enter_block


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.ram_ppzksnark import RAMPpzksnark, load_proving_key
    from ..serialization import Codec
    device, args = split_device(argv)
    d = args[0] if len(args) > 0 else default_dir()
    dev = cuda_lib.resolve_device(device)
    if len(args) > 1:
        prog = load_program(args[1])
    else:
        path = os.path.join(d, "program.txt")
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(DEFAULT_PROGRAM)
        prog = load_program(path)
    curve = get_curve("alt_bn128")
    ps = RAMPpzksnark(curve, device=dev)
    codec = Codec(curve)
    with profiling():
        with enter_block("Read the proving key", sync=dev):
            pk = load_proving_key(os.path.join(d, "pk.pt"), dev)
        with enter_block("RAM ppzkSNARK prover", sync=dev):
            proof, boot_primary = ps.ram_prover(pk, prog, [], [], seed=2)
        with open(os.path.join(d, "proof.txt"), "wb") as f:
            codec.write_bctv14_proof(f, proof)
        with open(os.path.join(d, "boot_input.txt"), "wb") as f:
            codec.write_fr_vector(f, boot_primary)
    print(f"wrote {d}/proof.txt and {d}/boot_input.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
