"""TinyRAM demo, step 1 of 3 (reference demo_ram_ppzksnark_generator):
run the universal circuit's generator (TinyRAM w = 16, k = 4, over
alt_bn128) and write the keys to files: ``vk.txt`` in the text grammar of
``serialization.Codec`` (the JAX package reads it too) and ``pk.pt``, the
port's own format (``ram_ppzksnark.save_proving_key``: its tensors copied
to the CPU).

usage: python -m libsnark_tpu_torch.demos.demo_ram_ppzksnark_generator
         [outdir] [time_bound] [boot_bound] [--device cuda|cpu]
(defaults: <temporary directory>/ram_demo, 4, 8)
"""
import os
import sys

from ._ram_files import default_dir
from ..profiles._common import split_device, profiling
from ..ops import cuda_lib
from ..profiling import enter_block


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.ram_ppzksnark import RAMPpzksnark, save_proving_key
    from ..relations.tinyram import TinyRAMParams
    from ..serialization import Codec
    device, args = split_device(argv)
    outdir = args[0] if len(args) > 0 else default_dir()
    T = int(args[1]) if len(args) > 1 else 4
    B = int(args[2]) if len(args) > 2 else 8
    dev = cuda_lib.resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    curve = get_curve("alt_bn128")
    ps = RAMPpzksnark(curve, device=dev)
    with profiling():
        with enter_block("RAM ppzkSNARK generator", sync=dev):
            kp = ps.ram_generator(TinyRAMParams(w=16, k=4), B, T, seed=1)
        with enter_block("Write the keys"):
            with open(os.path.join(outdir, "vk.txt"), "wb") as f:
                Codec(curve).write_bctv14_vk(f, kp.vk)
            save_proving_key(kp.pk, os.path.join(outdir, "pk.pt"))
    print(f"wrote {outdir}/vk.txt and {outdir}/pk.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
