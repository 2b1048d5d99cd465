"""TinyRAM demo, step 3 of 3: read ``vk.txt``, ``proof.txt`` and
``boot_input.txt`` and verify (host pairings). Exit code 0 when the proof
is accepted, 1 when it is rejected.

usage: python -m libsnark_tpu_torch.demos.demo_ram_ppzksnark_verifier
         [dir] [--device cuda|cpu]
"""
import os
import sys

from ._ram_files import default_dir
from ..profiles._common import split_device
from ..ops import cuda_lib


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.ram_ppzksnark import RAMPpzksnark
    from ..serialization import Codec
    device, args = split_device(argv)
    d = args[0] if len(args) > 0 else default_dir()
    dev = cuda_lib.resolve_device(device)
    curve = get_curve("alt_bn128")
    ps = RAMPpzksnark(curve, device=dev)
    codec = Codec(curve)
    with open(os.path.join(d, "vk.txt"), "rb") as f:
        vk = codec.read_bctv14_vk(f)
    with open(os.path.join(d, "proof.txt"), "rb") as f:
        proof = codec.read_bctv14_proof(f)
    with open(os.path.join(d, "boot_input.txt"), "rb") as f:
        boot_primary = codec.read_fr_vector(f)
    ok = ps.ram_verifier(vk, boot_primary, proof)
    print(f"verification result: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
