"""DFGK14 (uscs_ppzksnark) profiling front-end (reference
uscs_ppzksnark/profiling/profile_uscs_ppzksnark.cpp) over alt_bn128.

usage: python -m libsnark_tpu_torch.profiles.profile_uscs_ppzksnark
           <num_constraints> <input_size> [Fr|bytes] [--device cuda|cpu]
"""
import sys

from ._common import (check, split_device, parse_std_args, profiling)
from ..ops import cuda_lib
from ..profiling import enter_block


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.dfgk14 import DFGK14
    from ..relations.examples import generate_uscs_example
    device, args = split_device(argv)
    nc, ninp = parse_std_args(args, prog="profile_uscs_ppzksnark")
    dev = cuda_lib.resolve_device(device)
    curve = get_curve("alt_bn128")
    with profiling():
        with enter_block("Generate USCS example"):
            cs, primary, aux = generate_uscs_example(curve.r, nc, ninp)
        system = DFGK14(curve, device=dev)
        with enter_block("Generator", sync=dev):
            kp = system.generator(cs, seed=1)
        with enter_block("Prover", sync=dev):
            proof = system.prover(kp.pk, primary, aux, seed=2)
        with enter_block("Verifier"):
            ok = system.verifier_strong_IC(kp.vk, primary, proof)
    print(f"verification result: {'PASS' if ok else 'FAIL'}")
    check(ok, "the proof was rejected")
    bad = system.verifier_strong_IC(
        kp.vk, [(primary[0] + 1) % curve.r] + list(primary[1:]), proof)
    print(f"tampered-input result: {'FAIL (expected)' if not bad else 'BUG'}")
    check(not bad, "the proof was accepted for a changed input")
    return 0


if __name__ == "__main__":
    sys.exit(main())
