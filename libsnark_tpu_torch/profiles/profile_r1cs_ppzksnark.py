"""BCTV14 profiling front-end (reference profile_r1cs_ppzksnark.cpp)
over alt_bn128.

usage: python -m libsnark_tpu_torch.profiles.profile_r1cs_ppzksnark
           <num_constraints> <input_size> [Fr|bytes] [--device cuda|cpu]
"""
import sys

from ._common import (split_device, parse_std_args, profile_r1cs_system,
                      profiling)


def main(argv=None) -> int:
    from ..proof_systems.bctv14 import BCTV14
    device, args = split_device(argv)
    nc, ninp = parse_std_args(args, prog="profile_r1cs_ppzksnark")
    with profiling():
        profile_r1cs_system(BCTV14, "alt_bn128", nc, ninp, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
