"""Groth16 profiling front-end (reference
profile_r1cs_gg_ppzksnark.cpp:41-77) over alt_bn128, with the proof's
text-codec round trip.

usage: python -m libsnark_tpu_torch.profiles.profile_r1cs_gg_ppzksnark
           <num_constraints> <input_size> [Fr|bytes] [--device cuda|cpu]
"""
import sys

from ._common import (split_device, parse_std_args, profile_r1cs_system,
                      profiling)


def _serialize(curve, kp, proof):
    from ..serialization import Codec, reserialize
    codec = Codec(curve)
    return reserialize(codec, codec.write_groth16_proof,
                       codec.read_groth16_proof, proof)


def main(argv=None, result=None) -> int:
    """result: optional dict that receives "keypair", "proof", "primary"
    and "auxiliary"."""
    from ..proof_systems.groth16 import Groth16
    device, args = split_device(argv)
    nc, ninp = parse_std_args(args, prog="profile_r1cs_gg_ppzksnark")
    with profiling():
        profile_r1cs_system(Groth16, "alt_bn128", nc, ninp,
                            serialize_fns=_serialize, device=device,
                            result=result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
