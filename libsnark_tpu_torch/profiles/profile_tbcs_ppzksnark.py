"""TBCS ppzkSNARK profiling front-end (reference
profile_tbcs_ppzksnark.cpp) over alt_bn128.

usage: python -m libsnark_tpu_torch.profiles.profile_tbcs_ppzksnark
           [num_gates] [input_size] [--device cuda|cpu]
"""
import sys

from ._common import check, split_device, profiling
from ..ops import cuda_lib
from ..profiling import enter_block


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.tbcs_ppzksnark import TBCSPpzksnark
    from ..relations.examples import generate_tbcs_example
    device, args = split_device(argv)
    ng = int(args[0]) if len(args) > 0 else 100
    ninp = int(args[1]) if len(args) > 1 else 4
    dev = cuda_lib.resolve_device(device)
    curve = get_curve("alt_bn128")
    with profiling():
        with enter_block("Generate TBCS example"):
            circuit, bits, aux = generate_tbcs_example(ng, ninp)
        ps = TBCSPpzksnark(curve, device=dev)
        with enter_block("Generator", sync=dev):
            kp = ps.tbcs_generator(circuit, seed=1)
        with enter_block("Prover", sync=dev):
            proof = ps.tbcs_prover(kp.pk, bits, aux, seed=2)
        with enter_block("Verifier"):
            ok = ps.tbcs_verifier_strong_IC(kp.vk, bits, proof)
    print(f"verification result: {'PASS' if ok else 'FAIL'}")
    check(ok, "the proof was rejected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
