"""BACS ppzkSNARK profiling front-end (reference
profile_bacs_ppzksnark.cpp) over alt_bn128.

usage: python -m libsnark_tpu_torch.profiles.profile_bacs_ppzksnark
           [num_gates] [input_size] [--device cuda|cpu]
"""
import sys

from ._common import check, split_device, profiling
from ..ops import cuda_lib
from ..profiling import enter_block


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.bacs_ppzksnark import BACSPpzksnark
    from ..relations.examples import generate_bacs_example
    device, args = split_device(argv)
    ng = int(args[0]) if len(args) > 0 else 100
    ninp = int(args[1]) if len(args) > 1 else 4
    dev = cuda_lib.resolve_device(device)
    curve = get_curve("alt_bn128")
    with profiling():
        with enter_block("Generate BACS example"):
            circuit, primary, aux = generate_bacs_example(curve.r, ng, ninp)
        ps = BACSPpzksnark(curve, device=dev)
        with enter_block("Generator", sync=dev):
            kp = ps.bacs_generator(circuit, seed=1)
        with enter_block("Prover", sync=dev):
            proof = ps.bacs_prover(kp.pk, primary, aux, seed=2)
        with enter_block("Verifier"):
            ok = ps.verifier_strong_IC(kp.vk, primary, proof)
    print(f"verification result: {'PASS' if ok else 'FAIL'}")
    check(ok, "the proof was rejected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
