"""MNT-cycle sp-PCD profiling front-end (reference
profile_r1cs_sp_ppzkpcd.cpp at its default instantiation, the MNT4/MNT6
cycle of r1cs_ppzkpcd_pp.hpp:27-38): a tally chain of the given depth with
real Groth16 proofs alternating between the two curves.

usage: python -m libsnark_tpu_torch.profiles.profile_r1cs_sp_ppzkpcd_cycle
           [depth] [--device cuda|cpu]   (2)
"""
import sys

from ._common import check, split_device, profiling
from ..ops import cuda_lib
from ..profiling import enter_block


def main(argv=None) -> int:
    from ..proof_systems.compliance_predicate import (
        PCDLocalData, TallyCompliancePredicate)
    from ..proof_systems.pcd_cycle import CycleSpPCD
    device, args = split_device(argv)
    depth = int(args[0]) if args else 2
    dev = cuda_lib.resolve_device(device)
    pcd = CycleSpPCD(device=dev)
    cp = TallyCompliancePredicate(pcd.A.r, max_arity=1)
    cp.generate_r1cs_constraints()
    with profiling():
        with enter_block("Generator (compliance A + translation B keys)",
                         sync=dev):
            pk, vk = pcd.generator(cp, seed=7)
        proof = None
        for d in range(depth):
            h = TallyCompliancePredicate(pcd.A.r, max_arity=1)
            h.generate_r1cs_constraints()
            with enter_block(f"PCD step depth={d} (prove A + translate B)",
                             sync=dev):
                proof = pcd.prover(pk, h, [proof] if proof else [],
                                   PCDLocalData(values=[d + 1]), seed=3 + d)
            print(f"  msg: {proof.msg.payload}")
        with enter_block("Verifier (one pairing check over B)"):
            ok = pcd.verifier(vk, proof.msg, proof)
    print(f"verified: {ok}")
    check(ok, "the proof was rejected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
