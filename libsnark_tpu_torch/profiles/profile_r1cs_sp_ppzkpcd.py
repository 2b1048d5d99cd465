"""sp-PCD profiling front-end (reference profile_r1cs_sp_ppzkpcd.cpp): a
tally-predicate chain with real inner and outer Groth16 proofs over the
one-layer BLS12-377 -> BW6-761 substitution (proof_systems/pcd.py).

usage: python -m libsnark_tpu_torch.profiles.profile_r1cs_sp_ppzkpcd
           [num_proofs] [--device cuda|cpu]   (1)
"""
import sys

from ._common import check, split_device, profiling
from ..ops import cuda_lib
from ..profiling import enter_block


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.compliance_predicate import (
        PCDLocalData, PCDMessage, TallyCompliancePredicate)
    from ..proof_systems.pcd import SpPCD
    device, args = split_device(argv)
    k = int(args[0]) if args else 1
    dev = cuda_lib.resolve_device(device)
    bls = get_curve("bls12_377")
    pcd = SpPCD(bls, get_curve("bw6_761"), device=dev)
    cp = TallyCompliancePredicate(bls.r, max_arity=2)
    cp.generate_r1cs_constraints()
    with profiling():
        with enter_block("Generator (inner + outer keys)", sync=dev):
            pk, vk = pcd.generator(cp, num_proofs=k, seed=7)
        stmts, proofs = [], []
        with enter_block(f"Inner proves x{k}", sync=dev):
            for i in range(k):
                cpw = TallyCompliancePredicate(bls.r, max_arity=2)
                cpw.generate_r1cs_constraints()
                s, pi = pcd.prove_step(
                    pk, cpw, [PCDMessage(type=1, payload=[10 + i, 1])],
                    PCDLocalData(values=[5 + i]), seed=3 + i)
                stmts.append(s)
                proofs.append(pi)
        with enter_block("Outer prove (aggregation)", sync=dev):
            proof = pcd.prover(pk, stmts, proofs, seed=11)
        with enter_block("Verifier"):
            ok = pcd.verifier(vk, stmts, proof)
    print(f"verification result: {'PASS' if ok else 'FAIL'}")
    check(ok, "the proof was rejected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
