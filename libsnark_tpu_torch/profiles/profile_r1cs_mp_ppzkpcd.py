"""mp-PCD profiling front-end (reference profile_r1cs_mp_ppzkpcd.cpp): two
tally predicates aggregated under a committed vk set, with real Groth16
proofs over the one-layer BLS12-377 -> BW6-761 substitution
(proof_systems/mp_pcd.py).

usage: python -m libsnark_tpu_torch.profiles.profile_r1cs_mp_ppzkpcd
           [num_proofs] [--device cuda|cpu]   (2)
"""
import sys

from ._common import check, split_device, profiling
from ..ops import cuda_lib
from ..profiling import enter_block


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.compliance_predicate import (
        PCDLocalData, PCDMessage, TallyCompliancePredicate)
    from ..proof_systems.mp_pcd import MpPCD
    device, args = split_device(argv)
    k = int(args[0]) if args else 2
    dev = cuda_lib.resolve_device(device)
    bls = get_curve("bls12_377")
    mp = MpPCD(bls, get_curve("bw6_761"), device=dev)

    def handler():
        h = TallyCompliancePredicate(bls.r, max_arity=1)
        h.generate_r1cs_constraints()
        return h

    handlers = {"tally_a": handler(), "tally_b": handler()}
    with profiling():
        with enter_block(f"Generator ({len(handlers)} predicates, vk set)",
                         sync=dev):
            pk, vk = mp.generator(handlers, num_proofs=k, seed=7)
        steps = []
        with enter_block(f"Inner proves x{k} (alternating predicates)",
                         sync=dev):
            for i in range(k):
                name = "tally_a" if i % 2 == 0 else "tally_b"
                hw = handler()
                hw.generate_r1cs_witness(
                    [PCDMessage(type=1, payload=[10 + i, 1])],
                    PCDLocalData(values=[5 + i]))
                primary = hw.pb.primary_input()
                pi = mp.g16_inner.prover(pk.inner_keypairs[name].pk,
                                         primary, hw.pb.auxiliary_input(),
                                         seed=3 + i)
                steps.append((name, primary, pi))
        with enter_block("Outer prove (vk-membership aggregation)",
                         sync=dev):
            proof = mp.prover(pk, steps, seed=11)
        with enter_block("Verifier"):
            ok = mp.verifier(vk, [s for _, s, _ in steps], proof)
    print(f"verification result: {'PASS' if ok else 'FAIL'}")
    check(ok, "the proof was rejected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
