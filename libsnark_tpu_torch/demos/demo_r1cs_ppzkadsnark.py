"""ADSNARK demo (reference zk_proof_systems/ppzkadsnark/r1cs_ppzkadsnark/
examples/demo_r1cs_ppzkadsnark.cpp) over alt_bn128: generate a synthetic
R1CS, authenticate the input data (the signature's public path and the
symmetric path), prove over the authenticated data, verify both ways.

usage: python -m libsnark_tpu_torch.demos.demo_r1cs_ppzkadsnark
         <num_constraints> <input_size> [Fr|bytes] [--device cuda|cpu]
(the reference argv contract, demo_r1cs_ppzkadsnark.cpp:29-41; ``-v``
prints the name and exits).
"""
import sys

from ..ops import cuda_lib
from ..profiles._common import ALT_BN128_R, split_device, profiling
from ..profiling import enter_block


def main(argv=None) -> int:
    device, args = split_device(argv)
    if args == ["-v"]:
        print("libsnark_tpu_torch demo_r1cs_ppzkadsnark")
        return 0
    if len(args) not in (2, 3) or (len(args) == 3
                                   and args[2] not in ("Fr", "bytes")):
        print("usage: demo_r1cs_ppzkadsnark num_constraints input_size "
              "[Fr|bytes]")
        return 1
    from .. import get_curve
    from ..proof_systems.adsnark import ADSNARK
    from ..relations.examples import generate_r1cs_example
    dev = cuda_lib.resolve_device(device)
    curve = get_curve("alt_bn128")
    num_constraints, input_size = int(args[0]), int(args[1])
    if len(args) == 3 and args[2] == "bytes":
        input_size = -(-8 * input_size // (ALT_BN128_R.bit_length() - 1))
    with profiling():
        with enter_block("Generate R1CS example"):
            cs, primary, aux = generate_r1cs_example(
                curve.r, num_constraints, input_size)
        ads = ADSNARK(curve, device=dev)
        with enter_block("ADSNARK authentication keygen"):
            keys = ads.auth_generator()
        labels = [f"input{i}".encode() for i in range(len(primary))]
        with enter_block("Authenticate data (signature + symmetric)"):
            auth = ads.auth_sign(primary, keys.sak, labels)
            signed = ads.auth_verify_pub(primary, auth, keys.pak, labels)
        with enter_block("ADSNARK generator", sync=dev):
            kp = ads.generator(cs, keys.pap)
        with enter_block("ADSNARK prover", sync=dev):
            proof = ads.prover(kp.pk, primary, aux, auth)
        with enter_block("ADSNARK verifier (symmetric)"):
            ok_sec = ads.verifier_sec(kp.vk, proof, keys.sak, labels)
        with enter_block("ADSNARK verifier (public)"):
            ok_pub = ads.verifier_pub(kp.vk, auth, proof, keys.pak, labels)
    print(f"* Signed data verification: {'PASS' if signed else 'FAIL'}")
    print(f"* Symmetric verification: {'PASS' if ok_sec else 'FAIL'}")
    print(f"* Public verification:    {'PASS' if ok_pub else 'FAIL'}")
    return 0 if (signed and ok_sec and ok_pub) else 1


if __name__ == "__main__":
    sys.exit(main())
