"""ram_zksnark profiling front-end (reference zk_proof_systems/zksnark/
ram_zksnark/profiling/profile_ram_zksnark.cpp): delegated-memory TinyRAM
proving, timed by phase.

Backends (--backend=X):
  transcript  one inner Groth16 proof a step over BLS12-377, the
              statement hashes chained (default)
  succinct    and one outer aggregation proof over BW6-761
  cycle       the unbounded MNT-cycle PCD (RamZkSnarkCycle)

usage: python -m libsnark_tpu_torch.profiles.profile_ram_zksnark
           [w] [k] [time_bound] [--backend=X] [--device cuda|cpu]
           (16, 4, 3)
"""
import sys

from ._common import check, split_device, profiling
from ..ops import cuda_lib
from ..profiling import enter_block

BACKENDS = ("transcript", "succinct", "cycle")


def main(argv=None) -> int:
    from .. import get_curve
    from ..proof_systems.ram_zksnark import (RamZkSnark, RamZkSnarkArchParams,
                                             RamZkSnarkCycle)
    from ..relations.tinyram import Opcode, TinyRAMParams, TinyRAMProgram
    device, argv = split_device(argv)
    args = [a for a in argv if not a.startswith("--")]
    backend = "transcript"
    for a in argv:
        if a.startswith("--backend="):
            backend = a.split("=", 1)[1]
    if backend not in BACKENDS:
        print(f"unknown backend {backend!r}: one of {', '.join(BACKENDS)}")
        return 1
    w = int(args[0]) if len(args) > 0 else 16
    kregs = int(args[1]) if len(args) > 1 else 4
    T = int(args[2]) if len(args) > 2 else 3
    dev = cuda_lib.resolve_device(device)
    ap = TinyRAMParams(w=w, k=kregs)
    arch = RamZkSnarkArchParams(ap=ap, tree_depth=min(8, w))
    prog = TinyRAMProgram()
    prog.add(Opcode.MOV, True, 0, 0, 7)
    prog.add(Opcode.STOREW, True, 0, 0, 5)
    prog.add(Opcode.ANSWER, True, 0, 0, 0)

    with profiling():
        if backend == "cycle":
            rs = RamZkSnarkCycle(device=dev)
            with enter_block("Generator (cycle keys; compliance + "
                             "translation)", sync=dev):
                kp = rs.generator(arch, seed=1)
            with enter_block(f"Prover ({T} PCD steps)", sync=dev):
                proof = rs.prover(kp, prog, [], T, [], seed=2)
            with enter_block("Verifier (host checks + one pairing check)"):
                ok = rs.verifier(kp.pcd_vk, arch, prog, [], T, proof)
        elif backend == "succinct":
            bw6 = get_curve("bw6_761")
            rs = RamZkSnark(get_curve("bls12_377"), device=dev)
            with enter_block("Generator (inner + outer aggregation keys)",
                             sync=dev):
                skp = rs.generator_succinct(arch, bw6, T, seed=1)
            with enter_block(f"Prover ({T} inner proves + outer prove)",
                             sync=dev):
                proof = rs.prover_succinct(skp, prog, [], T, [], seed=2)
            with enter_block("Verifier"):
                ok = rs.verifier_succinct(skp.outer_keypair.vk, arch, bw6,
                                          prog, [], T, proof)
        else:
            rs = RamZkSnark(get_curve("bls12_377"), device=dev)
            with enter_block("Generator (inner step keys)", sync=dev):
                kp = rs.generator(arch, seed=1)
            with enter_block("Message chain (execute + witness)"):
                _, msgs, _ = rs.run_and_chain(arch, prog, [], [], T)
            with enter_block(f"Prover ({T} inner proves)", sync=dev):
                proof = rs.prover(kp.pk, prog, [], T, [], seed=2)
            with enter_block("Verifier (endpoint checks + per-step "
                             "pairings)"):
                ok = rs.verify_transcript(kp.vk, prog, [], T, proof,
                                          all_messages=msgs)
    print(f"verification result: {'PASS' if ok else 'FAIL'}")
    check(ok, "the proof was rejected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
