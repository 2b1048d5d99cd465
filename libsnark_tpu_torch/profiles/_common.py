"""Shared plumbing of the profile_* front-ends (the port of
profiles/_common.py; the reference's libsnark/*/profiling/profile_*.cpp
harness layer).

Each profile mirrors its reference executable's argv contract, e.g.
  python -m libsnark_tpu_torch.profiles.profile_r1cs_gg_ppzksnark
      <num_constraints> <input_size> [Fr|bytes] [--device cuda|cpu]
and runs generator -> prover -> verifier under the port's phase timers
(``profiling.enter_block``, which waits for the card before it stops the
clock). ``--device`` (default ``cuda``) is taken out of argv before the
positional arguments are read; without a card only ``--device cpu``
runs, on the plain PyTorch versions of every kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

from ..ops import cuda_lib
from ..profiling import PROFILER, enter_block, start_profiling

# alt_bn128's scalar field order: the bytes -> field elements conversion
# packs (bits - 1) bits an element
ALT_BN128_R = int("21888242871839275222246405745257275088"
                  "548364400416034343698204186575808495617")


def split_device(argv=None):
    """(device, the other arguments) of a front-end's argv (sys.argv[1:]
    when None): ``--device cuda|cpu`` (or ``--device=...``) taken out;
    "cuda" if absent."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ns, rest = ap.parse_known_args(sys.argv[1:] if argv is None
                                   else list(argv))
    return ns.device, rest


def parse_std_args(args, default_constraints=1000, default_inputs=10,
                   prog="profile"):
    """num_constraints input_size [Fr|bytes] (profile_r1cs_gg_
    ppzksnark.cpp:52-64): (num_constraints, num_inputs). Any other arity
    prints the usage line and exits with code 1; ``bytes`` converts a
    byte count to field elements of alt_bn128's Fr (one bit spare)."""
    if len(args) not in (0, 2, 3):
        print(f"usage: {prog} num_constraints input_size [Fr|bytes]")
        raise SystemExit(1)
    nc = int(args[0]) if args else default_constraints
    ninp = int(args[1]) if args else default_inputs
    if len(args) == 3:
        if args[2] not in ("Fr", "bytes"):
            print(f"usage: {prog} num_constraints input_size [Fr|bytes]")
            raise SystemExit(1)
        if args[2] == "bytes":
            cap = ALT_BN128_R.bit_length() - 1
            ninp = -(-8 * ninp // cap)
    return nc, ninp


@contextlib.contextmanager
def profiling():
    """The port's profiler on, its totals cleared, for one front-end run;
    on or off afterwards as it was before (``PROFILER.totals`` keep each
    block's seconds)."""
    was = PROFILER.enabled
    start_profiling()
    try:
        yield
    finally:
        PROFILER.enabled = was


def check(ok: bool, what: str):
    """Fails the run (exit code 1 from the command line) unless ok."""
    if not ok:
        raise AssertionError(what)


def profile_r1cs_system(system_factory, curve_name, nc, ninp,
                        serialize_fns=None, device="cuda", result=None):
    """generator(seed=1) -> prover(seed=2) -> (reserialize) ->
    verifier_strong_IC on generate_r1cs_example(r, nc, ninp), each a timed
    block (run_r1cs_gg_ppzksnark.tcc:67-127 shape), then the verifier on
    the input with its first element changed, which must reject.
    system_factory(curve, device=...) makes the system. result: optional
    dict that receives "keypair", "proof", "primary" and "auxiliary".
    Returns (keypair, proof)."""
    from .. import get_curve
    from ..relations.examples import generate_r1cs_example

    dev = cuda_lib.resolve_device(device)
    curve = get_curve(curve_name)
    with enter_block("Generate R1CS example"):
        cs, primary, aux = generate_r1cs_example(curve.r, nc, ninp)
    system = system_factory(curve, device=dev)
    with enter_block("Generator", sync=dev):
        kp = system.generator(cs, seed=1)
    with enter_block("Prover", sync=dev):
        proof = system.prover(kp.pk, primary, aux, seed=2)
    if serialize_fns:
        with enter_block("Serialization round trip"):
            proof = serialize_fns(curve, kp, proof)
    with enter_block("Verifier"):
        ok = system.verifier_strong_IC(kp.vk, primary, proof)
    print(f"verification result: {'PASS' if ok else 'FAIL'}")
    check(ok, "the proof was rejected")
    bad = system.verifier_strong_IC(
        kp.vk, [(primary[0] + 1) % curve.r] + list(primary[1:]), proof)
    print(f"tampered-input result: {'FAIL (expected)' if not bad else 'BUG'}")
    check(not bad, "the proof was accepted for a changed input")
    if result is not None:
        result.update(keypair=kp, proof=proof, primary=primary,
                      auxiliary=aux)
    return kp, proof
