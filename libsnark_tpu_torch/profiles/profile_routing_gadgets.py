"""Routing-gadget profiling (reference gadgetlib1/gadgets/routing/
profiling/profile_routing_gadgets.cpp): constraint counts and witness
time of the Benes and AS-Waksman routing gadgets over a range of sizes,
each board checked satisfied and its packets routed. Host only (the
circuit layer): no device option.

usage: python -m libsnark_tpu_torch.profiles.profile_routing_gadgets
           [max_log2_size]   (5)
"""
import random
import sys

from ._common import check, profiling
from ..profiling import enter_block


def main(argv=None) -> int:
    from ..common.integer_permutation import IntegerPermutation
    from ..gadgets.protoboard import PBVariableArray, Protoboard
    from ..gadgets.routing_gadgets import (ASWaksmanRoutingGadget,
                                           BenesRoutingGadget)
    args = sys.argv[1:] if argv is None else list(argv)
    max_l = int(args[0]) if args else 5
    p = (1 << 61) - 1
    rng = random.Random(5)
    w = 4                     # packet width (field elements)
    with profiling():
        for l in range(2, max_l + 1):
            n = 1 << l
            perm = IntegerPermutation(n)
            perm.random_shuffle(rng)
            for name, cls in (("benes", BenesRoutingGadget),
                              ("as_waksman", ASWaksmanRoutingGadget)):
                pb = Protoboard(p)
                ins = [PBVariableArray().allocate(pb, w, f"in{i}")
                       for i in range(n)]
                outs = [PBVariableArray().allocate(pb, w, f"out{i}")
                        for i in range(n)]
                g = cls(pb, ins, outs, f"{name}_{n}")
                with enter_block(f"{name} n={n}: constraints"):
                    g.generate_r1cs_constraints()
                nc = len(pb.get_constraint_system().constraints)
                vals = [[rng.randrange(p) for _ in range(w)]
                        for _ in range(n)]
                for pkt, v in zip(ins, vals):
                    for var, x in zip(pkt, v):
                        pb.setval(var, x)
                with enter_block(f"{name} n={n}: witness"):
                    g.generate_r1cs_witness(perm)
                ok = pb.first_unsatisfied() is None
                routed = all(
                    [pb.val(v) for v in outs[perm.get(i)]] == vals[i]
                    for i in range(n))
                print(f"{name} n={n}: {nc} constraints, satisfied={ok}, "
                      f"routed={routed}", flush=True)
                check(ok and routed, f"{name} n={n} failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
