"""Routing-algorithm profiling (reference profile_routing_algorithms.cpp):
Benes and AS-Waksman routing time against network size on seeded random
permutations, each routing checked by simulating the network. Host only
(the circuit layer): no device option.

usage: python -m libsnark_tpu_torch.profiles.profile_routing_algorithms
           [max_log2_size]   (10)
"""
import random
import sys
import time

from ._common import check


def main(argv=None) -> int:
    from ..common.integer_permutation import IntegerPermutation
    from ..common.routing import (ASWaksmanNetwork, BenesNetwork,
                                  benes_num_columns)
    args = sys.argv[1:] if argv is None else list(argv)
    max_log = int(args[0]) if args else 10
    rng = random.Random(1)
    for logn in range(2, max_log + 1):
        n = 1 << logn
        perm = list(range(n))
        rng.shuffle(perm)
        ip = IntegerPermutation(perm)
        bn = BenesNetwork(n)
        t0 = time.monotonic()
        rb = bn.route(ip)
        tb = time.monotonic() - t0
        wn = ASWaksmanNetwork(n)
        t0 = time.monotonic()
        rw = wn.route(ip)
        tw = time.monotonic() - t0
        pkts = list(range(n))
        expect = [None] * n
        for i in range(n):
            expect[ip.get(i)] = i
        check(bn.simulate(rb, pkts) == expect
              and wn.simulate(rw, pkts) == expect, f"misroute at n={n}")
        print(f"n=2^{logn:2d}  benes[{benes_num_columns(n)} cols] "
              f"{tb*1e3:8.2f}ms   as-waksman {tw*1e3:8.2f}ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
