"""Routing networks: Benes (2^k packets) and AS-Waksman (any size).

Host-side algorithms (reference common/routing_algorithms/
{benes,as_waksman}_routing_algorithm.{hpp,cpp}; the reference also ships a
python cross-check, tests/test_routing_algorithms.py -- this module is an
independent implementation of the textbook algorithms).

Representation: a network is a list of columns; each column is a list of
gates. A gate is a tuple (in0, in1, out0, out1) of wire indices between
columns, or a straight pass (in0, None, out0, None). Routing produces a
{(column, gate_index): bool} dict -- False routes in0->out0 (straight),
True crosses. ``simulate`` pushes packets through for verification and for
witness generation in the routing gadgets.
"""
from __future__ import annotations

from .integer_permutation import IntegerPermutation


# =============================================================== Benes (2^k)

def benes_num_columns(n: int) -> int:
    """Benes(2^k) has 2k-1 switch columns."""
    k = (n - 1).bit_length()
    assert 1 << k == n, "benes requires a power-of-two size"
    return 2 * k - 1


def _two_color(perm: dict, inv: dict, n: int) -> dict:
    """2-color packets so that input pairs (2i,2i+1) and output pairs
    (2j,2j+1) each split across subnets. Returns {pos: True(=upper)}."""
    color = {}
    for start in range(n):
        if start in color:
            continue
        pos, c = start, True
        while pos not in color:
            color[pos] = c
            # packet sharing pos's OUTPUT switch must take the other subnet
            q = inv[perm[pos] ^ 1]
            color[q] = not c
            # packet sharing q's INPUT switch must take the other subnet (=c)
            pos = q ^ 1
    return color


class BenesNetwork:
    """Explicit Benes network for n = 2^k packets, 2k-1 switch columns of
    n/2 switches each. Settings: {(column, row): bool}, True = cross."""

    def __init__(self, n: int):
        self.n = n
        self.k = (n - 1).bit_length()
        assert 1 << self.k == n and n >= 2
        self.num_columns = benes_num_columns(n)

    def route(self, perm: IntegerPermutation) -> dict:
        assert perm.is_valid() and perm.size == self.n
        settings = {}
        p = {i: perm.get(i + perm.min_element) - perm.min_element
             for i in range(self.n)}
        self._route_rec(p, 0, 0, self.n, settings)
        return settings

    def _route_rec(self, perm, col, row_offset, n, settings):
        if n == 2:
            settings[(col, row_offset)] = perm[0] == 1
            return
        inv = {v: k for k, v in perm.items()}
        color = _two_color(perm, inv, n)
        half = n // 2
        up_perm, lo_perm = {}, {}
        out_col = col + benes_num_columns(n) - 1
        for pos in range(n):
            upper = color[pos]
            dest = perm[pos]
            if pos % 2 == 0:
                settings[(col, row_offset + pos // 2)] = not upper
            if upper:
                up_perm[pos // 2] = dest // 2
                settings[(out_col, row_offset + dest // 2)] = (dest % 2 == 1)
            else:
                lo_perm[pos // 2] = dest // 2
        self._route_rec(up_perm, col + 1, row_offset, half, settings)
        self._route_rec(lo_perm, col + 1, row_offset + half // 2, half,
                        settings)

    def simulate(self, settings: dict, packets: list) -> list:
        return self._sim_rec(settings, packets, 0, 0)

    def _sim_rec(self, settings, packets, col, row_offset):
        n = len(packets)
        if n == 2:
            b = settings[(col, row_offset)]
            return [packets[1], packets[0]] if b else list(packets)
        half = n // 2
        upper_in, lower_in = [], []
        for i in range(half):
            b = settings[(col, row_offset + i)]
            a, c = packets[2 * i], packets[2 * i + 1]
            if b:
                a, c = c, a
            upper_in.append(a)
            lower_in.append(c)
        out_col = col + benes_num_columns(n) - 1
        upper_out = self._sim_rec(settings, upper_in, col + 1, row_offset)
        lower_out = self._sim_rec(settings, lower_in, col + 1,
                                  row_offset + half // 2)
        out = [None] * n
        for j in range(half):
            b = settings.get((out_col, row_offset + j), False)
            a, c = upper_out[j], lower_out[j]
            if b:
                a, c = c, a
            out[2 * j] = a
            out[2 * j + 1] = c
        return out


# ======================================================= AS-Waksman (any n)

class ASWaksmanNetwork:
    """Arbitrary-size Waksman network (reference
    as_waksman_routing_algorithm.hpp:83-126 behavior)."""

    def __init__(self, n: int):
        assert n >= 2
        self.n = n
        self.settings_shape = None

    def route(self, perm: IntegerPermutation) -> dict:
        assert perm.is_valid() and perm.size == self.n
        settings = {}
        p = {i: perm.get(i + perm.min_element) - perm.min_element
             for i in range(self.n)}
        self._route_rec(p, 0, list(range(self.n)), settings, key=())
        return settings

    def _route_rec(self, perm, depth, wires, settings, key):
        n = len(wires)
        if n == 1:
            return
        if n == 2:
            settings[key + ("sw",)] = perm[0] == 1
            return
        half_low = n // 2          # lower subnet (gets the straight wires)
        half_up = n - half_low     # upper subnet size (>= half_low)
        # NOTE: convention: upper = ceil(n/2), lower = floor(n/2);
        # input i pairs (2i, 2i+1) for i < floor(n/2); odd n: last input
        # goes straight to upper subnet's last input.
        num_in_sw = n // 2
        num_out_sw = (n - 1) // 2 if n % 2 == 1 else n // 2 - 1
        inv = {v: k for k, v in perm.items()}

        in_bits = [None] * num_in_sw
        out_bits = [None] * num_out_sw
        up_perm = {}
        lo_perm = {}

        def in_subnet_slot(pos, upper):
            """Input wire position -> slot index in chosen subnet."""
            if pos == n - 1 and n % 2 == 1:
                return half_up - 1  # straight into upper... see below
            return pos // 2

        # Convention used here (self-consistent; verified by simulate):
        #  - even n: outputs 2j,2j+1 from switch j for j < n/2 - 1; the last
        #    two outputs n-2, n-1 are fixed: upper last -> n-2, lower last
        #    -> n-1.
        #  - odd n: output n-1 comes straight from upper subnet's last
        #    output; outputs 2j,2j+1 switched for j <= (n-3)/2.
        def out_force(dest):
            """Returns (forced, upper) if dest must come from a fixed side."""
            if n % 2 == 1:
                if dest == n - 1:
                    return (True, True)
                return (False, None)
            else:
                if dest == n - 2:
                    return (True, True)
                if dest == n - 1:
                    return (True, False)
                return (False, None)

        def set_route(pos, upper):
            """Route input pos through `upper` subnet; returns dest info."""
            dest = perm[pos]
            if pos == n - 1 and n % 2 == 1:
                # straight wire into upper's last slot
                src_slot = half_up - 1
                assert upper
            else:
                sw = pos // 2
                if in_bits[sw] is None:
                    in_bits[sw] = (pos % 2 == 0) != upper
                src_slot = sw
            forced, f_up = out_force(dest)
            if forced:
                dst_slot = (half_up - 1) if f_up else (half_low - 1)
            else:
                sw = dest // 2
                if sw < num_out_sw and out_bits[sw] is None:
                    out_bits[sw] = ((dest % 2) == 0) != upper
                dst_slot = sw
            if upper:
                up_perm[src_slot] = dst_slot
            else:
                lo_perm[src_slot] = dst_slot
            return dest

        # 1) forced routes first (fixed output wires and odd straight input)
        visited = [False] * n

        def walk(pos, upper):
            """Route pos via upper/lower, then constrain siblings."""
            stack = [(pos, upper)]
            while stack:
                pos, upper = stack.pop()
                if visited[pos]:
                    continue
                visited[pos] = True
                dest = set_route(pos, upper)
                # sibling at output side must use the other subnet
                forced, _ = out_force(dest)
                if not forced and dest // 2 < num_out_sw:
                    sib_out = dest ^ 1
                    sp = inv[sib_out]
                    if not visited[sp]:
                        stack.append((sp, not upper))
                # sibling at input side must use the other subnet
                if not (pos == n - 1 and n % 2 == 1):
                    sib_in = pos ^ 1
                    if sib_in < n and not visited[sib_in] and not (
                            sib_in == n - 1 and n % 2 == 1):
                        stack.append((sib_in, not upper))

        if n % 2 == 1:
            # odd: input n-1 forced through upper; output n-1 forced upper
            walk(n - 1, True)
            src_of_last = inv[n - 1]
            if not visited[src_of_last]:
                walk(src_of_last, True)
        else:
            walk(inv[n - 2], True)
            walk(inv[n - 1], False)
        for pos in range(n):
            if not visited[pos]:
                walk(pos, True)

        for i, b in enumerate(in_bits):
            settings[key + ("in", depth, i)] = bool(b) if b is not None else False
        for j, b in enumerate(out_bits):
            settings[key + ("out", depth, j)] = bool(b) if b is not None else False
        self._route_rec(up_perm, depth + 1,
                        list(range(half_up)), settings, key + ("U",))
        self._route_rec(lo_perm, depth + 1,
                        list(range(half_low)), settings, key + ("L",))

    # -- simulation -------------------------------------------------------------
    def simulate(self, settings: dict, packets: list) -> list:
        return self._sim_rec(settings, packets, 0, ())

    def _sim_rec(self, settings, packets, depth, key):
        n = len(packets)
        if n == 1:
            return list(packets)
        if n == 2:
            b = settings[key + ("sw",)]
            return [packets[1], packets[0]] if b else list(packets)
        half_low = n // 2
        half_up = n - half_low
        upper_in = [None] * half_up
        lower_in = [None] * half_low
        for i in range(n // 2):
            b = settings[key + ("in", depth, i)]
            a, c = packets[2 * i], packets[2 * i + 1]
            if b:
                a, c = c, a
            upper_in[i] = a
            lower_in[i] = c
        if n % 2 == 1:
            upper_in[half_up - 1] = packets[n - 1]
        upper_out = self._sim_rec(settings, upper_in, depth + 1, key + ("U",))
        lower_out = self._sim_rec(settings, lower_in, depth + 1, key + ("L",))
        out = [None] * n
        num_out_sw = (n - 1) // 2 if n % 2 == 1 else n // 2 - 1
        for j in range(num_out_sw):
            b = settings[key + ("out", depth, j)]
            a, c = upper_out[j], lower_out[j]
            if b:
                a, c = c, a
            out[2 * j] = a
            out[2 * j + 1] = c
        if n % 2 == 1:
            out[n - 1] = upper_out[half_up - 1]
            if num_out_sw * 2 < n - 1:
                # leftover unswitched pair (when n-1 odd? cannot happen)
                pass
        else:
            out[n - 2] = upper_out[half_up - 1]
            out[n - 1] = lower_out[half_low - 1]
        return out


def get_benes_routing(perm: IntegerPermutation) -> dict:
    return BenesNetwork(perm.size).route(perm)


def get_as_waksman_routing(perm: IntegerPermutation) -> dict:
    return ASWaksmanNetwork(perm.size).route(perm)
