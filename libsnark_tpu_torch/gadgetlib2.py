"""gadgetlib2-equivalent: the reference's second circuit-authoring DSL
(reference libsnark/gadgetlib2/: protoboard.hpp:38-54, variable.hpp:31-151,
gadget.hpp:81-456, adapters.{hpp,cpp}, integration.hpp:18-21).

Where gadgetlib1 is template/index-centric (caller allocates variables on
a protoboard), gadgetlib2 is object-centric: Variables are first-class
objects bound to a board lazily, gadgets are constructed through
factories (createAndGadget, ...), and an ADAPTER converts the authored
circuit into the core R1CS consumed by the proof systems
(get_constraint_system_from_gadgetlib2 /
get_variable_assignment_from_gadgetlib2).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from .relations.r1cs import R1CSConstraintSystem
from .relations.variable import LinearCombination as CoreLC, Variable as CoreVar


_var_ids = itertools.count(1)


class GL2Variable:
    """A first-class variable object; board-independent identity."""

    def __init__(self, name: str = ""):
        self.vid = next(_var_ids)
        self.name = name or f"v{self.vid}"

    def __add__(self, o):
        return GL2LinearCombination(self) + o

    __radd__ = __add__

    def __sub__(self, o):
        return GL2LinearCombination(self) - o

    def __rsub__(self, o):
        return -(GL2LinearCombination(self) - o)

    def __mul__(self, k):
        return GL2LinearCombination(self) * k

    __rmul__ = __mul__

    def __neg__(self):
        return GL2LinearCombination(self) * -1

    def __repr__(self):
        return self.name


class GL2VariableArray(list):
    def __init__(self, n: int, name: str = "arr"):
        super().__init__(GL2Variable(f"{name}[{i}]") for i in range(n))


class GL2LinearCombination:
    """Affine combination of GL2Variables (variable.hpp LinearCombination)."""

    def __init__(self, init=None):
        self.terms: Dict[int, int] = {}
        self.const = 0
        self._vars: Dict[int, GL2Variable] = {}
        if isinstance(init, GL2Variable):
            self.terms[init.vid] = 1
            self._vars[init.vid] = init
        elif isinstance(init, int):
            self.const = init
        elif isinstance(init, GL2LinearCombination):
            self.terms = dict(init.terms)
            self.const = init.const
            self._vars = dict(init._vars)
        elif init is not None:
            raise TypeError(type(init))

    @staticmethod
    def _coerce(o):
        if isinstance(o, GL2LinearCombination):
            return o
        return GL2LinearCombination(o)

    def __add__(self, o):
        o = self._coerce(o)
        out = GL2LinearCombination(self)
        for vid, c in o.terms.items():
            out.terms[vid] = out.terms.get(vid, 0) + c
            out._vars[vid] = o._vars[vid]
        out.const += o.const
        return out

    __radd__ = __add__

    def __sub__(self, o):
        return self + (self._coerce(o) * -1)

    def __rsub__(self, o):
        return self._coerce(o) - self

    def __neg__(self):
        return self * -1

    def __mul__(self, k: int):
        out = GL2LinearCombination()
        out.terms = {vid: c * k for vid, c in self.terms.items()}
        out._vars = dict(self._vars)
        out.const = self.const * k
        return out

    __rmul__ = __mul__


class GL2Protoboard:
    """gadgetlib2 Protoboard (create() factory parity)."""

    @classmethod
    def create(cls, p: int) -> "GL2Protoboard":
        return cls(p)

    def __init__(self, p: int):
        self.p = p
        self.values: Dict[int, int] = {}
        self.constraints: List[tuple] = []    # (a, b, c, annotation)
        self.gadgets: List["GL2Gadget"] = []
        self._inputs: List[GL2Variable] = []

    def set_public(self, variables):
        """Mark variables as the public input (ordering preserved)."""
        self._inputs.extend(variables)

    def val(self, v: GL2Variable) -> int:
        return self.values.get(v.vid, 0)

    def setval(self, v: GL2Variable, x: int):
        self.values[v.vid] = int(x) % self.p

    def add_rank1_constraint(self, a, b, c, annotation=""):
        self.constraints.append(
            (GL2LinearCombination._coerce(a),
             GL2LinearCombination._coerce(b),
             GL2LinearCombination._coerce(c), annotation))

    def enforce_booleanity(self, v):
        self.add_rank1_constraint(v, 1 - GL2LinearCombination(v), 0,
                                  f"{v} boolean")

    def eval_lc(self, lc) -> int:
        lc = GL2LinearCombination._coerce(lc)
        return (lc.const + sum(c * self.val(lc._vars[vid])
                               for vid, c in lc.terms.items())) % self.p

    def is_satisfied(self) -> bool:
        for a, b, c, _ in self.constraints:
            if (self.eval_lc(a) * self.eval_lc(b)
                    - self.eval_lc(c)) % self.p != 0:
                return False
        return True


class GL2Gadget:
    """Virtual-dispatch gadget base (gadget.hpp); subclasses implement
    init / generateConstraints / generateWitness."""

    def __init__(self, pb: GL2Protoboard):
        self.pb = pb
        pb.gadgets.append(self)

    def generateConstraints(self):
        raise NotImplementedError

    def generateWitness(self):
        raise NotImplementedError


class ANDGadget(GL2Gadget):
    def __init__(self, pb, inputs, result):
        super().__init__(pb)
        self.inputs, self.result = list(inputs), result
        self.inv = GL2Variable("and_inv")

    def generateConstraints(self):
        n = len(self.inputs)
        s = GL2LinearCombination(n)
        for x in self.inputs:
            s = s - x
        self.pb.add_rank1_constraint(self.inv, s,
                                     1 - GL2LinearCombination(self.result),
                                     "and_inv")
        self.pb.add_rank1_constraint(self.result, s, 0, "and_zero")

    def generateWitness(self):
        pb = self.pb
        s = (len(self.inputs)
             - sum(pb.val(x) for x in self.inputs)) % pb.p
        if s == 0:
            pb.setval(self.result, 1)
            pb.setval(self.inv, 0)
        else:
            pb.setval(self.result, 0)
            pb.setval(self.inv, pow(s, -1, pb.p))


class ORGadget(GL2Gadget):
    def __init__(self, pb, inputs, result):
        super().__init__(pb)
        self.inputs, self.result = list(inputs), result
        self.inv = GL2Variable("or_inv")

    def generateConstraints(self):
        s = GL2LinearCombination(0)
        for x in self.inputs:
            s = s + x
        self.pb.add_rank1_constraint(self.inv, s, self.result, "or_inv")
        self.pb.add_rank1_constraint(
            1 - GL2LinearCombination(self.result), s, 0, "or_zero")

    def generateWitness(self):
        pb = self.pb
        s = sum(pb.val(x) for x in self.inputs) % pb.p
        if s == 0:
            pb.setval(self.result, 0)
            pb.setval(self.inv, 0)
        else:
            pb.setval(self.result, 1)
            pb.setval(self.inv, pow(s, -1, pb.p))


class InnerProductGadget(GL2Gadget):
    def __init__(self, pb, A, B, result):
        super().__init__(pb)
        assert len(A) == len(B)
        self.A, self.B, self.result = list(A), list(B), result
        self.partials = [GL2Variable(f"ip_s{i}")
                         for i in range(len(A) - 1)]

    def generateConstraints(self):
        n = len(self.A)
        for i in range(n):
            out = (self.result if i == n - 1 else self.partials[i])
            c = GL2LinearCombination(out)
            if i > 0:
                c = c - self.partials[i - 1]
            self.pb.add_rank1_constraint(self.A[i], self.B[i], c,
                                         f"ip_{i}")

    def generateWitness(self):
        pb = self.pb
        total = 0
        n = len(self.A)
        for i in range(n):
            total = (total + pb.val(self.A[i]) * pb.val(self.B[i])) % pb.p
            pb.setval(self.result if i == n - 1 else self.partials[i],
                      total)


class CompressionPackingGadget(GL2Gadget):
    """bits <-> packed field element (bitpacking gadget parity)."""

    def __init__(self, pb, bits, packed):
        super().__init__(pb)
        self.bits, self.packed = list(bits), packed

    def generateConstraints(self):
        s = GL2LinearCombination(0)
        for i, b in enumerate(self.bits):
            self.pb.enforce_booleanity(b)
            s = s + GL2LinearCombination(b) * (1 << i)
        self.pb.add_rank1_constraint(1, s, self.packed, "pack")

    def generateWitness(self):
        v = 0
        for i, b in enumerate(self.bits):
            v |= (self.pb.val(b) & 1) << i
        self.pb.setval(self.packed, v)

    def generateWitnessFromPacked(self):
        v = self.pb.val(self.packed)
        for i, b in enumerate(self.bits):
            self.pb.setval(b, (v >> i) & 1)


class LooseMUXGadget(GL2Gadget):
    def __init__(self, pb, arr, index, result, success):
        super().__init__(pb)
        self.arr, self.index = list(arr), index
        self.result, self.success = result, success
        self.alpha = [GL2Variable(f"mux_a{i}") for i in range(len(arr))]
        self.ip = InnerProductGadget(pb, self.alpha, self.arr, result)

    def generateConstraints(self):
        s = GL2LinearCombination(0)
        for i, a in enumerate(self.alpha):
            self.pb.add_rank1_constraint(
                a, GL2LinearCombination(self.index) - i, 0, f"mux_{i}")
            s = s + a
        self.pb.add_rank1_constraint(1, s, self.success, "mux_sum")
        self.pb.enforce_booleanity(self.success)
        self.ip.generateConstraints()

    def generateWitness(self):
        pb = self.pb
        idx = pb.val(self.index)
        ok = idx < len(self.arr)
        for i, a in enumerate(self.alpha):
            pb.setval(a, 1 if (ok and i == idx) else 0)
        pb.setval(self.success, 1 if ok else 0)
        self.ip.generateWitness()


class BinaryANDGadget(GL2Gadget):
    """2-input AND specialization (gadget.hpp:175 BinaryAND_Gadget):
    one constraint x*y = result."""

    def __init__(self, pb, x, y, result):
        super().__init__(pb)
        self.x, self.y, self.result = x, y, result

    def generateConstraints(self):
        self.pb.add_rank1_constraint(self.x, self.y, self.result,
                                     "binary_and")

    def generateWitness(self):
        pb = self.pb
        pb.setval(self.result, pb.val(self.x) & pb.val(self.y) & 1)


class BinaryORGadget(GL2Gadget):
    """2-input OR (gadget.hpp:255): x + y - result = x*y."""

    def __init__(self, pb, x, y, result):
        super().__init__(pb)
        self.x, self.y, self.result = x, y, result

    def generateConstraints(self):
        self.pb.add_rank1_constraint(
            self.x, self.y,
            GL2LinearCombination(self.x) + self.y - self.result,
            "binary_or")

    def generateWitness(self):
        pb = self.pb
        pb.setval(self.result, (pb.val(self.x) | pb.val(self.y)) & 1)


class IntegerPackingGadget(GL2Gadget):
    """Packing without booleanity (gadget.hpp:511
    R1P_IntegerPacking_Gadget): sum_i bits[i]*2^i = packed; callers
    guarantee bit-ness elsewhere."""

    def __init__(self, pb, bits, packed):
        super().__init__(pb)
        self.bits, self.packed = list(bits), packed

    def generateConstraints(self):
        s = GL2LinearCombination(0)
        for i, b in enumerate(self.bits):
            s = s + GL2LinearCombination(b) * (1 << i)
        self.pb.add_rank1_constraint(1, s, self.packed, "int_pack")

    def generateWitness(self):
        v = 0
        for i, b in enumerate(self.bits):
            v += self.pb.val(b) << i
        self.pb.setval(self.packed, v % self.pb.p)


class EqualsConstGadget(GL2Gadget):
    """result = (input == n) for a constant n (gadget.hpp:567
    R1P_EqualsConst_Gadget): aux*(input-n) = 1-result;
    result*(input-n) = 0."""

    def __init__(self, pb, inp, n: int, result):
        super().__init__(pb)
        self.inp, self.n, self.result = inp, n % pb.p, result
        self.aux = GL2Variable("eqc_aux")

    def generateConstraints(self):
        diff = GL2LinearCombination(self.inp) - self.n
        self.pb.add_rank1_constraint(
            self.aux, diff, 1 - GL2LinearCombination(self.result),
            "eqc_aux")
        self.pb.add_rank1_constraint(self.result, diff, 0, "eqc_zero")

    def generateWitness(self):
        pb = self.pb
        d = (pb.val(self.inp) - self.n) % pb.p
        if d == 0:
            pb.setval(self.result, 1)
            pb.setval(self.aux, 0)
        else:
            pb.setval(self.result, 0)
            pb.setval(self.aux, pow(d, -1, pb.p))


class ToggleGadget(GL2Gadget):
    """output = toggle ? oneValue : zeroValue (gadget.hpp:682
    Toggle_Gadget): toggle*(one-zero) = output-zero."""

    def __init__(self, pb, toggle, zero_value, one_value, output):
        super().__init__(pb)
        self.toggle, self.zv, self.ov = toggle, zero_value, one_value
        self.output = output

    def generateConstraints(self):
        self.pb.add_rank1_constraint(
            self.toggle,
            GL2LinearCombination._coerce(self.ov) - self.zv,
            GL2LinearCombination(self.output) - self.zv, "toggle")

    def generateWitness(self):
        pb = self.pb
        pb.setval(self.output,
                  pb.eval_lc(self.ov) if pb.val(self.toggle)
                  else pb.eval_lc(self.zv))


class ConditionalFlagGadget(GL2Gadget):
    """flag = (condition != 0) (gadget.hpp:730
    ConditionalFlag_Gadget)."""

    def __init__(self, pb, condition, flag):
        super().__init__(pb)
        self.condition, self.flag = condition, flag
        self.aux = GL2Variable("cf_aux")

    def generateConstraints(self):
        self.pb.add_rank1_constraint(self.aux, self.condition, self.flag,
                                     "cf_inv")
        self.pb.add_rank1_constraint(
            self.condition, 1 - GL2LinearCombination(self.flag), 0,
            "cf_zero")

    def generateWitness(self):
        pb = self.pb
        c = pb.eval_lc(self.condition)
        if c == 0:
            pb.setval(self.flag, 0)
            pb.setval(self.aux, 0)
        else:
            pb.setval(self.flag, 1)
            pb.setval(self.aux, pow(c, -1, pb.p))


class LogicImplicationGadget(GL2Gadget):
    """condition != 0 implies flag == 1 (gadget.hpp:772
    LogicImplication_Gadget): condition*(1-flag) = 0."""

    def __init__(self, pb, condition, flag):
        super().__init__(pb)
        self.condition, self.flag = condition, flag

    def generateConstraints(self):
        self.pb.add_rank1_constraint(
            self.condition, 1 - GL2LinearCombination(self.flag), 0,
            "implies")

    def generateWitness(self):
        pb = self.pb
        if pb.eval_lc(self.condition) != 0:
            pb.setval(self.flag, 1)


class ComparisonGadget(GL2Gadget):
    """less / lessOrEqual between two w-bit words (gadget.hpp:811
    R1P_Comparison_Gadget): alpha = 2^w + b - a bit-decomposed;
    lessOrEq = alpha[w]; less = lessOrEq AND (a != b)."""

    def __init__(self, pb, word_bits: int, lhs, rhs, less, less_or_eq):
        super().__init__(pb)
        self.w = word_bits
        self.lhs, self.rhs = lhs, rhs
        self.less, self.less_or_eq = less, less_or_eq
        self.alpha = GL2VariableArray(word_bits + 1, "cmp_alpha")
        self.neq = GL2Variable("cmp_neq")

    def generateConstraints(self):
        pb, w = self.pb, self.w
        s = GL2LinearCombination(0)
        for i, b in enumerate(self.alpha):
            pb.enforce_booleanity(b)
            s = s + GL2LinearCombination(b) * (1 << i)
        diff = (GL2LinearCombination._coerce(self.rhs)
                - self.lhs + (1 << w))
        pb.add_rank1_constraint(1, s, diff, "cmp_pack")
        # lessOrEq == top bit
        pb.add_rank1_constraint(
            1, self.alpha[w], self.less_or_eq, "cmp_le")
        # neq = OR of low bits; less = lessOrEq AND neq
        self._or = ORGadget(pb, list(self.alpha[:w]), self.neq)
        self._or.generateConstraints()
        pb.add_rank1_constraint(self.less_or_eq, self.neq, self.less,
                                "cmp_less")

    def generateWitness(self):
        pb, w = self.pb, self.w
        a = pb.eval_lc(self.lhs)
        b = pb.eval_lc(self.rhs)
        alpha = ((1 << w) + b - a) % pb.p
        for i, bit in enumerate(self.alpha):
            pb.setval(bit, (alpha >> i) & 1)
        pb.setval(self.less_or_eq, (alpha >> w) & 1)
        self._or.generateWitness()
        pb.setval(self.less, ((alpha >> w) & 1) & pb.val(self.neq))


class DualWordGadget(GL2Gadget):
    """A word held both packed and as bits, kept consistent
    (gadget.hpp:608 DualWord_Gadget; PACK/UNPACK modes)."""

    def __init__(self, pb, word_bits: int, name="dw"):
        super().__init__(pb)
        self.packed = GL2Variable(f"{name}.packed")
        self.bits = GL2VariableArray(word_bits, f"{name}.bits")
        self._pack = CompressionPackingGadget(pb, self.bits, self.packed)

    def generateConstraints(self):
        self._pack.generateConstraints()

    def generateWitness(self, value: int = None):
        if value is not None:
            self.pb.setval(self.packed, value)
        self._pack.generateWitnessFromPacked()


class DualWordArrayGadget(GL2Gadget):
    """Array of DualWords (gadget.hpp:642)."""

    def __init__(self, pb, n: int, word_bits: int, name="dwa"):
        super().__init__(pb)
        self.words = [DualWordGadget(pb, word_bits, f"{name}[{i}]")
                      for i in range(n)]

    def generateConstraints(self):
        for wg in self.words:
            wg.generateConstraints()

    def generateWitness(self, values=None):
        for wg, v in zip(self.words,
                         values or [None] * len(self.words)):
            wg.generateWitness(v)


# -------------------------------------------------------- gadget factories
# The reference's field-agnostic factory pattern (gadget.hpp:74:
# "static method create, such as AND_Gadget::create(...)"): pick the
# specialization by arity/field. Our single field type is R1P (prime
# field R1CS), so dispatch is on arity.

def create_and_gadget(pb, inputs, result):
    ins = list(inputs)
    if len(ins) == 2:
        return BinaryANDGadget(pb, ins[0], ins[1], result)
    return ANDGadget(pb, ins, result)


def create_or_gadget(pb, inputs, result):
    ins = list(inputs)
    if len(ins) == 2:
        return BinaryORGadget(pb, ins[0], ins[1], result)
    return ORGadget(pb, ins, result)


def create_inner_product_gadget(pb, A, B, result):
    return InnerProductGadget(pb, A, B, result)


def create_loose_mux_gadget(pb, arr, index, result, success):
    return LooseMUXGadget(pb, arr, index, result, success)


def create_compression_packing_gadget(pb, bits, packed):
    return CompressionPackingGadget(pb, bits, packed)


def create_integer_packing_gadget(pb, bits, packed):
    return IntegerPackingGadget(pb, bits, packed)


def create_equals_const_gadget(pb, inp, n, result):
    return EqualsConstGadget(pb, inp, n, result)


def create_comparison_gadget(pb, word_bits, lhs, rhs, less, less_or_eq):
    return ComparisonGadget(pb, word_bits, lhs, rhs, less, less_or_eq)


# ---------------------------------------------------------------- adapters

def get_constraint_system_from_gadgetlib2(pb: GL2Protoboard):
    """Convert an authored GL2 circuit to the core R1CS
    (integration.hpp:18 parity). Public-input variables come first."""
    order: Dict[int, int] = {}
    ordered_vars: List[GL2Variable] = []

    def visit(v: GL2Variable):
        if v.vid not in order:
            order[v.vid] = len(ordered_vars) + 1     # index 0 = constant
            ordered_vars.append(v)

    for v in pb._inputs:
        visit(v)
    for a, b, c, _ in pb.constraints:
        for lc in (a, b, c):
            for vid in lc.terms:
                visit(lc._vars[vid])

    def conv(lc: GL2LinearCombination) -> CoreLC:
        out = CoreLC(lc.const)
        for vid, coeff in lc.terms.items():
            out = out + CoreVar(order[vid]) * coeff
        return out

    cs = R1CSConstraintSystem(
        pb.p, primary_input_size=len(pb._inputs),
        auxiliary_input_size=len(ordered_vars) - len(pb._inputs))
    for a, b, c, ann in pb.constraints:
        cs.add_constraint(conv(a), conv(b), conv(c), ann)
    return cs, ordered_vars


def get_variable_assignment_from_gadgetlib2(pb: GL2Protoboard,
                                            ordered_vars) -> list:
    """Full assignment in adapter order (integration.hpp:21 parity)."""
    return [pb.val(v) for v in ordered_vars]
