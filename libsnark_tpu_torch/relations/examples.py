"""Deterministic satisfiable R1CS instance generators.

Behavioral parity with the reference's test-instance generators
(relations/.../examples/r1cs_examples.tcc:25 `generate_r1cs_example_with_field_input`,
:70 `_with_binary_input`): given (num_constraints, input_size), produce a
valid, satisfiable R1CS plus a witness, deterministically (no RNG state
needed for reproducible tests). The construction here is our own:
a multiplicative chain z_{j+1} = z_j * (z_{j-1} + j).
"""
from __future__ import annotations

from .r1cs import R1CSConstraintSystem
from .uscs import USCSConstraintSystem
from .bacs import BACSCircuit
from .tbcs import TBCSCircuit, TBCSGate, TBCSGateType
from .variable import Variable, ONE


def generate_r1cs_example(p: int, num_constraints: int, num_inputs: int):
    """Returns (cs, primary_input, auxiliary_input)."""
    assert num_inputs >= 1 and num_constraints >= num_inputs
    # variables: x_1..x_{num_inputs} primary; z_1..z_{num_constraints} aux
    num_aux = num_constraints
    cs = R1CSConstraintSystem(p, num_inputs, num_aux)
    xs = [Variable(i + 1) for i in range(num_inputs)]
    zs = [Variable(num_inputs + 1 + j) for j in range(num_aux)]

    # seed values for the chain
    vals_x = [(3 * i * i + 7 * i + 5) % p for i in range(num_inputs)]
    # constraint j: (prev2 + j) * prev1 = z_j
    aux_vals = []
    prev1_v, prev2_v = vals_x[0], (vals_x[1] if num_inputs > 1 else 1)
    prev1, prev2 = xs[0], (xs[1] if num_inputs > 1 else ONE)
    for j in range(num_aux):
        a_lc = prev2 + j
        b_lc = prev1 * 1
        zv = (prev2_v + j) * prev1_v % p
        cs.add_constraint(a_lc, b_lc, zs[j], f"chain_{j}")
        aux_vals.append(zv)
        prev2, prev2_v = prev1, prev1_v
        prev1, prev1_v = zs[j], zv
    return cs, vals_x, aux_vals


def generate_uscs_example(p: int, num_constraints: int, num_inputs: int,
                          seed: int = 7):
    """Satisfiable USCS instance + witness (parity with
    generate_uscs_example_with_field_input, uscs_examples.tcc:25-86):
    pick a random assignment, then for each constraint pick two random
    terms and SOLVE the third coefficient so the LC evaluates to +/-1."""
    import random as _random
    assert num_inputs >= 1 and num_constraints >= num_inputs
    rng = _random.Random(seed)
    cs = USCSConstraintSystem(p, num_inputs,
                              num_constraints - num_inputs)
    full = [rng.randrange(1, p) for _ in range(num_constraints)]
    for i in range(num_constraints):
        # constraint i always touches variable i: every variable (in
        # particular every INPUT) appears with a nonzero coefficient, so
        # the verifier's IC accumulation actually binds the inputs
        x = i
        while True:
            y, z = (rng.randrange(num_constraints) for _ in range(2))
            if x != z and y != z:
                break
        x_coeff = rng.randrange(1, p)
        y_coeff = rng.randrange(p)
        val = 1 if rng.randrange(2) == 0 else p - 1
        z_coeff = (val - x_coeff * full[x] - y_coeff * full[y]) \
            * pow(full[z], -1, p) % p
        lc = (x_coeff * Variable(x + 1) + y_coeff * Variable(y + 1)
              + z_coeff * Variable(z + 1))
        cs.add_constraint(lc)
    return cs, full[:num_inputs], full[num_inputs:]


def generate_bacs_example(p: int, num_gates: int, num_inputs: int):
    """Satisfiable BACS circuit + inputs (parity:
    relations/.../examples/bacs_examples.tcc): a chain of bilinear gates
    whose final gate is a circuit-output gate forced to zero by
    construction (lhs picks a value v, rhs = (v - v) = 0)."""
    assert num_inputs >= 1 and num_gates >= 2
    circuit = BACSCircuit(p, num_inputs, 0)
    xs = [Variable(i + 1) for i in range(num_inputs)]
    vals_x = [(5 * i * i + 11 * i + 3) % p for i in range(num_inputs)]
    wires = list(vals_x)
    prev = xs[0]
    prev_v = vals_x[0]
    for j in range(num_gates - 1):
        out = Variable(num_inputs + 1 + j)
        lhs = prev + j
        rhs = xs[j % num_inputs] + 1
        v = (prev_v + j) * (vals_x[j % num_inputs] + 1) % p
        circuit.add_gate(lhs, rhs, out, is_circuit_output=False)
        wires.append(v)
        prev, prev_v = out, v
    # output gate: prev * (prev - prev_v) = 0
    out = Variable(num_inputs + num_gates)
    circuit.add_gate(prev, prev - prev_v, out, is_circuit_output=True)
    wires.append(0)
    return circuit, vals_x, []


def generate_tbcs_example(num_gates: int, num_inputs: int):
    """Satisfiable TBCS circuit + inputs: XOR/AND chain ending in a
    circuit-output gate that evaluates to 0 for the generated input."""
    assert num_inputs >= 2 and num_gates >= 2
    circuit = TBCSCircuit(num_inputs, 0)
    bits = [bool((i * 2654435761) & 4) for i in range(num_inputs)]
    wires = list(bits)
    prev = 1
    for j in range(num_gates - 1):
        other = (j % num_inputs) + 1
        gtype = TBCSGateType.XOR if j % 2 == 0 else TBCSGateType.NAND
        out = num_inputs + 1 + j
        g = TBCSGate(prev, other, gtype, out, is_circuit_output=False)
        circuit.add_gate(g)
        wires.append(g.evaluate(wires))
        prev = out
    # force a zero output: w XOR w = 0
    out = num_inputs + num_gates
    g = TBCSGate(prev, prev, TBCSGateType.XOR, out, is_circuit_output=True)
    circuit.add_gate(g)
    wires.append(False)
    return circuit, bits, []


def generate_r1cs_example_with_binary_input(p: int, num_constraints: int,
                                            num_inputs: int):
    """Variant with 0/1 primary inputs (parity with
    generate_r1cs_example_with_binary_input semantics)."""
    assert num_inputs >= 1 and num_constraints >= num_inputs + 1
    num_aux = num_constraints
    cs = R1CSConstraintSystem(p, num_inputs, num_aux)
    xs = [Variable(i + 1) for i in range(num_inputs)]
    zs = [Variable(num_inputs + 1 + j) for j in range(num_aux)]
    vals_x = [(i * 7919) % 2 for i in range(num_inputs)]

    # booleanity of inputs uses the first num_inputs constraints' pattern:
    # x_i * (1 - x_i) = 0 is implied by inputs being bits; here we chain
    # products so the witness depends on every input bit.
    aux_vals = []
    prev, prev_v = ONE, 1
    for j in range(num_aux):
        x = xs[j % num_inputs]
        xv = vals_x[j % num_inputs]
        cs.add_constraint(prev + j, x + 1, zs[j], f"bchain_{j}")
        zv = (prev_v + j) * (xv + 1) % p
        aux_vals.append(zv)
        prev, prev_v = zs[j], zv
    return cs, vals_x, aux_vals


# --------------------------------------------------------------- RAM examples
# Parity with the reference's RAM example samplers
# (relations/ram_computations/rams/examples/ram_examples.tcc:24
# gen_ram_example_simple, :77 gen_ram_example_complex): produce a TinyRAM
# program + inputs with prescribed boot-trace/time bounds whose
# acceptance is controlled by `satisfiable`. The programs here are our
# own (the reference's rely on its tape-loading prelude + self-modifying
# code); ours exercise the same surfaces -- ANSWER control, random
# non-executed filler, and (complex) LOADW/STOREB/LOADB byte-addressed
# memory with input-dependent acceptance.

def gen_ram_example_simple(ap, boot_trace_size_bound: int, time_bound: int,
                           satisfiable: bool = True, seed: int = 0):
    """Minimal example: ANSWER immediately (0 accepts / 1 rejects),
    followed by random never-executed filler instructions and random
    input words filling the boot trace.

    Returns (program, primary_input, aux_tape, time_bound).
    """
    import random as _random
    from .tinyram import TinyRAMProgram, TinyRAMInstruction, Opcode
    rng = _random.Random(seed)
    assert boot_trace_size_bound >= 2 and time_bound >= 1
    program_size = boot_trace_size_bound // 2
    input_size = boot_trace_size_bound - program_size

    prog = TinyRAMProgram()
    prog.add(Opcode.ANSWER, True, 0, 0, 0 if satisfiable else 1)
    ops = list(Opcode)
    while prog.size < program_size:
        prog.add_instruction(TinyRAMInstruction(
            rng.choice(ops), bool(rng.getrandbits(1)),
            rng.randrange(1 << ap.reg_arg_width),
            rng.randrange(1 << ap.reg_arg_width),
            rng.randrange(1 << ap.reg_arg_or_imm_width)))
    primary = [rng.randrange(1 << ap.w) for _ in range(input_size)]
    return prog, primary, [], time_bound


def gen_ram_example_complex(ap, boot_trace_size_bound: int, time_bound: int,
                            satisfiable: bool = True, seed: int = 0):
    """Memory-exercising example: load the first input word, subtract a
    constant, round-trip the result through a byte-addressed
    STOREB/LOADB pair, and ANSWER it -- accepted iff the input word
    equals the constant (byte semantics: only the low byte survives the
    round trip, so the constant keeps the difference within one byte).

    Returns (program, primary_input, aux_tape, time_bound).
    """
    import random as _random
    from .tinyram import TinyRAMProgram, TinyRAMInstruction, Opcode
    rng = _random.Random(seed)
    K = 42
    assert boot_trace_size_bound >= 12 and time_bound >= 6
    program_size = boot_trace_size_bound // 2
    input_size = boot_trace_size_bound - program_size

    sal = ap.subaddr_len
    input0_byte_addr = program_size << sal          # dword cell after prog
    scratch_byte_addr = (program_size + input_size) << sal

    prog = TinyRAMProgram()
    prog.add(Opcode.LOADW, True, 1, 0, input0_byte_addr)   # r1 = input[0]
    prog.add(Opcode.SUB, True, 1, 1, K)                    # r1 = input - K
    prog.add(Opcode.STOREB, True, 1, 0, scratch_byte_addr)
    prog.add(Opcode.LOADB, True, 2, 0, scratch_byte_addr)  # r2 = low byte
    prog.add(Opcode.ANSWER, False, 0, 0, 2)                # accept iff 0
    ops = list(Opcode)
    while prog.size < program_size:
        prog.add_instruction(TinyRAMInstruction(
            rng.choice(ops), bool(rng.getrandbits(1)),
            rng.randrange(1 << ap.reg_arg_width),
            rng.randrange(1 << ap.reg_arg_width),
            rng.randrange(1 << ap.reg_arg_or_imm_width)))
    primary = [K if satisfiable else K + 3] + \
        [rng.randrange(1 << ap.w) for _ in range(input_size - 1)]
    return prog, primary, [], time_bound
