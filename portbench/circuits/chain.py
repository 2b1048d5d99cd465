"""The chain circuit of libsnark's R1CS example generator, as the
profiling front-ends take it: constraint j is (prev2 + j) * prev1 = z_j,
starting from the first two primary inputs, so every auxiliary value is
a product of full-width values and so full width itself. The other
inputs appear only in the QAP's input consistency rows."""


def build(num_constraints: int, num_inputs: int):
    """(A, B, C, num_aux): terms as (rows, cols, coeffs) lists."""
    if num_inputs < 2 or num_constraints < 1:
        raise ValueError("the chain needs two inputs and a constraint")
    mats = tuple(([], [], []) for _ in range(3))
    prev1, prev2 = 1, 2
    for j in range(num_constraints):
        z = num_inputs + 1 + j
        for (rows, cols, coeffs), terms in zip(
                mats, (((prev2, 1), (0, j)), ((prev1, 1),), ((z, 1),))):
            for col, coeff in terms:
                if coeff:
                    rows.append(j)
                    cols.append(col)
                    coeffs.append(coeff)
        prev1, prev2 = z, prev1
    return mats + (num_constraints,)


def witness(circuit, primary: list, r: int) -> list:
    """z_j = (prev2 + j) prev1 along the chain."""
    aux = []
    p1, p2 = primary[0] % r, primary[1] % r
    for j in range(circuit.num_constraints):
        z = (p2 + j) * p1 % r
        aux.append(z)
        p1, p2 = z, p1
    return aux
