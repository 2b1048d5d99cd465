"""Groth16 (r1cs_gg_ppzksnark) under the benchmark: the program's
``Groth16.prover`` on a pool of witnesses of one circuit, each proof
with randomness of its own.

Configuration keys: ``curve``, ``num_constraints``, ``num_inputs``,
``msm_strategy``. Traffic keys: ``circuit`` (a family of ``circuits/``),
``witness_pool``, ``check_sample``.
"""
from __future__ import annotations

from portbench import generate, workcount
from portbench.reference import groth16 as ref
from portbench.reference.ec import Curve as RefCurve

# bits of the low part that the control keeps of each witness value
CONTROL_BITS = 128


def port_r1cs(circuit, r: int):
    """The program's R1CSConstraintSystem of a benchmark circuit."""
    from libsnark_tpu_torch.relations.r1cs import (R1CSConstraint,
                                                   R1CSConstraintSystem)
    from libsnark_tpu_torch.relations.variable import (LinearCombination,
                                                       LinearTerm)
    n = circuit.num_constraints
    lcs = []
    for rows, cols, coeffs in (circuit.A, circuit.B, circuit.C):
        per_row = [LinearCombination() for _ in range(n)]
        for row, col, coeff in zip(rows, cols, coeffs):
            per_row[row].terms.append(LinearTerm(col, coeff))
        lcs.append(per_row)
    cs = R1CSConstraintSystem(r, circuit.num_inputs, circuit.num_aux)
    cs.constraints = [R1CSConstraint(a, b, c) for a, b, c in zip(*lcs)]
    return cs


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.ref_curve = RefCurve(config["curve"])
        r = self.ref_curve.r
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.circuit = generate.circuit(traffic["circuit"],
                                        config["num_constraints"],
                                        config["num_inputs"])
        self.pool = []
        for p in range(traffic["witness_pool"]):
            primary = generate.field_elements(seed, f"primary/{p}",
                                              config["num_inputs"], r)
            self.pool.append((primary, self.circuit.witness(primary, r)))
        draw = generate.rng(seed, "secrets")
        self.secrets = {k: draw.randrange(1, r)
                        for k in ("t", "alpha", "beta", "gamma", "delta")}
        self.prover = self.pk = None
        self._qap = None
        self._work = {}

    def proof_seed(self, i: int) -> int:
        return generate.subseed(self.seed, "proof", i)

    def inputs(self, i: int) -> tuple:
        return self.pool[i % len(self.pool)]

    # -- the program -----------------------------------------------------------
    def prepare(self):
        """Build the program's proving key on the device."""
        from libsnark_tpu_torch.curves import get_curve
        from libsnark_tpu_torch.proof_systems.groth16 import Groth16
        self.prover = Groth16(get_curve(self.config["curve"]),
                              device=self.device,
                              msm_strategy=self.config["msm_strategy"])
        cs = port_r1cs(self.circuit, self.ref_curve.r)
        s = self.secrets
        self.pk = self.prover.generator_from_secrets(
            cs, s["t"], s["alpha"], s["beta"], s["gamma"], s["delta"]).pk

    def warm_up(self):
        for i in range(2):
            self.request(-1 - i)

    def request(self, i: int, laps=None):
        """The timed call: one proof."""
        primary, aux = self.inputs(i)
        return self.prover.prover(self.pk, primary, aux,
                                  seed=self.proof_seed(i), timings=laps)

    def release(self):
        self.pk = self.prover = None

    # -- outputs ---------------------------------------------------------------
    @staticmethod
    def as_ints(proof) -> tuple:
        """(A, B, C) of a program's proof as affine integer points."""
        def g1(P):
            return None if P.is_zero() else (int(P.x), int(P.y))

        def g2(P):
            return None if P.is_zero() else (
                (int(P.x.c0), int(P.x.c1)), (int(P.y.c0), int(P.y.c1)))
        return g1(proof.g_A), g2(proof.g_B), g1(proof.g_C)

    def qap(self):
        if self._qap is None:
            self._qap = ref.QAPAtT(self.ref_curve, self.circuit,
                                   self.secrets["t"])
        return self._qap

    def expected(self, i: int, bits: int = 0) -> tuple:
        """The reference's proof of request i; with ``bits``, the control:
        every witness value cut to its low ``bits`` bits."""
        primary, aux = self.inputs(i)
        if bits:
            mask = (1 << bits) - 1
            primary = [v & mask for v in primary]
            aux = [v & mask for v in aux]
        return ref.proof(self.ref_curve, self.qap(),
                         self.circuit.num_inputs, self.secrets, primary, aux,
                         self.proof_seed(i))

    def control_request(self, i: int, laps=None) -> tuple:
        """The control in the program's place: the proof as integer
        points."""
        return self.expected(i, CONTROL_BITS)

    def wrong_elements(self, i: int, got: tuple) -> int:
        """How many of the proof's three elements (``got``, as integers)
        differ from the reference's."""
        return sum(g != e for g, e in zip(got, self.expected(i)))

    # -- work ------------------------------------------------------------------
    def msm_seconds(self, i: int) -> float:
        """The least time of request i's five MSMs (``workcount``)."""
        p = i % len(self.pool)
        if p not in self._work:
            curve = self.ref_curve
            primary, aux = self.pool[p]
            bits, fq = curve.r.bit_length(), curve.q.bit_length()
            full = workcount.DigitCounts([1] + primary + aux, bits)
            aux_c = workcount.DigitCounts(aux, bits)
            m = self.config["num_constraints"] + self.config["num_inputs"] + 1
            h = workcount.uniform_counts(m - 1, curve.r)
            self._work[p] = sum(
                workcount.msm_bound(c, fq, ext)["seconds"]
                for c, ext in ((full, 1), (full, 2), (full, 1), (h, 1),
                               (aux_c, 1)))
        return self._work[p]
