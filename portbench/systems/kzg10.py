"""KZG10 under the benchmark: the program's ``KZG10.commit`` and then
``create_evaluation_witness`` at a fresh point, on the next polynomial
of a pool.

Configuration keys: ``curve``, ``degree``, ``msm_strategy``. Traffic
keys: ``poly_pool``, ``check_sample``.
"""
from __future__ import annotations

from portbench import generate, workcount
from portbench.reference import kzg10 as ref
from portbench.reference.ec import Curve as RefCurve

# bits of the low part that the control keeps of each coefficient
CONTROL_BITS = 128


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.ref_curve = RefCurve(config["curve"])
        r = self.ref_curve.r
        self.config, self.seed, self.device = config, seed, device
        n = config["degree"] + 1
        self.pool = [generate.field_elements(seed, f"poly/{p}", n, r)
                     for p in range(traffic["poly_pool"])]
        self.tau = generate.rng(seed, "secrets").randrange(2, r)
        self.kzg = self.srs = None
        self._work = {}

    def inputs(self, i: int) -> tuple:
        """(coefficients, point) of request i."""
        z = generate.rng(self.seed, "point", i).randrange(self.ref_curve.r)
        return self.pool[i % len(self.pool)], z

    # -- the program -----------------------------------------------------------
    def prepare(self):
        """Build the program's SRS on the device."""
        from libsnark_tpu_torch.curves import get_curve
        from libsnark_tpu_torch.polynomial_commitments.kzg10 import KZG10
        self.kzg = KZG10(get_curve(self.config["curve"]), device=self.device,
                         msm_strategy=self.config["msm_strategy"])
        self.srs = self.kzg.setup_from_secret(self.config["degree"], self.tau)

    def warm_up(self):
        self.request(-1)

    def request(self, i: int, laps=None):
        """The timed call: commit to a polynomial and open it."""
        coeffs, z = self.inputs(i)
        commitment = self.kzg.commit(self.srs, coeffs)
        value, witness = self.kzg.create_evaluation_witness(self.srs, coeffs,
                                                            z)
        return commitment.point, value, witness.point

    def release(self):
        self.kzg = self.srs = None

    # -- outputs ---------------------------------------------------------------
    @staticmethod
    def as_ints(out) -> tuple:
        C, v, W = out

        def g1(P):
            return None if P.is_zero() else (int(P.x), int(P.y))
        return g1(C), int(v), g1(W)

    def expected(self, i: int, bits: int = 0) -> tuple:
        """The reference's (commitment, value, witness) of request i; with
        ``bits``, the control: every coefficient cut to its low bits."""
        coeffs, z = self.inputs(i)
        if bits:
            mask = (1 << bits) - 1
            coeffs = [c & mask for c in coeffs]
        return ref.commit_and_open(self.ref_curve, self.tau, coeffs, z)

    def control_request(self, i: int, laps=None) -> tuple:
        return self.expected(i, CONTROL_BITS)

    def wrong_elements(self, i: int, got: tuple) -> int:
        """How many of the commitment, the value and the witness (``got``,
        as integers) differ from the reference's."""
        return sum(g != e for g, e in zip(got, self.expected(i)))

    # -- work ------------------------------------------------------------------
    def msm_seconds(self, i: int) -> float:
        """The least time of request i's two MSMs: the commitment's over
        the coefficients, the witness's over the quotient's n - 1
        coefficients (counted as uniform scalars)."""
        p = i % len(self.pool)
        if p not in self._work:
            curve = self.ref_curve
            bits, fq = curve.r.bit_length(), curve.q.bit_length()
            coeffs = self.pool[p]
            commit = workcount.DigitCounts(coeffs, bits)
            quotient = workcount.uniform_counts(len(coeffs) - 1, curve.r)
            self._work[p] = sum(workcount.msm_bound(c, fq, 1)["seconds"]
                                for c in (commit, quotient))
        return self._work[p]
