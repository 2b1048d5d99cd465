"""KZG10 polynomial commitments (the port of
libsnark_tpu/polynomial_commitments/kzg10.py; reference
polynomial_commitments/kzg10.{hpp,tcc}).

API parity: setup / setup_from_secret / commit / create_evaluation_witness
/ verify_evaluation / verify_poly (kzg10.hpp:30; commit via MSM
kzg10.tcc:81-84; verify = 2 pairings tcc:149-182).

``commit`` is one Pippenger MSM over the alpha-power SRS, which stays on
the device between ``setup`` and the calls that slice it.
``create_evaluation_witness`` avoids the reference's sequential synthetic
division: the quotient q(x) = (phi(x) - phi(z)) / (x - z) is produced by
coset-evaluating phi, dividing pointwise by (g w^i - z) and interpolating
back -- two NTTs instead of an O(n) serial recurrence.

What runs where. Python integers cross to the device as plain limbs once
per call (``scalars_to_dev``); everything of size n after that is device
work over the ``mont_mul`` kernel: the powers of alpha (a table built by
doubling), the Montgomery conversion of the coefficients, the coset points
g w^i (from the domain's root table), and their inverses (one batched
Fermat inversion, ~1.5 log2(r) products over the whole vector, where the JAX
package batch-inverts Python integers on the host). SRS, commitments and
witnesses are the same points as the JAX package's. The JAX package's
power-of-two shape buckets for ``commit`` (shared XLA executables) and its
host-segmented MSM have no counterpart here: an MSM takes exactly n points.

Phases run under ``profiling.enter_block`` (inert unless profiling was
started), each ended by a device synchronize: ``kzg.setup.*``,
``kzg.commit.{encode,msm,decode}``,
``kzg.open.{evaluate,encode,quotient,msm,decode}``.
"""
from __future__ import annotations

import dataclasses
import random
import secrets
from typing import List, Optional

from ..ops.ntt import Radix2Domain, get_domain_size, powers_table
from ..profiling import enter_block
from ..proof_systems.base import PairingSystem


@dataclasses.dataclass
class KZG10SRS:
    """Structured reference string: [alpha^i]_1 for i <= degree, [alpha]_2."""
    alpha_powers_g1: tuple       # device affine (x, y, inf), >= degree+1 lanes
    alpha_g2: object             # host G2 point
    degree: int


@dataclasses.dataclass
class KZG10Commitment:
    point: object                # host G1


class KZG10(PairingSystem):
    """KZG10 over a named curve. device: ``"cuda"`` (the default) or
    ``"cpu"``, where every kernel wrapper runs its plain PyTorch version;
    msm_strategy as for ``PairingSystem`` (it changes no commitment)."""

    def __init__(self, curve, device="cuda", msm_strategy="segments"):
        super().__init__(curve, device, msm_strategy)
        self.msm = self.msm_g1
        self._domains = {}

    # -- setup -----------------------------------------------------------------
    def setup(self, degree: int, seed: Optional[int] = None):
        r = self.curve.r
        if seed is None:
            alpha = secrets.randbelow(r - 2) + 2
        else:
            alpha = random.Random(seed).randrange(2, r)
        return self.setup_from_secret(degree, alpha)

    def setup_from_secret(self, degree: int, alpha: int):
        """[alpha^i]_1 for i <= degree by fixed-base batch exp (window
        table, one madd_windows launch, one batched to_affine), padded
        with infinity to the power-of-two bucket as in the JAX package.
        The window width is 8, the JAX package's, from 2^12 points up and 4
        below, where the table would outweigh the batch (the rule of
        ``PairingSystem._fixed_base``); it changes no output bit."""
        if degree < 0:
            raise ValueError("KZG10 setup: degree must be >= 0")
        n = degree + 1
        c = 8 if n >= 1 << 12 else 4
        with enter_block("kzg.setup.powers", sync=self.device):
            sc = self.fr.from_mont(powers_table(self.fr, alpha % self.curve.r,
                                                n))
            sc = self.pad_to(sc, self.bucket(n))
        with enter_block("kzg.setup.table", sync=self.device):
            taff, rows = self._window_table_affine(self.g1, self.msm,
                                                   self.curve.G1.one(), c)
        with enter_block("kzg.setup.batch_exp", sync=self.device):
            g1_powers = self.g1.to_affine(self.msm.batch_exp(taff, sc, c,
                                                             rows))
        return KZG10SRS(alpha_powers_g1=g1_powers,
                        alpha_g2=self.curve.G2.one() * alpha,
                        degree=degree)

    # -- commit ----------------------------------------------------------------
    def _msm_point(self, srs, sc, phase: str):
        """The host point sum_i sc[:, i] * srs_i over the first sc.shape[-1]
        SRS points (sliced on the device, never copied to the host)."""
        n = sc.shape[-1]
        pts = tuple(a[..., :n] for a in srs.alpha_powers_g1)
        with enter_block(f"{phase}.msm", sync=self.device):
            out = self.g1.to_affine(self.msm.msm(pts, sc))
        with enter_block(f"{phase}.decode"):
            return self.decode_g1(out)

    def commit(self, srs: KZG10SRS, coeffs: List[int]):
        """coeffs: host ints, length <= degree+1."""
        n = len(coeffs)
        if n > srs.degree + 1:
            raise ValueError(f"polynomial of {n} coefficients under an SRS "
                             f"of degree {srs.degree}")
        if n == 0:
            return KZG10Commitment(self.curve.G1.zero())
        with enter_block("kzg.commit.encode", sync=self.device):
            sc = self.scalars_to_dev(coeffs)
        return KZG10Commitment(self._msm_point(srs, sc, "kzg.commit"))

    # -- evaluation + witness ------------------------------------------------------
    @staticmethod
    def evaluate_polynomial(coeffs: List[int], z: int, r: int) -> int:
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * z + c) % r
        return acc

    def _domain(self, logm: int):
        if logm not in self._domains:
            self._domains[logm] = Radix2Domain(self.fr, self.curve.fr_params,
                                               logm)
        return self._domains[logm]

    def quotient(self, sc, v: int, z: int):
        """Plain limbs of (phi(x) - v) / (x - z), all m coefficients of the
        enclosing radix-2 domain, from phi's plain coefficient limbs
        ``sc`` (NL, n): coset FFT, pointwise divide by g w^i - z, inverse
        coset FFT. The coefficients from n - 1 up are zero when
        v = phi(z)."""
        fr = self.fr
        r = self.curve.r
        m = get_domain_size(sc.shape[-1])
        dom = self._domain(m.bit_length() - 1)
        a = fr.to_mont(self.pad_to(sc, m))
        xs = fr.mul_small(dom.domain_elements_mont(), dom.generator)
        d = fr.sub(xs, fr.encode([z % r]))
        if bool(fr.is_zero(d).any()):
            raise ValueError("KZG10 opening: z lies on the evaluation coset")
        evals = dom.coset_fft(a)
        q_evals = fr.mul(fr.sub(evals, fr.encode([v % r])), fr.inv(d))
        return fr.from_mont(dom.icoset_fft(q_evals))

    def create_evaluation_witness(self, srs, coeffs: List[int], z: int):
        """Returns (eval_value, witness_commitment)."""
        r = self.curve.r
        n = len(coeffs)
        if n > srs.degree + 1:
            raise ValueError(f"polynomial of {n} coefficients under an SRS "
                             f"of degree {srs.degree}")
        with enter_block("kzg.open.evaluate"):
            v = self.evaluate_polynomial(coeffs, z, r)
        if n <= 1:
            return v, KZG10Commitment(self.curve.G1.zero())
        with enter_block("kzg.open.encode", sync=self.device):
            sc = self.scalars_to_dev(coeffs)
        with enter_block("kzg.open.quotient", sync=self.device):
            q_plain = self.quotient(sc, v, z)[..., :n - 1].contiguous()
        return v, KZG10Commitment(self._msm_point(srs, q_plain, "kzg.open"))

    # -- verification -----------------------------------------------------------------
    def verify_evaluation(self, srs, commitment, z: int, value: int,
                          witness) -> bool:
        """e(C - [v]_1, [1]_2) == e(W, [alpha - z]_2)."""
        curve = self.curve
        C = commitment.point - curve.G1.one() * value
        S = srs.alpha_g2 - curve.G2.one() * (z % curve.r)
        return curve.pairing_check([(C, -curve.G2.one()), (witness.point, S)])

    def verify_poly(self, srs, commitment, coeffs: List[int]) -> bool:
        return self.commit(srs, coeffs).point == commitment.point
