"""A run comes out as not correct where the timed path is broken
underneath it, or where the control (the reference at half the field's
width) serves in the program's place; and as correct where nothing is
broken. The harness's look for a card is skipped: the runs are on the
CPU at small sizes, through ``run.run_cell``."""
import pytest
import torch

from _small import GROTH16, KZG, run_small
from libsnark_tpu_torch.polynomial_commitments.kzg10 import KZG10
from libsnark_tpu_torch.proof_systems.base import PairingSystem
from libsnark_tpu_torch.proof_systems.groth16 import Groth16


def _stale(cls, name):
    """The method returns its first answer for every later call: a step
    that returns its state unchanged."""
    orig = getattr(cls, name)
    first = []

    def stale(self, *a, **k):
        out = orig(self, *a, **k)
        if not first:
            first.append(out)
        return first[0]
    return stale


def _half_msm_groth16():
    orig = PairingSystem.msm_affine

    def half(self, which, q, scalars, c):
        n = scalars.shape[-1]
        kept = torch.cat([scalars[..., : n // 2],
                          torch.zeros_like(scalars[..., n // 2:])], dim=-1)
        return orig(self, which, q, kept, c)
    return PairingSystem, "msm_affine", half


def _half_msm_kzg():
    orig = KZG10._msm_point

    def half(self, srs, sc, phase):
        n = sc.shape[-1]
        kept = torch.cat([sc[..., : n // 2], torch.zeros_like(sc[..., n // 2:])],
                         dim=-1)
        return orig(self, srs, kept, phase)
    return KZG10, "_msm_point", half


def _altered_groth16():
    orig = Groth16._prove

    def altered(self, *a, **k):
        proof = orig(self, *a, **k)
        proof.g_C = proof.g_C + self.curve.G1.one()
        return proof
    return Groth16, "_prove", altered


def _altered_kzg():
    orig = KZG10.evaluate_polynomial

    def altered(coeffs, z, r):
        return (orig(coeffs, z, r) + 1) % r
    return KZG10, "evaluate_polynomial", staticmethod(altered)


FAULTS = {
    (GROTH16, "stale"): lambda: (Groth16, "prover",
                                 _stale(Groth16, "prover")),
    (GROTH16, "half_batch"): _half_msm_groth16,
    (GROTH16, "altered"): _altered_groth16,
    (KZG, "stale"): lambda: (KZG10, "commit", _stale(KZG10, "commit")),
    (KZG, "half_batch"): _half_msm_kzg,
    (KZG, "altered"): _altered_kzg,
}


@pytest.mark.parametrize("cell", (GROTH16, KZG))
def test_sound_run_is_correct(cell):
    res = run_small(cell, trace=True)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["wrong_elements"]["value"] == 0


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    cls, name, broken = FAULTS[(cell, fault)]()
    monkeypatch.setattr(cls, name, broken)
    res = run_small(cell)
    assert not res["correct"]
    assert res["checks"]["wrong_elements"]["value"] > 0


@pytest.mark.parametrize("cell", (GROTH16, KZG))
@pytest.mark.parametrize("seed", (3, 2 ** 33 + 1, 2 ** 62 + 5))
def test_control_is_not_correct(cell, seed):
    res = run_small(cell, seed=seed, serve="control")
    checks = res["checks"]
    assert not res["correct"]
    # every element of every checked answer differs
    assert checks["wrong_elements"]["value"] == \
        3 * checks["checked_requests"]["value"]
