"""Default type bundles — runtime re-design of the reference's
compile-time `common/default_types/*_pp.hpp` headers (14 headers keyed
on -DCURVE_*; e.g. r1cs_ppzkpcd_pp.hpp:27-38 pins the PCD systems to
the MNT4/MNT6 cycle, tinyram_ppzksnark_pp.hpp:28-39 bundles the TinyRAM
machine with the SNARK curve).

The reference resolves these at COMPILE time; here one registry call
returns the fully-built bundle at runtime (no ABI hazard — the
reference warns users must compile with identical defines,
README.md:287; a runtime registry makes that class of bug impossible).
"""
from __future__ import annotations

import dataclasses

from .curves import get_curve


def default_ec_pp(curve_name: str = "alt_bn128"):
    """libff::default_ec_pp (ec_pp.hpp keyed on -DCURVE_*; the
    reference's default is BN128 = our alt_bn128 bundle)."""
    return get_curve(curve_name)


# per-proof-system defaults (one function per *_pp.hpp header)
def default_r1cs_gg_ppzksnark_pp():
    return get_curve("alt_bn128")


def default_r1cs_ppzksnark_pp():
    return get_curve("alt_bn128")


def default_r1cs_se_ppzksnark_pp():
    return get_curve("alt_bn128")


def default_uscs_ppzksnark_pp():
    return get_curve("alt_bn128")


def default_bacs_ppzksnark_pp():
    return get_curve("alt_bn128")


def default_tbcs_ppzksnark_pp():
    return get_curve("alt_bn128")


def default_r1cs_ppzkadsnark_pp():
    return get_curve("alt_bn128")


@dataclasses.dataclass(frozen=True)
class PCDCyclePP:
    """default_r1cs_ppzkpcd_pp (r1cs_ppzkpcd_pp.hpp:27-38): curve A
    carries compliance steps, curve B translation steps; the scalar
    fields swap across the 2-cycle."""
    curve_A: object
    curve_B: object

    @property
    def scalar_field_A(self) -> int:
        return self.curve_A.r

    @property
    def scalar_field_B(self) -> int:
        return self.curve_B.r


def default_r1cs_ppzkpcd_pp() -> PCDCyclePP:
    return PCDCyclePP(get_curve("mnt4"), get_curve("mnt6"))


@dataclasses.dataclass(frozen=True)
class TinyRAMSnarkPP:
    """default_tinyram_ppzksnark_pp / default_tinyram_zksnark_pp: the
    TinyRAM machine bundled with its proving curve(s)."""
    machine_field: int           # Fr the CPU checker is arithmetized in
    snark_curve: object          # ram_ppzksnark: the single curve
    cycle: PCDCyclePP = None     # ram_zksnark: the recursion cycle


def default_ram_ppzksnark_pp() -> TinyRAMSnarkPP:
    c = get_curve("alt_bn128")
    return TinyRAMSnarkPP(machine_field=c.r, snark_curve=c)


def default_ram_zksnark_pp() -> TinyRAMSnarkPP:
    cyc = default_r1cs_ppzkpcd_pp()
    return TinyRAMSnarkPP(machine_field=cyc.scalar_field_A,
                          snark_curve=cyc.curve_A, cycle=cyc)


# tinyram_*_pp are aliases of the ram_* bundles in the reference
default_tinyram_ppzksnark_pp = default_ram_ppzksnark_pp
default_tinyram_zksnark_pp = default_ram_zksnark_pp
