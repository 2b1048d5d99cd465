"""Curve registry of the port: alt_bn128 and BLS12-377 (a = 0, G2 over
Fq2), BW6-761 (a = 0, G2 over Fq itself), and the curves with an
a-coefficient: MNT4-298 (G2 over Fq2) and MNT6-298 (G2 over Fq3), the PCD
cycle of the reference (default_types/r1cs_ppzkpcd_pp.hpp:27-38), and
edwards (183-bit Fq, G2 over Fq3), the curves of the Groth16 path."""
from __future__ import annotations

import functools
import importlib

# curve name -> its module; the reference's "bn128" (the ate-pairing
# backend) is the same curve as alt_bn128, one implementation here
_MODULES = {"alt_bn128": "alt_bn128", "bn128": "alt_bn128",
            "bls12_377": "bls12_377", "bw6_761": "bw6_761",
            "mnt4": "mnt", "mnt6": "mnt", "edwards": "edwards"}
# the constructor function of each curve whose module makes more than one
_CONSTRUCTORS = {"mnt4": "build_mnt4", "mnt6": "build_mnt6"}


@functools.lru_cache(maxsize=None)
def get_curve(name: str):
    """Fetch (and memoize) a fully-built Curve bundle by name."""
    if name not in _MODULES:
        raise KeyError(f"unknown curve {name!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return getattr(mod, _CONSTRUCTORS.get(name, "build"))()


def available_curves():
    return sorted(_MODULES)
