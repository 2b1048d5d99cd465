"""Curve registry of the port: alt_bn128 and BLS12-377 (a = 0, G2 over
Fq2), the curves of the Groth16 path."""
from __future__ import annotations

import functools
import importlib

_MODULES = ("alt_bn128", "bls12_377")     # one module per curve


@functools.lru_cache(maxsize=None)
def get_curve(name: str):
    """Fetch (and memoize) a fully-built Curve bundle by name."""
    if name not in _MODULES:
        raise KeyError(f"unknown curve {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(f".{name}", __package__).build()


def available_curves():
    return sorted(_MODULES)
