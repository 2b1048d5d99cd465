"""The benchmark's input generator: every input of a run comes from its
``--seed`` through here, and a traffic mix (``traffic/<mix>.json``) only
sets parameters for it.

A sub-seed is derived from the run's seed and a label, so that each kind
of input (circuit values, set-up secrets, request randomness,
polynomials, points) has a stream of its own and the same seed always
gives the same inputs, whatever the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import random
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def subseed(seed: int, *labels) -> int:
    """A 64-bit seed from the run's seed and labels."""
    text = "/".join(str(x) for x in (seed,) + labels).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little")


def rng(seed: int, *labels) -> random.Random:
    return random.Random(subseed(seed, *labels))


def field_elements(seed: int, label: str, n: int, r: int) -> list:
    """n uniform elements of Z_r as Python ints, from 64 random bits over
    r's width (the bias of the reduction is below 2^-64)."""
    width = (r.bit_length() + 64 + 7) // 8
    gen = np.random.Generator(np.random.PCG64(subseed(seed, label)))
    buf = gen.bytes(width * n)
    frm = int.from_bytes
    return [frm(buf[i:i + width], "little") % r
            for i in range(0, width * n, width)]


@dataclasses.dataclass
class Circuit:
    """An R1CS in the benchmark's own form, read by the program's adapter
    and by the reference alike: A, B, C as (rows, cols, coeffs) lists of
    terms; variable 0 is the constant 1, 1..k the primary inputs, then the
    auxiliary ones."""
    num_constraints: int
    num_inputs: int
    num_aux: int
    A: tuple
    B: tuple
    C: tuple
    family: object           # the circuit family's module

    def witness(self, primary: list, r: int) -> list:
        """The auxiliary values that satisfy the circuit for ``primary``."""
        return self.family.witness(self, primary, r)


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file, by name."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def circuit(family: str, num_constraints: int, num_inputs: int) -> Circuit:
    """The circuit of ``circuits/<family>.py`` at this size."""
    mod = load_module(HERE / "circuits" / f"{family}.py",
                      f"portbench_circuit_{family}")
    A, B, C, num_aux = mod.build(num_constraints, num_inputs)
    return Circuit(num_constraints, num_inputs, num_aux, A, B, C, mod)
