"""From-spec decoder for the libsnark container stream grammar.

INDEPENDENT of libsnark_compat.py by construction: every production
below is transcribed directly from the reference's visible `.tcc`
operator<< bodies (cited per method), NOT from this repo's writer.
Purpose (r5): parsing the committed golden vectors with this decoder
cross-validates the writer against the reference spec, shrinking the
unverifiable residual to exactly the libff *element* token encoding
(the submodule that is empty in the checkout; its pinned convention —
decimal non-Montgomery tokens, `is_zero SEP coords` points — is the
one layer this cannot check and is documented in STATUS.md).

Framing constants (libff/common/serialization.hpp convention for
non-binary builds): OUTPUT_NEWLINE = "\\n", OUTPUT_SEPARATOR = " ";
`consume_newline` eats one '\\n', `consume_OUTPUT_NEWLINE` likewise in
text mode.

Spec sources:
  proving/verification key, proof ......... r1cs_gg_ppzksnark.tcc:49-204
  accumulation_vector ..................... accumulation_vector.tcc:64-81
  sparse_vector ........................... sparse_vector.tcc:255-291
  r1cs_constraint_system / constraint ..... r1cs.tcc:63-71,255-267
  linear_combination ...................... variable.tcc:433-446
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class SpecG1:
    is_zero: bool
    x: int
    y: int


@dataclass
class SpecG2:
    is_zero: bool
    x: Tuple[int, int]
    y: Tuple[int, int]


@dataclass
class SpecSparseVector:
    domain_size: int
    indices: List[int]
    values: list


@dataclass
class SpecAccumulationVector:
    first: SpecG1
    rest: SpecSparseVector


@dataclass
class SpecVerificationKey:
    alpha_g1: SpecG1
    beta_g2: SpecG2
    delta_g2: SpecG2
    ABC_g1: SpecAccumulationVector


@dataclass
class SpecProof:
    g_A: SpecG1
    g_B: SpecG2
    g_C: SpecG1


@dataclass
class SpecLinearCombination:
    terms: List[Tuple[int, int]]          # (index, coeff)


@dataclass
class SpecConstraintSystem:
    primary_input_size: int
    auxiliary_input_size: int
    constraints: List[Tuple[SpecLinearCombination, ...]]


class SpecStream:
    """A C++ istream-like tokenizer: `>>` skips leading whitespace and
    reads one whitespace-delimited token; consume_newline reads exactly
    one character (the reference calls istream::read(&b, 1))."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def token(self) -> str:
        n = len(self.text)
        while self.pos < n and self.text[self.pos] in " \n\t\r":
            self.pos += 1
        start = self.pos
        while self.pos < n and self.text[self.pos] not in " \n\t\r":
            self.pos += 1
        if start == self.pos:
            raise ValueError("unexpected end of stream")
        return self.text[start:self.pos]

    def size(self) -> int:
        return int(self.token())

    def consume_newline(self):
        """libff::consume_newline / consume_OUTPUT_NEWLINE (text mode):
        eat exactly one character, which must be '\\n'."""
        if self.pos >= len(self.text) or self.text[self.pos] != "\n":
            raise ValueError(
                f"expected newline at {self.pos}: "
                f"{self.text[self.pos:self.pos+8]!r}")
        self.pos += 1

    def at_end(self) -> bool:
        return self.text[self.pos:].strip() == ""


class SpecDecoder:
    """Container-grammar decoder transcribed from the reference .tcc."""

    # -- libff element layer (PINNED, not spec-verifiable: submodule
    # empty in the checkout; convention documented in module header) --
    def g1(self, s: SpecStream) -> SpecG1:
        return SpecG1(is_zero=s.token() == "1",
                      x=int(s.token()), y=int(s.token()))

    def g2(self, s: SpecStream) -> SpecG2:
        return SpecG2(is_zero=s.token() == "1",
                      x=(int(s.token()), int(s.token())),
                      y=(int(s.token()), int(s.token())))

    def fr(self, s: SpecStream) -> int:
        return int(s.token())

    # -- containers (spec-transcribed) --------------------------------
    def sparse_vector_g1(self, s: SpecStream) -> SpecSparseVector:
        """sparse_vector.tcc:259-272:
        domain_size '\\n'; indices.size '\\n'; (idx '\\n')*;
        values.size '\\n'; (T OUTPUT_NEWLINE)*"""
        domain_size = s.size()
        s.consume_newline()
        n_idx = s.size()
        s.consume_newline()
        indices = []
        for _ in range(n_idx):
            indices.append(s.size())
            s.consume_newline()
        n_val = s.size()
        s.consume_newline()
        values = []
        for _ in range(n_val):
            values.append(self.g1(s))
            s.consume_newline()               # OUTPUT_NEWLINE
        return SpecSparseVector(domain_size, indices, values)

    def accumulation_vector_g1(self, s: SpecStream) -> SpecAccumulationVector:
        """accumulation_vector.tcc:64-70: first OUTPUT_NEWLINE;
        rest OUTPUT_NEWLINE"""
        first = self.g1(s)
        s.consume_newline()
        rest = self.sparse_vector_g1(s)
        s.consume_newline()
        return SpecAccumulationVector(first, rest)

    def verification_key(self, s: SpecStream) -> SpecVerificationKey:
        """r1cs_gg_ppzksnark.tcc:100-108: alpha_g1 NL; beta_g2 NL;
        delta_g2 NL; ABC_g1 NL (the clearmatics gg vk has NO gamma)."""
        alpha_g1 = self.g1(s)
        s.consume_newline()
        beta_g2 = self.g2(s)
        s.consume_newline()
        delta_g2 = self.g2(s)
        s.consume_newline()
        abc = self.accumulation_vector_g1(s)
        s.consume_newline()
        return SpecVerificationKey(alpha_g1, beta_g2, delta_g2, abc)

    def proof(self, s: SpecStream) -> SpecProof:
        """r1cs_gg_ppzksnark.tcc:181-188: g_A NL; g_B NL; g_C NL."""
        g_A = self.g1(s)
        s.consume_newline()
        g_B = self.g2(s)
        s.consume_newline()
        g_C = self.g1(s)
        s.consume_newline()
        return SpecProof(g_A, g_B, g_C)

    def linear_combination(self, s: SpecStream) -> SpecLinearCombination:
        """variable.tcc:433-441: terms.size '\\n';
        (index '\\n' coeff OUTPUT_NEWLINE)*"""
        n = s.size()
        s.consume_newline()
        terms = []
        for _ in range(n):
            idx = s.size()
            s.consume_newline()
            coeff = self.fr(s)
            s.consume_newline()               # OUTPUT_NEWLINE
            terms.append((idx, coeff))
        return SpecLinearCombination(terms)

    def constraint_system(self, s: SpecStream) -> SpecConstraintSystem:
        """r1cs.tcc:255-263: primary '\\n' auxiliary '\\n' count '\\n'
        then constraints, each a; b; c (r1cs.tcc:63-71) back to back."""
        primary = s.size()
        s.consume_newline()
        auxiliary = s.size()
        s.consume_newline()
        count = s.size()
        s.consume_newline()
        constraints = []
        for _ in range(count):
            a = self.linear_combination(s)
            b = self.linear_combination(s)
            c = self.linear_combination(s)
            constraints.append((a, b, c))
        return SpecConstraintSystem(primary, auxiliary, constraints)
