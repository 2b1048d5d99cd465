"""libsnark-compatible text serialization grammar.

Reconstructs the reference's stream grammar from its *libsnark-side*
sources, which are fully visible in the checkout:

* field order + ``OUTPUT_NEWLINE`` framing per class:
  r1cs_gg_ppzksnark.tcc:49-202 (pk/vk/pvk/proof),
  r1cs.tcc:64-78,255-283 (constraint / constraint system),
  variable.tcc:433-456 (linear combination),
  sparse_vector.tcc:255-291, accumulation_vector.tcc:64-81,
  knowledge_commitment.tcc:143-157.
* ``OUTPUT_NEWLINE`` is "\\n" and ``OUTPUT_SEPARATOR`` is " " in
  non-binary builds (libff/common/serialization.hpp convention).

The *libff element* encoding (how one Fq / G1 / G2 prints) lives in the
libff submodule, which is EMPTY in the mounted reference -- that layer is
pinned here from the public upstream libff convention and documented as
the residual unverifiable gap (STATUS.md):

  Fp      -> decimal value (non-Montgomery) as one token
  Fp2     -> c0 OUTPUT_SEPARATOR c1
  G1      -> is_zero SEP x SEP y          (NO_PT_COMPRESSION grammar)
  G2      -> is_zero SEP x.c0 SEP x.c1 SEP y.c0 SEP y.c1

Golden vectors produced by this codec are committed under
tests/golden/ and pinned by test_serialization_compat.py.
"""
from __future__ import annotations

import io
from typing import List

OUTPUT_NEWLINE = "\n"
OUTPUT_SEPARATOR = " "


class LibsnarkCompatCodec:
    """Text-mode libsnark grammar writer/reader for one curve."""

    def __init__(self, curve):
        self.curve = curve

    # ------------------------------------------------------------ elements
    def _fq_tokens(self, v) -> List[str]:
        if hasattr(v, "c0"):                     # Fp2 tower element
            return [str(int(v.c0)), str(int(v.c1))]
        return [str(int(v))]

    def write_g1(self, out, P):
        """is_zero SEP x SEP y (libff NO_PT_COMPRESSION grammar)."""
        if P.is_zero():
            out.write("1" + OUTPUT_SEPARATOR + "0" + OUTPUT_SEPARATOR + "0")
        else:
            out.write("0" + OUTPUT_SEPARATOR + str(int(P.x))
                      + OUTPUT_SEPARATOR + str(int(P.y)))

    def read_g1(self, inp):
        toks = self._read_tokens(inp, 3)
        if toks[0] == "1":
            return self.curve.G1.zero()
        return self.curve.G1.point(int(toks[1]), int(toks[2]))

    def write_g2(self, out, P):
        if P.is_zero():
            out.write(OUTPUT_SEPARATOR.join(["1", "0", "0", "0", "0"]))
        else:
            out.write(OUTPUT_SEPARATOR.join(
                ["0"] + self._fq_tokens(P.x) + self._fq_tokens(P.y)))

    def read_g2(self, inp):
        toks = self._read_tokens(inp, 5)
        if toks[0] == "1":
            return self.curve.G2.zero()
        F = self.curve.G2.F
        return self.curve.G2.point(F(int(toks[1]), int(toks[2])),
                                   F(int(toks[3]), int(toks[4])))

    def write_fr(self, out, v: int):
        out.write(str(int(v) % self.curve.r))

    # ------------------------------------------------------------ tokens
    @staticmethod
    def _read_tokens(inp, n: int) -> List[str]:
        toks = []
        while len(toks) < n:
            line = inp.readline()
            if not line:
                raise EOFError("unexpected end of stream")
            toks.extend(line.split())
        return toks

    # ---------------------------------------------------- linear combination
    # variable.tcc:433-443: terms.size \n {index \n coeff OUTPUT_NEWLINE}
    def write_lc(self, out, lc):
        out.write(f"{len(lc.terms)}\n")
        for t in lc.terms:
            out.write(f"{t.index}\n")
            self.write_fr(out, t.coeff)
            out.write(OUTPUT_NEWLINE)

    def read_lc(self, inp):
        from .relations.variable import LinearCombination, LinearTerm
        n = int(self._read_tokens(inp, 1)[0])
        lc = LinearCombination()
        for _ in range(n):
            idx = int(self._read_tokens(inp, 1)[0])
            coeff = int(self._read_tokens(inp, 1)[0])
            lc.terms.append(LinearTerm(idx, coeff))
        return lc

    # -------------------------------------------------------------- r1cs
    # r1cs.tcc:64-71 (constraint: a b c, no separators) and
    # r1cs.tcc:255-267 (system: primary \n aux \n n \n constraints)
    def write_r1cs(self, out, cs):
        out.write(f"{cs.primary_input_size}\n")
        out.write(f"{cs.auxiliary_input_size}\n")
        out.write(f"{cs.num_constraints}\n")
        for con in cs.constraints:
            self.write_lc(out, con.a)
            self.write_lc(out, con.b)
            self.write_lc(out, con.c)

    def read_r1cs(self, inp):
        from .relations.r1cs import R1CSConstraintSystem
        primary = int(self._read_tokens(inp, 1)[0])
        aux = int(self._read_tokens(inp, 1)[0])
        n = int(self._read_tokens(inp, 1)[0])
        cs = R1CSConstraintSystem(self.curve.r, primary, aux)
        for _ in range(n):
            a = self.read_lc(inp)
            b = self.read_lc(inp)
            c = self.read_lc(inp)
            cs.add_constraint(a, b, c)
        return cs

    # ----------------------------------------------------- container grammars
    # libff std::vector<<: size \n {element OUTPUT_NEWLINE}
    def write_g1_vector(self, out, ps):
        out.write(f"{len(ps)}\n")
        for P in ps:
            self.write_g1(out, P)
            out.write(OUTPUT_NEWLINE)

    def read_g1_vector(self, inp):
        n = int(self._read_tokens(inp, 1)[0])
        return [self._read_g1_nl(inp) for _ in range(n)]

    def _read_g1_nl(self, inp):
        P = self.read_g1(inp)
        return P

    # sparse_vector.tcc:255-267
    def write_sparse_g1(self, out, domain_size, indices, values):
        out.write(f"{domain_size}\n")
        out.write(f"{len(indices)}\n")
        for i in indices:
            out.write(f"{i}\n")
        out.write(f"{len(values)}\n")
        for P in values:
            self.write_g1(out, P)
            out.write(OUTPUT_NEWLINE)

    def read_sparse_g1(self, inp):
        domain = int(self._read_tokens(inp, 1)[0])
        ni = int(self._read_tokens(inp, 1)[0])
        indices = [int(self._read_tokens(inp, 1)[0]) for _ in range(ni)]
        nv = int(self._read_tokens(inp, 1)[0])
        values = [self.read_g1(inp) for _ in range(nv)]
        return domain, indices, values

    # accumulation_vector.tcc:64-70: first OUTPUT_NEWLINE rest OUTPUT_NEWLINE
    def write_accumulation_g1(self, out, first, rest_domain, rest_indices,
                              rest_values):
        self.write_g1(out, first)
        out.write(OUTPUT_NEWLINE)
        self.write_sparse_g1(out, rest_domain, rest_indices, rest_values)
        out.write(OUTPUT_NEWLINE)

    def read_accumulation_g1(self, inp):
        first = self.read_g1(inp)
        domain, indices, values = self.read_sparse_g1(inp)
        return first, domain, indices, values

    # knowledge_commitment.tcc:143-148: g OUTPUT_SEPARATOR h
    def write_kc(self, out, g, h, write_g=None, write_h=None):
        (write_g or self.write_g1)(out, g)
        out.write(OUTPUT_SEPARATOR)
        (write_h or self.write_g1)(out, h)

    # ------------------------------------------------- Groth16 (gg) classes
    # r1cs_gg_ppzksnark.tcc:100-125: alpha_g1, beta_g2, delta_g2, ABC_g1
    # (the clearmatics fork fixes gamma = 1, so its vk carries no gamma_g2;
    # writing a vk with gamma != 1 in this grammar would be lossy)
    def write_groth16_vk(self, out, vk):
        if not vk.gamma_g2.is_zero() and vk.gamma_g2 != self.curve.G2.one():
            raise ValueError(
                "libsnark-compat gg vk grammar has no gamma_g2 slot "
                "(clearmatics gamma=1 convention); generate with gamma=1")
        self.write_g1(out, vk.alpha_g1)
        out.write(OUTPUT_NEWLINE)
        self.write_g2(out, vk.beta_g2)
        out.write(OUTPUT_NEWLINE)
        self.write_g2(out, vk.delta_g2)
        out.write(OUTPUT_NEWLINE)
        # ABC_g1 is an accumulation_vector over G1 with full domain
        rest = vk.gamma_ABC[1:]
        self.write_accumulation_g1(out, vk.gamma_ABC[0], len(rest),
                                   list(range(len(rest))), rest)
        out.write(OUTPUT_NEWLINE)

    def read_groth16_vk(self, inp):
        from .proof_systems.groth16 import Groth16VerificationKey
        alpha = self.read_g1(inp)
        beta = self.read_g2(inp)
        delta = self.read_g2(inp)
        first, _, idxs, values = self.read_accumulation_g1(inp)
        rest = [None] * len(values)
        for i, v in zip(idxs, values):
            rest[i] = v
        return Groth16VerificationKey(
            alpha_g1=alpha, beta_g2=beta, gamma_g2=self.curve.G2.one(),
            delta_g2=delta, gamma_ABC=[first] + rest)

    # r1cs_gg_ppzksnark.tcc:178-202: g_A, g_B, g_C with OUTPUT_NEWLINE
    def write_groth16_proof(self, out, proof):
        self.write_g1(out, proof.g_A)
        out.write(OUTPUT_NEWLINE)
        self.write_g2(out, proof.g_B)
        out.write(OUTPUT_NEWLINE)
        self.write_g1(out, proof.g_C)
        out.write(OUTPUT_NEWLINE)

    def read_groth16_proof(self, inp):
        from .proof_systems.groth16 import Groth16Proof
        A = self.read_g1(inp)
        B = self.read_g2(inp)
        C = self.read_g1(inp)
        return Groth16Proof(g_A=A, g_B=B, g_C=C)

    # ------------------------------------------------------------ helpers
    def dumps(self, write_fn, obj) -> str:
        out = io.StringIO()
        write_fn(out, obj)
        return out.getvalue()

    def loads(self, read_fn, data: str):
        return read_fn(io.StringIO(data))
