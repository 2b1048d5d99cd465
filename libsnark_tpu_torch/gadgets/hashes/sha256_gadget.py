"""SHA-256 gadgets (reference gadgetlib1/gadgets/hashes/sha256/).

Same R1CS shapes as the reference components
(sha256_aux.tcc / sha256_components.tcc / sha256_gadget.tcc):

* XOR3 via 2A*B = A+B-tmp chains (sha256_aux.tcc:82-100)
* small/big sigma as per-bit XOR3 of rotations/shifts
* choice: x*(y-z) = r-z; majority: booleanity + (x+y+z-2r)(1-(x+y+z-2r))=0
* mod-2^32 additions via unpack-to-(32+k)-bits ("lastbits" pattern)
* message schedule W[16..63], 64 rounds, final Davies-Meyer adds

Bit convention: digests/blocks are MSB-first within each 32-bit word
(matching SHA256_default_IV, sha256_components.tcc:45-61); internal word
bit arrays are LSB-first for packing.
"""
from __future__ import annotations

from typing import List

from ..protoboard import Gadget, PBVariable, PBVariableArray
from ..basic import (PackingGadget, generate_boolean_r1cs_constraint,
                     pb_packing_sum)
from ...relations.variable import LinearCombination, Variable
from .sha256_host import SHA256_K, SHA256_H, sha256_compress, bits_to_words


def _lc(x):
    return LinearCombination._coerce(x)


class DigestVariable:
    """A 256-bit digest as a bit array, MSB-first per word
    (hash_io.hpp digest_variable)."""

    def __init__(self, pb, digest_size: int = 256, annotation=""):
        self.pb = pb
        self.digest_size = digest_size
        self.bits = PBVariableArray().allocate(pb, digest_size, annotation)

    def generate_r1cs_constraints(self):
        for i, b in enumerate(self.bits):
            generate_boolean_r1cs_constraint(self.pb, b, f"digest_bit_{i}")

    def generate_r1cs_witness(self, bit_values):
        assert len(bit_values) == self.digest_size
        self.bits.fill_with_bits(self.pb, bit_values)

    def get_digest(self) -> list:
        return [self.pb.val(b) & 1 for b in self.bits]


class BlockVariable:
    """A 512-bit message block as a bit array (hash_io.hpp
    block_variable): concatenation of input bit arrays."""

    def __init__(self, pb, parts=None, block_size: int = 512, annotation=""):
        self.pb = pb
        if parts is not None:
            self.bits = []
            for part in parts:
                self.bits.extend(part.bits if hasattr(part, "bits") else part)
            assert len(self.bits) == block_size
        else:
            self.bits = PBVariableArray().allocate(pb, block_size, annotation)
        self.block_size = block_size

    def generate_r1cs_witness(self, bit_values):
        for b, v in zip(self.bits, bit_values):
            self.pb.setval(b, 1 if v else 0)


def _word_lsb(bits_msb, w):
    """Extract word w of an MSB-first digest/block bit list, LSB-first."""
    return list(reversed(bits_msb[32 * w: 32 * w + 32]))


class XOR3Gadget(Gadget):
    """out = A ^ B ^ C for boolean lcs (sha256_aux.tcc:61-118)."""

    def __init__(self, pb, A, B, C, assume_C_is_zero, out,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.A, self.B, self.C = _lc(A), _lc(B), _lc(C)
        self.assume_C_is_zero = assume_C_is_zero
        self.out = out
        if not assume_C_is_zero:
            self.tmp = PBVariable().allocate(pb, self.annot("tmp"))

    def generate_r1cs_constraints(self):
        if self.assume_C_is_zero:
            self.pb.add_r1cs_constraint(
                self.A * 2, self.B, self.A + self.B - self.out,
                self.annot("implicit_tmp_equals_out"))
        else:
            self.pb.add_r1cs_constraint(
                self.A * 2, self.B, self.A + self.B - self.tmp,
                self.annot("tmp"))
            self.pb.add_r1cs_constraint(
                _lc(self.tmp) * 2, self.C,
                _lc(self.tmp) + self.C - self.out, self.annot("out"))

    def generate_r1cs_witness(self):
        p = self.pb.p
        a, b, c = (self.pb.lc_val(self.A), self.pb.lc_val(self.B),
                   self.pb.lc_val(self.C))
        if self.assume_C_is_zero:
            self.pb.setval(self.out, (a + b - 2 * a * b) % p)
        else:
            t = (a + b - 2 * a * b) % p
            self.pb.setval(self.tmp, t)
            self.pb.setval(self.out, (t + c - 2 * t * c) % p)


class SmallSigmaGadget(Gadget):
    """sigma(x) = ROTR(x,r1) ^ ROTR(x,r2) ^ SHR(x,s), packed result
    (sha256_aux.tcc:120-165). W: LSB-first 32-bit array."""

    def __init__(self, pb, W, result, rot1, rot2, shift,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.W, self.result = W, result
        self.result_bits = PBVariableArray().allocate(
            pb, 32, self.annot("result_bits"))
        self.compute_bits = []
        for i in range(32):
            shifted_ok = i + shift < 32
            self.compute_bits.append(XOR3Gadget(
                pb, W[(i + rot1) % 32], W[(i + rot2) % 32],
                W[i + shift] if shifted_ok else 0,
                not shifted_ok, self.result_bits[i],
                self.annot(f"xor3_{i}")))
        self.pack_result = PackingGadget(
            pb, self.result_bits, result, self.annot("pack"))

    def generate_r1cs_constraints(self):
        for g in self.compute_bits:
            g.generate_r1cs_constraints()
        self.pack_result.generate_r1cs_constraints(False)

    def generate_r1cs_witness(self):
        for g in self.compute_bits:
            g.generate_r1cs_witness()
        self.pack_result.generate_r1cs_witness_from_bits()


class BigSigmaGadget(Gadget):
    """Sigma(x) = ROTR^r1 ^ ROTR^r2 ^ ROTR^r3 (sha256_aux.tcc:167-212)."""

    def __init__(self, pb, W, result, rot1, rot2, rot3,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.W, self.result = W, result
        self.result_bits = PBVariableArray().allocate(
            pb, 32, self.annot("result_bits"))
        self.compute_bits = [
            XOR3Gadget(pb, W[(i + rot1) % 32], W[(i + rot2) % 32],
                       W[(i + rot3) % 32], False, self.result_bits[i],
                       self.annot(f"xor3_{i}"))
            for i in range(32)]
        self.pack_result = PackingGadget(
            pb, self.result_bits, result, self.annot("pack"))

    def generate_r1cs_constraints(self):
        for g in self.compute_bits:
            g.generate_r1cs_constraints()
        self.pack_result.generate_r1cs_constraints(False)

    def generate_r1cs_witness(self):
        for g in self.compute_bits:
            g.generate_r1cs_witness()
        self.pack_result.generate_r1cs_witness_from_bits()


class ChoiceGadget(Gadget):
    """ch(x,y,z) = x?y:z per bit (sha256_aux.tcc:214-253)."""

    def __init__(self, pb, X, Y, Z, result, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.X, self.Y, self.Z, self.result = X, Y, Z, result
        self.result_bits = PBVariableArray().allocate(
            pb, 32, self.annot("result_bits"))
        self.pack_result = PackingGadget(
            pb, self.result_bits, result, self.annot("pack"))

    def generate_r1cs_constraints(self):
        for i in range(32):
            self.pb.add_r1cs_constraint(
                self.X[i], _lc(self.Y[i]) - self.Z[i],
                _lc(self.result_bits[i]) - self.Z[i],
                self.annot(f"choice_{i}"))
        self.pack_result.generate_r1cs_constraints(False)

    def generate_r1cs_witness(self):
        p = self.pb.p
        for i in range(32):
            x, y, z = (self.pb.lc_val(self.X[i]), self.pb.lc_val(self.Y[i]),
                       self.pb.lc_val(self.Z[i]))
            self.pb.setval(self.result_bits[i], (x * y + (1 - x) * z) % p)
        self.pack_result.generate_r1cs_witness_from_bits()


class MajorityGadget(Gadget):
    """maj(x,y,z) per bit (sha256_aux.tcc:255-302)."""

    def __init__(self, pb, X, Y, Z, result, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.X, self.Y, self.Z, self.result = X, Y, Z, result
        self.result_bits = PBVariableArray().allocate(
            pb, 32, self.annot("result_bits"))
        self.pack_result = PackingGadget(
            pb, self.result_bits, result, self.annot("pack"))

    def generate_r1cs_constraints(self):
        for i in range(32):
            generate_boolean_r1cs_constraint(
                self.pb, self.result_bits[i], self.annot(f"bit_{i}"))
            aux = (_lc(self.X[i]) + self.Y[i] + self.Z[i]
                   - _lc(self.result_bits[i]) * 2)
            self.pb.add_r1cs_constraint(aux, 1 - aux, 0,
                                        self.annot(f"maj_{i}"))
        self.pack_result.generate_r1cs_constraints(False)

    def generate_r1cs_witness(self):
        for i in range(32):
            x, y, z = (self.pb.lc_val(self.X[i]) & 1,
                       self.pb.lc_val(self.Y[i]) & 1,
                       self.pb.lc_val(self.Z[i]) & 1)
            self.pb.setval(self.result_bits[i],
                           (x & y) ^ (x & z) ^ (y & z))
        self.pack_result.generate_r1cs_witness_from_bits()


class Mod32Gadget(Gadget):
    """result = (value of lc_sum) mod 2^32 by unpacking to 32+k bits
    (the reference lastbits pattern, sha256_aux.tcc:20-59). Returns the
    low 32 bits LSB-first in `low_bits`."""

    def __init__(self, pb, lc_sum, total_bits: int, result,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.lc_sum = _lc(lc_sum)
        self.result = result
        self.full_bits = PBVariableArray().allocate(
            pb, total_bits, self.annot("full_bits"))
        self.low_bits = list(self.full_bits[:32])
        self.unpack = PackingGadget(pb, self.full_bits, self.lc_sum,
                                    self.annot("unpack"))
        self.pack_low = PackingGadget(pb, self.low_bits, result,
                                      self.annot("pack_low"))

    def generate_r1cs_constraints(self):
        self.unpack.generate_r1cs_constraints(True)
        self.pack_low.generate_r1cs_constraints(False)

    def generate_r1cs_witness(self):
        self.unpack.generate_r1cs_witness_from_packed()
        self.pack_low.generate_r1cs_witness_from_bits()


class SHA256MessageScheduleGadget(Gadget):
    """W[0..63] from the 512-bit block (sha256_components.tcc:64-170)."""

    def __init__(self, pb, block_bits_msb, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        # W bit arrays, LSB-first
        self.W_bits: List[list] = [
            _word_lsb(block_bits_msb, w) for w in range(16)]
        self.packed_W = PBVariableArray().allocate(
            pb, 64, self.annot("packed_W"))
        self.pack_W = [
            PackingGadget(pb, self.W_bits[i], self.packed_W[i],
                          self.annot(f"pack_W_{i}"))
            for i in range(16)]
        self.sigma0 = {}
        self.sigma1 = {}
        self.compute_sigma0 = {}
        self.compute_sigma1 = {}
        self.mod_reduce_W = {}
        for i in range(16, 64):
            self.sigma0[i] = PBVariable().allocate(
                pb, self.annot(f"sigma0_{i}"))
            self.sigma1[i] = PBVariable().allocate(
                pb, self.annot(f"sigma1_{i}"))
            self.compute_sigma0[i] = SmallSigmaGadget(
                pb, self.W_bits[i - 15], self.sigma0[i], 7, 18, 3,
                self.annot(f"csigma0_{i}"))
            self.compute_sigma1[i] = SmallSigmaGadget(
                pb, self.W_bits[i - 2], self.sigma1[i], 17, 19, 10,
                self.annot(f"csigma1_{i}"))
            unreduced = (_lc(self.sigma0[i]) + self.sigma1[i]
                         + self.packed_W[i - 7] + self.packed_W[i - 16])
            self.mod_reduce_W[i] = Mod32Gadget(
                pb, unreduced, 34, self.packed_W[i],
                self.annot(f"mod_W_{i}"))
            self.W_bits.append(self.mod_reduce_W[i].low_bits)

    def generate_r1cs_constraints(self):
        for g in self.pack_W:
            g.generate_r1cs_constraints(False)
        for i in range(16, 64):
            self.compute_sigma0[i].generate_r1cs_constraints()
            self.compute_sigma1[i].generate_r1cs_constraints()
            self.mod_reduce_W[i].generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for g in self.pack_W:
            g.generate_r1cs_witness_from_bits()
        for i in range(16, 64):
            self.compute_sigma0[i].generate_r1cs_witness()
            self.compute_sigma1[i].generate_r1cs_witness()
            self.mod_reduce_W[i].generate_r1cs_witness()


class SHA256CompressionGadget(Gadget):
    """Full compression function: prev digest + block -> output digest
    (sha256_gadget.tcc sha256_compression_function_gadget)."""

    def __init__(self, pb, prev_bits_msb, block_bits_msb,
                 output: DigestVariable, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        self.prev_bits_msb = list(prev_bits_msb)
        self.block_bits_msb = (block_bits_msb.bits
                               if hasattr(block_bits_msb, "bits")
                               else list(block_bits_msb))
        self.output = output
        self.schedule = SHA256MessageScheduleGadget(
            pb, self.block_bits_msb, self.annot("schedule"))

        # initial working state bit arrays (LSB-first per word)
        state_bits = [_word_lsb(self.prev_bits_msb, w) for w in range(8)]
        state_packed = []
        self.pack_state = []
        for w in range(8):
            v = PBVariable().allocate(pb, self.annot(f"state_{w}"))
            state_packed.append(v)
            self.pack_state.append(PackingGadget(
                pb, state_bits[w], v, self.annot(f"pack_state_{w}")))

        self.rounds = []
        a, b, c, d, e, f, g, h = range(8)
        cur_bits = state_bits
        cur_packed = [_lc(v) for v in state_packed]
        for i in range(64):
            rnd = _SHA256Round(pb, cur_bits, cur_packed,
                               self.schedule.packed_W[i],
                               self.schedule.W_bits[i], SHA256_K[i],
                               self.annot(f"round_{i}"))
            self.rounds.append(rnd)
            cur_bits = rnd.new_state_bits
            cur_packed = rnd.new_state_packed

        # Davies-Meyer: output words = final state + input state mod 2^32
        self.final_mod = []
        out_words_bits = [_word_lsb(self.output.bits, w) for w in range(8)]
        self.final_pack = []
        for w in range(8):
            res = PBVariable().allocate(pb, self.annot(f"out_{w}"))
            mg = Mod32Gadget(pb, cur_packed[w] + state_packed[w], 33, res,
                             self.annot(f"final_mod_{w}"))
            self.final_mod.append(mg)
            # tie mg.low_bits to the output digest bits
            self.final_pack.append(PackingGadget(
                pb, out_words_bits[w], res, self.annot(f"final_pack_{w}")))

    def generate_r1cs_constraints(self):
        self.schedule.generate_r1cs_constraints()
        for g in self.pack_state:
            g.generate_r1cs_constraints(False)
        for rnd in self.rounds:
            rnd.generate_r1cs_constraints()
        for mg in self.final_mod:
            mg.generate_r1cs_constraints()
        for g in self.final_pack:
            g.generate_r1cs_constraints(True)

    def generate_r1cs_witness(self):
        self.schedule.generate_r1cs_witness()
        for g in self.pack_state:
            g.generate_r1cs_witness_from_bits()
        for rnd in self.rounds:
            rnd.generate_r1cs_witness()
        for mg in self.final_mod:
            mg.generate_r1cs_witness()
        for g in self.final_pack:
            g.generate_r1cs_witness_from_packed()


class _SHA256Round(Gadget):
    """One SHA-256 round (sha256_components round_function_gadget)."""

    def __init__(self, pb, state_bits, state_packed, W_packed, W_bits, K,
                 annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        a_bits, b_bits, c_bits, d_bits, e_bits, f_bits, g_bits, h_bits = \
            state_bits
        a_p, b_p, c_p, d_p, e_p, f_p, g_p, h_p = state_packed

        self.S0 = PBVariable().allocate(pb, self.annot("S0"))
        self.S1 = PBVariable().allocate(pb, self.annot("S1"))
        self.ch = PBVariable().allocate(pb, self.annot("ch"))
        self.maj = PBVariable().allocate(pb, self.annot("maj"))
        self.compute_S0 = BigSigmaGadget(pb, a_bits, self.S0, 2, 13, 22,
                                         self.annot("Sigma0"))
        self.compute_S1 = BigSigmaGadget(pb, e_bits, self.S1, 6, 11, 25,
                                         self.annot("Sigma1"))
        self.compute_ch = ChoiceGadget(pb, e_bits, f_bits, g_bits, self.ch,
                                       self.annot("ch"))
        self.compute_maj = MajorityGadget(pb, a_bits, b_bits, c_bits,
                                          self.maj, self.annot("maj"))

        T1 = (_lc(h_p) + self.S1 + self.ch + K + W_packed)
        self.new_e = PBVariable().allocate(pb, self.annot("new_e"))
        self.mod_e = Mod32Gadget(pb, _lc(d_p) + T1, 35, self.new_e,
                                 self.annot("mod_e"))
        self.new_a = PBVariable().allocate(pb, self.annot("new_a"))
        self.mod_a = Mod32Gadget(pb, T1 + self.S0 + self.maj, 35,
                                 self.new_a, self.annot("mod_a"))

        self.new_state_bits = [
            self.mod_a.low_bits, a_bits, b_bits, c_bits,
            self.mod_e.low_bits, e_bits, f_bits, g_bits]
        self.new_state_packed = [
            _lc(self.new_a), _lc(a_p), _lc(b_p), _lc(c_p),
            _lc(self.new_e), _lc(e_p), _lc(f_p), _lc(g_p)]

    def generate_r1cs_constraints(self):
        self.compute_S0.generate_r1cs_constraints()
        self.compute_S1.generate_r1cs_constraints()
        self.compute_ch.generate_r1cs_constraints()
        self.compute_maj.generate_r1cs_constraints()
        self.mod_e.generate_r1cs_constraints()
        self.mod_a.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        self.compute_S0.generate_r1cs_witness()
        self.compute_S1.generate_r1cs_witness()
        self.compute_ch.generate_r1cs_witness()
        self.compute_maj.generate_r1cs_witness()
        self.mod_e.generate_r1cs_witness()
        self.mod_a.generate_r1cs_witness()


def sha256_default_IV_bits() -> list:
    from .sha256_host import words_to_bits
    return words_to_bits(SHA256_H)


class SHA256TwoToOneHashGadget(Gadget):
    """two_to_one CRH: compression of left||right with the standard IV
    (sha256_gadget.hpp:70). Static get_hash lives in sha256_host."""

    DIGEST_SIZE = 256
    BLOCK_SIZE = 512

    def __init__(self, pb, left: DigestVariable, right: DigestVariable,
                 output: DigestVariable, annotation_prefix=""):
        super().__init__(pb, annotation_prefix)
        iv = sha256_default_IV_bits()
        iv_lcs = [LinearCombination(v) for v in iv]   # constants
        block_bits = list(left.bits) + list(right.bits)
        self.f = SHA256CompressionGadget(
            pb, iv_lcs, block_bits, output, self.annot("f"))

    def generate_r1cs_constraints(self, ensure_output_bitness: bool = True):
        self.f.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        self.f.generate_r1cs_witness()

    @staticmethod
    def get_hash(left_bits, right_bits):
        from .sha256_host import sha256_two_to_one_hash_bits
        return sha256_two_to_one_hash_bits(left_bits, right_bits)
