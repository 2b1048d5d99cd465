"""Host-side SHA-256 compression function (no padding).

Oracle for the SHA-256 gadgets: libsnark's two-to-one hash is the raw
compression function over a 512-bit block with the standard IV (reference
gadgetlib1/gadgets/hashes/sha256/sha256_gadget.tcc get_hash). Digests and
blocks are bit lists MSB-first within each 32-bit word, matching the
reference's pb bit conventions (sha256_components.tcc:45-61).
"""
from __future__ import annotations

SHA256_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

SHA256_H = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

SHA256_DIGEST_SIZE = 256
SHA256_BLOCK_SIZE = 512

_M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def sha256_compress(state_words, block_words):
    """One SHA-256 compression: 8 state words + 16 block words -> 8 words."""
    a, b, c, d, e, f, g, h = state_words
    W = list(block_words)
    for i in range(16, 64):
        s0 = _rotr(W[i - 15], 7) ^ _rotr(W[i - 15], 18) ^ (W[i - 15] >> 3)
        s1 = _rotr(W[i - 2], 17) ^ _rotr(W[i - 2], 19) ^ (W[i - 2] >> 10)
        W.append((W[i - 16] + s0 + W[i - 7] + s1) & _M32)
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + SHA256_K[i] + W[i]) & _M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & _M32
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M32,
                                  c, b, a, (t1 + t2) & _M32)
    return [(x + y) & _M32 for x, y in
            zip(state_words, [a, b, c, d, e, f, g, h])]


# -- bit conventions ----------------------------------------------------------

def words_to_bits(words) -> list:
    """32-bit words -> MSB-first bit list (libsnark digest convention)."""
    out = []
    for w in words:
        out.extend((w >> (31 - j)) & 1 for j in range(32))
    return out


def bits_to_words(bits) -> list:
    assert len(bits) % 32 == 0
    out = []
    for i in range(0, len(bits), 32):
        w = 0
        for j in range(32):
            w = (w << 1) | (1 if bits[i + j] else 0)
        out.append(w)
    return out


def sha256_two_to_one_hash_bits(left_bits, right_bits) -> list:
    """libsnark sha256_two_to_one_hash_gadget::get_hash semantics:
    compression of left||right (512 bits) with the standard IV."""
    assert len(left_bits) == 256 and len(right_bits) == 256
    block = bits_to_words(list(left_bits) + list(right_bits))
    return words_to_bits(sha256_compress(SHA256_H, block))


def sha256_compression_bits(prev_digest_bits, block_bits) -> list:
    assert len(prev_digest_bits) == 256 and len(block_bits) == 512
    return words_to_bits(
        sha256_compress(bits_to_words(prev_digest_bits),
                        bits_to_words(block_bits)))
