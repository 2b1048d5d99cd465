"""Ed25519 (RFC 8032) signatures — the reference's SUPERCOP dependency.

The reference vendors SUPERCOP's Ed25519 asm for ADSNARK's public
authentication mode (depends/CMakeLists.txt:15-34, use site
r1cs_ppzkadsnark_signature.hpp). Signing is host-side setup work (never
on the prover's device hot path), so a portable big-int implementation
is the right TPU-framework equivalent; tests cross-validate against an
independent implementation (the `cryptography` package).

Implements: keypair from a 32-byte seed, detached sign, verify — the
exact RFC 8032 Ed25519 construction (SHA-512, cofactored edwards25519).
"""
from __future__ import annotations

import hashlib
import secrets

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P

_BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int:
    """x from y on -x^2 + y^2 = 1 + d x^2 y^2 (RFC 8032 5.1.3)."""
    if y >= P:
        raise ValueError("y out of range")
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        if sign:
            raise ValueError("invalid point")
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P != 0:
        raise ValueError("not a square")
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
# extended homogeneous coordinates (X, Y, Z, T), T = XY/Z
_B = (_BX, _BY, 1, _BX * _BY % P)
_IDENT = (0, 1, 1, 0)


def _add(p1, p2):
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    A = (Y1 - X1) * (Y2 - X2) % P
    Bv = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * T1 * T2 * D % P
    Dv = 2 * Z1 * Z2 % P
    E, F, G, H = Bv - A, Dv - C, Dv + C, Bv + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def _mul(s: int, pt):
    q = _IDENT
    while s:
        if s & 1:
            q = _add(q, pt)
        pt = _add(pt, pt)
        s >>= 1
    return q


def _equal(p1, p2) -> bool:
    X1, Y1, Z1, _ = p1
    X2, Y2, Z2, _ = p2
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def _encode(pt) -> bytes:
    X, Y, Z, _ = pt
    zi = pow(Z, P - 2, P)
    x, y = X * zi % P, Y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decode(b: bytes):
    if len(b) != 32:
        raise ValueError("bad point length")
    v = int.from_bytes(b, "little")
    sign = v >> 255
    y = v & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    return (x, y, 1, x * y % P)


def _sha512_int(*parts: bytes) -> int:
    h = hashlib.sha512()
    for pt in parts:
        h.update(pt)
    return int.from_bytes(h.digest(), "little")


def _secret_expand(seed: bytes):
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def publickey(seed: bytes) -> bytes:
    a, _ = _secret_expand(seed)
    return _encode(_mul(a, _B))


def sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix = _secret_expand(seed)
    A = _encode(_mul(a, _B))
    r = _sha512_int(prefix, msg) % L
    R = _encode(_mul(r, _B))
    k = _sha512_int(R, A, msg) % L
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def verify(public: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64:
        return False
    try:
        A = _decode(public)
        R = _decode(sig[:32])
    except ValueError:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = _sha512_int(sig[:32], public, msg) % L
    # cofactored check: 8sB == 8R + 8kA
    return _equal(_mul(8 * s, _B), _add(_mul(8, R), _mul(8 * k, A)))


class Ed25519Signature:
    """ADSNARK signature-scheme instantiation (sigGen/sigSign/sigVerif/
    sigBatchVerif shape of r1cs_ppzkadsnark_signature.hpp) over real
    Ed25519, replacing the Schnorr-over-G1 stand-in."""

    def __init__(self, curve=None):
        self.curve = curve

    @staticmethod
    def _message(label: bytes, Lambda) -> bytes:
        return b"adsnark.ed25519|" + label + b"|" + str(Lambda).encode()

    def gen(self, rng):
        seed = bytes(rng.getrandbits(8) for _ in range(32)) \
            if rng is not None else secrets.token_bytes(32)
        return seed, publickey(seed)

    def sign(self, sk: bytes, label: bytes, Lambda, rng=None):
        return sign(sk, self._message(label, Lambda))

    def verify(self, vk: bytes, label: bytes, Lambda, sig) -> bool:
        return verify(vk, self._message(label, Lambda), sig)

    def batch_verify(self, vk, labels, Lambdas, sigs) -> bool:
        return all(self.verify(vk, l, lam, s)
                   for l, lam, s in zip(labels, Lambdas, sigs))
