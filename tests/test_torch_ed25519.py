"""The port's Ed25519 (``libsnark_tpu_torch/common/ed25519.py``, RFC 8032,
ADSNARK's public signature scheme) against the JAX package's copy and RFC
8032 section 7.1 TEST 1, byte for byte."""
import random

import pytest

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.common import ed25519 as jax_ed

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.common import ed25519 as ed

# RFC 8032, section 7.1, TEST 1 (the empty message)
SECRET = bytes.fromhex(
    "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
PUBLIC = bytes.fromhex(
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
SIGNATURE = bytes.fromhex(
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")


def _flip(b: bytes, bit: int) -> bytes:
    out = bytearray(b)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


def test_rfc8032_test1():
    assert ed.publickey(SECRET) == PUBLIC == jax_ed.publickey(SECRET)
    assert ed.sign(SECRET, b"") == SIGNATURE == jax_ed.sign(SECRET, b"")
    assert ed.verify(PUBLIC, b"", SIGNATURE)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_keys_signatures_and_verdicts_equal_the_jax_package(seed):
    rng = random.Random(seed)
    sk = bytes(rng.getrandbits(8) for _ in range(32))
    msg = bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 200)))
    pk = ed.publickey(sk)
    sig = ed.sign(sk, msg)
    assert pk == jax_ed.publickey(sk)
    assert sig == jax_ed.sign(sk, msg)
    assert ed.verify(pk, msg, sig) and jax_ed.verify(pk, msg, sig)
    other = ed.publickey(bytes(32))
    assert ed.verify(other, msg, sig) == jax_ed.verify(other, msg, sig) \
        is False


@pytest.mark.parametrize("seed,part", enumerate(
    ["signature R", "signature s", "message", "public key"]))
def test_a_flipped_bit_is_rejected(seed, part):
    msg, pk = b"adsnark", PUBLIC
    sig = ed.sign(SECRET, msg)
    bit = random.Random(seed).randrange(200)
    if part == "signature R":
        sig = _flip(sig, bit)
    elif part == "signature s":
        sig = _flip(sig, 256 + bit)
    elif part == "message":
        msg = _flip(msg + bytes(32), bit)
    else:
        pk = _flip(pk, bit)
    assert not ed.verify(pk, msg, sig)
    assert not jax_ed.verify(pk, msg, sig)


def test_adsnark_signature_scheme_equals_the_jax_package():
    """Ed25519Signature as ADSNARK uses it: keys from random.Random(seed),
    a message over a G2 point's str()."""
    curve, jcurve = get_curve("alt_bn128"), jax_get_curve("alt_bn128")
    sch, jsch = ed.Ed25519Signature(curve), jax_ed.Ed25519Signature(jcurve)
    sk, vk = sch.gen(random.Random(7))
    assert (sk, vk) == jsch.gen(random.Random(7))
    Lambda, jLambda = curve.G2.one() * 12345, jcurve.G2.one() * 12345
    assert str(Lambda) == str(jLambda)
    sig = sch.sign(sk, b"label", Lambda)
    assert sig == jsch.sign(sk, b"label", jLambda)
    assert sch.verify(vk, b"label", Lambda, sig)
    assert not sch.verify(vk, b"label", Lambda * 2, sig)
    assert not sch.batch_verify(vk, [b"label", b"other"], [Lambda, Lambda],
                                [sig, sig])
