"""Host-side (arbitrary-precision Python int) finite field towers.

This is the *oracle* layer of the framework: a small, correct, pure-Python
implementation of prime fields and their quadratic/cubic extension towers
(Fp -> Fp2 -> Fp6 -> Fp12 and Fp -> Fp3 -> Fp6), used by

  * the pairing-based verifiers (a handful of field ops per verification),
  * the trusted-setup secret-side math (evaluated once per circuit), and
  * the test-suite as the bit-exactness reference for every TPU kernel.

Capability parity: libff's Fp_model/Fp2/Fp6/Fp12 template classes
(reference: libff field headers consumed at
zk_proof_systems/ppzksnark/r1cs_gg_ppzksnark/r1cs_gg_ppzksnark.tcc:242).
The TPU hot path does NOT go through this module -- see
libsnark_tpu/ops/fp.py for the batched packed-limb kernels.
"""
from __future__ import annotations

import functools
import hashlib

_new = object.__new__


# ---------------------------------------------------------------------------
# Prime field
# ---------------------------------------------------------------------------

class FieldMeta(type):
    def __repr__(cls):
        return getattr(cls, "_name", cls.__name__)


@functools.lru_cache(maxsize=None)
def make_prime_field(p: int, name: str = "Fp"):
    """Create a prime-field class for modulus ``p``.

    Elements are immutable wrappers over ``int`` with operator arithmetic,
    mirroring libff's ``Fp_model`` API surface (``inverse``, ``squared``,
    ``sqrt``, ``random_element`` analogues live on the class).
    """

    class Fp(metaclass=FieldMeta):
        _name = name
        modulus = p
        degree = 1          # extension degree over the prime field
        char = p            # field characteristic

        __slots__ = ("n",)

        def __init__(self, v=0):
            if isinstance(v, Fp):
                self.n = v.n
            else:
                self.n = int(v) % p

        # -- constructors -------------------------------------------------
        @classmethod
        def zero(cls):
            return cls(0)

        @classmethod
        def one(cls):
            return cls(1)

        @classmethod
        def from_int(cls, v):
            return cls(v)

        # -- predicates ---------------------------------------------------
        def is_zero(self):
            return self.n == 0

        # -- arithmetic -----------------------------------------------------
        # (results are made by _new and a reduced int: the pairings'
        # tower spends most of its time in these)
        def __add__(self, o):
            r = _new(Fp)
            r.n = (self.n + (o if isinstance(o, int) else o.n)) % p
            return r

        __radd__ = __add__

        def __sub__(self, o):
            r = _new(Fp)
            r.n = (self.n - (o if isinstance(o, int) else o.n)) % p
            return r

        def __rsub__(self, o):
            r = _new(Fp)
            r.n = ((o if isinstance(o, int) else o.n) - self.n) % p
            return r

        def __mul__(self, o):
            r = _new(Fp)
            r.n = self.n * (o if isinstance(o, int) else o.n) % p
            return r

        __rmul__ = __mul__

        def __neg__(self):
            r = _new(Fp)
            r.n = -self.n % p
            return r

        def __pow__(self, e):
            return Fp(pow(self.n, int(e), p))

        def squared(self):
            r = _new(Fp)
            r.n = self.n * self.n % p
            return r

        def inverse(self):
            if self.n == 0:
                raise ZeroDivisionError("inverse of zero field element")
            return Fp(pow(self.n, -1, p))

        def __truediv__(self, o):
            o = Fp(o) if not isinstance(o, Fp) else o
            return self * o.inverse()

        def __eq__(self, o):
            if isinstance(o, Fp):
                return self.n == o.n
            if isinstance(o, int):
                return self.n == o % p
            return NotImplemented

        def __hash__(self):
            return hash((p, self.n))

        def __repr__(self):
            return f"{name}({self.n})"

        def __int__(self):
            return self.n

        # -- misc (libff parity helpers) ------------------------------------
        def frobenius(self, power=1):
            return self

        def conjugate(self):
            return self

        def sqrt(self):
            """Tonelli-Shanks square root; raises ValueError if non-residue."""
            return Fp(tonelli_shanks(self.n, p))

        def is_square(self):
            return self.n == 0 or pow(self.n, (p - 1) // 2, p) == 1

        def to_list(self):
            """Flatten to list of base-field ints (tower-generic)."""
            return [self.n]

        @classmethod
        def from_list(cls, xs):
            assert len(xs) == 1
            return cls(xs[0])

        @classmethod
        def random_element(cls, rng=None):
            import secrets
            if rng is None:
                return cls(secrets.randbelow(p))
            return cls(rng.randrange(p))

    return Fp


def as_int(o):
    if isinstance(o, int):
        return o
    return o.n


def tonelli_shanks(a: int, p: int) -> int:
    """Square root mod odd prime p. Raises ValueError for non-residues."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        raise ValueError("not a quadratic residue")
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # factor p-1 = q * 2^s
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue z
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        # find least i with t^(2^i) == 1
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


# ---------------------------------------------------------------------------
# Generic extension fields
# ---------------------------------------------------------------------------

def make_quadratic_ext(base, non_residue, name="Fp2"):
    """Quadratic extension base[s]/(s^2 - non_residue).

    ``non_residue`` is an element of ``base``. Mirrors libff Fp2_model /
    Fp12_model (quadratic over Fp6).
    """
    beta = non_residue if not isinstance(non_residue, int) else base(non_residue)

    class Ext(metaclass=FieldMeta):
        _name = name
        base_field = base
        modulus = base.modulus
        char = base.char
        degree = 2 * base.degree
        NON_RESIDUE = beta

        __slots__ = ("c0", "c1")

        def __init__(self, c0=None, c1=None):
            self.c0 = base() if c0 is None else (c0 if isinstance(c0, base) else base(c0))
            self.c1 = base() if c1 is None else (c1 if isinstance(c1, base) else base(c1))

        @classmethod
        def zero(cls):
            return cls(base.zero(), base.zero())

        @classmethod
        def one(cls):
            return cls(base.one(), base.zero())

        @classmethod
        def from_int(cls, v):
            return cls(base.from_int(v), base.zero())

        def is_zero(self):
            return self.c0.is_zero() and self.c1.is_zero()

        # (results are made by _mk from base elements: the pairings' tower
        # spends most of its time in these)
        def __add__(self, o):
            if type(o) is not Ext:
                o = self._coerce(o)
            return _mk(self.c0 + o.c0, self.c1 + o.c1)

        __radd__ = __add__

        def __sub__(self, o):
            if type(o) is not Ext:
                o = self._coerce(o)
            return _mk(self.c0 - o.c0, self.c1 - o.c1)

        def __rsub__(self, o):
            return self._coerce(o) - self

        def __neg__(self):
            return _mk(-self.c0, -self.c1)

        def __mul__(self, o):
            if isinstance(o, int):
                return Ext(self.c0 * o, self.c1 * o)
            if type(o) is not Ext:
                o = self._coerce(o)
            # Karatsuba: (a0 + a1 s)(b0 + b1 s) = a0b0 + beta a1b1 + ((a0+a1)(b0+b1) - a0b0 - a1b1) s
            v0 = self.c0 * o.c0
            v1 = self.c1 * o.c1
            return _mk(v0 + beta * v1,
                       (self.c0 + self.c1) * (o.c0 + o.c1) - v0 - v1)

        __rmul__ = __mul__

        def squared(self):
            # complex squaring
            a, b = self.c0, self.c1
            v = a * b
            return _mk((a + b) * (a + beta * b) - v - beta * v, v + v)

        def inverse(self):
            # (a - b s)/(a^2 - beta b^2)
            a, b = self.c0, self.c1
            t = (a.squared() - beta * b.squared()).inverse()
            return Ext(a * t, -(b * t))

        def __truediv__(self, o):
            return self * self._coerce(o).inverse()

        def __pow__(self, e):
            return generic_pow(self, int(e))

        def conjugate(self):
            return Ext(self.c0, -self.c1)

        def __eq__(self, o):
            if not isinstance(o, Ext):
                if isinstance(o, int):
                    o = Ext.from_int(o)
                else:
                    return NotImplemented
            return self.c0 == o.c0 and self.c1 == o.c1

        def __hash__(self):
            return hash((name, self.c0, self.c1))

        def __repr__(self):
            return f"{name}({self.c0!r}, {self.c1!r})"

        def _coerce(self, o):
            if isinstance(o, Ext):
                return o
            if isinstance(o, (int, base)):
                return Ext(o if not isinstance(o, int) else base(o), base.zero())
            raise TypeError(f"cannot coerce {type(o)} to {name}")

        # Frobenius: (a + b s)^(q^i) = a^(q^i) + b^(q^i) * s^(q^i)
        #   s^q = s * beta^((q-1)/2)   (since s^2 = beta)
        _frob_coeffs = {}

        def frobenius(self, power=1):
            power %= self.degree
            if power == 0:
                return self
            c = Ext._frob_coeff(power)
            return Ext(self.c0.frobenius(power), self.c1.frobenius(power) * c)

        @classmethod
        def _frob_coeff(cls, power):
            if power not in cls._frob_coeffs:
                q = base.char
                # s^(q^power) = s * beta^((q^power - 1)/2)
                cls._frob_coeffs[power] = generic_pow(beta, (q ** power - 1) // 2)
            return cls._frob_coeffs[power]

        def to_list(self):
            return self.c0.to_list() + self.c1.to_list()

        @classmethod
        def from_list(cls, xs):
            h = len(xs) // 2
            return cls(base.from_list(xs[:h]), base.from_list(xs[h:]))

        @classmethod
        def random_element(cls, rng=None):
            return cls(base.random_element(rng), base.random_element(rng))

        def sqrt(self):
            """Square root in Fp2 via the complex method (p = 3 mod 4 fast
            path not assumed). Generic: uses norm + base sqrt."""
            if self.is_zero():
                return Ext.zero()
            if self.c1.is_zero():
                # sqrt of base element: either sqrt(c0) in base, or
                # sqrt(c0/beta) * s
                try:
                    return Ext(self.c0.sqrt(), base.zero())
                except ValueError:
                    return Ext(base.zero(), (self.c0 / beta).sqrt())
            # solve (x0 + x1 s)^2 = c0 + c1 s
            # norm = c0^2 - beta c1^2 must be a square in base
            alpha = (self.c0.squared() - beta * self.c1.squared()).sqrt()
            two_inv = base.from_int(2).inverse()
            delta = (self.c0 + alpha) * two_inv
            if not delta.is_square():
                delta = (self.c0 - alpha) * two_inv
            x0 = delta.sqrt()
            x1 = self.c1 * (x0 + x0).inverse()
            return Ext(x0, x1)

    def _mk(c0, c1):
        r = _new(Ext)
        r.c0, r.c1 = c0, c1
        return r

    return Ext


def make_cubic_ext(base, non_residue, name="Fp3"):
    """Cubic extension base[s]/(s^3 - non_residue). Mirrors libff Fp3/Fp6_3over2."""
    beta = non_residue if not isinstance(non_residue, int) else base(non_residue)

    class Ext(metaclass=FieldMeta):
        _name = name
        base_field = base
        modulus = base.modulus
        char = base.char
        degree = 3 * base.degree
        NON_RESIDUE = beta

        __slots__ = ("c0", "c1", "c2")

        def __init__(self, c0=None, c1=None, c2=None):
            mk = lambda v: base() if v is None else (v if isinstance(v, base) else base(v))
            self.c0, self.c1, self.c2 = mk(c0), mk(c1), mk(c2)

        @classmethod
        def zero(cls):
            return cls()

        @classmethod
        def one(cls):
            return cls(base.one())

        @classmethod
        def from_int(cls, v):
            return cls(base.from_int(v))

        def is_zero(self):
            return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

        def __add__(self, o):
            if type(o) is not Ext:
                o = self._coerce(o)
            return _mk(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

        __radd__ = __add__

        def __sub__(self, o):
            if type(o) is not Ext:
                o = self._coerce(o)
            return _mk(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

        def __rsub__(self, o):
            return self._coerce(o) - self

        def __neg__(self):
            return _mk(-self.c0, -self.c1, -self.c2)

        def __mul__(self, o):
            if isinstance(o, int):
                return Ext(self.c0 * o, self.c1 * o, self.c2 * o)
            if type(o) is not Ext:
                o = self._coerce(o)
            a0, a1, a2 = self.c0, self.c1, self.c2
            b0, b1, b2 = o.c0, o.c1, o.c2
            v0, v1, v2 = a0 * b0, a1 * b1, a2 * b2
            # Toom/Karatsuba style (CH-SQR3 layout as in libff Fp3_model):
            return _mk(
                v0 + beta * ((a1 + a2) * (b1 + b2) - v1 - v2),
                (a0 + a1) * (b0 + b1) - v0 - v1 + beta * v2,
                (a0 + a2) * (b0 + b2) - v0 - v2 + v1,
            )

        __rmul__ = __mul__

        def squared(self):
            return self * self

        def inverse(self):
            a0, a1, a2 = self.c0, self.c1, self.c2
            t0 = a0.squared() - beta * (a1 * a2)
            t1 = beta * a2.squared() - a0 * a1
            t2 = a1.squared() - a0 * a2
            t3 = ((a0 * t0) + beta * ((a2 * t1) + (a1 * t2))).inverse()
            return Ext(t0 * t3, t1 * t3, t2 * t3)

        def __truediv__(self, o):
            return self * self._coerce(o).inverse()

        def __pow__(self, e):
            return generic_pow(self, int(e))

        def __eq__(self, o):
            if not isinstance(o, Ext):
                if isinstance(o, int):
                    o = Ext.from_int(o)
                else:
                    return NotImplemented
            return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

        def __hash__(self):
            return hash((name, self.c0, self.c1, self.c2))

        def __repr__(self):
            return f"{name}({self.c0!r}, {self.c1!r}, {self.c2!r})"

        def _coerce(self, o):
            if isinstance(o, Ext):
                return o
            if isinstance(o, (int, base)):
                return Ext(o if not isinstance(o, int) else base(o))
            raise TypeError(f"cannot coerce {type(o)} to {name}")

        _frob_coeffs = {}

        def frobenius(self, power=1):
            power %= self.degree
            if power == 0:
                return self
            c1, c2 = Ext._frob_coeff(power)
            return Ext(self.c0.frobenius(power),
                       self.c1.frobenius(power) * c1,
                       self.c2.frobenius(power) * c2)

        @classmethod
        def _frob_coeff(cls, power):
            if power not in cls._frob_coeffs:
                q = base.char
                # s^(q^i) = s * beta^((q^i - 1)/3); (s^2)^(q^i) = s^2 * beta^(2(q^i-1)/3)
                e = (q ** power - 1) // 3
                c1 = generic_pow(beta, e)
                cls._frob_coeffs[power] = (c1, c1 * c1)
            return cls._frob_coeffs[power]

        def to_list(self):
            return self.c0.to_list() + self.c1.to_list() + self.c2.to_list()

        @classmethod
        def from_list(cls, xs):
            h = len(xs) // 3
            return cls(base.from_list(xs[:h]), base.from_list(xs[h:2 * h]),
                       base.from_list(xs[2 * h:]))

        @classmethod
        def random_element(cls, rng=None):
            return cls(base.random_element(rng), base.random_element(rng),
                       base.random_element(rng))

        def is_square(self):
            order = self.char ** self.degree - 1
            return self.is_zero() or generic_pow(self, order // 2) == Ext.one()

        def sqrt(self):
            """Generic Tonelli-Shanks in the cubic extension (used by
            compressed G2 deserialization on MNT6; no structure
            assumed). Raises ValueError on non-squares."""
            if self.is_zero():
                return Ext.zero()
            order = self.char ** self.degree - 1
            if generic_pow(self, order // 2) != Ext.one():
                raise ValueError("not a square")
            m_odd, s = order, 0
            while m_odd % 2 == 0:
                m_odd //= 2
                s += 1
            import random as _random
            rng = _random.Random(0x5077)
            z = Ext.random_element(rng)
            while z.is_zero() or generic_pow(z, order // 2) == Ext.one():
                z = Ext.random_element(rng)
            c = generic_pow(z, m_odd)
            t = generic_pow(self, m_odd)
            r_ = generic_pow(self, (m_odd + 1) // 2)
            mm = s
            while t != Ext.one():
                i, tt = 0, t
                while tt != Ext.one():
                    tt = tt * tt
                    i += 1
                b = generic_pow(c, 1 << (mm - i - 1))
                mm, c = i, b * b
                t = t * c
                r_ = r_ * b
            return r_

    def _mk(c0, c1, c2):
        r = _new(Ext)
        r.c0, r.c1, r.c2 = c0, c1, c2
        return r

    return Ext


def generic_pow(x, e: int):
    if e < 0:
        return generic_pow(x.inverse(), -e)
    result = type(x).one()
    acc = x
    while e:
        if e & 1:
            result = result * acc
        acc = acc.squared() if hasattr(acc, "squared") else acc * acc
        e >>= 1
    return result


def hash_to_field(Fp, data: bytes, dst: bytes = b"libsnark_tpu"):
    """Deterministic field element from bytes (for derived test generators)."""
    n = 0
    counter = 0
    # expand enough uniform bytes for negligible bias
    nbytes = (Fp.modulus.bit_length() + 7) // 8 + 16
    buf = b""
    while len(buf) < nbytes:
        buf += hashlib.sha256(dst + counter.to_bytes(4, "big") + data).digest()
        counter += 1
    n = int.from_bytes(buf[:nbytes], "big")
    return Fp(n)
