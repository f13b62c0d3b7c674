"""Goldilocks and its cubic extension on Python ints, for the verifier.

GL: p = 2^64 - 2^32 + 1.  GF(p^3) = GL[X] / (X^3 - X - 1); an element is a
3-tuple (a0, a1, a2) = a0 + a1 X + a2 X^2, a base element (a, 0, 0).
"""
from __future__ import annotations

P = 0xFFFFFFFF00000001
GENERATOR = 7          # of GL's multiplicative group
TWO_ADICITY = 32
SHIFT = 49             # the coset of the extended evaluation domain


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("0 has no inverse in GL")
    return pow(a, P - 2, P)


def root_of_unity(nbits: int) -> int:
    """The primitive 2^nbits-th root of unity 7^((p - 1) / 2^nbits)."""
    if not 0 <= nbits <= TWO_ADICITY:
        raise ValueError(f"GL has no 2^{nbits}-th root of unity")
    return pow(GENERATOR, (P - 1) >> nbits, P)


ZERO3 = (0, 0, 0)
ONE3 = (1, 0, 0)


def e3(x) -> tuple:
    """A base element or an iterable of 3 as a GF(p^3) tuple."""
    if isinstance(x, int):
        return (x % P, 0, 0)
    a = tuple(int(v) % P for v in x)
    if len(a) == 1:
        return (a[0], 0, 0)
    if len(a) != 3:
        raise ValueError(f"not a GF(p^3) element: {x!r}")
    return a


def add3(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P, (a[2] + b[2]) % P)


def sub3(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P, (a[2] - b[2]) % P)


def neg3(a):
    return ((-a[0]) % P, (-a[1]) % P, (-a[2]) % P)


def mul3(a, b):
    # (a0 + a1 X + a2 X^2)(b0 + b1 X + b2 X^2) with X^3 = X + 1, X^4 = X^2 + X
    c0 = a[0] * b[0]
    c1 = a[0] * b[1] + a[1] * b[0]
    c2 = a[0] * b[2] + a[1] * b[1] + a[2] * b[0]
    c3 = a[1] * b[2] + a[2] * b[1]
    c4 = a[2] * b[2]
    return ((c0 + c3) % P, (c1 + c3 + c4) % P, (c2 + c4) % P)


def scale3(a, s: int):
    return (a[0] * s % P, a[1] * s % P, a[2] * s % P)


def pow3(a, e: int):
    r, b = ONE3, a
    while e:
        if e & 1:
            r = mul3(r, b)
        b = mul3(b, b)
        e >>= 1
    return r


def inv3(a):
    """a^(p^3 - 2), Fermat in GF(p^3)."""
    if a == ZERO3:
        raise ZeroDivisionError("0 has no inverse in GF(p^3)")
    return pow3(a, P ** 3 - 2)
