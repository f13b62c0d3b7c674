"""Quintic extension GF(p^5) of Goldilocks (x^5 = 3) on int64 tensors.

Port of eigen_zkvm_tpu/fields/f5g.py (reference starky/src/f5g.rs: the
irreducible x^5 - 3), shaped like ops/f3.py: an element is the last axis
(size 5) of an int64 tensor of u64 bit patterns (ops/gl.py); base-field
values embed as (v, 0, 0, 0, 0).  Every result is canonical, so every
implementation agrees bit for bit.  FRI folds over this field when it is
given `dim=5` (stark/fri.py).

The `*_int` forms take and return 5-tuples of Python ints: the FRI
challenges and the host verifier.
"""
from __future__ import annotations

import functools

import torch

from . import gl

DIM = 5
_W = 3   # x^5 = 3


def add(a, b):
    return gl.add(a, b)


def sub(a, b):
    return gl.sub(a, b)


def neg(a):
    return gl.neg(a)


# _TWIST[k][i]: where b_(k - i), times 3 if k - i wraps below 0, sits in
# [b, 3 b] (x^5 = 3: x^i x^j = 3 x^(i + j - 5) for i + j >= 5)
_TWIST = [[(k - i) % DIM + (DIM if i > k else 0) for i in range(DIM)]
          for k in range(DIM)]


@functools.lru_cache(maxsize=8)
def _twist(device) -> torch.Tensor:
    return torch.tensor(_TWIST, device=device)


def mul(a, b):
    """Schoolbook product with the x^5 = 3 wrap (f5g.py mul); broadcasts.
    out[k] = sum_i a_i b'[k, i] with b' = [b, 3 b] gathered by _TWIST: the
    25 products in one batched product and one 5-term sum, so a Horner
    step of the fold is a few dozen launches, not hundreds."""
    bb = torch.cat([b, gl.mul(b, gl.as_i64(_W))], dim=-1)[..., _twist(
        b.device)]
    return gl.sum_mod(gl.mul(a[..., None, :], bb), -1)


def mul_base(a, s):
    """a [..., 5] times base-field s [...] (or an int64 bit pattern)."""
    if isinstance(s, torch.Tensor):
        s = s[..., None]
    return gl.mul(a, s)


def square(a):
    return mul(a, a)


def from_ints(v, device=None) -> torch.Tensor:
    """A 5-sequence of u64 values as an int64 [5] tensor on `device`, made
    by fills (no host-to-device copy)."""
    return torch.stack([gl.full((), x, device) for x in v])


# ---- the same field on 5-tuples of Python ints (u64 values)

ONE_INT = (1, 0, 0, 0, 0)
ZERO_INT = (0, 0, 0, 0, 0)
_P = gl.P_INT


def add_int(a, b):
    return tuple((int(x) + int(y)) % _P for x, y in zip(a, b))


def mul_int(a, b):
    a = [int(x) for x in a]
    b = [int(x) for x in b]
    out = [0] * DIM
    for i in range(DIM):
        for j in range(DIM):
            k = i + j
            out[k % DIM] += a[i] * b[j] * (_W if k >= DIM else 1)
    return tuple(x % _P for x in out)


def mul_base_int(a, s: int):
    return tuple(int(x) * int(s) % _P for x in a)


def exp_int(a, e: int):
    result, base = ONE_INT, tuple(int(x) for x in a)
    while e > 0:
        if e & 1:
            result = mul_int(result, base)
        base = mul_int(base, base)
        e >>= 1
    return result


def inv_int(a):
    """a^(p^5 - 2): the inverse of a nonzero element (f5g.py inv)."""
    return exp_int(a, _P ** 5 - 2)
