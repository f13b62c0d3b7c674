"""Goldilocks field arithmetic on torch int64 tensors (the plain version).

A field element is the u64 bit pattern of its canonical value (< p) held in
an int64 tensor: torch has no unsigned 64-bit arithmetic on the CPU, so adds
and multiplies wrap in int64, right shifts are masked to act logically, and
unsigned compares flip the sign bit first.  Host numpy uint64 arrays cross
without a copy through `from_u64` / `to_u64`.

The reduction is the one of ops/gl_jax.py and csrc/gl.cuh: a 128-bit product
is folded with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).  All outputs are
canonical for canonical inputs, so every implementation agrees bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

P_INT = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF          # 2^64 mod p
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def as_i64(v: int) -> int:
    """The int64 bit pattern of a u64 value."""
    v = int(v)
    return v - (1 << 64) if v >= 1 << 63 else v


P = as_i64(P_INT)


def from_u64(a, device: torch.device | str | None = None) -> torch.Tensor:
    """uint64 numpy array -> int64 tensor (zero-copy on the CPU)."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    t = torch.from_numpy(a.view(np.int64))
    return t if device is None else t.to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array (a view for contiguous CPU tensors)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def ult(a, b):
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _canon(r):
    """Subtract p once where r >= p (any u64 input)."""
    return torch.where(ult(r, P), r, r - P)


def add(a, b):
    s = a + b
    s = torch.where(ult(s, a), s + EPS, s)  # carry: 2^64 = 2^32 - 1
    return _canon(s)


def sub(a, b):
    d = a - b
    return torch.where(ult(a, b), d - EPS, d)  # borrow: add p mod 2^64


def neg(a):
    return torch.where(a == 0, a, P - a)


def reduce160(lo, hi, top):
    """(top * 2^128 + hi * 2^64 + lo) mod p for top < 2^32 - 1: the plain
    twin of csrc/gl.cuh's reduce160, canonical.  With hi = h1 * 2^32 + h0
    the value is lo - (top * 2^32 + h1) + h0 * (2^32 - 1)."""
    sub_ = ((hi >> 32) & _M32) | (top << 32)
    hi_lo = hi & _M32
    t0 = lo - sub_
    t0 = torch.where(ult(lo, sub_), t0 - EPS, t0)
    t1 = (hi_lo << 32) - hi_lo
    r = t0 + t1
    r = torch.where(ult(r, t1), r + EPS, r)
    return _canon(r)


def reduce128(lo, hi):
    """(hi * 2^64 + lo) mod p: reduce160 with no third word, written out
    so that the eager path spends no launch on it."""
    hi_hi = (hi >> 32) & _M32
    hi_lo = hi & _M32
    t0 = lo - hi_hi
    t0 = torch.where(ult(lo, hi_hi), t0 - EPS, t0)
    t1 = (hi_lo << 32) - hi_lo
    r = t0 + t1
    r = torch.where(ult(r, t1), r + EPS, r)
    return _canon(r)


def mul_wide(a, b):
    """The 128-bit product (lo, hi) of two u64 bit patterns; b may be a
    tensor or an int64 bit pattern (`as_i64`)."""
    a0, a1 = a & _M32, (a >> 32) & _M32
    b0, b1 = b & _M32, (b >> 32) & _M32
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = ((ll >> 32) & _M32) + (lh & _M32) + (hl & _M32)  # < 3 * 2^32
    lo = (ll & _M32) | (mid << 32)
    hi = hh + ((lh >> 32) & _M32) + ((hl >> 32) & _M32) + (mid >> 32)
    return lo, hi


def mul(a, b):
    """a * b mod p; b may be a tensor or an int64 bit pattern (`as_i64`)."""
    return reduce128(*mul_wide(a, b))


def sqr(a):
    """a * a mod p with three limb products, the plain twin of csrc/gl.cuh's
    sqr_wide: the cross product a0 * a1 is taken once and added twice."""
    a0, a1 = a & _M32, (a >> 32) & _M32
    t, c = a0 * a0, a0 * a1
    u = c + ((t >> 32) & _M32)           # < 2^64: c <= (2^32 - 1)^2
    v = c + (u & _M32)
    hi = a1 * a1 + ((u >> 32) & _M32) + ((v >> 32) & _M32)
    lo = (t & _M32) | (v << 32)
    return reduce128(lo, hi)


def square(a):
    return mul(a, a)


def mul_pow2(a, k: int):
    """a * 2^k mod p for 0 <= k < 192, the plain twin of csrc/gl.cuh's
    mul_pow2: the value shifted by k mod 96 has at most 160 bits and is
    reduced once; 2^96 = -1 negates it for k >= 96."""
    if not 0 <= k < 192:
        raise ValueError(f"mul_pow2: k = {k}")
    s = k % 96
    zero = torch.zeros_like(a)
    if s == 0:
        r = _canon(a)
    elif s < 64:
        r = reduce160(a << s, (a >> (64 - s)) & ((1 << s) - 1), 0)
    elif s == 64:
        r = reduce160(zero, a, 0)
    else:
        r = reduce160(zero, a << (s - 64),
                      (a >> (128 - s)) & ((1 << (s - 64)) - 1))
    return r if k < 96 else neg(r)


def dot(a, b, dim: int):
    """sum_j a_j * b_j mod p along `dim`, the plain twin of csrc/gl.cuh's
    Acc: the 128-bit products are summed in three words (the third counts
    the carries) and reduced once."""
    lo_j, hi_j = mul_wide(a, b)
    lo_j, hi_j = lo_j.movedim(dim, 0), hi_j.movedim(dim, 0)
    lo, hi = lo_j[0], hi_j[0]
    top = torch.zeros_like(lo)
    for j in range(1, lo_j.shape[0]):
        lo = lo + lo_j[j]
        carry = ult(lo, lo_j[j]).long()
        hi = hi + carry
        top = top + ult(hi, carry).long()
        hi = hi + hi_j[j]
        top = top + ult(hi, hi_j[j]).long()
    return reduce160(lo, hi, top)


def pow7(a):
    a2 = mul(a, a)
    a3 = mul(a2, a)
    a6 = mul(a3, a3)
    return mul(a6, a)


def exp_const(a, e: int):
    """a ** e for a Python-int exponent (square and multiply)."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inv(a):
    return exp_const(a, P_INT - 2)


def select(mask, a, b):
    return torch.where(mask, a, b)


def sum_mod(v, dim: int):
    """Modular sum along `dim` by pairwise folding."""
    v = v.movedim(dim, 0)
    while v.shape[0] > 1:
        half = v.shape[0] // 2
        s = add(v[:half], v[half : 2 * half])
        if v.shape[0] % 2:
            s = torch.cat([s, v[-1:]], dim=0)
        v = s
    return v[0]


def full(shape, value: int, device) -> torch.Tensor:
    """A tensor of one field element (u64 value), made on `device` by a
    fill (no host-to-device copy)."""
    return torch.full(shape, as_i64(value), dtype=torch.int64, device=device)


def powers(base: int, n: int, device=None) -> torch.Tensor:
    """[base^0, ..., base^(n-1)] by log-doubling (each doubling appends the
    current powers times base^m)."""
    pows = full((1,), 1, device)
    cur = as_i64(base)
    while pows.shape[0] < n:
        pows = torch.cat([pows, mul(pows, cur)])
        cur = as_i64(mul_int(cur, cur))
    return pows[:n]


# ---- scalar helpers on Python ints (u64 values, not bit patterns): the
# transcript-side points, twiddle seeds and table builders of the host

GENERATOR = 7
SHIFT = 49          # coset shift of the LDE domain
TWO_ADICITY = 32


def mul_int(a: int, b: int) -> int:
    return (int(a) % (1 << 64)) * (int(b) % (1 << 64)) % P_INT


def exp_int(a: int, e: int) -> int:
    return pow(int(a) % (1 << 64), int(e), P_INT)


def inv_int(a: int) -> int:
    return exp_int(a, P_INT - 2)


@functools.lru_cache(maxsize=None)
def root_of_unity(nbits: int) -> int:
    """The canonical primitive 2^nbits-th root: 7^((p-1)/2^32) squared down
    32 - nbits times."""
    if not 0 <= nbits <= TWO_ADICITY:
        raise ValueError(f"no 2^{nbits}-th root of unity in GL")
    w = exp_int(GENERATOR, (P_INT - 1) >> TWO_ADICITY)
    for _ in range(TWO_ADICITY - nbits):
        w = w * w % P_INT
    return w


def shift_powers(nbits: int, device=None) -> torch.Tensor:
    """[SHIFT^0, ..., SHIFT^(2^nbits - 1)]."""
    return powers(SHIFT, 1 << nbits, device)


@functools.lru_cache(maxsize=64)
def bit_reverse(nbits: int) -> torch.Tensor:
    """The bit-reversal permutation of 2^nbits indices (CPU int64)."""
    idx = torch.arange(1 << nbits)
    rev = torch.zeros_like(idx)
    for b in range(nbits):
        rev |= ((idx >> b) & 1) << (nbits - 1 - b)
    return rev
