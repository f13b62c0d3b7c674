"""Goldilocks on int64 tensors (each element a u64 bit pattern, canonical,
below p), and the coset low-degree extension of columns.

Plain elementwise tensor code on any torch device.  A product is split
into 32-bit halves, its four partial products summed into 128 bits, and
the 128 bits reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import field

P = field.P
EPS = (1 << 32) - 1            # 2^64 mod p
_MIN = -(1 << 63)
_M32 = 0xFFFFFFFF


def as_i64(v: int) -> int:
    """A u64 as the int64 that has its bits."""
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


_P64 = as_i64(P)


def lt(a, b):
    """Unsigned a < b of u64 bit patterns."""
    return (a ^ _MIN) < (b ^ _MIN)


def _srl32(a):
    """Logical shift right by 32."""
    return (a >> 32) & _M32


def _canon(a):
    """a mod p for any u64 a (a - p where a >= p)."""
    return torch.where(lt(a, torch.full_like(a, _P64)), a, a - _P64)


def add(a, b):
    s = a + b
    s = s + lt(s, a).long() * EPS
    return _canon(s)


def sub(a, b):
    d = a - b
    return d - lt(a, b).long() * EPS


def reduce128(hi, lo):
    """hi * 2^64 + lo mod p, canonical."""
    hh, hl = _srl32(hi), hi & _M32
    t0 = lo - hh
    t0 = t0 - lt(lo, hh).long() * EPS
    t1 = (hl << 32) - hl
    t2 = t0 + t1
    t2 = t2 + lt(t2, t1).long() * EPS
    return _canon(t2)


def mul(a, b):
    a0, a1 = a & _M32, _srl32(a)
    b0, b1 = b & _M32, _srl32(b)
    p00, p11 = a0 * b0, a1 * b1
    mid = a0 * b1
    p10 = a1 * b0
    mid2 = mid + p10
    carry_mid = lt(mid2, mid).long()
    lo = p00 + (mid2 << 32)
    carry_lo = lt(lo, p00).long()
    hi = p11 + _srl32(mid2) + (carry_mid << 32) + carry_lo
    return reduce128(hi, lo)


def const(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, as_i64(v % P))


def powers(base: int, n: int, device) -> torch.Tensor:
    """[base^0, ..., base^(n-1)] by doubling blocks."""
    out = torch.ones(1, dtype=torch.int64, device=device)
    step = base % P
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, torch.full_like(out, as_i64(step)))])
        step = step * step % P
    return out[:n].contiguous()


def from_u64(buf) -> torch.Tensor:
    """A numpy uint64 array as an int64 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(buf).view(np.int64))


@functools.lru_cache(maxsize=8)
def _bitrev(nbits: int) -> torch.Tensor:
    idx = torch.arange(1 << nbits, dtype=torch.int64)
    r = torch.zeros_like(idx)
    for b in range(nbits):
        r |= ((idx >> b) & 1) << (nbits - 1 - b)
    return r


def _ntt(x: torch.Tensor, nbits: int, w: int) -> torch.Tensor:
    """Cooley-Tukey radix-2 transform along axis 0 of [2^nbits, m], by the
    root w: out[k] = sum_j x[j] w^(jk)."""
    n, m = x.shape
    buf = x[_bitrev(nbits).to(x.device)]
    tw_all = powers(w, n // 2, x.device)
    for s in range(1, nbits + 1):
        half = 1 << (s - 1)
        tw = tw_all[:: n // (2 * half)][:half].view(1, half, 1)
        b = buf.view(n // (2 * half), 2 * half, m)
        u, v = b[:, :half], mul(b[:, half:], tw.expand_as(b[:, half:]))
        buf = torch.cat([add(u, v), sub(u, v)], dim=1).view(n, m)
    return buf


def lde(x: torch.Tensor, nbits: int, nbits_ext: int) -> torch.Tensor:
    """Columns x [2^nbits, m] (values on the subgroup of order 2^nbits) ->
    their values on the coset SHIFT * <w_ext>, [2^nbits_ext, m]."""
    n = 1 << nbits
    coef = _ntt(x, nbits, field.inv(field.root_of_unity(nbits)))
    scale = powers(field.SHIFT, n, x.device)
    scale = mul(scale, torch.full_like(scale, as_i64(field.inv(n))))
    coef = mul(coef, scale[:, None].expand_as(coef))
    ext = torch.zeros((1 << nbits_ext, x.shape[1]), dtype=torch.int64,
                      device=x.device)
    ext[:n] = coef
    del coef
    return _ntt(ext, nbits_ext, field.root_of_unity(nbits_ext))
