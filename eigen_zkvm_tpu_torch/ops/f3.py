"""Cubic extension GF(p^3) of Goldilocks (x^3 = x + 1) on int64 tensors.

Port of the F3 products of eigen_zkvm_tpu/ops/vm_jax.py (`_f3_mul`,
`_f3_inv`) and ops/fri_jax.py, with fields/f3g.py's `mul_base` and
`prefix_product` (and its distributed scan over a mesh's row blocks,
`prefix_product_sharded`).  An element is the last axis (size 3) of an int64 tensor
of u64 bit patterns (ops/gl.py); base-field values embed as (v, 0, 0).
Every result is canonical, so every implementation agrees bit for bit.

The `*_int` forms take and return 3-tuples of Python ints: the
transcript-side points (xi, the FRI challenges) and the host verifier.
"""
from __future__ import annotations

import torch

from . import gl

DIM = 3


def add(a, b):
    return gl.add(a, b)


def sub(a, b):
    return gl.sub(a, b)


def neg(a):
    return gl.neg(a)


def mul(a, b):
    """Karatsuba-style product (fields/f3g.py mul); broadcasts."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    aa = gl.mul(gl.add(a0, a1), gl.add(b0, b1))
    bb = gl.mul(gl.add(a0, a2), gl.add(b0, b2))
    cc = gl.mul(gl.add(a1, a2), gl.add(b1, b2))
    dd = gl.mul(a0, b0)
    ee = gl.mul(a1, b1)
    ff = gl.mul(a2, b2)
    gg = gl.sub(dd, ee)
    c0 = gl.sub(gl.add(cc, gg), ff)
    c1 = gl.sub(gl.add(aa, cc), gl.add(gl.add(ee, ee), dd))
    c2 = gl.sub(bb, gg)
    return torch.stack([c0, c1, c2], dim=-1)


def mul_base(a, s):
    """a [..., 3] times base-field s [...] (or an int64 bit pattern)."""
    if isinstance(s, torch.Tensor):
        s = s[..., None]
    return gl.mul(a, s)


def inv(a):
    """Inverse by the adjugate/norm formula (fields/f3g.py inv)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    aa = gl.mul(a0, a0)
    ac = gl.mul(a0, a2)
    ba = gl.mul(a1, a0)
    bb = gl.mul(a1, a1)
    bc = gl.mul(a1, a2)
    cc = gl.mul(a2, a2)
    aaa = gl.mul(aa, a0)
    aac = gl.mul(aa, a2)
    abc = gl.mul(ba, a2)
    abb = gl.mul(ba, a1)
    acc = gl.mul(ac, a2)
    bbb = gl.mul(bb, a1)
    bcc = gl.mul(bc, a2)
    ccc = gl.mul(cc, a2)
    t = gl.neg(aaa)
    t = gl.sub(t, aac)
    t = gl.sub(t, aac)
    t = gl.add(t, abc)
    t = gl.add(t, abc)
    t = gl.add(t, abc)
    t = gl.add(t, abb)
    t = gl.sub(t, acc)
    t = gl.sub(t, bbb)
    t = gl.add(t, bcc)
    t = gl.sub(t, ccc)
    tinv = gl.inv(t)
    i1 = gl.neg(aa)
    i1 = gl.sub(i1, ac)
    i1 = gl.sub(i1, ac)
    i1 = gl.add(i1, bc)
    i1 = gl.add(i1, bb)
    i1 = gl.sub(i1, cc)
    i1 = gl.mul(i1, tinv)
    i2 = gl.mul(gl.sub(ba, cc), tinv)
    i3 = gl.mul(gl.add(gl.sub(ac, bb), cc), tinv)
    return torch.stack([i1, i2, i3], dim=-1)


def prefix_product(a):
    """Inclusive prefix product along axis 0 (log-depth doubling)."""
    out = a.clone()
    shift = 1
    while shift < out.shape[0]:
        out[shift:] = mul(out[shift:], out[:-shift])
        shift <<= 1
    return out


def prefix_product_sharded(a, mesh):
    """prefix_product of a row-sharded column (a: this rank's block, [R,
    3]): (this block of the whole column's inclusive product, the
    exclusive product of the earlier blocks, the whole column's product).
    Each rank scans its block, one all_gather brings every block's total,
    and the block is multiplied by the product of the earlier totals."""
    acc = prefix_product(a)
    totals = mesh.all_gather(acc[-1])          # [model, 3]
    before = from_ints(ONE_INT, a.device)
    for j in range(mesh.coords[1]):
        before = mul(before, totals[j])
    total = before
    for j in range(mesh.coords[1], mesh.model):
        total = mul(total, totals[j])
    return mul(acc, before[None, :]), before, total


def from_ints(v, device=None) -> torch.Tensor:
    """A 3-sequence of u64 values as an int64 [3] tensor on `device`, made
    by fills (no host-to-device copy)."""
    return torch.stack([gl.full((), x, device) for x in v])


# ---- the same field on 3-tuples of Python ints (u64 values)

ONE_INT = (1, 0, 0)
ZERO_INT = (0, 0, 0)
_P = gl.P_INT


def add_int(a, b):
    return tuple((int(x) + int(y)) % _P for x, y in zip(a, b))


def sub_int(a, b):
    return tuple((int(x) - int(y)) % _P for x, y in zip(a, b))


def mul_int(a, b):
    a0, a1, a2 = (int(x) for x in a)
    b0, b1, b2 = (int(x) for x in b)
    hi = a1 * b2 + a2 * b1            # x^3 = x + 1
    return ((a0 * b0 + hi) % _P,
            (a0 * b1 + a1 * b0 + hi + a2 * b2) % _P,
            (a0 * b2 + a1 * b1 + a2 * b0 + a2 * b2) % _P)


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
    """a^(p^3 - 2): the inverse of a nonzero element."""
    return exp_int(a, _P ** 3 - 2)
