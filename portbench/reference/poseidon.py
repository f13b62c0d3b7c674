"""Poseidon over Goldilocks, width 12 (rate 8, capacity 4), x^7, 8 full
rounds and 22 partial rounds, in the form with the partial rounds'
matrices made sparse: round constants C (118), the MDS matrix M, the
matrix P applied before the partial rounds and their sparse vectors S.
The tables are data (data/poseidon_gl_opt.npz).

`permute` works on one state of Python ints (the verifier's paths and
transcript); `permute_rows` on a [12, n] int64 tensor, one state a column
(the commitment roots).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import tensor_gl as tg
from .field import P

WIDTH = 12
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 22

with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "poseidon_gl_opt.npz")) as _t:
    C = [int(x) for x in _t["C"]]
    M = [[int(x) for x in row] for row in _t["M"]]
    PRE = [[int(x) for x in row] for row in _t["P"]]
    S = [int(x) for x in _t["S"]]

_HALF = FULL_ROUNDS // 2
# where each round's constants start in C
_C_FIRST = [WIDTH * r for r in range(_HALF + 1)]          # 0 .. 4 * 12
_C_PARTIAL = WIDTH * (_HALF + 1)                          # 60
_C_LAST = [_C_PARTIAL + PARTIAL_ROUNDS + WIDTH * r for r in range(_HALF - 1)]


def _by(mat, st):
    """The row vector st times the matrix mat: out_i = sum_j mat[j][i] st_j."""
    return [sum(mat[j][i] * st[j] for j in range(WIDTH)) % P
            for i in range(WIDTH)]


def _sbox(x: int) -> int:
    return pow(x, 7, P)


def permute(state) -> list:
    st = [(int(state[i]) + C[i]) % P for i in range(WIDTH)]
    for r in range(1, _HALF):
        st = [(_sbox(x) + C[_C_FIRST[r] + i]) % P for i, x in enumerate(st)]
        st = _by(M, st)
    st = [(_sbox(x) + C[_C_FIRST[_HALF] + i]) % P for i, x in enumerate(st)]
    st = _by(PRE, st)
    for r in range(PARTIAL_ROUNDS):
        s0 = (_sbox(st[0]) + C[_C_PARTIAL + r]) % P
        st[0] = s0
        base = (2 * WIDTH - 1) * r
        new0 = sum(S[base + j] * st[j] for j in range(WIDTH)) % P
        for k in range(1, WIDTH):
            st[k] = (st[k] + S[base + WIDTH - 1 + k] * s0) % P
        st[0] = new0
    for r in range(_HALF - 1):
        st = [(_sbox(x) + C[_C_LAST[r] + i]) % P for i, x in enumerate(st)]
        st = _by(M, st)
    return _by(M, [_sbox(x) for x in st])


def hash8(inputs, capacity=(0, 0, 0, 0), out: int = 4) -> list:
    """Poseidon of 8 inputs under a 4-element capacity: the first `out`
    elements of the permuted [inputs, capacity]."""
    return permute(list(inputs) + list(capacity))[:out]


# ---- the same permutation on rows of int64 tensors --------------------------
# The state is one [12, n] tensor.  Products by the constant matrices go
# through float64 matrix products, exact because every partial sum stays
# below 2^53: M's entries are under 2^6, so M times the 32-bit halves of
# the state sums below 2^42; P and S are split into 16-bit limbs, so each
# limb product sums below 2^38.

def _f64(m) -> "torch.Tensor":
    return torch.tensor(m, dtype=torch.float64)


def _limbs16(v: int) -> list:
    return [(v >> (16 * k)) & 0xFFFF for k in range(4)]


class _Tables:
    """The constants on one device, made once."""

    def __init__(self, device):
        t = lambda rows: torch.tensor([[tg.as_i64(v) for v in r]
                                       for r in rows], dtype=torch.int64,
                                      device=device)
        self.c_full = t([C[i : i + WIDTH] for i in _C_FIRST]).unsqueeze(2)
        self.c_last = t([C[i : i + WIDTH] for i in _C_LAST]).unsqueeze(2)
        self.m_t = _f64([[M[j][i] for j in range(WIDTH)]
                         for i in range(WIDTH)]).to(device)
        # row i of each matrix is the coefficients of output i
        pre = [[PRE[j][i] for j in range(WIDTH)] for i in range(WIDTH)]
        self.pre = self._split(pre, device)
        self.s_row = [self._split([S[(2 * WIDTH - 1) * r :
                                     (2 * WIDTH - 1) * r + WIDTH]], device)
                      for r in range(PARTIAL_ROUNDS)]
        self.s_col = t([S[(2 * WIDTH - 1) * r + WIDTH :
                          (2 * WIDTH - 1) * (r + 1)]
                        for r in range(PARTIAL_ROUNDS)]).unsqueeze(2)
        self.pow16 = [tg.as_i64(pow(2, 16 * k, P)) for k in range(7)]

    @staticmethod
    def _split(rows, device):
        """[4, r, 12] float64: limb b of each coefficient."""
        return torch.stack([_f64([[_limbs16(v)[b] for v in r] for r in rows])
                            for b in range(4)]).to(device)


_TABLES: dict = {}


def _tables(device) -> _Tables:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = _Tables(device)
    return _TABLES[key]


def _sbox_t(x):
    x2 = tg.mul(x, x)
    x3 = tg.mul(x2, x)
    return tg.mul(tg.mul(x3, x3), x)


def _by_small(m_t, x):
    """M times the state [12, n], with M's entries small."""
    lo = (m_t @ (x & 0xFFFFFFFF).double()).long()
    hi = (m_t @ ((x >> 32) & 0xFFFFFFFF).double()).long()
    lo2 = lo + ((hi & 0xFFFFFFFF) << 32)
    carry = tg.lt(lo2, lo).long()
    return tg.reduce128(((hi >> 32) & 0xFFFFFFFF) + carry, lo2)


def _by_limbs(split, x, pow16):
    """The constant matrix (split into 16-bit limbs, [4, r, 12]) times the
    state [12, n]: [r, n]."""
    xs = [((x >> (16 * a)) & 0xFFFF).double() for a in range(4)]
    acc = None
    for s in range(7):
        part = None
        for a in range(max(0, s - 3), min(3, s) + 1):
            t = split[s - a] @ xs[a]
            part = t if part is None else part + t
        term = part.long()
        if s:
            term = tg.mul(term, torch.full_like(term, pow16[s]))
        acc = term if acc is None else tg.add(acc, term)
    return acc


def permute_rows(x: "torch.Tensor") -> "torch.Tensor":
    """[12, n] int64 states (a state a column) -> the permuted [12, n]."""
    tb = _tables(x.device)
    x = tg.add(x, tb.c_full[0].expand_as(x))
    for r in range(1, _HALF):
        x = _by_small(tb.m_t, tg.add(_sbox_t(x), tb.c_full[r].expand_as(x)))
    x = tg.add(_sbox_t(x), tb.c_full[_HALF].expand_as(x))
    x = _by_limbs(tb.pre, x, tb.pow16)
    for r in range(PARTIAL_ROUNDS):
        s0 = tg.add(_sbox_t(x[0:1]), tg.const(C[_C_PARTIAL + r], x[0:1]))
        x = torch.cat([s0, x[1:]])
        new0 = _by_limbs(tb.s_row[r], x, tb.pow16)
        rest = tg.add(x[1:], tg.mul(s0.expand_as(x[1:]),
                                    tb.s_col[r].expand_as(x[1:])))
        x = torch.cat([new0, rest])
    for r in range(_HALF - 1):
        x = _by_small(tb.m_t, tg.add(_sbox_t(x), tb.c_last[r].expand_as(x)))
    return _by_small(tb.m_t, _sbox_t(x))


def permute_cols(st: list) -> list:
    """12 int64 tensors of one shape [n] -> the permuted 12."""
    return list(permute_rows(torch.stack(st)).unbind(0))
