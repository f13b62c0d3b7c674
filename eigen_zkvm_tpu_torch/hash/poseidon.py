"""Poseidon-GL constants and the scalar permutation on Python ints.

Port of the constant tables and the scalar fast path of
eigen_zkvm_tpu/hash/poseidon_gl.py: t = 12 (rate 8, capacity 4), x^7 sbox,
the "opt" schedule (8 full rounds, 22 partial rounds with sparse matrices S
and a pre-round constant fold).  The tables are the port's copy,
data/poseidon_gl_opt.npz.  The batched permutation on tensors is
ops/poseidon.py; this one serves the transcript and the verifier's Merkle
paths, one state at a time.
"""
from __future__ import annotations

import os

import numpy as np

from ..ops.gl import P_INT

T = 12
N_ROUNDS_F = 8
N_ROUNDS_P = 22

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "poseidon_gl_opt.npz")
with np.load(_DATA) as _consts:
    C = _consts["C"].astype(np.uint64)
    M = _consts["M"].astype(np.uint64)      # [12][12]
    PMAT = _consts["P"].astype(np.uint64)
    S = _consts["S"].astype(np.uint64)

_P = P_INT
_C_I = [int(x) for x in C]
_M_I = [[int(x) for x in row] for row in M]
_P_I = [[int(x) for x in row] for row in PMAT]
_S_I = [int(x) for x in S]


def _pow7i(x: int) -> int:
    x2 = x * x % _P
    x3 = x2 * x % _P
    return x3 * x3 % _P * x % _P


def permute(state: list) -> list:
    """One permutation of 12 field elements (Python ints)."""
    t, half_f = T, N_ROUNDS_F // 2
    state = [(state[i] + _C_I[i]) % _P for i in range(t)]
    for r in range(half_f - 1):
        state = [_pow7i(x) for x in state]
        state = [(state[i] + _C_I[(r + 1) * t + i]) % _P for i in range(t)]
        state = [sum(_M_I[j][i] * state[j] for j in range(t)) % _P
                 for i in range(t)]
    state = [_pow7i(x) for x in state]
    state = [(state[i] + _C_I[half_f * t + i]) % _P for i in range(t)]
    state = [sum(_P_I[j][i] * state[j] for j in range(t)) % _P
             for i in range(t)]
    for r in range(N_ROUNDS_P):
        s0 = (_pow7i(state[0]) + _C_I[(half_f + 1) * t + r]) % _P
        state[0] = s0
        base = (2 * t - 1) * r
        new0 = sum(_S_I[base + j] * state[j] for j in range(t)) % _P
        for k in range(1, t):
            state[k] = (state[k] + _S_I[base + t + k - 1] * s0) % _P
        state[0] = new0
    base = (half_f + 1) * t + N_ROUNDS_P
    for r in range(half_f - 1):
        state = [_pow7i(x) for x in state]
        state = [(state[i] + _C_I[base + r * t + i]) % _P for i in range(t)]
        state = [sum(_M_I[j][i] * state[j] for j in range(t)) % _P
                 for i in range(t)]
    state = [_pow7i(x) for x in state]
    return [sum(_M_I[j][i] * state[j] for j in range(t)) % _P
            for i in range(t)]


def hash_n(inp8, cap4=(0, 0, 0, 0), out: int = 4) -> list:
    """Sponge call: 8 inputs and a 4-element capacity -> `out` elements."""
    return permute([int(x) for x in inp8] + [int(x) for x in cap4])[:out]
