"""Poseidon over a big (snark-curve scalar) field, circomlib "opt" schedule.

Port of eigen_zkvm_tpu/hash/poseidon_big.py: state width t = len(inp) + 1
(2..17), x^5 S-box, 8 full rounds and a per-t count of partial rounds.  The
tables are the port's copies, data/poseidon_{bn128,bls12381}_opt.npz
(C, M, P, S for each t, value form, [.., 4] u64 limbs).

Two forms: `hash_ex` / `hash_fr` on Python ints, one state at a time (the
transcript and the verifier's Merkle paths), and `device_tables`, the
tables in Montgomery form as [.., 4] int64 word tensors for the batched
permutation of ops/poseidon_fr.py (the prover's trees).  Instantiated by
hash/poseidon_bn128.py and hash/poseidon_bls12381.py.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..ops import bigint

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
N_ROUNDS_F = 8


def _limbs_to_ints(arr: np.ndarray) -> list[int]:
    """[..., 4] u64 little-endian limbs -> flat list of ints."""
    flat = arr.reshape(-1, 4)
    return [int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128
            | int(r[3]) << 192 for r in flat]


class PoseidonBig:
    def __init__(self, field: bigint.Field, npz_name: str,
                 n_rounds_p: list[int], hash_index: int):
        self.field = field
        self.P = field.modulus
        self.N_ROUNDS_P = n_rounds_p
        self.hash_index = hash_index   # which output is the hash
        self._npz = os.path.join(_DATA, npz_name)
        self._tables = None

    def tables(self) -> dict:
        """{t: (C, M, P, S)} as Python ints: C and S flat lists, M and P
        [t][t] lists."""
        if self._tables is None:
            tabs = {}
            with np.load(self._npz) as data:
                for t in range(2, 18):
                    C, S = (_limbs_to_ints(data[f"{k}_{t}"]) for k in "CS")
                    M, Pm = ([v[i * t : (i + 1) * t] for i in range(t)]
                             for v in (_limbs_to_ints(data[f"{k}_{t}"])
                                       for k in "MP"))
                    tabs[t] = (C, M, Pm, S)
            self._tables = tabs
        return self._tables

    def n_rounds_p(self, t: int) -> int:
        return self.N_ROUNDS_P[t - 2]

    @functools.lru_cache(maxsize=64)
    def device_tables(self, t: int, device: torch.device) -> dict:
        """The tables of width t in Montgomery form, [n, 4] int64 words on
        `device`: {"C", "M" ([t * t] row-major, M[j][i] at j * t + i),
        "P", "S"}."""
        C, M, Pm, S = self.tables()[t]
        f = self.field
        return {"C": bigint.mont_ints(f, C, device),
                "M": bigint.mont_ints(f, [x for row in M for x in row],
                                      device),
                "P": bigint.mont_ints(f, [x for row in Pm for x in row],
                                      device),
                "S": bigint.mont_ints(f, S, device)}

    def _pow5(self, x: int) -> int:
        P = self.P
        x2 = x * x % P
        return x2 * x2 % P * x % P

    def hash_ex(self, inp: list[int], init_state: int, out: int) -> list[int]:
        """Poseidon sponge call: 1..16 inputs + capacity init -> the first
        `out` lanes of the permuted state."""
        if not 1 <= len(inp) <= 16:
            raise ValueError(f"Wrong inputs length {len(inp)}")
        P = self.P
        _pow5 = self._pow5
        t = len(inp) + 1
        C, M, Pm, S = self.tables()[t]
        n_p = self.n_rounds_p(t)
        half = N_ROUNDS_F // 2

        state = [(init_state + C[0]) % P] + [(x + C[i + 1]) % P
                                             for i, x in enumerate(inp)]
        for r in range(half - 1):
            state = [(_pow5(x) + C[(r + 1) * t + i]) % P
                     for i, x in enumerate(state)]
            state = [sum(M[j][i] * state[j] for j in range(t)) % P
                     for i in range(t)]

        state = [(_pow5(x) + C[half * t + i]) % P for i, x in enumerate(state)]
        state = [sum(Pm[j][i] * state[j] for j in range(t)) % P
                 for i in range(t)]

        for r in range(n_p):
            s0 = (_pow5(state[0]) + C[(half + 1) * t + r]) % P
            state[0] = s0
            base = (2 * t - 1) * r
            new0 = sum(S[base + j] * state[j] for j in range(t)) % P
            for k in range(1, t):
                state[k] = (state[k] + S[base + t + k - 1] * s0) % P
            state[0] = new0

        cbase = (half + 1) * t + n_p
        for r in range(half - 1):
            state = [(_pow5(x) + C[cbase + r * t + i]) % P
                     for i, x in enumerate(state)]
            state = [sum(M[j][i] * state[j] for j in range(t)) % P
                     for i in range(t)]

        state = [_pow5(x) for x in state]
        state = [sum(M[j][i] * state[j] for j in range(t)) % P
                 for i in range(t)]
        return state[:out]

    def hash_fr(self, inp: list[int], init_state: int = 0) -> int:
        """The hash of 1..16 inputs: output `hash_index` of the permutation
        (BN254: the first; BLS12-381: the second, the Neptune convention of
        the reference's poseidon_bls12381_opt.rs)."""
        return self.hash_ex(inp, init_state, self.hash_index + 1)[
            self.hash_index]
