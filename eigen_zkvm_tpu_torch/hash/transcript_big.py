"""Fiat-Shamir transcript over a big-field Poseidon.

Port of eigen_zkvm_tpu/hash/transcript_big.py (reference
transcript_bn128.rs / transcript_bls12381.rs).  The state is one Fr;
pending inputs absorb in groups of 16 through hash_ex(.., 17); GL
challenges come from splitting a squeezed Fr into three 64-bit chunks,
each reduced into the Goldilocks field; query indices from 253-bit chunks
of raw squeezed Frs.  Host code on Python ints.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..ops.gl import P_INT as GL_P
from . import poseidon_bls12381, poseidon_bn128


class TranscriptBig:
    PBN = None  # the curve's PoseidonBig; set by subclasses

    def __init__(self):
        self.state = 0
        self.pending: list[int] = []
        self.out: deque[int] = deque()
        self.out3: deque[int] = deque()

    def _update_state(self):
        pending = self.pending + [0] * (16 - len(self.pending))
        self.out = deque(self.PBN.hash_ex(pending, self.state, 17))
        self.out3 = deque()
        self.pending = []
        self.state = self.out[0]

    def _add_1(self, e: int):
        self.out = deque()
        self.pending.append(e % self.PBN.P)
        if len(self.pending) == 16:
            self._update_state()

    def put_elements(self, values):
        """Absorb GL values (or already-packed Fr ints), one Fr each."""
        for v in values:
            self._add_1(int(v))

    def put_root(self, root):
        """Absorb a Merkle root digest (a single Fr value)."""
        self._add_1(int(root))

    def _get_fields253(self) -> int:
        if not self.out:
            self._update_state()
        return self.out.popleft()

    def get_fields1(self) -> int:
        if not self.out3:
            if not self.out:
                self._update_state()
            v = self.out.popleft()
            mask = (1 << 64) - 1
            self.out3.extend(((v >> s) & mask) % GL_P for s in (0, 64, 128))
        return self.out3.popleft()

    def get_field(self) -> np.ndarray:
        """Draw one GF(p^3) challenge as a u64 [3] array."""
        return np.array([self.get_fields1() for _ in range(3)],
                        dtype=np.uint64)

    def get_permutations(self, n: int, nbits: int) -> list[int]:
        n_fields = (n * nbits - 1) // 253 + 1
        fields = [self._get_fields253() for _ in range(n_fields)]
        res = []
        cur_field = cur_bit = 0
        for _ in range(n):
            a = 0
            for j in range(nbits):
                if (fields[cur_field] >> cur_bit) & 1:
                    a += 1 << j
                cur_bit += 1
                if cur_bit == 253:
                    cur_bit = 0
                    cur_field += 1
            res.append(a)
        return res


class TranscriptBN128(TranscriptBig):
    PBN = poseidon_bn128.POSEIDON


class TranscriptBLS12381(TranscriptBig):
    PBN = poseidon_bls12381.POSEIDON
