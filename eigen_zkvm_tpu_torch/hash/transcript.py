"""Fiat-Shamir transcript over Goldilocks: Poseidon sponge, state[4], rate 8.

Port of eigen_zkvm_tpu/hash/transcript_gl.py (starky transcript.rs
semantics) on the scalar Poseidon of hash/poseidon.py: values are absorbed
8 at a time (zero-padded on squeeze), challenges are drained from the
12-element permutation output one field element at a time, and query
indices are taken 63 bits per field element, LSB first.  Host code: a
transcript step is one permutation of Python ints.
"""
from __future__ import annotations

import numpy as np

from ..ops.gl import P_INT
from . import poseidon


class TranscriptGL:
    def __init__(self):
        self.state = [0, 0, 0, 0]
        self.pending: list[int] = []
        self.out: list[int] = []

    def _update_state(self):
        while len(self.pending) < 8:
            self.pending.append(0)
        self.out = poseidon.hash_n(self.pending, self.state, out=12)
        self.pending = []
        self.state = self.out[0:4]

    def put(self, values):
        """Absorb a flat iterable of field elements (ints or np.uint64)."""
        for v in values:
            self.out = []
            self.pending.append(int(v) % P_INT)
            if len(self.pending) == 8:
                self._update_state()

    put_elements = put

    def put_root(self, root):
        """Absorb a Merkle root digest (4 GL elements, one by one)."""
        self.put(root)

    def get_fields1(self) -> int:
        if not self.out:
            self._update_state()
        return self.out.pop(0)

    def get_field(self) -> np.ndarray:
        """Draw one GF(p^3) challenge as a u64 [3] array."""
        return np.array([self.get_fields1() for _ in range(3)],
                        dtype=np.uint64)

    def get_permutations(self, n: int, nbits: int) -> list[int]:
        n_fields = (n * nbits - 1) // 63 + 1
        fields = [self.get_fields1() for _ in range(n_fields)]
        res = []
        cur_field = cur_bit = 0
        for _ in range(n):
            a = 0
            for j in range(nbits):
                if (fields[cur_field] >> cur_bit) & 1:
                    a += 1 << j
                cur_bit += 1
                if cur_bit == 63:
                    cur_bit = 0
                    cur_field += 1
            res.append(a)
        return res
