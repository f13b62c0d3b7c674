"""The Fiat-Shamir transcript over Goldilocks.

Elements are absorbed 8 at a time into a 4-element state; squeezing pads
the pending inputs with zeros to 8, permutes, keeps the first 4 outputs as
the new state and hands out the 12 outputs one by one.  Absorbing drops
whatever was left to hand out.  Query indices are read 63 bits to a drawn
element, lowest bit first.
"""
from __future__ import annotations

from . import poseidon
from .field import P


class Transcript:
    def __init__(self):
        self.state = [0, 0, 0, 0]
        self.pending: list[int] = []
        self.out: list[int] = []

    def _squeeze(self):
        block = self.pending + [0] * (8 - len(self.pending))
        self.out = poseidon.hash8(block, self.state, out=12)
        self.state = self.out[:4]
        self.pending = []

    def put(self, values):
        for v in values:
            self.out = []
            self.pending.append(int(v) % P)
            if len(self.pending) == 8:
                self._squeeze()

    def draw1(self) -> int:
        if not self.out:
            self._squeeze()
        return self.out.pop(0)

    def draw3(self) -> tuple:
        return (self.draw1(), self.draw1(), self.draw1())

    def indices(self, n: int, nbits: int) -> list:
        words = [self.draw1() for _ in range((n * nbits - 1) // 63 + 1)]
        bits = [(words[k // 63] >> (k % 63)) & 1 for k in range(n * nbits)]
        return [sum(bits[i * nbits + j] << j for j in range(nbits))
                for i in range(n)]
