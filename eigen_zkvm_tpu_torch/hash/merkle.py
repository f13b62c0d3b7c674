"""Host side of the GL Merkle tree: the width-0 tree and proof checks.

Port of eigen_zkvm_tpu/hash/merkle_gl.py (`ZeroMerkleTreeGL`,
`calculate_root_from_proof`, `verify_group_proof`) and of the leaf hash of
hash/linearhash_gl.py, one row at a time on the scalar Poseidon
(hash/poseidon.py).  The trees the prover builds are ops/commit.py's device
trees; this module serves the verifier and the zero-width stage trees.

Layout (starky merklehash.rs): a leaf is the linear hash of one row, a node
is Poseidon(left || right) with zero capacity, an odd level is padded with a
zero digest, and a proof lists the sibling digests from leaf to root.
"""
from __future__ import annotations

import numpy as np

from . import poseidon


def _hash_rows(vals: list) -> list:
    """Sponge-fold one row of w elements into a digest (linearhash `_hash`)."""
    w = len(vals)
    if w <= 4:
        return vals + [0] * (4 - w)
    st = [0, 0, 0, 0]
    for i in range(0, w, 8):
        block = vals[i : i + 8]
        st = poseidon.hash_n(block + [0] * (8 - len(block)), st)
    return st


def hash_leaf(row) -> list:
    """Leaf digest of one row (linearhash.rs: chunks of max(8, ceil(w/4))
    folded independently, then their digests folded)."""
    vals = [int(x) for x in np.asarray(row, dtype=np.uint64).reshape(-1)]
    w = len(vals)
    if w <= 4:
        return vals + [0] * (4 - w)
    bs = max(8, -(-w // 4))
    digs = [_hash_rows(vals[c : c + bs]) for c in range(0, w, bs)]
    if len(digs) == 1:
        return digs[0]
    return _hash_rows([x for d in digs for x in d])


def hash_pair(left, right) -> list:
    return poseidon.hash_n([int(x) for x in left] + [int(x) for x in right])


def calculate_root_from_proof(mp, idx: int, digest) -> list:
    value = [int(x) for x in digest]
    for sib in mp:
        value = hash_pair(sib, value) if idx & 1 else hash_pair(value, sib)
        idx >>= 1
    return value


def verify_group_proof(root, mp, idx: int, group_elements) -> bool:
    """Whether the row `group_elements` sits at leaf `idx` under `root`."""
    c_root = calculate_root_from_proof(mp, idx, hash_leaf(group_elements))
    return c_root == [int(x) for x in root]


class ZeroMerkleTreeGL:
    """The tree over a width-0 [height, 0] matrix (a stage a trace does not
    use): every leaf digest is zero, so every node of a level is one digest,
    one scalar Poseidon per level.  Power-of-two heights only."""

    _cache: dict = {}

    @classmethod
    def build(cls, height: int) -> "ZeroMerkleTreeGL":
        tree = cls._cache.get(height)
        if tree is None:
            tree = cls._cache[height] = cls(height)
        return tree

    def __init__(self, height: int):
        if height & (height - 1):
            raise ValueError("a zero-width tree needs a power-of-two height")
        self.width = 0
        self.height = height
        d = [0, 0, 0, 0]
        self._lvl = [d]
        n = height
        while n > 1:
            d = hash_pair(d, d)
            self._lvl.append(d)
            n //= 2

    def root(self) -> np.ndarray:
        return np.array(self._lvl[-1], dtype=np.uint64)

    def get_group_proof(self, idx: int):
        if not 0 <= idx < self.height:
            raise IndexError(f"leaf {idx} of a tree of height {self.height}")
        return (np.zeros(0, dtype=np.uint64),
                [np.array(d, dtype=np.uint64) for d in self._lvl[:-1]])
