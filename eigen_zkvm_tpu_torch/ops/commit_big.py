"""Big-field commit backend: coset LDE + 16-ary Poseidon-Fr Merkle tree on a
torch device (BN128 / BLS12381 verificationHashType).

Port of eigen_zkvm_tpu/hash/merkle_big.py's tree (`merkelize`, `root`,
`get_group_proof`; merkle_big.py:17-58), which the JAX package builds on
the host (native/poseidon_fr.cpp); here every leaf and node hashes on the
big-field Poseidon kernel (ops/poseidon_fr.py) and stays on the device.
Only the root comes back for the transcript; query rows and their sibling
groups come back through one batched gather (`prefetch`).  Roots and proofs
equal the JAX package's MerkleTreeBN128 / MerkleTreeBLS12381;
hash/merkle_big.py verifies them.

Node store: one [total, 4] tensor of value-form words, level after level
from the leaf digests to the root.  Every level, the root's included, is
zero-padded to a multiple of 16 (merkle_big.py:40-48), so a level hashes
as its rows viewed as [n / 16, 16, 4] and a proof's level is 16
consecutive rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..hash import linearhash_big as lh
from . import bigint as bi
from . import gl, ntt, poseidon_fr
from .commit import DeviceTree


def level_layout(height: int):
    """(counts, offsets): the digests of each level before padding, leaf
    digests first, and each level's first row in the store; a level takes
    16 * ceil(count / 16) rows, and the last level's first row is the
    root."""
    counts = [height]
    while counts[-1] > 1:
        counts.append((counts[-1] - 1) // 16 + 1)
    offsets = [0]
    for n in counts:
        offsets.append(offsets[-1] + 16 * ((n - 1) // 16 + 1))
    return counts, offsets


def build_nodes(field: bi.Field, elements: torch.Tensor,
                on_call=None) -> torch.Tensor:
    """The node store of the tree over `elements` [height, width].

    Rows of width <= 4 pack with no permutation (a width-0 section: all
    zero), so their leaf digests are compared, and where every one is the
    same each level is one value repeated and, after a zero-padded group,
    one other: all its groups but the last are equal.  Such a level hashes
    its first and its last group only, and the first's digest fills the
    rest: the same nodes for at most two permutations a level.  Wider rows
    always pass through a permutation and are not compared.  `on_call()`,
    where given, runs after the leaves' hash and after each level's (a
    benchmark's CUDA events)."""
    height, width = elements.shape
    counts, offsets = level_layout(height)
    nodes = torch.zeros((offsets[-1], 4), dtype=torch.int64,
                        device=elements.device)
    leaves = lh.hash_leaves(field, elements)
    nodes[:height] = leaves
    if on_call:
        on_call()
    equal = (width <= 4 and height > 16
             and bool((leaves == leaves[:1]).all()))
    for lvl in range(len(counts) - 1):
        off, nxt = offsets[lvl], offsets[lvl + 1]
        groups = nodes[off : nxt].view(-1, 16, 4)
        n = groups.shape[0]
        if equal and n > 2:
            ends = poseidon_fr.hash_fr(field, groups[:: n - 1])
            nodes[nxt : nxt + n - 1] = ends[0]
            nodes[nxt + n - 1] = ends[1]
        else:
            nodes[nxt : nxt + n] = poseidon_fr.hash_fr(field, groups)
        if on_call:
            on_call()
    return nodes


class DeviceMerkleTreeBig(DeviceTree):
    """A big-field Merkle tree whose nodes and leaf elements live on a torch
    device (ops/commit.py::DeviceTree)."""

    def __init__(self, nodes: torch.Tensor, height: int, width: int,
                 device_elements: torch.Tensor):
        self._nodes = nodes
        self._counts, self._offsets = level_layout(height)
        self.device_elements = device_elements
        self._elements = None
        self._root = None
        self._pref: dict[int, tuple] = {}  # idx -> (row, [[16 ints]...])
        self.height = height
        self.width = width

    def root(self) -> int:
        if self._root is None:
            self._root = bi.to_ints(self._nodes[self._offsets[-2]])[0]
        return self._root

    def levels(self) -> list[list[int]]:
        """The padded levels as int lists (merkle_big.py's `levels`)."""
        flat = bi.to_ints(self._nodes)
        return [flat[a:b] for a, b in zip(self._offsets, self._offsets[1:])]

    def prefetch(self, indices):
        """One batched gather for the rows and the 16-digest groups of every
        level below the root of all `indices` not fetched yet."""
        todo = [i for i in dict.fromkeys(int(i) for i in indices)
                if i not in self._pref]
        if not todo:
            return
        depth = len(self._counts) - 1
        idx = np.asarray(todo, dtype=np.int64)
        lvls = np.arange(depth)
        first = (np.asarray(self._offsets[:depth], dtype=np.int64)[None, :]
                 + (((idx[:, None] >> (4 * lvls[None, :])) >> 4) << 4))
        rows_at = first[:, :, None] + np.arange(16)[None, None, :]
        dev = self._nodes.device
        sib = bi.to_ints(self._nodes.index_select(
            0, torch.from_numpy(rows_at.reshape(-1)).to(dev)))
        rows = gl.to_u64(self.device_elements.index_select(
            0, torch.from_numpy(idx).to(dev)))
        per = depth * 16
        for k, i in enumerate(todo):
            s = sib[k * per : (k + 1) * per]
            self._pref[i] = (rows[k], [s[l * 16 : (l + 1) * 16]
                                       for l in range(depth)])

    def get_group_proof(self, idx: int):
        """(row values [width], [[16 Fr ints] a level below the root])."""
        if not 0 <= idx < self.height:
            raise IndexError(f"leaf {idx} of a tree of height {self.height}")
        if idx not in self._pref:
            self.prefetch([idx])
        v, mp = self._pref[idx]
        return v.copy(), [list(lvl) for lvl in mp]


class CommitBig:
    """The tree builders of one field, with ops/commit.py's interface."""

    def __init__(self, field: bi.Field):
        self.field = field

    def merkelize(self, buf: torch.Tensor) -> DeviceMerkleTreeBig:
        """The tree over an already-extended [height, width] section; a
        width-0 section is the full tree over zero digests
        (merkle_big.merkelize of a [height, 0] matrix)."""
        height, width = buf.shape
        return DeviceMerkleTreeBig(build_nodes(self.field, buf), height,
                                   width, buf)

    def extend_and_merkelize(self, buf: torch.Tensor, nbits: int,
                             nbits_ext: int) -> DeviceMerkleTreeBig:
        """buf: [2^nbits, n_pols] section -> the tree over its coset LDE; the
        LDE stays on buf's device as `tree.device_elements`."""
        if buf.shape[1] == 0:
            return self.merkelize(torch.zeros(
                (1 << nbits_ext, 0), dtype=torch.int64, device=buf.device))
        return self.merkelize(ntt.interpolate(buf, nbits, nbits_ext))


BN128 = CommitBig(bi.FR)
BLS12381 = CommitBig(bi.FR_BLS)
