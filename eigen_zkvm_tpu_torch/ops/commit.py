"""Commit backend: coset LDE + Poseidon-GL Merkle tree on a torch device,
and the quotient split.

Port of eigen_zkvm_tpu/ops/commit_tpu.py (`tpu_extend_and_merkelize`,
`tpu_merkelize`, `DeviceMerkleTreeGL`, `_q_split`).  The LDE and every tree
node stay on the device; only the root (32 bytes) comes back for the
transcript, and query rows and sibling paths come back through one batched
gather (`prefetch`).  Roots and proofs are identical to the JAX package's
host hash/merkle_gl.py::MerkleTreeGL; hash/merkle.py verifies them.

Node store: one [total, 4] tensor, level after level from the leaf digests
to the root.  A level of odd size n > 1 reserves n + 1 rows and its last row
holds the zero digest, so a level is hashed as `hash_n` over its rows viewed
as [ceil(n/2), 8] and every sibling of a path is one row of the store.
"""
from __future__ import annotations

import numpy as np
import torch

from ..hash.merkle import ZeroMerkleTreeGL
from . import gl, ntt, poseidon


def level_layout(height: int):
    """(sizes, offsets): nodes per level, leaf digests first, and each
    level's first row in the store; the last offset is the root's row."""
    sizes = [height]
    while sizes[-1] > 1:
        sizes.append((sizes[-1] - 1) // 2 + 1)
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s + (s & 1))
    return sizes, offsets


def build_nodes(elements: torch.Tensor, width: int) -> torch.Tensor:
    """The node store of the tree over `elements` [height, width]."""
    height = elements.shape[0]
    sizes, offsets = level_layout(height)
    nodes = torch.empty((offsets[-1] + 1, 4), dtype=torch.int64,
                        device=elements.device)
    nodes[:height] = poseidon.hash_leaves(elements, width)
    for lvl in range(len(sizes) - 1):
        n, off = sizes[lvl], offsets[lvl]
        if n & 1:
            nodes[off + n].zero_()
        nxt = offsets[lvl + 1]
        poseidon.hash_n(nodes[off : off + n + (n & 1)].view(-1, 8),
                        out=nodes[nxt : nxt + sizes[lvl + 1]])
    return nodes


class DeviceMerkleTreeGL:
    """A GL Merkle tree whose nodes and leaf elements live on a torch device.

    `device_elements` is the committed [height, width] tensor; `elements`
    is its host copy, fetched lazily when a host consumer reads it."""

    def __init__(self, nodes: torch.Tensor, height: int, width: int,
                 device_elements: torch.Tensor):
        self._nodes = nodes
        self._sizes, self._offsets = level_layout(height)
        self.device_elements = device_elements
        self._elements = None
        self._root = None
        self._pref: dict[int, tuple] = {}  # idx -> (row, [sibling digests])
        self.height = height
        self.width = width

    @property
    def elements(self) -> np.ndarray:
        if self._elements is None:
            self._elements = gl.to_u64(self.device_elements)
        return self._elements

    def to_extend(self) -> np.ndarray:
        """The committed values on the host, [height, width]."""
        return self.elements

    def root(self) -> np.ndarray:
        if self._root is None:
            self._root = gl.to_u64(self._nodes[self._offsets[-1]]).copy()
        return self._root

    def prefetch(self, indices):
        """One batched gather for the rows and sibling paths of all
        `indices` not fetched yet."""
        todo = [i for i in dict.fromkeys(int(i) for i in indices)
                if i not in self._pref]
        if not todo:
            return
        depth = len(self._sizes) - 1
        idx = np.asarray(todo, dtype=np.int64)
        lvls = np.arange(depth)
        path = (np.asarray(self._offsets[:depth], dtype=np.int64)[None, :]
                + ((idx[:, None] >> lvls[None, :]) ^ 1))     # [q, depth]
        dev = self._nodes.device
        sib = gl.to_u64(self._nodes.index_select(
            0, torch.from_numpy(path.reshape(-1)).to(dev))).reshape(
                len(todo), depth, 4)
        rows = gl.to_u64(self.device_elements.index_select(
            0, torch.from_numpy(idx).to(dev)))
        for k, i in enumerate(todo):
            self._pref[i] = (rows[k], [sib[k, lvl] for lvl in range(depth)])

    def get_group_proof(self, idx: int):
        if not 0 <= idx < self.height:
            raise IndexError(f"leaf {idx} of a tree of height {self.height}")
        if idx not in self._pref:
            self.prefetch([idx])
        v, mp = self._pref[idx]
        return v.copy(), [d.copy() for d in mp]

    # pickling (StarkSetup.save): tensors travel as numpy and return to the
    # device they came from
    def __getstate__(self):
        d = self.__dict__.copy()
        d["_device"] = str(self._nodes.device)
        d["_nodes"] = gl.to_u64(self._nodes).copy()
        d["device_elements"] = gl.to_u64(self.device_elements).copy()
        d["_elements"] = None
        return d

    def __setstate__(self, d):
        device = torch.device(d.pop("_device"))
        d["_nodes"] = gl.from_u64(d["_nodes"], device)
        d["device_elements"] = gl.from_u64(d["device_elements"], device)
        self.__dict__.update(d)


def extend_and_merkelize(buf: torch.Tensor, nbits: int, nbits_ext: int):
    """buf: [2^nbits, n_pols] section -> the tree over its coset LDE; the
    LDE stays on buf's device as `tree.device_elements`."""
    n_pols = buf.shape[1]
    if n_pols == 0:
        return ZeroMerkleTreeGL.build(1 << nbits_ext)
    lde = ntt.interpolate(buf, nbits, nbits_ext)
    return DeviceMerkleTreeGL(build_nodes(lde, n_pols), 1 << nbits_ext,
                              n_pols, lde)


def merkelize(buf: torch.Tensor):
    """The tree over an already-extended [height, width] section."""
    height, width = buf.shape
    if width == 0:
        return ZeroMerkleTreeGL.build(height)
    return DeviceMerkleTreeGL(build_nodes(buf, width), height, width, buf)


def q_split(q: torch.Tensor, q_dim: int, q_deg: int, nbits: int,
            nbits_ext: int) -> torch.Tensor:
    """The quotient [Next, q_dim] -> cm4_2ns [Next, q_dim * q_deg]
    (commit_tpu._q_split): iNTT over the extended domain, each degree-N
    monomial block unscaled off the coset by SHIFT^(-N*p) and zero-padded,
    the blocks side by side, NTT back to evaluations."""
    N, Next = 1 << nbits, 1 << nbits_ext
    qq1 = ntt.intt(q, nbits_ext)
    qq2 = torch.zeros((Next, q_dim * q_deg), dtype=torch.int64,
                      device=q.device)
    shift_inv_n = gl.exp_int(gl.inv_int(gl.SHIFT), N)
    cur_s = 1
    for p in range(q_deg):
        qq2[:N, q_dim * p : q_dim * (p + 1)] = gl.mul(
            qq1[p * N : (p + 1) * N], gl.as_i64(cur_s))
        cur_s = gl.mul_int(cur_s, shift_inv_n)
    del qq1
    return ntt.ntt(qq2, nbits_ext)
