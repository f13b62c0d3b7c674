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

Under a mesh (parallel/meshctx.py) `ShardedCommit` builds the same trees
over row blocks (`ShardedMerkleTreeGL`: a subtree a rank and a replicated
top), with the pol-sharded LDE of `lde_rows` and the replicated Q split of
commit_tpu.py's mesh layout.
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
    return build_levels(poseidon.hash_leaves(elements, width))


def build_levels(digests: torch.Tensor) -> torch.Tensor:
    """The node store of the tree whose leaf digests are `digests`
    [height, 4]."""
    height = digests.shape[0]
    sizes, offsets = level_layout(height)
    nodes = torch.empty((offsets[-1] + 1, 4), dtype=torch.int64,
                        device=digests.device)
    nodes[:height] = digests
    for lvl in range(len(sizes) - 1):
        n, off = sizes[lvl], offsets[lvl]
        if n & 1:
            nodes[off + n].zero_()
        nxt = offsets[lvl + 1]
        poseidon.hash_n(nodes[off : off + n + (n & 1)].view(-1, 8),
                        out=nodes[nxt : nxt + sizes[lvl + 1]])
    return nodes


class DeviceTree:
    """What the device trees share: `device_elements`, the committed
    [height, width] tensor, and `_nodes`, the node store, both on a torch
    device; `elements`, the host copy, fetched when a host consumer reads
    it; pickling (StarkSetup.save), where the tensors travel as numpy and
    return to the device they came from."""

    @property
    def elements(self) -> np.ndarray:
        if self._elements is None:
            self._elements = gl.to_u64(self.device_elements)
        return self._elements

    def to_extend(self) -> np.ndarray:
        """The committed values on the host, [height, width]."""
        return self.elements

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


def _siblings(nodes: torch.Tensor, offsets: list, idx: np.ndarray):
    """[q, depth, 4]: the sibling digests of leaves `idx` from the leaf
    level up to the root's children, out of a node store laid out by
    `offsets` (level_layout)."""
    depth = len(offsets) - 1
    lvls = np.arange(depth)
    path = (np.asarray(offsets[:depth], dtype=np.int64)[None, :]
            + ((idx[:, None] >> lvls[None, :]) ^ 1))          # [q, depth]
    return nodes.index_select(0, torch.from_numpy(path.reshape(-1)).to(
        nodes.device)).reshape(len(idx), depth, 4)


class DeviceMerkleTreeGL(DeviceTree):
    """A GL Merkle tree whose nodes and leaf elements live on a torch
    device (DeviceTree)."""

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
        sib = gl.to_u64(_siblings(self._nodes, self._offsets, idx))
        rows = gl.to_u64(self.device_elements.index_select(
            0, torch.from_numpy(idx).to(self._nodes.device)))
        for k, i in enumerate(todo):
            self._pref[i] = (rows[k], [sib[k, lvl] for lvl in range(depth)])

    def get_group_proof(self, idx: int):
        if not 0 <= idx < self.height:
            raise IndexError(f"leaf {idx} of a tree of height {self.height}")
        if idx not in self._pref:
            self.prefetch([idx])
        v, mp = self._pref[idx]
        return v.copy(), [d.copy() for d in mp]


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


# ---- the sharded twins (parallel/): row blocks of a model axis

class ShardedMerkleTreeGL(DeviceMerkleTreeGL):
    """The GL tree over a row-sharded [height, width] matrix (height /
    model a power of two).  This rank keeps its row block
    (`device_elements`, [height / model, width]) and the node store of the
    block's subtree (`_nodes`); every rank keeps the replicated top
    (`_top`), the tree over the model axis' sub-roots, gathered once.
    Root, rows and sibling paths equal the single-device tree's:
    `prefetch` fills each query's row and subtree siblings on the rank
    that owns its leaf and gathers them, one collective a call, and adds
    the top's siblings on every rank."""

    def __init__(self, mesh, block: torch.Tensor, height: int, width: int):
        super().__init__(build_nodes(block, width), block.shape[0], width,
                         block)
        self.mesh = mesh
        self.height = height
        self._top = build_levels(mesh.all_gather(
            self._nodes[self._offsets[-1]]))
        self._top_offsets = level_layout(mesh.model)[1]

    def root(self) -> np.ndarray:
        if self._root is None:
            self._root = gl.to_u64(self._top[self._top_offsets[-1]]).copy()
        return self._root

    def prefetch(self, indices):
        todo = [i for i in dict.fromkeys(int(i) for i in indices)
                if i not in self._pref]
        if not todo:
            return
        rows = self.device_elements.shape[0]
        idx = np.asarray(todo, dtype=np.int64)
        owner, local = idx // rows, idx % rows
        dev = self._nodes.device
        depth = len(self._sizes) - 1
        k = self.width + 4 * depth
        buf = torch.zeros((len(todo), k), dtype=torch.int64, device=dev)
        mine = np.nonzero(owner == self.mesh.coords[1])[0]
        if len(mine):
            mine_rows = self.device_elements.index_select(
                0, torch.from_numpy(local[mine]).to(dev))
            sib = _siblings(self._nodes, self._offsets, local[mine])
            buf[torch.from_numpy(mine).to(dev)] = torch.cat(
                [mine_rows, sib.reshape(len(mine), -1)], dim=1)
        got = gl.to_u64(self.mesh.all_gather(buf)[
            torch.from_numpy(owner).to(dev), torch.arange(len(todo),
                                                         device=dev)])
        top = gl.to_u64(_siblings(self._top, self._top_offsets, owner))
        for q, i in enumerate(todo):
            sibs = got[q, self.width :].reshape(depth, 4)
            self._pref[i] = (got[q, : self.width],
                             [sibs[lvl] for lvl in range(depth)]
                             + [top[q, lvl] for lvl in range(top.shape[1])])


def lde_rows(block: torch.Tensor, nbits: int, nbits_ext: int, mesh):
    """The coset LDE of a row-sharded [2^nbits / model, w] section, handed
    back as row blocks [2^nbits_ext / model, w]: pol-sharded between two
    all_to_alls, so the transform's butterflies stay on the rank; a width
    the axis does not divide is replicated (all_gather), transformed whole
    and sliced."""
    if block.shape[1] % mesh.model:
        return mesh.rows(ntt.interpolate(mesh.replicated(block), nbits,
                                         nbits_ext))
    return mesh.cols_to_rows(ntt.interpolate(mesh.rows_to_cols(block),
                                             nbits, nbits_ext))


class ShardedCommit:
    """The commits of a sharded prove: extend_and_merkelize, merkelize
    and q_split over the row blocks of `mesh`'s model axis."""

    def __init__(self, mesh):
        self.mesh = mesh

    def extend_and_merkelize(self, block: torch.Tensor, nbits: int,
                             nbits_ext: int):
        """The tree over the LDE of a row-sharded section; the LDE's row
        block is `tree.device_elements`."""
        if block.shape[1] == 0:
            return ZeroMerkleTreeGL.build(1 << nbits_ext)
        return ShardedMerkleTreeGL(self.mesh, lde_rows(block, nbits,
                                                       nbits_ext, self.mesh),
                                   1 << nbits_ext, block.shape[1])

    def merkelize(self, block: torch.Tensor):
        """The tree over an extended section given as its row blocks."""
        height = block.shape[0] * self.mesh.model
        if block.shape[1] == 0:
            return ZeroMerkleTreeGL.build(height)
        return ShardedMerkleTreeGL(self.mesh, block, height, block.shape[1])

    def q_split(self, q: torch.Tensor, q_dim: int, q_deg: int, nbits: int,
                nbits_ext: int) -> torch.Tensor:
        """q_split of a row-sharded quotient (commit_tpu._q_split under a
        mesh): the quotient is too narrow to split by columns, so it is
        gathered, transformed whole on every rank, and handed back as this
        rank's row block."""
        return self.mesh.rows(q_split(self.mesh.replicated(q), q_dim, q_deg,
                                      nbits, nbits_ext))
