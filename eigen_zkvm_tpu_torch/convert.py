"""Carry state between eigen_zkvm_tpu (JAX) and the port.

Nothing here imports the JAX package: its objects are read by duck typing,
its limb pairs as numpy (or JAX) arrays.

The JAX package keeps a field element as a u32 (lo, hi) limb pair; the port
keeps its u64 bit pattern in one int64 tensor (ops/gl.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .hash.merkle import ZeroMerkleTreeGL
from .ops import commit, gl
from .stark.stark_setup import StarkSetup


def _join(lo, hi) -> np.ndarray:
    return (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))


def from_limb_pair(lo, hi, device: torch.device | str | None = None):
    """u32 (lo, hi) arrays (numpy or JAX) -> int64 tensor."""
    return gl.from_u64(_join(lo, hi), device)


def to_limb_pair(t: torch.Tensor):
    """int64 tensor -> (lo, hi) u32 numpy arrays."""
    v = gl.to_u64(t)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def _tree_levels(tree):
    """(elements [h, w] u64, node levels) of a JAX-package GL const tree,
    duck-typed: the host MerkleTreeGL through its `levels`, or
    commit_tpu.DeviceMerkleTreeGL through its pickled state (numpy, no JAX
    call)."""
    if getattr(tree, "levels", None):
        return tree.elements, tree.levels
    d = tree.__getstate__()
    flat = _join(*d["_flat"])
    levels = [flat[o : o + s] for s, o in zip(d["_sizes"], d["_offsets"])]
    elements = d["_elements"] if d.get("_elem_pair") is None \
        else _join(*d["_elem_pair"])
    return elements, levels


def setup_from_jax(setup, device: torch.device | str) -> StarkSetup:
    """A JAX-package StarkSetup (GL) as the port's, its const tree on
    `device`.  The tree's nodes are copied, not rehashed."""
    device = torch.device(device)
    tree = setup.const_tree
    out = StarkSetup.__new__(StarkSetup)
    out.const_root = setup.const_root
    out.starkinfo = setup.starkinfo
    out.program = setup.program
    if tree.width == 0:
        out.const_tree = ZeroMerkleTreeGL.build(tree.height)
        return out
    elements, levels = _tree_levels(tree)
    height, width = elements.shape
    sizes, offsets = commit.level_layout(height)
    if [lvl.shape[0] for lvl in levels] != sizes:
        raise ValueError("const tree levels do not match a GL Merkle tree")
    nodes = np.zeros((offsets[-1] + 1, 4), dtype=np.uint64)
    for lvl, off in zip(levels, offsets):
        nodes[off : off + lvl.shape[0]] = lvl
    out.const_tree = commit.DeviceMerkleTreeGL(
        gl.from_u64(nodes, device), height, width,
        gl.from_u64(elements, device))
    return out
