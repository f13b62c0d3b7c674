"""Carry state between eigen_zkvm_tpu (JAX) and the port.

Nothing here imports the JAX package: its objects are read by duck typing,
its limb pairs as numpy (or JAX) arrays, its curve points as affine ints,
its PILs through the PIL JSON (bench_chain.pil_to_json).

The JAX package keeps a field element as a u32 (lo, hi) limb pair; the port
keeps its u64 bit pattern in one int64 tensor (ops/gl.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .bench_chain import pil_to_json
from .groth16 import groth16 as g16
from .hash.merkle import ZeroMerkleTreeGL
from .ops import bigint, commit, commit_big, ec, gl
from .recursion.plonk_setup import PlonkSetup
from .recursion.r1cs2plonk import PlonkAdd
from .stark.polsarray import PolsArray
from .stark.stark_setup import StarkSetup
from .stark.types import PIL, StarkStruct


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


def _big_tree(tree, device: torch.device):
    """A JAX-package MerkleTreeBig (BN128 or BLS12381: `levels` as padded
    int lists, the field's modulus at `tree.PBN.P`) as the port's device
    tree, its nodes copied."""
    if tree.PBN.P not in (bigint.FR.modulus, bigint.FR_BLS.modulus):
        raise ValueError(f"no big-field tree over {tree.PBN.P}")
    elements = np.asarray(tree.elements, dtype=np.uint64).reshape(
        tree.height, tree.width)
    _, offsets = commit_big.level_layout(tree.height)
    if [len(lvl) for lvl in tree.levels] != [
            b - a for a, b in zip(offsets, offsets[1:])]:
        raise ValueError("const tree levels do not match a 16-ary tree")
    nodes = bigint.to_tensor([v for lvl in tree.levels for v in lvl], device)
    return commit_big.DeviceMerkleTreeBig(
        nodes, tree.height, tree.width, gl.from_u64(elements, device))


def setup_from_jax(setup, device: torch.device | str) -> StarkSetup:
    """A JAX-package StarkSetup (GL, BN128 or BLS12381) as the port's, its
    const tree on `device`.  The tree's nodes are copied, not rehashed."""
    device = torch.device(device)
    tree = setup.const_tree
    out = StarkSetup.__new__(StarkSetup)
    out.const_root = setup.const_root
    out.starkinfo = setup.starkinfo
    out.program = setup.program
    if getattr(tree, "PBN", None) is not None:
        out.const_tree = _big_tree(tree, device)
        return out
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


def pil_from_jax(pil) -> PIL:
    """A JAX-package PIL as the port's, through its JSON form."""
    return PIL.from_json(pil_to_json(pil))


def struct_from_jax(ss) -> StarkStruct:
    return StarkStruct.from_json(
        {"nBits": ss.nBits, "nBitsExt": ss.nBitsExt, "nQueries": ss.nQueries,
         "verificationHashType": ss.verificationHashType,
         "steps": [{"nBits": s.nBits} for s in ss.steps]})


def pols_from_jax(pols, pil: PIL) -> PolsArray:
    """A JAX-package PolsArray (a [n, nPols] u64 buffer) on the port's PIL."""
    out = PolsArray(pil, pols.kind)
    out.buffer = np.array(pols.buffer, dtype=np.uint64)
    return out


def plonk_setup_from_jax(psetup) -> PlonkSetup:
    """A JAX-package recursion PlonkSetup as the port's: PIL, constants,
    s_map and plonk additions copied, field for field."""
    out = PlonkSetup.__new__(PlonkSetup)
    out.pil = pil_from_jax(psetup.pil)
    out.const_pols = pols_from_jax(psetup.const_pols, out.pil)
    out.s_map = np.array(psetup.s_map, dtype=np.uint64)
    out.plonk_additions = [PlonkAdd(a.s1, a.s2, a.c1, a.c2)
                           for a in psetup.plonk_additions]
    out.n_used, out.n_bits = psetup.n_used, psetup.n_bits
    out.n_publics = psetup.n_publics
    return out


def groth16_keys_from_jax(pk, vk, device: torch.device | str):
    """A JAX-package Groth16 key pair (BN254 or BLS12-381, its
    `curve_name`) as the port's, the proving key's queries on `device`.
    The points are read as affine ints, by element access (lists, or
    `native.RawAffine`, whose elements decode to affine tuples), never in
    the native kernels' limb layout."""
    device = torch.device(device)
    G1, G2 = ec.GROUPS[pk.curve_name]

    def g1(points):
        return ec.affine_tensor(G1, [points[i] for i in range(len(points))],
                                device)

    out_pk = g16.ProvingKey(
        curve_name=pk.curve_name, n_public=pk.n_public, n_vars=pk.n_vars,
        domain_size=pk.domain_size, alpha1=pk.alpha1, beta1=pk.beta1,
        beta2=pk.beta2, delta1=pk.delta1, delta2=pk.delta2,
        a_query=g1(pk.a_query), b1_query=g1(pk.b1_query),
        b2_query=ec.affine_tensor(
            G2, [pk.b2_query[i] for i in range(len(pk.b2_query))], device),
        l_query=g1(pk.l_query), h_query=g1(pk.h_query))
    out_vk = g16.VerifyingKey(
        curve_name=vk.curve_name, alpha1=vk.alpha1, beta2=vk.beta2,
        gamma2=vk.gamma2, delta2=vk.delta2,
        ic=[vk.ic[i] for i in range(len(vk.ic))])
    return out_pk, out_vk
