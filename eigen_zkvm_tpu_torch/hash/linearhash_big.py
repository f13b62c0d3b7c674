"""Big-field linear (leaf) hash over Goldilocks rows (BN254 / BLS12-381).

Port of eigen_zkvm_tpu/hash/linearhash_big.py (reference
starky/src/linearhash_bn128.rs / linearhash_bls12381.rs, digest.rs:162).
Packing and sponge grouping: 3 GL values pack into one Fr as
e0 + e1 * 2^64 + e2 * 2^128; the Fr values hash in groups of 16 with the
state carried (the last group's width is its own size + 1).  Rows of width
<= 4 are NOT hashed: their 4 GL values pack straight into the digest
(mod r).

Two forms: the host functions on Python ints, which take the curve's
PoseidonBig (hash/poseidon_bn128.py::POSEIDON, ...) first (the verifier),
and `hash_leaves` on tensors, which takes the field (ops/bigint.py FR or
FR_BLS) and hashes on ops/poseidon_fr.py (the prover's trees).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import bigint as bi
from ..ops import poseidon_fr


def pack_gl4(pos, e) -> int:
    """4 GL u64s -> an Fr value: little-endian u64 limbs reduced mod r."""
    return (int(e[0]) | int(e[1]) << 64 | int(e[2]) << 128
            | int(e[3]) << 192) % pos.P


def pack_gl3(pos, e0: int, e1: int, e2: int) -> int:
    return (e0 | e1 << 64 | e2 << 128) % pos.P


def hash_element_array(pos, vals) -> int:
    """One leaf row [w] of GL values -> its Fr digest (the prover's leaf,
    linearhash_bn128.rs hash_element_array)."""
    vals = [int(v) for v in np.asarray(vals, dtype=np.uint64).reshape(-1)]
    w = len(vals)
    if w <= 4:
        return pack_gl4(pos, vals + [0] * (4 - w))
    fr_vals = [pack_gl3(pos, *(vals[i : i + 3] + [0] * (i + 3 - w)))
               for i in range(0, w, 3)]
    digest = 0
    for i in range(0, len(fr_vals), 16):
        digest = pos.hash_fr(fr_vals[i : i + 16], digest)
    return digest


def hash_element_matrix(pos, columns) -> int:
    """Flattened column values packed 3 to an Fr, then sponge-folded in
    16s (hash_element_matrix: the verifier's leaf hash).  A single packed
    value is its own digest, so a row of width 4 (two packed values) hashes
    here and packs in hash_element_array: the JAX package's prover and
    verifier disagree at that width, and the port keeps both."""
    vals3 = []
    acc = acc_n = 0
    for col in columns:
        for elem in col:
            acc = (acc + (int(elem) << (64 * acc_n))) % pos.P
            acc_n += 1
            if acc_n == 3:
                vals3.append(acc)
                acc = acc_n = 0
    if acc_n > 0:
        vals3.append(acc)
    if not vals3:
        return 0
    if len(vals3) == 1:
        return vals3[0]
    st = 0
    for i in range(0, len(vals3), 16):
        st = pos.hash_fr(vals3[i : i + 16], st)
    return st


def hash_node(pos, children) -> int:
    """Internal 16-ary node: Poseidon(children, 0)."""
    if len(children) != 16:
        raise ValueError(f"a node has 16 children, not {len(children)}")
    return pos.hash_fr([int(c) for c in children], 0)


def _reduce_words(field: bi.Field, w: torch.Tensor) -> torch.Tensor:
    """[..., 4] words of values below 2^256 -> the values mod the field,
    by as many conditional subtractions as 2^256 / r needs."""
    x = bi.limbs(w)
    for _ in range(((1 << 256) - 1) // field.modulus):
        x = bi._cond_sub(field, x)
    return bi.words(x)


def hash_leaves(field: bi.Field, elements: torch.Tensor) -> torch.Tensor:
    """All leaf rows at once: [H, w] GL values (int64 bit patterns) -> [H, 4]
    Fr digests (value-form words), equal to hash_element_array row by row.
    Width <= 4 packs the four words mod r, with no permutation; a wider row
    packs 3 GL values an Fr (below 2^192: no reduction) and sponges them
    in groups of 16 on the Poseidon kernel."""
    return _leaves(poseidon_fr.hash_fr, field, elements)


def hash_leaves_plain(field: bi.Field, elements: torch.Tensor
                      ) -> torch.Tensor:
    """hash_leaves with every sponge call on the plain permutation, on any
    device."""
    return _leaves(poseidon_fr.hash_fr_plain, field, elements)


def _leaves(hash_fr, field: bi.Field, elements: torch.Tensor):
    H, w = elements.shape
    dev = elements.device
    if w <= 4:
        words = torch.zeros((H, 4), dtype=torch.int64, device=dev)
        words[:, :w] = elements
        return _reduce_words(field, words)
    n3 = -(-w // 3)
    packed = torch.zeros((H, n3, 4), dtype=torch.int64, device=dev)
    flat = torch.zeros((H, 3 * n3), dtype=torch.int64, device=dev)
    flat[:, :w] = elements
    packed[:, :, :3] = flat.view(H, n3, 3)
    digest = torch.zeros((H, 4), dtype=torch.int64, device=dev)
    for i in range(0, n3, 16):
        digest = hash_fr(field, packed[:, i : i + 16], digest)
    return digest
