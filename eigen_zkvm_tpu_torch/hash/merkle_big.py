"""Host side of the 16-ary big-field Merkle tree: the proof checks.

Port of eigen_zkvm_tpu/hash/merkle_big.py (`calculate_root_from_proof`,
`verify_group_proof`; reference starky/src/merklehash_bn128.rs /
merklehash_bls12381.rs) on Python ints.  The trees the prover builds are
ops/commit_big.py's device trees; this module serves the verifier.

Layout: a leaf is the linear hash of one row (hash/linearhash_big.py), a
node is Poseidon(16 children, 0), every level is zero-padded to a multiple
of 16, and a proof lists, level by level, all 16 digests of the leaf's
group (its own slot included).  The check also requires the recomputed leaf
digest in its slot of the first level, as the JAX package does.
"""
from __future__ import annotations

from . import linearhash_big as lh
from . import poseidon_bls12381, poseidon_bn128


class MerkleBig:
    PBN = None  # the curve's PoseidonBig; set by subclasses

    @classmethod
    def calculate_root_from_proof(cls, mp, idx: int, digest: int) -> int:
        value = digest
        for level in mp:
            value = lh.hash_node(cls.PBN, level)
        return value

    @classmethod
    def verify_group_proof(cls, root, mp, idx: int, group_elements) -> bool:
        """Whether the row `group_elements` sits at leaf `idx` under
        `root` (an Fr int)."""
        digest = lh.hash_element_matrix(cls.PBN,
                                        [[int(x) for x in group_elements]])
        mp = [[int(x) for x in lvl] for lvl in mp]
        if mp and mp[0][idx & 0xF] != digest:
            return False  # the leaf slot must carry the recomputed digest
        c_root = cls.calculate_root_from_proof(mp, idx, digest) if mp \
            else digest
        return c_root == int(root)


class MerkleBN128(MerkleBig):
    PBN = poseidon_bn128.POSEIDON


class MerkleBLS12381(MerkleBig):
    PBN = poseidon_bls12381.POSEIDON
