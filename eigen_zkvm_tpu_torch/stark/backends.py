"""Hash-backend registry: verificationHashType -> the tree builder, the
verifier's Merkle checks and the transcript class.

Port of eigen_zkvm_tpu/stark/backends.py (reference dispatch:
starky/src/prove.rs:52-90).  GL is the recursion layers' backend; BN128 and
BLS12381 give big-field Merkle roots and transcripts for the top layer
that a SNARK wraps.  The trees are built on the engine's device
(ops/commit.py, ops/commit_big.py); the checks and the transcripts are
host code.
"""
from __future__ import annotations

from typing import NamedTuple


class Backend(NamedTuple):
    tree: object        # merkelize(buf), extend_and_merkelize(buf, nb, nbe)
    merkle: object      # verify_group_proof(root, mp, idx, row)
    transcript: type    # the Fiat-Shamir transcript class


def get_backend(hash_type: str) -> Backend:
    if hash_type == "GL":
        from ..hash import merkle
        from ..hash.transcript import TranscriptGL
        from ..ops import commit

        return Backend(commit, merkle, TranscriptGL)
    if hash_type == "BN128":
        from ..hash.merkle_big import MerkleBN128
        from ..hash.transcript_big import TranscriptBN128
        from ..ops import commit_big

        return Backend(commit_big.BN128, MerkleBN128, TranscriptBN128)
    if hash_type == "BLS12381":
        from ..hash.merkle_big import MerkleBLS12381
        from ..hash.transcript_big import TranscriptBLS12381
        from ..ops import commit_big

        return Backend(commit_big.BLS12381, MerkleBLS12381,
                       TranscriptBLS12381)
    raise NotImplementedError(f"verificationHashType {hash_type}")
