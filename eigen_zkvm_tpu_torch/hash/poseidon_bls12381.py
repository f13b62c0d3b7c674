"""Poseidon over the BLS12-381 scalar field: see poseidon_big.py.

Port of eigen_zkvm_tpu/hash/poseidon_bls12381.py (reference:
starky/src/poseidon_bls12381_opt.rs and its generated constants).  The hash
is the SECOND permutation output (the Neptune convention).
"""
from __future__ import annotations

from ..ops import bigint
from .poseidon_big import PoseidonBig

N_ROUNDS_P = [55, 55, 56, 56, 56, 56, 57, 57, 57, 57, 57, 57, 57, 57, 59, 59]
HASH_FR_INDEX = 1  # which permutation output is the hash

POSEIDON = PoseidonBig(bigint.FR_BLS, "poseidon_bls12381_opt.npz",
                       N_ROUNDS_P, HASH_FR_INDEX)
P = POSEIDON.P
hash_ex = POSEIDON.hash_ex
hash_fr = POSEIDON.hash_fr
