"""Poseidon over the BN254 (a.k.a. BN128) scalar field: see poseidon_big.py.

Port of eigen_zkvm_tpu/hash/poseidon_bn128.py (reference:
starky/src/poseidon_bn128_opt.rs and its generated constants).
"""
from __future__ import annotations

from ..ops import bigint
from .poseidon_big import PoseidonBig

N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
HASH_FR_INDEX = 0  # which permutation output is the hash

POSEIDON = PoseidonBig(bigint.FR, "poseidon_bn128_opt.npz", N_ROUNDS_P,
                       HASH_FR_INDEX)
P = POSEIDON.P
hash_ex = POSEIDON.hash_ex
hash_fr = POSEIDON.hash_fr
