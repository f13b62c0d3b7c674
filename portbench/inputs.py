"""What the benchmark hands the prover and its reference alike: a circuit
(its PIL as JSON, its constant columns, its starkStruct as JSON) and host
trace buffers.  A configuration file under configs/ makes them."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Circuit:
    pil_json: dict
    struct_json: dict
    const: np.ndarray  # uint64 [2^nBits, nConstants]


def chain_struct_json(nbits: int, queries: int) -> dict:
    """A GL starkStruct of blowup 2 whose FRI steps run from nbits + 1 down
    by 5 while above 4 (eigen_zkvm_tpu_torch/bench_chain.py's
    chain_struct_json with its "chain" rule, as scripts/bench_big.py set
    it)."""
    steps, cur = [], nbits + 1
    while cur > 4:
        steps.append(cur)
        cur -= 5
    steps.append(cur)
    return {"nBits": nbits, "nBitsExt": nbits + 1, "nQueries": queries,
            "verificationHashType": "GL",
            "steps": [{"nBits": s} for s in steps]}
