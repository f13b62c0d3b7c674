"""The device field primitives of csrc/gl.cuh held against Python integers.

`run` applies one primitive on the card through the library's test entry
(csrc/gl_check.cu), `expected` computes the same with Python integers, and
`operands` makes the edge pairs (every ordered pair of the values where the
reduction's carries and borrows flip) followed by random pairs.  `failures`
runs every primitive and returns the mismatches; chip_smoke.py and the CUDA
tests call it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import check, library
from ..ops import gl

P = gl.P_INT
OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "mul_pow2": 4, "dot": 5,
       "add_nc": 6, "pow7_add": 7}
DOT_WIDTH = 12
CANONICAL_EDGES = [0, 1, 2, 2**32 - 1, 2**32, 2**32 + 1, 2**63, P - 2**32,
                   P - 2, P - 1]
ANY_EDGES = CANONICAL_EDGES + [P, 2**64 - 1]
# which operands a primitive takes below p only
CANONICAL_A = {"add"}
CANONICAL_B = {"add", "sub", "add_nc"}


def operands(op: str, n_random: int, seed: int = 0):
    """(a, b) uint64 arrays: every ordered pair of the edge values the
    primitive admits, then n_random random pairs."""
    rng = np.random.default_rng(seed)
    ea = CANONICAL_EDGES if op in CANONICAL_A else ANY_EDGES
    eb = CANONICAL_EDGES if op in CANONICAL_B else ANY_EDGES
    a = np.concatenate([np.repeat(np.array(ea, dtype=np.uint64), len(eb)),
                        rng.integers(0, 2**64, size=n_random,
                                     dtype=np.uint64)])
    b = np.concatenate([np.tile(np.array(eb, dtype=np.uint64), len(ea)),
                        rng.integers(0, 2**64, size=n_random,
                                     dtype=np.uint64)])
    if op in CANONICAL_A:
        a %= np.uint64(P)
    if op in CANONICAL_B:
        b %= np.uint64(P)
    if op == "dot":  # rows of DOT_WIDTH: pad with the first values
        pad = -a.size % DOT_WIDTH
        a = np.concatenate([a, a[:pad]])
        b = np.concatenate([b, b[:pad]])
    return a, b


def expected(op: str, a: np.ndarray, b: np.ndarray, k: int = 0) -> np.ndarray:
    """The primitive on Python integers, canonical."""
    ai, bi = [int(x) for x in a], [int(x) for x in b]
    if op == "dot":
        rows = len(ai) // DOT_WIDTH
        out = [sum(x * y for x, y in zip(
            ai[r * DOT_WIDTH:(r + 1) * DOT_WIDTH],
            bi[r * DOT_WIDTH:(r + 1) * DOT_WIDTH])) % P for r in range(rows)]
    else:
        fn = {"mul": lambda x, y: x * y, "sqr": lambda x, y: x * x,
              "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
              "mul_pow2": lambda x, y: x << k, "add_nc": lambda x, y: x + y,
              "pow7_add": lambda x, y: pow(x, 7, P) + y}[op]
        out = [fn(x, y) % P for x, y in zip(ai, bi)]
    return np.array(out, dtype=np.uint64)


def run(op: str, a: np.ndarray, b: np.ndarray, device: torch.device,
        k: int = 0) -> np.ndarray:
    """The primitive on the card (CUDA devices only)."""
    if device.type != "cuda":
        raise ValueError("gl_check runs the device primitives: CUDA only")
    ta, tb = gl.from_u64(a, device), gl.from_u64(b, device)
    n = a.size // DOT_WIDTH if op == "dot" else a.size
    out = torch.empty(n, dtype=torch.int64, device=device)
    check("gl_check", library().gl_check(
        device.index, OPS[op], ta.data_ptr(), tb.data_ptr(), out.data_ptr(),
        n, k, torch.cuda.current_stream(device).cuda_stream))
    return gl.to_u64(out)


def failures(device: torch.device, n_random: int = 1 << 20) -> list[str]:
    """Every primitive on its edge pairs and n_random random pairs (mul_pow2
    for every k < 192, on fewer random values a k); the mismatches as
    strings, empty when the device arithmetic is right."""
    bad = []
    for op in OPS:
        ks = range(192) if op == "mul_pow2" else (0,)
        a, b = operands(op, n_random // len(ks), seed=OPS[op])
        for k in ks:
            got, want = run(op, a, b, device, k), expected(op, a, b, k)
            wrong = np.nonzero(got != want)[0]
            if wrong.size:
                i = int(wrong[0])
                bad.append(f"{op} k={k}: {wrong.size} wrong, first at {i}: "
                           f"a={int(a[i]) if op != 'dot' else 'row'} "
                           f"b={int(b[i]) if op != 'dot' else 'row'} "
                           f"got {int(got[i])} want {int(want[i])}")
    return bad
