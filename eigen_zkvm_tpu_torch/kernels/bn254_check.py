"""The device field primitives of csrc/bn254.cuh held against Python ints.

`run` applies one primitive on the card through the library's test entry
(csrc/bn254_check.cu), `expected` computes the same with Python ints, and
`operands` makes the edge pairs (every ordered pair of 0, 1, q - 1, q - 2
and R mod q) followed by random pairs.  Operands are canonical words;
mul, sqr and inv work in Montgomery form (mul(a, b) = a * b / R, inv(x) =
R^2 / x, R = 2^256 or 2^384), so the expected values are taken on the raw
words.  `failures` runs every primitive of the fields named (BN254's Fq
and Fr by default; BLS12-381's Fq381 and Fr381) and of the Fq2 over each
base field among them, and returns the mismatches; chip_smoke.py and the
CUDA tests call it.
"""
from __future__ import annotations

import random

import torch

from . import check, library
from ..curves import bn254
from ..ops import bigint as bi

OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "inv": 4, "neg": 5,
       "f2_mul": 6, "f2_sqr": 7, "f2_inv": 8}
FIELDS = {"Fq": bi.FQ, "Fr": bi.FR, "Fr381": bi.FR_BLS, "Fq381": bi.FQ381}
CODES = {"Fq": 0, "Fr": 1, "Fr381": 2, "Fq381": 3}   # bn254.cuh's rows
BASE_FIELDS = ("Fq", "Fq381")                         # those with an Fq2


def operands(op: str, field: bi.Field, n_random: int, seed: int = 0):
    """(a, b): lists of ints, or of (c0, c1) pairs for the Fq2 ops."""
    m = field.modulus
    rng = random.Random(seed)
    edges = [0, 1, m - 1, m - 2, field.one]
    if op.startswith("f2_"):
        pairs = [(x, y) for x in edges for y in edges]
        a = [p for p in pairs for _ in pairs] + \
            [(rng.randrange(m), rng.randrange(m)) for _ in range(n_random)]
        b = [p for _ in pairs for p in pairs] + \
            [(rng.randrange(m), rng.randrange(m)) for _ in range(n_random)]
        return a, b
    a = [x for x in edges for _ in edges] + \
        [rng.randrange(m) for _ in range(n_random)]
    b = [y for _ in edges for y in edges] + \
        [rng.randrange(m) for _ in range(n_random)]
    return a, b


def expected(op: str, field: bi.Field, a: list, b: list) -> list:
    m = field.modulus
    rinv = pow(1 << field.rbits, -1, m)
    r2 = field.r2
    if op == "mul":
        return [x * y * rinv % m for x, y in zip(a, b)]
    if op == "sqr":
        return [x * x * rinv % m for x in a]
    if op == "add":
        return [(x + y) % m for x, y in zip(a, b)]
    if op == "sub":
        return [(x - y) % m for x, y in zip(a, b)]
    if op == "neg":
        return [(-x) % m for x in a]
    if op == "inv":
        return [v * r2 % m for v in bn254.batch_inv(a, m)]
    if op == "f2_inv":
        norms = bn254.batch_inv([(x0 * x0 + x1 * x1) % m for x0, x1 in a], m)
        return [(x0 * t * r2 % m, (-x1) * t * r2 % m)
                for (x0, x1), t in zip(a, norms)]
    if op == "f2_sqr":
        b = a
    return [((x0 * y0 - x1 * y1) * rinv % m, (x0 * y1 + x1 * y0) * rinv % m)
            for (x0, x1), (y0, y1) in zip(a, b)]


def run(op: str, field: bi.Field, a: list, b: list, device: torch.device
        ) -> list:
    """The primitive on the card (CUDA devices only)."""
    if device.type != "cuda":
        raise ValueError("bn254_check runs the device primitives: CUDA only")
    f2 = op.startswith("f2_")
    flat = (lambda v: [c for p in v for c in p]) if f2 else list
    ta = bi.to_tensor(flat(a), device, field.words)
    tb = bi.to_tensor(flat(b), device, field.words)
    out = torch.empty_like(ta)
    code = next(CODES[k] for k, f in FIELDS.items() if f is field)
    check("bn254_check", library().bn254_check(
        device.index, OPS[op], code, ta.data_ptr(), tb.data_ptr(),
        out.data_ptr(), len(a), torch.cuda.current_stream(device).cuda_stream))
    got = bi.to_ints(out)
    return list(zip(got[::2], got[1::2])) if f2 else got


def failures(device: torch.device, n_random: int = 1 << 20,
             fields=("Fq", "Fr")) -> list[str]:
    """Every primitive of the `fields` named (keys of FIELDS) and the Fq2
    ones over each base field among them, on their edge pairs and n_random
    random pairs (a sixteenth of that for the Fq2 ones); the mismatches as
    strings, empty when the device arithmetic is right."""
    bad = []
    for fname in fields:
        field = FIELDS[fname]
        for op, code in OPS.items():
            if op.startswith("f2_") and fname not in BASE_FIELDS:
                continue
            a, b = operands(op, field, n_random >> 4 if op.startswith("f2_")
                            else n_random, seed=code)
            got, want = run(op, field, a, b, device), expected(op, field, a, b)
            wrong = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            if wrong:
                i = wrong[0]
                bad.append(f"{fname} {op}: {len(wrong)} wrong, first at {i}: "
                           f"a={a[i]} b={b[i]} got {got[i]} want {want[i]}")
    return bad
