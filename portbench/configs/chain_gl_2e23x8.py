"""Configuration chain_gl_2e23x8: the repo's chain AIR at 2^23 rows x 8
columns, blowup 2, GL hash, 8 queries.

The AIR is eigen_zkvm_tpu_torch/bench_chain.py::build_chain_air (itself
scripts/bench_big.py's), copied here on the reference's PilBuilder: W
committed columns with c_j' = k_j * c_j off the last row (k_j = j + 2),
each pinned at the last row by a public input.  The first row is not
pinned, so a trace may start each column anywhere: a fresh trace scales
column j of the powers k_j^i by a seeded nonzero GL element s_j, and
stays valid.
"""
from __future__ import annotations

import numpy as np
import torch

from ..inputs import Circuit, chain_struct_json
from ..reference import tensor_gl as tg
from ..reference.stark.pil_builder import PilBuilder, pil_to_json
from ..reference.stark.polsarray import PolsArray

SOURCE = ("https://github.com/0xEigenLabs/eigen-zkvm/blob/main/starky/data/"
          "starkStruct.json.gl for blowup 2, GL hash, 8 queries; the chain "
          "AIR, its 2^23 rows and FRI steps are this repo's own")
NBITS = 23
WIDTH = 8
QUERIES = 8
ASSUMED = {
    "air": "bench_chain.build_chain_air, 8 multiplicative chains (not an "
           "upstream AIR)",
    "nBits": "23, the north star's trace length (SURVEY.md section 6)",
    "steps": "bench_chain.chain_struct_json: nBits + 1 down by 5 above 4",
}
REDUCED: list = []


def circuit(nbits: int = NBITS, width: int = WIDTH,
            queries: int = QUERIES) -> Circuit:
    p = PilBuilder(nbits)
    islast = p.const_pol("Chain.ISLAST")
    cols = [p.cm_pol(f"Chain.c{j}") for j in range(width)]
    N = 1 << nbits
    one_m = p.sub(p.num(1), p.const(islast))
    for j, c in enumerate(cols):
        end = p.public_input(f"end{j}", p.cm(c), N - 1)
        p.identity(p.sub(p.mul(one_m,
                               p.sub(p.cm(c, True),
                                     p.mul(p.num(j + 2), p.cm(c)))),
                         p.num(0)), "chain.pil", j)
        p.identity(p.sub(p.mul(p.const(islast), p.sub(p.cm(c), end)),
                         p.num(0)), "chain.pil", width + j)
    pil = p.build()
    const = PolsArray(pil, PolsArray.CONSTANT).buffer
    const[N - 1, islast] = 1
    return Circuit(pil_to_json(pil), chain_struct_json(nbits, queries),
                   const)


def traces(c: Circuit, seed: int, count: int,
           device: torch.device) -> list[np.ndarray]:
    """`count` host traces [2^nBits, W] (uint64) from `seed`: column j of
    trace r is s_rj * k_j^i, the powers made once on `device`, the
    scales drawn there by a torch.Generator."""
    n = c.struct_json["nBits"]
    width = c.pil_json["nCommitments"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    base = torch.stack([tg.powers(j + 2, 1 << n, device)
                        for j in range(width)], dim=1)
    out = []
    for _ in range(count):
        s = torch.randint(1, 1 << 62, (width,), generator=gen, device=device)
        out.append(tg.mul(base, s[None, :]).cpu().numpy().view(np.uint64)
                   .copy())
    return out
