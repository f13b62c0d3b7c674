"""Configuration plookup_gl_2e22: upstream's starkjs/plookup/plookup.pil at
2^22 rows, blowup 2, GL hash, 8 queries.

The AIR is eigen_zkvm_tpu_torch/examples/plookup.py::build (a mirror of
starkjs/plookup/plookup.js), copied here on the reference's PilBuilder:
committed sel, a, b, cc, constant L1, SEL, A, B and one 3-tuple lookup
{sel: a, b', a*b'} in {SEL: A, B, cc} over a table of N/2 rows.  Its trace
maker is rewritten vectorised: rows i < N - 1 with i % 3 != 2 are selected
(2/3 of the rows), each row's key is uniform over the table, a = key,
b' = 2 key, and cc holds the table's products.
"""
from __future__ import annotations

import numpy as np
import torch

from ..inputs import Circuit, chain_struct_json
from ..reference.stark.pil_builder import PilBuilder, pil_to_json
from ..reference.stark.polsarray import PolsArray

SOURCE = ("https://github.com/0xEigenLabs/eigen-zkvm/blob/main/starkjs/"
          "plookup/plookup.pil, starkStruct.json.gl's blowup 2, GL, 8 "
          "queries; 2^22 rows (upstream 2^10) and FRI steps are this repo's")
NBITS = 22
QUERIES = 8
ASSUMED = {
    "nBits": ("22, raised from the example's 10 so that one proof's 4.2 M "
              "lookup rows are of the order of one ecrecover chunk's "
              "(99 plookups x 2^16 = 6.5 M)"),
    "table_rows": "N/2, as the example",
    "selected": "2/3 of the rows, as the example",
    "keys": "uniform over the table, as the example",
    "steps": "bench_chain.chain_struct_json: nBits + 1 down by 5 above 4",
}
REDUCED: list = []


def circuit(nbits: int = NBITS, queries: int = QUERIES) -> Circuit:
    p = PilBuilder(nbits)
    l1 = p.const_pol("Global.L1")
    sel = p.cm_pol("Plookup.sel")
    a = p.cm_pol("Plookup.a")
    b = p.cm_pol("Plookup.b")
    SEL = p.const_pol("Plookup.SEL")
    A = p.const_pol("Plookup.A")
    B = p.const_pol("Plookup.B")
    cc = p.cm_pol("Plookup.cc")
    p.plookup(
        f=[p.cm(a), p.cm(b, True), p.mul(p.cm(a), p.cm(b, True))],
        t=[p.const(A), p.const(B), p.cm(cc)],
        sel_f=p.cm(sel), sel_t=p.const(SEL),
        file_name="plookup.pil", line=14)
    pil = p.build()
    n, n_table = 1 << nbits, 1 << (nbits - 1)
    const = PolsArray(pil, PolsArray.CONSTANT).buffer
    const[0, l1] = 1
    j = np.arange(1, n_table + 1, dtype=np.uint64)
    const[:n_table, SEL] = 1
    const[:n_table, A] = j
    const[:n_table, B] = 2 * j
    return Circuit(pil_to_json(pil), chain_struct_json(nbits, queries),
                   const)


def _column(pil_json: dict, name: str) -> int:
    return pil_json["references"][name]["id"]


def traces(c: Circuit, seed: int, count: int,
           device: torch.device) -> list[np.ndarray]:
    """`count` host traces [2^nBits, 4] (uint64) from `seed`, the keys drawn
    on `device` by a torch.Generator."""
    n = 1 << c.struct_json["nBits"]
    n_table = n // 2
    pj = c.pil_json
    sel, a, b, cc = (_column(pj, f"Plookup.{k}")
                     for k in ("sel", "a", "b", "cc"))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    i = torch.arange(n, device=device)
    j = torch.arange(1, n_table + 1, device=device)
    out = []
    for _ in range(count):
        keys = torch.randint(1, n_table + 1, (n,), generator=gen,
                             device=device)
        t = torch.zeros((n, pj["nCommitments"]), dtype=torch.int64,
                        device=device)
        t[:, sel] = ((i < n - 1) & (i % 3 != 2)).long()
        t[:, a] = keys
        t[1:, b] = 2 * keys[:-1]     # b' seen from row i - 1; row 0's is free
        t[:n_table, cc] = j * 2 * j  # under 2^45: no reduction
        out.append(t.cpu().numpy().view(np.uint64).copy())
    return out
