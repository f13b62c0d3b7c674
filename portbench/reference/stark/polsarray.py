"""Named polynomial storage: .const / .cm binary column files.

Copy of eigen_zkvm_tpu/stark/polsarray.py, imports pointed at the port.

File format (reference: starky/src/polsarray.rs): row-major u64 little-endian,
row i holds [pol_0[i], ..., pol_{nPols-1}[i]].  In memory we keep the natural
TPU layout: a single [n, nPols] uint64 matrix.
"""
from __future__ import annotations

import numpy as np

from .types import PIL


class PolsArray:
    COMMIT = "cmP"
    CONSTANT = "constP"

    def __init__(self, pil: PIL, kind: str):
        self.kind = kind
        n_pols = pil.nCommitments if kind == self.COMMIT else pil.nConstants
        self.nPols = n_pols
        self.names = [None] * n_pols
        deg = None
        for ref_name, ref in pil.references.items():
            if ref.type_ != kind:
                continue
            deg = ref.polDeg
            if ref.isArray:
                for i in range(ref.len):
                    self.names[ref.id + i] = (ref_name, i)
            else:
                self.names[ref.id] = (ref_name, None)
        assert all(nm is not None for nm in self.names), "Invalid pils sequence"
        self.n = deg
        self.buffer = np.zeros((self.n, n_pols), dtype=np.uint64)

    def load(self, path: str) -> "PolsArray":
        data = np.fromfile(path, dtype="<u8")
        assert data.size == self.n * self.nPols, (data.size, self.n, self.nPols)
        self.buffer = data.reshape(self.n, self.nPols).astype(np.uint64)
        return self

    def save(self, path: str):
        self.buffer.astype("<u8").tofile(path)

    def write_buff(self) -> np.ndarray:
        """Row-major [n, nPols] buffer (already our native layout)."""
        return self.buffer
