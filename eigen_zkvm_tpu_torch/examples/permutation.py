"""Permutation-argument example — mirror of starkjs/permutation/permutation.js:

  {selC: a, b} is {selD: c, d}

selected rows of (a, b) are a multiset permutation of selected rows of (c, d).

Copy of eigen_zkvm_tpu/examples/permutation.py on the port's PilBuilder and
PolsArray; field products on Python ints.
"""
from __future__ import annotations

import numpy as np

from ..stark.pil_builder import PilBuilder
from ..stark.polsarray import PolsArray


def build(n_bits: int = 10):
    p = PilBuilder(n_bits)
    l1 = p.const_pol("Global.L1")
    a = p.cm_pol("Permutation.a")
    b = p.cm_pol("Permutation.b")
    c = p.cm_pol("Permutation.c")
    d = p.cm_pol("Permutation.d")
    sel_c = p.cm_pol("Permutation.selC")
    sel_d = p.cm_pol("Permutation.selD")
    N = 1 << n_bits

    p.permutation(
        f=[p.cm(a), p.cm(b)], t=[p.cm(c), p.cm(d)],
        sel_f=p.cm(sel_c), sel_t=p.cm(sel_d),
        file_name="permutation.pil", line=11)
    pil = p.build()

    const_pols = PolsArray(pil, PolsArray.CONSTANT)
    const_pols.buffer[0, l1] = 1

    def make_trace(seed: int = 0):
        rng = np.random.default_rng(seed)
        cm = PolsArray(pil, PolsArray.COMMIT)
        buf = cm.buffer
        n_sel = N // 2
        pairs = [(int(x), int(y)) for x, y in
                 rng.integers(0, 1 << 32, size=(n_sel, 2))]
        perm = rng.permutation(n_sel)
        for i in range(n_sel):
            buf[2 * i, a] = pairs[i][0]
            buf[2 * i, b] = pairs[i][1]
            buf[2 * i, sel_c] = 1
            buf[2 * i + 1, c] = pairs[perm[i]][0]
            buf[2 * i + 1, d] = pairs[perm[i]][1]
            buf[2 * i + 1, sel_d] = 1
        return cm

    return pil, const_pols, make_trace
