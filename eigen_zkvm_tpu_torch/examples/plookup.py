"""Plookup example — mirror of starkjs/plookup/plookup.js:

  {sel: a, b', a*b'} in {SEL: A, B, cc}

committed columns sel/a/b/cc, constant table SEL/A/B.

Copy of eigen_zkvm_tpu/examples/plookup.py on the port's PilBuilder and
PolsArray; field products on Python ints.
"""
from __future__ import annotations

import numpy as np

from ..ops import gl
from ..stark.pil_builder import PilBuilder
from ..stark.polsarray import PolsArray


def build(n_bits: int = 10):
    p = PilBuilder(n_bits)
    l1 = p.const_pol("Global.L1")
    sel = p.cm_pol("Plookup.sel")
    a = p.cm_pol("Plookup.a")
    b = p.cm_pol("Plookup.b")
    SEL = p.const_pol("Plookup.SEL")
    A = p.const_pol("Plookup.A")
    B = p.const_pol("Plookup.B")
    cc = p.cm_pol("Plookup.cc")
    N = 1 << n_bits

    p.plookup(
        f=[p.cm(a), p.cm(b, True), p.mul(p.cm(a), p.cm(b, True))],
        t=[p.const(A), p.const(B), p.cm(cc)],
        sel_f=p.cm(sel), sel_t=p.const(SEL),
        file_name="plookup.pil", line=14)
    pil = p.build()

    const_pols = PolsArray(pil, PolsArray.CONSTANT)
    cbuf = const_pols.buffer
    cbuf[0, l1] = 1
    n_table = N // 2
    for j in range(n_table):
        cbuf[j, SEL] = 1
        cbuf[j, A] = j + 1
        cbuf[j, B] = 2 * (j + 1)

    def make_trace(seed: int = 0):
        rng = np.random.default_rng(seed)
        cm = PolsArray(pil, PolsArray.COMMIT)
        buf = cm.buffer
        for j in range(n_table):
            buf[j, cc] = gl.mul_int(j + 1, 2 * (j + 1))
        picks = rng.integers(1, n_table + 1, size=N)
        for i in range(N):
            buf[i, sel] = 1 if i < N - 1 and i % 3 != 2 else 0
            j = int(picks[i])
            buf[i, a] = j
            if i > 0:
                jp = int(picks[i - 1])
                buf[i, b] = 2 * jp  # b' seen from row i-1
        # row0 b is unconstrained (only b' appears); leave 0
        return cm

    return pil, const_pols, make_trace
