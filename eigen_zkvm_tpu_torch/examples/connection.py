"""Connection (copy-constraint) example — mirror of
starkjs/connection/connection.js:

  {a, b, c} connect {S1, S2, S3}

S encodes a copy-permutation over the 3N cells: connected cells must carry
equal values.  Here cell (a, i) is connected to (b, i) and (c, i) for even i.

Copy of eigen_zkvm_tpu/examples/connection.py on the port's PilBuilder and
PolsArray; field products on Python ints.
"""
from __future__ import annotations

import numpy as np

from ..ops import gl
from ..stark.pil_builder import PilBuilder
from ..stark.polsarray import PolsArray
from ..stark.starkinfo import get_ks


def build(n_bits: int = 10):
    p = PilBuilder(n_bits)
    l1 = p.const_pol("Global.L1")
    s1 = p.const_pol("Connection.S1")
    s2 = p.const_pol("Connection.S2")
    s3 = p.const_pol("Connection.S3")
    a = p.cm_pol("Connection.a")
    b = p.cm_pol("Connection.b")
    c = p.cm_pol("Connection.c")
    N = 1 << n_bits

    p.connect(pols=[p.cm(a), p.cm(b), p.cm(c)],
              connections=[p.const(s1), p.const(s2), p.const(s3)],
              file_name="connection.pil", line=7)
    pil = p.build()

    const_pols = PolsArray(pil, PolsArray.CONSTANT)
    cbuf = const_pols.buffer
    cbuf[0, l1] = 1
    ks = [1] + get_ks(2)
    w = 1
    wn = gl.root_of_unity(n_bits)
    base = np.zeros((N, 3), dtype=np.uint64)
    for i in range(N):
        for j in range(3):
            base[i, j] = gl.mul_int(w, ks[j])
        w = gl.mul_int(w, wn)
    # connect cells (a,i) <-> (b,i) <-> (c,i) on even rows: rotate their tags
    S = base.copy()
    for i in range(0, N, 2):
        S[i, 0], S[i, 1], S[i, 2] = base[i, 1], base[i, 2], base[i, 0]
    cbuf[:, s1] = S[:, 0]
    cbuf[:, s2] = S[:, 1]
    cbuf[:, s3] = S[:, 2]

    def make_trace(seed: int = 0):
        rng = np.random.default_rng(seed)
        cm = PolsArray(pil, PolsArray.COMMIT)
        buf = cm.buffer
        vals = rng.integers(0, gl.P_INT, size=(N, 3), dtype=np.uint64)
        vals[0::2, 1] = vals[0::2, 0]  # connected cells share the value
        vals[0::2, 2] = vals[0::2, 0]
        buf[:, a] = vals[:, 0]
        buf[:, b] = vals[:, 1]
        buf[:, c] = vals[:, 2]
        return cm

    return pil, const_pols, make_trace
