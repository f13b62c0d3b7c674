"""Poseidon-GL permutation AIR — the starkjs `poseidon` example family
(reference starkjs/poseidon/poseidong.pil + sm_poseidong.js: one round
per row, x^7 sbox through chained intermediates, full/partial round
schedule flags, input/output publics).

One permutation occupies the first 30 rows (the non-opt 30-round
schedule shared with the continuation coprocessor and the in-circuit
Poseidon12 gate — the SAME permutation as the opt-schedule engines,
cross-checked in tests).  Publics bind the 12 input lanes at row 0 and
the 4 digest lanes at row 30.

Copy of eigen_zkvm_tpu/examples/poseidon.py on the port's PilBuilder,
PolsArray and zkvm/continuations.py round function.  build(n_bits) ->
(pil, const_pols, make_trace, reference_digest)."""
from __future__ import annotations

from ..stark.pil_builder import PilBuilder
from ..stark.polsarray import PolsArray
from ..zkvm.continuations import _PROUNDS, _poseidon_tables, _pos_round


def build(n_bits: int = 6):
    CP, MDS = _poseidon_tables()
    N = 1 << n_bits
    assert N >= _PROUNDS + 2

    p = PilBuilder(n_bits)
    c_rc = p.const_pol("PoseidonG.C", 12)
    c_full = p.const_pol("PoseidonG.FULL_ON")
    c_part = p.const_pol("PoseidonG.PARTIAL_ON")
    c_init = p.const_pol("PoseidonG.LINPUT")
    c_latch = p.const_pol("PoseidonG.LOUTPUT")
    m_st = p.cm_pol("PoseidonG.st", 12)

    st = [p.cm(m_st + i) for i in range(12)]
    stp = [p.cm(m_st + i, True) for i in range(12)]

    # input publics bound on the LINPUT row
    for i in range(12):
        pub = p.public_input(f"pin{i}", p.cm(m_st + i), 0)
        p.identity(p.mul(p.const(c_init), p.sub(st[i], pub)),
                   "poseidong.pil", 20 + i)
    # digest publics on the LOUTPUT row
    for j in range(4):
        pub = p.public_input(f"out{j}", p.cm(m_st + j), _PROUNDS)
        p.identity(p.mul(p.const(c_latch), p.sub(st[j], pub)),
                   "poseidong.pil", 40 + j)

    # round transition: st' = MDS * sbox(st + C); sbox lane 0 always,
    # all lanes on full rounds; x^7 via chained intermediates
    rc = [p.const(c_rc + i) for i in range(12)]
    s1 = [p.add(st[i], rc[i]) for i in range(12)]
    a7 = []
    for i in range(12):
        a2 = p.intermediate(p.mul(s1[i], s1[i]))
        a4 = p.intermediate(p.mul(a2, a2))
        a6 = p.intermediate(p.mul(a4, a2))
        a7.append(p.intermediate(p.mul(a6, s1[i])))
    for i in range(12):
        full_sum = p.lin([(MDS[i][k], a7[k]) for k in range(12)])
        p.identity(p.mul(p.const(c_full), p.sub(stp[i], full_sum)),
                   "poseidong.pil", 60 + i)
        part_sum = p.lin([(MDS[i][0], a7[0])]
                         + [(MDS[i][k], s1[k]) for k in range(1, 12)])
        p.identity(p.mul(p.const(c_part), p.sub(stp[i], part_sum)),
                   "poseidong.pil", 80 + i)

    pil = p.build()
    const_pols = PolsArray(pil, PolsArray.CONSTANT)
    cbuf = const_pols.buffer
    cbuf[0, c_init] = 1
    cbuf[_PROUNDS, c_latch] = 1
    for j in range(_PROUNDS):
        for i in range(12):
            cbuf[j, c_rc + i] = CP[j][i]
        full = j < 4 or j >= 26
        cbuf[j, c_full if full else c_part] = 1

    def make_trace(inputs):
        """inputs: 12 u64 lanes (rate 8 + capacity 4)."""
        assert len(inputs) == 12
        cm = PolsArray(pil, PolsArray.COMMIT)
        buf = cm.buffer
        s = [int(v) for v in inputs]
        for r in range(N):
            for i in range(12):
                buf[r, m_st + i] = s[i]
            if r < _PROUNDS:
                s = _pos_round(s, r)
        return cm

    def reference_digest(inputs):
        s = [int(v) for v in inputs]
        for j in range(_PROUNDS):
            s = _pos_round(s, j)
        return s[:4]

    return pil, const_pols, make_trace, reference_digest
