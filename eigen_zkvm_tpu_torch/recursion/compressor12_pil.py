"""Generate the compressor-12 PIL directly as a PIL object.

The reference renders PIL *text* from a template and re-compiles it with a
Rust port of pilcom (recursion/src/compressor12/compressor12_pil.rs render()
+ pilcom.rs).  Here the same constraint system is constructed straight into
the in-memory PIL schema (stark/types.py) — same namespaces, same column
order, same identities, no text round-trip.  Every expression keeps
pilcom's conventions: intermediates become expression-list entries referenced
through deg-1 `exp` nodes, composite degs are max/sum-combined, and
identities stay at deg <= 2.

Port of eigen_zkvm_tpu/recursion/compressor12_pil.py on the port's PIL
schema; the MDS from the port's data/poseidon_gl_opt.npz.
"""
from __future__ import annotations

import os

import numpy as np

from ..stark.types import (ConnectionIdentity, Expression, PIL, PolIdentity,
                           Public, Reference)

# MDS row coefficients of the POSEIDON12 gate (compressor12_pil.rs:174-185);
# row i is this row rotated right by i with the modified diagonal, i.e. the
# effective Poseidon-GL MDS (see recursion/circuit.py _poseidon_tables).
_FULL_SBOX_ROWS = tuple(range(0, 4)) + tuple(range(26, 30))


def _mds():
    d = np.load(os.path.join(os.path.dirname(__file__), "..", "data",
                             "poseidon_gl_opt.npz"))["M"]
    return [[int(d[j][i]) for j in range(12)] for i in range(12)]


class _PilBuilder:
    def __init__(self, deg: int):
        self.deg = deg
        self.expressions: list[Expression] = []
        self.references: dict = {}
        self.publics: list = []
        self.pol_identities: list = []
        self.connection_identities: list = []
        self.n_const = 0
        self.n_cm = 0

    # ---- references ----
    def const_pol(self, name: str, length: int | None = None):
        ref = Reference("constP", self.n_const, self.deg, length is not None,
                        None, length)
        self.references[name] = ref
        self.n_const += length or 1
        return ref.id

    def cm_pol(self, name: str, length: int | None = None):
        ref = Reference("cmP", self.n_cm, self.deg, length is not None,
                        None, length)
        self.references[name] = ref
        self.n_cm += length or 1
        return ref.id

    # ---- expression nodes ----
    @staticmethod
    def cm(id_, next_=False):
        e = Expression("cm", 1, id_)
        e.next = next_
        return e

    @staticmethod
    def const(id_, next_=False):
        e = Expression("const", 1, id_)
        e.next = next_
        return e

    @staticmethod
    def public(id_):
        return Expression("public", 0, id_)

    @staticmethod
    def num(v: int):
        return Expression("number", 0, None, str(v))

    @staticmethod
    def add(a, b):
        return Expression("add", max(a.deg, b.deg), values=[a, b])

    @staticmethod
    def sub(a, b):
        return Expression("sub", max(a.deg, b.deg), values=[a, b])

    @staticmethod
    def mul(a, b):
        return Expression("mul", a.deg + b.deg, values=[a, b])

    def smul(self, k: int, a):
        return self.mul(self.num(k), a)

    def lin(self, terms):
        """sum of [(coef, expr)] terms."""
        acc = None
        for k, e in terms:
            t = e if k == 1 else self.smul(k, e)
            acc = t if acc is None else self.add(acc, t)
        return acc

    def intermediate(self, e) -> Expression:
        """pilcom `pol name = e;` — returns a deg-1 exp reference node."""
        self.expressions.append(e)
        ref = Expression("exp", 1, len(self.expressions) - 1)
        ref.next = False
        return ref

    def identity(self, e):
        self.expressions.append(e)
        self.pol_identities.append(
            PolIdentity(len(self.expressions) - 1, "compressor12.pil", 0))

    def build(self) -> PIL:
        return PIL(
            nCommitments=self.n_cm, nQ=0, nIm=0, nConstants=self.n_const,
            publics=self.publics, references=self.references,
            expressions=self.expressions, polIdentities=self.pol_identities,
            plookupIdentities=[], permutationIdentities=[],
            connectionIdentities=self.connection_identities)


def render(n_bits: int, n_publics: int) -> PIL:
    """The compressor PIL for 2^n_bits rows and n_publics public inputs
    (constraint-for-constraint equal to compressor12_pil.rs render())."""
    p = _PilBuilder(1 << n_bits)
    n_public_rows = (n_publics - 1) // 12 + 1 if n_publics else 0

    l_ids = [p.const_pol(f"Global.L{i + 1}") for i in range(max(1, n_public_rows))]
    s_id = p.const_pol("Compressor.S", 12)
    c_id = p.const_pol("Compressor.C", 12)
    partial = p.const_pol("Compressor.PARTIAL")
    poseidon12 = p.const_pol("Compressor.POSEIDON12")
    gate = p.const_pol("Compressor.GATE")
    cmuladd = p.const_pol("Compressor.CMULADD")
    evpol4 = p.const_pol("Compressor.EVPOL4")
    fft4 = p.const_pol("Compressor.FFT4")
    a_id = p.cm_pol("Compressor.a", 12)

    def a(i, nxt=False):
        return p.cm(a_id + i, nxt)

    def C(i):
        return p.const(c_id + i)

    for i in range(n_publics):
        p.publics.append(Public("cmP", a_id + i % 12, i // 12, i, f"pub{i}"))
    for i in range(n_publics):
        p.identity(p.mul(p.const(l_ids[i // 12]),
                         p.sub(a(i % 12), p.public(i))))

    # normal plonk gates (two per row)
    for base, cb in ((0, 0), (3, 0), (6, 6), (9, 6)):
        prod = p.intermediate(p.mul(a(base), a(base + 1)))
        g = p.intermediate(p.lin([
            (1, p.mul(C(cb + 3), prod)),
            (1, p.mul(C(cb + 0), a(base))),
            (1, p.mul(C(cb + 1), a(base + 1))),
            (1, p.mul(C(cb + 2), a(base + 2))),
            (1, C(cb + 4))]))
        p.identity(p.mul(g, p.const(gate)))

    # POSEIDON12 gate
    a_r = []
    for i in range(12):
        a1 = p.intermediate(p.add(a(i), C(i)))
        a2 = p.intermediate(p.mul(a1, a1))
        a4 = p.intermediate(p.mul(a2, a2))
        a6 = p.intermediate(p.mul(a4, a2))
        a7 = p.intermediate(p.mul(a6, a1))
        if i == 0:
            a_r.append(a7)
        else:
            a_r.append(p.intermediate(
                p.add(p.mul(p.const(partial), p.sub(a1, a7)), a7)))
    mds = _mds()
    for i in range(12):
        acc = p.lin([(mds[i][k], a_r[k]) for k in range(12)])
        p.identity(p.mul(p.const(poseidon12), p.sub(a(i, True), acc)))

    # CMULADD gate
    ca = []
    for i in range(12):
        if i < 3:
            ca.append(p.intermediate(p.mul(p.add(a(i), C(i)), C(9))))
        elif i < 6:
            ca.append(p.intermediate(p.add(a(i), C(i))))
        elif i < 9:
            ca.append(p.intermediate(p.mul(p.add(a(i), C(i)), C(10))))
        else:
            ca.append(a(i))
    cA = p.intermediate(p.mul(p.add(ca[0], ca[1]), p.add(ca[3], ca[4])))
    cB = p.intermediate(p.mul(p.add(ca[0], ca[2]), p.add(ca[3], ca[5])))
    cC = p.intermediate(p.mul(p.add(ca[1], ca[2]), p.add(ca[4], ca[5])))
    cD = p.intermediate(p.mul(ca[0], ca[3]))
    cE = p.intermediate(p.mul(ca[1], ca[4]))
    cF = p.intermediate(p.mul(ca[2], ca[5]))
    p.identity(p.mul(p.const(cmuladd), p.sub(
        p.sub(ca[9], p.sub(p.sub(p.add(cC, cD), cE), cF)), ca[6])))
    p.identity(p.mul(p.const(cmuladd), p.sub(
        p.sub(ca[10], p.sub(p.sub(p.add(cA, cC), p.smul(2, cE)), cD)), ca[7])))
    p.identity(p.mul(p.const(cmuladd), p.sub(
        p.sub(ca[11], p.add(p.sub(cB, cD), cE)), ca[8])))

    # FFT4 gate (compressor12_pil.rs:215-242)
    fft_rows = [
        [(0, 0, 1), (1, 3, 1), (2, 6, 1), (3, 9, 1), (6, 0, 1), (7, 3, 1)],
        [(0, 0, 1), (1, 3, -1), (4, 6, 1), (5, 9, -1), (6, 0, 1), (7, 3, -1)],
        [(0, 0, 1), (1, 3, 1), (2, 6, -1), (3, 9, -1), (6, 6, 1), (8, 9, 1)],
        [(0, 0, 1), (1, 3, -1), (4, 6, -1), (5, 9, 1), (6, 6, 1), (8, 9, -1)],
    ]
    gs = []
    for e in range(3):
        for grp in range(4):
            terms = None
            for (ci, ai, sgn) in fft_rows[grp]:
                t = p.mul(C(ci), a(ai + e))
                terms = t if terms is None else (
                    p.add(terms, t) if sgn > 0 else p.sub(terms, t))
            gs.append((grp * 3 + e, p.intermediate(terms)))
    for idx, g in sorted(gs):
        p.identity(p.mul(p.const(fft4), p.sub(a(idx, True), g)))

    # EVPOL4 gate: four chained 3-dim mul-adds (compressor12_pil.rs:334-356)
    def cmul3(ax, bx, cx):
        A = p.intermediate(p.mul(p.add(ax[0], ax[1]), p.add(bx[0], bx[1])))
        B = p.intermediate(p.mul(p.add(ax[0], ax[2]), p.add(bx[0], bx[2])))
        Cc = p.intermediate(p.mul(p.add(ax[1], ax[2]), p.add(bx[1], bx[2])))
        D = p.intermediate(p.mul(ax[0], bx[0]))
        E = p.intermediate(p.mul(ax[1], bx[1]))
        F = p.intermediate(p.mul(ax[2], bx[2]))
        r0 = p.intermediate(p.add(p.sub(p.sub(p.add(Cc, D), E), F), cx[0]))
        r1 = p.intermediate(p.add(p.sub(p.sub(p.add(A, Cc), p.smul(2, E)), D),
                                  cx[1]))
        r2 = p.intermediate(p.add(p.add(p.sub(B, D), E), cx[2]))
        return [r0, r1, r2]

    ap = [a(i, True) for i in range(12)]
    acc1 = cmul3(ap[0:3], ap[3:6], [a(9), a(10), a(11)])
    acc2 = cmul3(acc1, ap[3:6], [a(6), a(7), a(8)])
    acc3 = cmul3(acc2, ap[3:6], [a(3), a(4), a(5)])
    acc4 = cmul3(acc3, ap[3:6], [a(0), a(1), a(2)])
    for e in range(3):
        p.identity(p.mul(p.const(evpol4), p.sub(a(6 + e, True), acc4[e])))

    # connection argument: a[0..12) connect S[0..12)
    pol_ids, conn_ids = [], []
    for i in range(12):
        p.expressions.append(p.cm(a_id + i))
        pol_ids.append(len(p.expressions) - 1)
    for i in range(12):
        p.expressions.append(p.const(s_id + i))
        conn_ids.append(len(p.expressions) - 1)
    p.connection_identities.append(
        ConnectionIdentity(pol_ids, conn_ids, "compressor12.pil", 0))

    return p.build()
