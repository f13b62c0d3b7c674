"""Native arithmetic-circuit builder over the Goldilocks prime.

This replaces the reference's circom front-end for the recursion layers
(reference flow: pil2circom -> circom compile -> .r1cs + WASM witness,
test/recursive_proof_to_snark.sh:42).  Instead of rendering circom text,
compiling it with an external compiler and executing a WASM witness
generator, the verifier circuit is built *directly* as an R1CS-plus-custom-
gates constraint system with an embedded witness: every gadget both records
its constraints and computes its concrete witness values in one pass.

The custom-gate vocabulary matches the c12 compressor PIL exactly
(reference: recursion/src/compressor12/compressor12_pil.rs):
  - Poseidon12: 31 rows x 12 signals, one Poseidon-GL permutation
  - CMulAdd:    12 signals, out = ina*inb + inc in GF(p^3)
(EvPol4/FFT4 exist in the PIL but this builder lowers polynomial evaluation
and group iFFTs to CMulAdd chains / linear combinations instead.)

Wire values are linear combinations (lc) over signals; additions and
constant multiplications are free (folded into lcs, reduced later by
r1cs2plonk), matching how circom constraints carry full lcs.
Signal 0 is the constant-1 wire in R1CS lcs; in custom-gate signal lists
(and s_map) index 0 means the constant *zero* (reference
compressor12_exec.rs:80).

Port of eigen_zkvm_tpu/recursion/circuit.py: the same gadgets, signals and
gate lists; the GF(p^3) values are the port's Python-int helpers
(ops/f3.py `*_int`, 3-tuples), the Poseidon tables the port's own copies
(data/cposeidon_gl.npy, data/poseidon_gl_opt.npz).
"""
from __future__ import annotations

import os

import numpy as np

from ..ops import f3

P = 0xFFFFFFFF00000001

_CPOSEIDON = None
_MDS = None


def _poseidon_tables():
    global _CPOSEIDON, _MDS
    if _CPOSEIDON is None:
        d = os.path.join(os.path.dirname(__file__), "..", "data")
        _CPOSEIDON = [[int(x) for x in row]
                      for row in np.load(os.path.join(d, "cposeidon_gl.npy"))]
        m = np.load(os.path.join(d, "poseidon_gl_opt.npz"))["M"]
        # effective MDS: out[i] = sum_j MDS[i][j] * in[j]
        _MDS = [[int(m[j][i]) for j in range(12)] for i in range(12)]
    return _CPOSEIDON, _MDS


class WBase:
    """A wire: linear combination of signals plus a constant, mod class P."""

    __slots__ = ("lc", "k")
    P = None  # set on subclasses via wire_class()

    def __init__(self, lc=None, k=0):
        self.lc = lc or {}
        self.k = k % self.P

    @property
    def is_const(self):
        return not self.lc

    def __add__(self, o):
        cls = type(self)
        if isinstance(o, int):
            return cls(dict(self.lc), self.k + o)
        lc = dict(self.lc)
        for s, c in o.lc.items():
            nc = (lc.get(s, 0) + c) % self.P
            if nc:
                lc[s] = nc
            elif s in lc:
                del lc[s]
        return cls(lc, self.k + o.k)

    def __sub__(self, o):
        if isinstance(o, int):
            return type(self)(dict(self.lc), self.k - o)
        return self + o.scale(self.P - 1)

    def scale(self, c: int):
        cls = type(self)
        c %= self.P
        if c == 0:
            return cls()
        return cls({s: (v * c) % self.P for s, v in self.lc.items()},
                   self.k * c)

    def __repr__(self):
        return f"W({self.lc}, {self.k})"


_wire_classes: dict = {}


def wire_class(prime: int):
    if prime not in _wire_classes:
        _wire_classes[prime] = type(f"W_{prime % 997}", (WBase,),
                                    {"P": prime, "__slots__": ()})
    return _wire_classes[prime]


W = wire_class(P)  # Goldilocks wires (the recursion layers' native field)


ZERO3 = None  # set below after W defined


def _const3(a, b=0, c=0):
    return (W(k=a), W(k=b), W(k=c))


class CircuitBuilder:
    """R1CS + custom gates over GL, with integrated witness computation.

    `record=False` re-runs the same construction computing only witness
    values (the constraint structure is value-independent), which is the
    per-proof "exec" phase of the compressor pipeline.
    """

    def __init__(self, record=True, prime: int = P):
        self.P = prime
        self.W = wire_class(prime)
        self.w = [1]           # witness values; signal 0 == 1
        self.record = record
        self.constraints = []  # (A, B, C) dicts sig->coef; A*B - C == 0
        self.custom_gates = []  # (template_name, [signal ids])
        self.n_publics = 0
        self._mat_cache = {}
        self._sealed_publics = False

    # ---- signals ----
    def sig(self, value: int) -> int:
        self.w.append(value % self.P)
        return len(self.w) - 1

    def public(self, value: int) -> W:
        """Allocate the next public signal (must precede private ones)."""
        assert len(self.w) == self.n_publics + 1, "publics must come first"
        s = self.sig(value)
        self.n_publics += 1
        return self.W({s: 1})

    def wire(self, sid: int):
        return self.W({sid: 1})

    # ---- evaluation ----
    def val(self, a: W) -> int:
        v = a.k
        for s, c in a.lc.items():
            v += self.w[s] * c
        return v % self.P

    # ---- constraints ----
    def _constraint(self, A: W, B: W, C: W):
        if self.record:
            a = dict(A.lc)
            if A.k:
                a[0] = A.k
            b = dict(B.lc)
            if B.k:
                b[0] = B.k
            c = dict(C.lc)
            if C.k:
                c[0] = C.k
            self.constraints.append((a, b, c))

    def materialize(self, a: W) -> int:
        """Force a wire into a single signal (for custom-gate operands)."""
        if len(a.lc) == 1 and a.k == 0 and next(iter(a.lc.values())) == 1:
            return next(iter(a.lc))
        if a.is_const and a.k == 0:
            return 0  # zero signal in gate lists
        key = (tuple(sorted(a.lc.items())), a.k)
        hit = self._mat_cache.get(key)
        if hit is not None:
            return hit
        s = self.sig(self.val(a))
        Wc = self.W
        self._constraint(Wc(), Wc(), a - Wc({s: 1}))
        self._mat_cache[key] = s
        return s

    def mul(self, a: W, b: W) -> W:
        if a.is_const:
            return b.scale(a.k)
        if b.is_const:
            return a.scale(b.k)
        s = self.sig(self.val(a) * self.val(b))
        self._constraint(a, b, self.W({s: 1}))
        return self.W({s: 1})

    def assert_zero(self, a: W):
        assert self.val(a) == 0, "constraint violated at build time"
        if not a.is_const:
            self._constraint(self.W(), self.W(), a)

    def assert_eq(self, a: W, b: W):
        self.assert_zero(a - b)

    def inv(self, a: W) -> W:
        v = self.val(a)
        s = self.sig(pow(v, self.P - 2, self.P))
        out = self.W({s: 1})
        self._constraint(a, out, self.W(k=1))
        return out

    def bits(self, a: W, n: int = 64, strict: bool = True) -> list[W]:
        """Num2Bits with (optionally) a strict < P aliasing check.

        Mirrors pil-stark's GL bitify semantics: 64-bit decomposition; the
        strict check uses P = 2^64 - 2^32 + 1: value >= P iff the top 32
        bits are all ones and the low 32 bits are nonzero.
        """
        Wc = self.W
        v = self.val(a)
        assert v < (1 << n)
        bs = []
        acc = Wc()
        for i in range(n):
            s = self.sig((v >> i) & 1)
            b = Wc({s: 1})
            self._constraint(b, b - Wc(k=1), Wc())  # b*(b-1) == 0
            bs.append(b)
            acc = acc + b.scale(1 << i)
        self.assert_eq(acc, a)
        if strict and n == 64 and self.P == P:
            hi = bs[32]
            for i in range(33, 64):
                hi = self.mul(hi, bs[i])
            lo = Wc()
            for i in range(32):
                lo = lo + bs[i].scale(1 << i)
            self.assert_zero(self.mul(hi, lo))
        return bs

    def mux(self, bit: W, v0: W, v1: W) -> W:
        """bit ? v1 : v0."""
        return self.mul(bit, v1 - v0) + v0

    # ---- GF(p^3) ops (x^3 = x + 1) ----
    def f3_add(self, a, b):
        return (a[0] + b[0], a[1] + b[1], a[2] + b[2])

    def f3_sub(self, a, b):
        return (a[0] - b[0], a[1] - b[1], a[2] - b[2])

    def f3_scale(self, a, c: int):
        return (a[0].scale(c), a[1].scale(c), a[2].scale(c))

    def f3_val(self, a) -> tuple:
        return (self.val(a[0]), self.val(a[1]), self.val(a[2]))

    def _f3_nonconst(self, a) -> int:
        return sum(0 if x.is_const else 1 for x in a)

    def f3_mul(self, a, b, c=None):
        """GF(p^3) (a*b + c); uses the CMulAdd custom gate when both operands
        are genuinely 3-dimensional, Karatsuba via scalar muls otherwise
        (reference gate: compressor12_pil.rs CMULADD; formulas match
        stark-circuits/circuits/gl.circom GLCMulAdd)."""
        if c is None:
            c = _const3(0)
        if self._f3_nonconst(a) >= 2 and self._f3_nonconst(b) >= 2:
            return self._cmuladd_gate(a, b, c)
        A = self.mul(a[0] + a[1], b[0] + b[1])
        B = self.mul(a[0] + a[2], b[0] + b[2])
        C = self.mul(a[1] + a[2], b[1] + b[2])
        D = self.mul(a[0], b[0])
        E = self.mul(a[1], b[1])
        F = self.mul(a[2], b[2])
        G = D - E
        return (C + G - F + c[0], A + C - E.scale(2) - D + c[1], B - G + c[2])

    def _cmuladd_gate(self, a, b, c):
        sa = [self.materialize(x) for x in a]
        sb = [self.materialize(x) for x in b]
        sc = [self.materialize(x) for x in c]
        av, bv, cv = self.f3_val(a), self.f3_val(b), self.f3_val(c)
        ov = f3.add_int(f3.mul_int(av, bv), cv)
        so = [self.sig(x) for x in ov]
        if self.record:
            self.custom_gates.append(("CMulAdd", sa + sb + sc + so))
        return (W({so[0]: 1}), W({so[1]: 1}), W({so[2]: 1}))

    def f3_inv(self, a):
        iv = f3.inv_int(self.f3_val(a))
        inv = tuple(W({self.sig(x): 1}) for x in iv)
        prod = self.f3_mul(a, inv)
        self.assert_eq(prod[0], W(k=1))
        self.assert_zero(prod[1])
        self.assert_zero(prod[2])
        return inv

    def f3_assert_eq(self, a, b):
        for i in range(3):
            self.assert_eq(a[i], b[i])

    # ---- EvPol4 custom gate ----
    def ev_pol4(self, cs, x, acc):
        """One EVPOL4 gate: out = (((acc*x + c3)*x + c2)*x + c1)*x + c0
        over GF(p^3), where cs = [c0, c1, c2, c3] F3 triples.  Occupies two
        trace rows (coefficients row + acc/x/out row) instead of the four
        CMulAdd rows a Horner chain would take (reference gate:
        compressor12_pil.rs:334-356)."""
        assert len(cs) == 4
        s_cs = [self.materialize(w) for c in cs for w in c]
        s_ax = [self.materialize(w) for w in acc] + \
               [self.materialize(w) for w in x]
        av, xv = self.f3_val(acc), self.f3_val(x)
        for c in reversed(cs):
            av = f3.add_int(f3.mul_int(av, xv), self.f3_val(c))
        so = [self.sig(v) for v in av]
        if self.record:
            self.custom_gates.append(("EvPol4", s_cs + s_ax + so))
        Wc = self.W
        return (Wc({so[0]: 1}), Wc({so[1]: 1}), Wc({so[2]: 1}))

    # ---- FFT4 custom gate ----
    @staticmethod
    def fft4_map(C, v, p):
        """The FFT4 gate's structured linear map (per GL component):
        4 inputs -> 4 outputs with 9 free constants (matches the
        compressor12_pil.py FFT4 identities / compressor12_pil.rs:215-242).
        By constant choice this expresses a radix-4 NTT butterfly or two
        independent radix-2 butterflies."""
        v0, v1, v2, v3 = v
        o0 = ((C[0] + C[6]) * v0 + (C[1] + C[7]) * v1
              + C[2] * v2 + C[3] * v3)
        o1 = ((C[0] + C[6]) * v0 - (C[1] + C[7]) * v1
              + C[4] * v2 - C[5] * v3)
        o2 = (C[0] * v0 + C[1] * v1
              + (C[6] - C[2]) * v2 + (C[8] - C[3]) * v3)
        o3 = (C[0] * v0 - C[1] * v1
              + (C[6] - C[4]) * v2 + (C[5] - C[8]) * v3)
        return [o0 % p, o1 % p, o2 % p, o3 % p]

    def fft4(self, v, consts):
        """One FFT4 gate: 4 F3 triples in, 4 F3 triples out via fft4_map
        with per-gate constants C0..C8 (GL scalars applied componentwise).
        Two trace rows per gate."""
        assert len(v) == 4 and len(consts) == 9
        s_in = [self.materialize(w) for t in v for w in t]
        vals = [[0 if s == 0 else self.w[s] for s in s_in[g * 3 : g * 3 + 3]]
                for g in range(4)]
        outs = []
        for e in range(3):
            outs.append(self.fft4_map(consts, [vals[g][e] for g in range(4)],
                                      self.P))
        s_out = [self.sig(outs[e][g]) for g in range(4) for e in range(3)]
        if self.record:
            self.custom_gates.append(("FFT4", s_in + s_out, tuple(consts)))
        Wc = self.W
        return [tuple(Wc({s_out[g * 3 + e]: 1}) for e in range(3))
                for g in range(4)]

    # ---- Poseidon (t=12) custom gate ----
    def poseidon(self, state: list[int]) -> list[int]:
        """One Poseidon-GL permutation over 12 *signal ids*; returns 12
        output signal ids.  Allocates the 30 intermediate rows and records
        one Poseidon12 custom-gate use (31*12 signals)."""
        assert len(state) == 12
        CP, MDS = _poseidon_tables()
        rows = [list(state)]
        # gate-list convention: signal id 0 carries the value ZERO
        vals = [0 if s == 0 else self.w[s] for s in state]
        for j in range(30):
            s1 = [(vals[i] + CP[j][i]) % P for i in range(12)]
            partial = 4 <= j < 26
            sr = [pow(s1[0], 7, P)] + [
                s1[i] if partial else pow(s1[i], 7, P) for i in range(1, 12)]
            vals = [sum(MDS[i][k] * sr[k] for k in range(12)) % P
                    for i in range(12)]
            rows.append([self.sig(v) for v in vals])
        if self.record:
            flat = [s for row in rows for s in row]
            self.custom_gates.append(("Poseidon12", flat))
        return rows[30]

    # ---- direct checking (for tests) ----
    def check(self) -> bool:
        """Verify every R1CS constraint and custom-gate relation against the
        embedded witness."""
        pr = self.P

        def ev(d):
            return sum(self.w[s] * c for s, c in d.items()) % pr

        for A, B, C in self.constraints:
            if (ev(A) * ev(B) - ev(C)) % pr != 0:
                return False
        CP, MDS = _poseidon_tables()

        def gv(s):
            return 0 if s == 0 else self.w[s]

        for entry in self.custom_gates:
            name, sigs = entry[0], entry[1]
            if name == "Poseidon12":
                for j in range(30):
                    cur = [gv(s) for s in sigs[j * 12 : (j + 1) * 12]]
                    nxt = [gv(s) for s in sigs[(j + 1) * 12 : (j + 2) * 12]]
                    s1 = [(cur[i] + CP[j][i]) % P for i in range(12)]
                    partial = 4 <= j < 26
                    sr = [pow(s1[0], 7, P)] + [
                        s1[i] if partial else pow(s1[i], 7, P)
                        for i in range(1, 12)]
                    exp = [sum(MDS[i][k] * sr[k] for k in range(12)) % P
                           for i in range(12)]
                    if exp != nxt:
                        return False
            elif name == "CMulAdd":
                g = [gv(s) for s in sigs]
                if f3.add_int(f3.mul_int(g[0:3], g[3:6]), g[6:9]) \
                        != tuple(g[9:12]):
                    return False
            elif name == "EvPol4":
                g = [gv(s) for s in sigs]
                acc, x = g[12:15], g[15:18]
                for k in (3, 2, 1, 0):
                    acc = f3.add_int(f3.mul_int(acc, x), g[k * 3 : k * 3 + 3])
                if list(acc) != g[18:21]:
                    return False
            elif name == "FFT4":
                g = [gv(s) for s in sigs]
                consts = entry[2]
                for e in range(3):
                    got = self.fft4_map(
                        consts, [g[gr * 3 + e] for gr in range(4)], self.P)
                    if got != [g[12 + gr * 3 + e] for gr in range(4)]:
                        return False
            else:
                return False
        return True

    @property
    def n_vars(self) -> int:
        return len(self.w)
