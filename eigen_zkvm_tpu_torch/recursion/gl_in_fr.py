"""Goldilocks arithmetic emulated inside a snark-field circuit (BN254 /
BLS12-381 Fr), plus the big-field Poseidon, transcript and sha256 gadgets
the on-chain STARK verifier needs.

Semantics mirror the reference's circuit library for the on-chain layer
(stark-circuits/circuits/gl.circom GLMul/GLCMul/GLInv + Num2Bits range
checks, poseidon.circom, bn1togl3.circom, compconstant64.circom,
stark_verifier_circom_onchain.rs Transcript/Sha256 publics hash), built on
the native CircuitBuilder.  GL values are Fr wires with statically tracked
integer bounds; multiplication introduces (k, out) witnesses with
m === k*GL_P + out and bit range checks, additions stay free in the lc.

Port of eigen_zkvm_tpu/recursion/gl_in_fr.py: the same gadgets, signals and
constraints; the GF(p^3) values are the port's Python-int helpers
(ops/f3.py `*_int`, 3-tuples) and the Poseidon round tables the port's
hash/poseidon_big.py (`PoseidonBig.tables()`: {t: (C, M, Pm, S)}).
"""
from __future__ import annotations

from ..ops import f3
from ..ops.gl import P_INT as GL_P
from .circuit import CircuitBuilder


class GlF:
    """A GL value as an Fr wire + exact integer witness + static bounds."""

    __slots__ = ("w", "ival", "lo", "hi")

    def __init__(self, w, ival: int, lo: int, hi: int):
        self.w = w        # Fr wire (W)
        self.ival = ival  # exact integer value of the wire
        self.lo = lo
        self.hi = hi


class GlCircuit:
    """GL-in-Fr gadget factory bound to one CircuitBuilder."""

    def __init__(self, b: CircuitBuilder):
        self.b = b
        self.Wc = b.W

    # ---- construction ----
    def const(self, c: int) -> GlF:
        c %= GL_P
        return GlF(self.Wc(k=c), c, c, c)

    def from_checked64(self, w, ival: int) -> GlF:
        """Wrap an Fr wire already known to be < 2^64."""
        return GlF(w, ival, 0, (1 << 64) - 1)

    def input64(self, value: int) -> GlF:
        """Allocate a proof-input GL value with a 64-bit range check."""
        value = int(value)
        s = self.b.sig(value)
        w = self.b.wire(s)
        self.b.bits(w, 64, strict=False)
        return GlF(w, value, 0, (1 << 64) - 1)

    def f3_input(self, vals) -> tuple:
        return tuple(self.input64(int(v)) for v in vals)

    def f3_const(self, a: int, b: int = 0, c: int = 0):
        return (self.const(a), self.const(b), self.const(c))

    # ---- linear ops (free) ----
    def add(self, a: GlF, b: GlF) -> GlF:
        return GlF(a.w + b.w, a.ival + b.ival, a.lo + b.lo, a.hi + b.hi)

    def sub(self, a: GlF, b: GlF) -> GlF:
        return GlF(a.w - b.w, a.ival - b.ival, a.lo - b.hi, a.hi - b.lo)

    def scale(self, a: GlF, c: int) -> GlF:
        c %= GL_P
        return GlF(a.w.scale(c), a.ival * c, min(a.lo * c, a.hi * c),
                   max(a.lo * c, a.hi * c))

    # ---- normalization / range machinery ----
    def _shifted(self, a: GlF):
        """(wire + ka*GL_P, ival + ka*GL_P, hi + ka*GL_P) non-negative."""
        ka = 0
        if a.lo < 0:
            ka = (-a.lo + GL_P - 1) // GL_P
        return a.w + self.Wc(k=ka * GL_P), a.ival + ka * GL_P, a.hi + ka * GL_P

    def norm(self, a: GlF) -> GlF:
        """Reduce to canonical [0, GL_P) with witness hints + range checks
        (GLNorm, gl.circom:6; the k and out widths follow the bound)."""
        if 0 <= a.lo and a.hi < GL_P:
            return a
        w_sh, v_sh, hi_sh = self._shifted(a)
        k = v_sh // GL_P
        out = v_sh % GL_P
        kw = self.b.wire(self.b.sig(k))
        ow = self.b.wire(self.b.sig(out))
        kbits = max(1, (hi_sh // GL_P).bit_length())
        self.b.bits(kw, kbits, strict=False)
        self.b.bits(ow, 64, strict=False)
        self.b.assert_eq(w_sh, kw.scale(GL_P) + ow)
        return GlF(ow, out, 0, (1 << 64) - 1)

    def assert_zero(self, a: GlF):
        """Assert a == 0 (mod GL_P) exactly."""
        assert a.ival % GL_P == 0, "GL constraint violated at build time"
        w_sh, v_sh, hi_sh = self._shifted(a)
        k = v_sh // GL_P
        kw = self.b.wire(self.b.sig(k))
        kbits = max(1, (hi_sh // GL_P).bit_length())
        self.b.bits(kw, kbits, strict=False)
        self.b.assert_eq(w_sh, kw.scale(GL_P))

    def assert_eq(self, a: GlF, b: GlF):
        self.assert_zero(self.sub(a, b))

    def _maybe_norm(self, a: GlF, limit_bits: int = 100) -> GlF:
        if a.lo < -(1 << limit_bits) or a.hi > (1 << limit_bits):
            return self.norm(a)
        return a

    # ---- multiplication (GLMul / GLMulAdd, gl.circom:44/66) ----
    def mul(self, a: GlF, b: GlF, c: GlF | None = None) -> GlF:
        a = self._maybe_norm(a)
        b = self._maybe_norm(b)
        aw, av, ah = self._shifted(a)
        bw, bv, bh = self._shifted(b)
        m = self.b.mul(aw, bw)
        mv = av * bv
        mh = ah * bh
        if c is not None:
            c = self._maybe_norm(c)
            cw, cv, ch = self._shifted(c)
            m = m + cw
            mv += cv
            mh += ch
        assert mh < self.b.P // 2, "GL product overflows the snark field"
        k = mv // GL_P
        out = mv % GL_P
        kw = self.b.wire(self.b.sig(k))
        ow = self.b.wire(self.b.sig(out))
        self.b.bits(kw, max(1, (mh // GL_P).bit_length()), strict=False)
        self.b.bits(ow, 64, strict=False)
        self.b.assert_eq(m, kw.scale(GL_P) + ow)
        return GlF(ow, out, 0, (1 << 64) - 1)

    def inv(self, a: GlF) -> GlF:
        iv = pow(a.ival % GL_P, GL_P - 2, GL_P)
        out = GlF(self.b.wire(self.b.sig(iv)), iv, 0, GL_P - 1)
        self.b.bits(out.w, 64, strict=False)
        prod = self.mul(a, out)
        self.assert_eq(prod, self.const(1))
        return out

    # ---- GF(p^3) (x^3 = x + 1), GLCMul/GLCMulAdd/GLCInv ----
    def f3_add(self, a, b):
        return tuple(self.add(a[e], b[e]) for e in range(3))

    def f3_sub(self, a, b):
        return tuple(self.sub(a[e], b[e]) for e in range(3))

    def f3_scale(self, a, c: int):
        return tuple(self.scale(a[e], c) for e in range(3))

    def f3_mul(self, a, b, c=None):
        A = self.mul(self.add(a[0], a[1]), self.add(b[0], b[1]))
        B = self.mul(self.add(a[0], a[2]), self.add(b[0], b[2]))
        C = self.mul(self.add(a[1], a[2]), self.add(b[1], b[2]))
        D = self.mul(a[0], b[0])
        E = self.mul(a[1], b[1])
        F = self.mul(a[2], b[2])
        G = self.sub(D, E)
        r0 = self.sub(self.add(C, G), F)
        r1 = self.sub(self.sub(self.add(A, C), self.scale(E, 2)), D)
        r2 = self.sub(B, G)
        if c is not None:
            r0 = self.add(r0, c[0])
            r1 = self.add(r1, c[1])
            r2 = self.add(r2, c[2])
        return (r0, r1, r2)

    def f3_inv(self, a):
        iv = f3.inv_int(self.f3_val(a))
        inv = tuple(self.input64(x) for x in iv)
        prod = self.f3_mul(a, inv)
        self.assert_eq(prod[0], self.const(1))
        self.assert_zero(prod[1])
        self.assert_zero(prod[2])
        return inv

    def f3_assert_eq(self, a, b):
        for e in range(3):
            self.assert_eq(a[e], b[e])

    def f3_val(self, a) -> tuple:
        return tuple(x.ival % GL_P for x in a)

    def mux(self, bit, v0: GlF, v1: GlF) -> GlF:
        """bit ? v1 : v0 over GL wires (bit is a boolean Fr wire)."""
        d = self.sub(v1, v0)
        sel = int(self.b.val(bit))
        prod = self.b.mul(bit, d.w)
        return GlF(v0.w + prod, v0.ival + sel * d.ival,
                   min(v0.lo, v1.lo), max(v0.hi, v1.hi))


# ---- big-field Poseidon on native Fr wires ----

class PoseidonFrCircuit:
    """In-circuit Poseidon over the snark field (PoseidonEx(16,17));
    round tables from hash/poseidon_big.py (circomlib "opt" schedule).
    Linear layers ride the lc — only the x^5 sboxes cost constraints.
    `pbn` is the curve's hash module (hash/poseidon_bn128.py,
    hash/poseidon_bls12381.py) or its PoseidonBig."""

    def __init__(self, b: CircuitBuilder, pbn):
        self.b = b
        self.pbn = getattr(pbn, "POSEIDON", pbn)  # a PoseidonBig

    def _pow5(self, x):
        b = self.b
        x2 = b.mul(x, x)
        x4 = b.mul(x2, x2)
        return b.mul(x4, x)

    def hash_fr(self, inputs, init_state):
        """The curve's single-Fr hash (BN: output 0; BLS12-381: output 1 —
        Neptune convention, hash/poseidon_bls12381.py)."""
        idx = self.pbn.hash_index
        return self.hash_ex(inputs, init_state, idx + 1)[idx]

    def hash_ex(self, inputs, init_state, n_out: int):
        """inputs: list of Fr wires (len 1..16); init_state: Fr wire."""
        b = self.b
        t = len(inputs) + 1
        C, M, Pm, S = self.pbn.tables()[t]
        n_p = self.pbn.n_rounds_p(t)
        half = 4

        state = [init_state + b.W(k=C[0])] + [
            x + b.W(k=C[i + 1]) for i, x in enumerate(inputs)]

        def mat(mt, st):
            return [sum((st[j].scale(mt[j][i]) for j in range(t)), b.W())
                    for i in range(t)]

        for r in range(half - 1):
            state = [self._pow5(x) for x in state]
            state = [state[i] + b.W(k=C[(r + 1) * t + i]) for i in range(t)]
            state = mat(M, state)
        state = [self._pow5(x) for x in state]
        state = [state[i] + b.W(k=C[half * t + i]) for i in range(t)]
        state = mat(Pm, state)
        for r in range(n_p):
            s0 = self._pow5(state[0]) + b.W(k=C[(half + 1) * t + r])
            base = (2 * t - 1) * r
            new0 = sum((state[j].scale(S[base + j]) for j in range(1, t)),
                       s0.scale(S[base]))
            state = [new0] + [state[k] + s0.scale(S[base + t + k - 1])
                              for k in range(1, t)]
        cbase = (half + 1) * t + n_p
        for r in range(half - 1):
            state = [self._pow5(x) for x in state]
            state = [state[i] + b.W(k=C[cbase + r * t + i]) for i in range(t)]
            state = mat(M, state)
        state = [self._pow5(x) for x in state]
        state = mat(M, state)
        return state[:n_out]


class TranscriptBigCircuit:
    """In-circuit big-field transcript (stark_verifier_circom_onchain.rs
    Transcript, hash/transcript_big.py semantics)."""

    def __init__(self, b: CircuitBuilder, pos: PoseidonFrCircuit, gl: GlCircuit):
        self.b = b
        self.pos = pos
        self.gl = gl
        self.state = b.W()  # zero
        self.pending = []
        self.out = []
        self.out3 = []

    def _update(self):
        while len(self.pending) < 16:
            self.pending.append(self.b.W())
        full = self.pos.hash_ex(self.pending, self.state, 17)
        self.out = list(full)
        self.out3 = []
        self.state = full[0]
        self.pending = []

    def put(self, w):
        self.out = []
        self.out3 = []
        self.pending.append(w)
        if len(self.pending) == 16:
            self._update()

    def get_fields253(self):
        if self.out:
            return self.out.pop(0)
        self._update()
        return self.get_fields253()

    def get_fields1(self) -> GlF:
        if self.out3:
            return self.out3.pop(0)
        if self.out:
            v = self.out.pop(0)
            # BN1toGL3: 255-bit decomposition, three 64-bit chunks
            bits = self.b.bits(v, 255, strict=False)
            iv = int(self.b.val(v))
            for c in range(3):
                w = sum((bits[64 * c + j].scale(1 << j) for j in range(64)),
                        self.b.W())
                self.out3.append(self.gl.from_checked64(
                    w, (iv >> (64 * c)) & ((1 << 64) - 1)))
            return self.get_fields1()
        self._update()
        return self.get_fields1()

    def get_field(self):
        return (self.get_fields1(), self.get_fields1(), self.get_fields1())

    def get_permutations(self, n: int, nbits: int):
        total = n * nbits
        n_fields = (total - 1) // 253 + 1
        stream = []
        for _ in range(n_fields):
            f = self.get_fields253()
            # Num2Bits_strict over Fr (full-width decomposition + < P check)
            fbits = self.b.bits(f, self.b.P.bit_length(), strict=False)
            _assert_lt_const(self.b, fbits, self.b.P)
            stream.extend(fbits[:253])
        return [stream[i * nbits : (i + 1) * nbits] for i in range(n)]


def _assert_lt_const(b: CircuitBuilder, bits, ct: int):
    """Assert the bit-decomposed value is < ct (circomlib CompConstant
    generalized; pairwise compression as in compconstant64.circom)."""
    c = ct - 1  # compare > ct-1 must be false
    n = len(bits)
    if n % 2:
        bits = bits + [b.W()]
        n += 1
    e = 1
    acc = b.W(k=(1 << (n // 2)) - 1)
    for i in range(n // 2):
        clsb = (c >> (2 * i)) & 1
        cmsb = (c >> (2 * i + 1)) & 1
        sl = bits[2 * i]
        sm = bits[2 * i + 1]
        slm = b.mul(sl, sm)
        if cmsb == 0 and clsb == 0:
            part = sm.scale(e) + sl.scale(e) - slm.scale(e)
        elif cmsb == 0 and clsb == 1:
            part = b.W(k=-e % b.P) + sl.scale(e) + sm.scale(2 * e) - slm.scale(e)
        elif cmsb == 1 and clsb == 0:
            part = slm.scale(e) - b.W(k=e) + sm.scale(e)
        else:
            part = slm.scale(e) - b.W(k=e)
        acc = acc + part
        e *= 2
    sbits = b.bits(acc, n // 2 + 1, strict=False)
    b.assert_zero(sbits[n // 2])


# ---- sha256 gadget (publics hash, stark_verifier_circom_onchain.rs:1786) --

_SHA_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]
_SHA_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
           0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


class _U32:
    """A 32-bit word as a list of 32 bit-wires (LSB first)."""

    def __init__(self, bits):
        self.bits = bits


def _u32_const(b, v):
    return _U32([b.W(k=(v >> i) & 1) for i in range(32)])


def _u32_xor(b, x, y):
    # a ^ b = a + b - 2ab per bit
    return _U32([x.bits[i] + y.bits[i] - b.mul(x.bits[i], y.bits[i]).scale(2)
                 for i in range(32)])


def _u32_and(b, x, y):
    return _U32([b.mul(x.bits[i], y.bits[i]) for i in range(32)])


def _u32_not(b, x):
    return _U32([b.W(k=1) - x.bits[i] for i in range(32)])


def _rotr(x, n):
    return _U32([x.bits[(i + n) % 32] for i in range(32)])


def _shr(b, x, n):
    return _U32([x.bits[i + n] if i + n < 32 else b.W() for i in range(32)])


def _u32_add(b, *words):
    """Sum of u32 words mod 2^32, re-decomposed to bits."""
    total = b.W()
    for wd in words:
        total = total + sum((wd.bits[i].scale(1 << i) for i in range(32)),
                            b.W())
    ext = 32 + (len(words) - 1).bit_length() + 1
    bits = b.bits(total, ext, strict=False)
    return _U32(bits[:32])


def sha256_bits(b: CircuitBuilder, msg_bits):
    """sha256 over a list of bit wires (MSB-first, circomlib Sha256(n)
    semantics); returns 256 bit wires MSB-first."""
    n = len(msg_bits)
    # padding
    bits = list(msg_bits) + [b.W(k=1)]
    while (len(bits) + 64) % 512:
        bits.append(b.W())
    for i in range(63, -1, -1):
        bits.append(b.W(k=(n >> i) & 1))
    h = [_u32_const(b, v) for v in _SHA_H0]
    for blk in range(0, len(bits), 512):
        wds = []
        for i in range(16):
            chunk = bits[blk + i * 32 : blk + (i + 1) * 32]
            wds.append(_U32(chunk[::-1]))  # MSB-first -> LSB-first
        for i in range(16, 64):
            s0 = _u32_xor(b, _u32_xor(b, _rotr(wds[i - 15], 7),
                                      _rotr(wds[i - 15], 18)),
                          _shr(b, wds[i - 15], 3))
            s1 = _u32_xor(b, _u32_xor(b, _rotr(wds[i - 2], 17),
                                      _rotr(wds[i - 2], 19)),
                          _shr(b, wds[i - 2], 10))
            wds.append(_u32_add(b, wds[i - 16], s0, wds[i - 7], s1))
        a, bb, c, d, e, f, g, hh = h
        for i in range(64):
            S1 = _u32_xor(b, _u32_xor(b, _rotr(e, 6), _rotr(e, 11)),
                          _rotr(e, 25))
            ch = _u32_xor(b, _u32_and(b, e, f),
                          _u32_and(b, _u32_not(b, e), g))
            t1 = _u32_add(b, hh, S1, ch, _u32_const(b, _SHA_K[i]), wds[i])
            S0 = _u32_xor(b, _u32_xor(b, _rotr(a, 2), _rotr(a, 13)),
                          _rotr(a, 22))
            maj = _u32_xor(b, _u32_xor(b, _u32_and(b, a, bb),
                                       _u32_and(b, a, c)),
                           _u32_and(b, bb, c))
            t2 = _u32_add(b, S0, maj)
            hh, g, f, e, d, c, bb, a = (
                g, f, e, _u32_add(b, d, t1), c, bb, a, _u32_add(b, t1, t2))
        h = [_u32_add(b, x, y) for x, y in zip(h, [a, bb, c, d, e, f, g, hh])]
    out = []
    for wd in h:
        out.extend(wd.bits[::-1])  # MSB-first
    return out
