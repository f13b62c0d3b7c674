"""In-circuit gadgets for the STARK verifier circuit.

Each gadget mirrors the semantics of a pil-stark circuits.gl template that
the reference's generated verifier includes (stark_verifier_circom.rs:16-27):
transcript (Poseidon sponge), LinearHash, MerkleHash, TreeSelector, FFT
(group iNTT), EvalPol — re-expressed on the native CircuitBuilder, with the
linear parts (iNTT, muxes' add-halves, MDS) carried symbolically in lcs so
they cost no gates.

Port of eigen_zkvm_tpu/recursion/gadgets.py on the port's builder and its
ops/gl.py int helpers.
"""
from __future__ import annotations

from ..ops import gl
from .circuit import CircuitBuilder, P, W


class CircuitTranscript:
    """Fiat-Shamir transcript over signal ids; semantics identical to
    hash/transcript_gl.py (reference: starky/src/transcript.rs)."""

    def __init__(self, b: CircuitBuilder):
        self.b = b
        self.state = [0, 0, 0, 0]  # signal ids; 0 == zero
        self.pending: list[int] = []
        self.out: list[int] = []

    def _update(self):
        while len(self.pending) < 8:
            self.pending.append(0)
        full = self.b.poseidon(self.pending + self.state)
        self.out = list(full)
        self.state = list(full[0:4])
        self.pending = []

    def put(self, sid: int):
        self.out = []
        self.pending.append(sid)
        if len(self.pending) == 8:
            self._update()

    def put_many(self, sids):
        for s in sids:
            self.put(s)

    def get_fields1(self) -> int:
        if self.out:
            return self.out.pop(0)
        self._update()
        return self.get_fields1()

    def get_field(self):
        return tuple(W({self.get_fields1(): 1}) for _ in range(3))

    def get_permutations(self, n: int, nbits: int) -> list[list[W]]:
        """n query indices, nbits bit-signals each (LSB first), drawing 63
        bits per transcript field element."""
        total = n * nbits
        n_fields = (total - 1) // 63 + 1
        bit_stream: list[W] = []
        for _ in range(n_fields):
            f = self.get_fields1()
            bits = self.b.bits(W({f: 1}), 64, strict=True)
            bit_stream.extend(bits[:63])
        res = []
        for i in range(n):
            res.append(bit_stream[i * nbits : (i + 1) * nbits])
        return res


def linear_hash(b: CircuitBuilder, vals: list[int]) -> list[int]:
    """Leaf hash of `vals` signal ids -> 4 signal ids (0 allowed for zero).
    Mirrors hash/linearhash_gl.py exactly (reference: starky/src/linearhash.rs)."""
    w = len(vals)
    if w <= 4:
        return vals + [0] * (4 - w)
    bs = max(8, -(-w // 4))
    hsz = -(-w // bs)
    chunks: list[int] = []
    for c in range(hsz):
        part = vals[c * bs : min((c + 1) * bs, w)]
        chunks.extend(_hash_rows(b, part))
    if hsz * 4 <= 4:
        return chunks[:4]
    return _hash_rows(b, chunks)


def _hash_rows(b: CircuitBuilder, vals: list[int]) -> list[int]:
    w = len(vals)
    if w <= 4:
        return vals + [0] * (4 - w)
    st = [0, 0, 0, 0]
    pos = 0
    while pos < w:
        block = vals[pos : pos + 8]
        block = block + [0] * (8 - len(block))
        st = b.poseidon(block + st)[:4]
        pos += 8
    return st


def merkle_verify(b: CircuitBuilder, root, vals: list[int],
                  siblings: list[list[int]], key_bits: list[W]):
    """Assert a Merkle group-proof in-circuit.

    root: 4 W wires; vals: leaf group signal ids; siblings: per level 4
    signal ids; key_bits: one bit wire per level (LSB first).  Mirrors
    hash/merkle_gl.py verify_group_proof / calculate_root_from_proof."""
    cur = linear_hash(b, vals)
    assert len(siblings) == len(key_bits)
    for lvl, sib in enumerate(siblings):
        bit = key_bits[lvl]
        left, right = [], []
        for i in range(4):
            c = W({cur[i]: 1}) if cur[i] else W()
            s = W({sib[i]: 1}) if sib[i] else W()
            l = b.mux(bit, c, s)   # bit ? sib : cur
            r = c + s - l
            left.append(b.materialize(l))
            right.append(b.materialize(r))
        cur = b.poseidon(left + right + [0, 0, 0, 0])[:4]
    for i in range(4):
        b.assert_eq(W({cur[i]: 1}), root[i])


def tree_selector(b: CircuitBuilder, values, key_bits: list[W]):
    """Select values[key] from 2^len(key_bits) F3 triples (TreeSelector)."""
    cur = list(values)
    for bit in key_bits:
        nxt = []
        for j in range(len(cur) // 2):
            v0, v1 = cur[2 * j], cur[2 * j + 1]
            nxt.append(tuple(b.mux(bit, v0[e], v1[e]) for e in range(3)))
        cur = nxt
    assert len(cur) == 1
    return cur[0]


def _ntt_fft4(b: CircuitBuilder, vals):
    """Forward NTT over F3 W-triples via FFT4 custom gates: radix-4 DIT
    stages (one gate per 4-point butterfly, 2 trace rows) plus one radix-2
    stage when log2(n) is odd (two 2-point butterflies per gate).  The
    pil-stark recursive circuits use the same gate for this (reference:
    compressor12_pil.rs FFT4 / starkinfo fft plan); the radix-2 lowering of
    the previous revision cost ~6 materialization gates per butterfly."""
    m = len(vals)
    if m == 1:
        return list(vals)
    nbits = m.bit_length() - 1
    w_m = _root_int(nbits)
    out = [None] * m
    if nbits % 2 == 0:
        # radix-4 DIT: X[t + k*m/4] from sub-NTTs of the 4 residue classes
        A = _ntt_fft4(b, vals[0::4])
        B = _ntt_fft4(b, vals[1::4])
        C = _ntt_fft4(b, vals[2::4])
        D = _ntt_fft4(b, vals[3::4])
        i4 = pow(w_m, m // 4, P)
        for t in range(m // 4):
            om = pow(w_m, t, P)
            om2 = om * om % P
            om3 = om2 * om % P
            consts = [1, i4 * om % P, om2, om3, om2, om3, 0,
                      (1 - i4) * om % P, (1 - i4) * om3 % P]
            o = b.fft4([A[t], B[t], C[t], D[t]], consts)
            out[t] = o[0]
            out[t + m // 4] = o[2]
            out[t + m // 2] = o[1]
            out[t + 3 * m // 4] = o[3]
    else:
        # odd log2: one radix-2 stage on top, two butterflies per gate
        E = _ntt_fft4(b, vals[0::2])
        F = _ntt_fft4(b, vals[1::2])
        half = m // 2
        if half == 1:  # m == 2: single linear butterfly, no gate needed
            return [tuple(E[0][e] + F[0][e] for e in range(3)),
                    tuple(E[0][e] - F[0][e] for e in range(3))]
        for t in range(0, half, 2):
            consts = [0, 0, 0, 0, 0, 0, 1,
                      pow(w_m, t, P), pow(w_m, t + 1, P)]
            o = b.fft4([E[t], F[t], E[t + 1], F[t + 1]], consts)
            out[t] = o[0]
            out[t + half] = o[1]
            out[t + 1] = o[2]
            out[t + 1 + half] = o[3]
    return out


def group_intt(b: CircuitBuilder, values) -> list:
    """iNTT over a list of F3 triples of W wires via FFT4 custom gates.
    Output matches poly/ntt.intt: forward NTT then index-reverse + 1/n
    (both free — pure linear-combination reindex/scale)."""
    n = len(values)
    nbits = n.bit_length() - 1
    assert 1 << nbits == n
    if n == 1:
        return list(values)
    if n <= 4:
        # small groups: dense linear combination, no gates at all
        w_inv = pow(_root_int(nbits), P - 2, P)
        n_inv = pow(n, P - 2, P)
        out = []
        for i in range(n):
            acc = [W(), W(), W()]
            for j in range(n):
                c = pow(w_inv, (i * j) % n, P) * n_inv % P
                for e in range(3):
                    acc[e] = acc[e] + values[j][e].scale(c)
            out.append(tuple(acc))
        return out

    buf = _ntt_fft4(b, list(values))
    n_inv = pow(n, P - 2, P)
    out = [tuple(x.scale(n_inv) for x in buf[0])]
    for i in range(n - 1, 0, -1):
        out.append(tuple(x.scale(n_inv) for x in buf[i]))
    return out


def _root_int(nbits: int) -> int:
    return int(gl.root_of_unity(nbits))


def eval_pol(b: CircuitBuilder, pol, x):
    """Horner evaluation of F3 coefficient triples at F3 x via EVPOL4
    custom gates: each gate folds four coefficients in two trace rows
    (vs four CMulAdd rows), top chunk zero-padded (reference: EvalPol
    template / compressor12_pil.rs EVPOL4)."""
    n = len(pol)
    if n == 1:
        return pol[0]
    if n <= 4:
        acc = pol[-1]
        for i in range(n - 2, -1, -1):
            acc = b.f3_mul(acc, x, pol[i])
        return acc
    zero = (W(), W(), W())
    padded = list(pol) + [zero] * (-n % 4)
    acc = zero
    for k in range(len(padded) - 4, -1, -4):
        acc = b.ev_pol4(padded[k : k + 4], x, acc)
    return acc
