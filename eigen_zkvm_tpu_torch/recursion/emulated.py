"""Non-native ("emulated") prime-field arithmetic over a SNARK scalar field.

The reference reaches BN254-inside-BLS12-381 through gnark's emulated-field
std library (recursion-gnark/ffi/go/eigen/recursion.go:30-82,
recursion-gnark/ffi/src/ffi/native.rs:32); this module is the native
equivalent used by the pairing wrap circuit: a foreign prime-field element
is a vector of limb wires over the host field, linear operations stay lazy
and limb-wise (free linear combinations), and every multiplicative identity
is enforced once per *output coefficient* with a hinted quotient/remainder
decomposition, binary range checks, and a 2^b-ary carry chain.

Cost model (the reason for the lazy design): with pure-R1CS bit range
checks, one modular reduction costs ~1k constraints regardless of how many
limb products feed it, so tower arithmetic (Fq2/Fq6/Fq12) accumulates raw
limb products unreduced and reduces once per output Fq coefficient.

Soundness sketch per reduction: every participating quantity (input limbs,
quotient limbs, remainder limbs, carries) is binary range-checked, static
signed bounds on every position are tracked and asserted to stay below
hostP/4, so each per-position linear constraint
    t_k + c_{k-1} - (q*p)_k - r_k == c_k * 2^b
holds over the integers, and their telescoped sum gives V == q*p + r
exactly, i.e. V === r (mod p).

Port of eigen_zkvm_tpu/recursion/emulated.py: the same limbs, hints,
range checks and carry chains, constraint for constraint, on the port's
recursion/circuit.py builder.
"""
from __future__ import annotations

from .circuit import CircuitBuilder


def _bits_fast(b: CircuitBuilder, w, value: int, n: int):
    """Range check 0 <= value < 2^n on wire `w` in O(n) direct appends.

    Equivalent to CircuitBuilder.bits(w, n, strict=False) but bypasses the
    per-bit W-object arithmetic (millions of these run per wrap circuit).
    """
    assert 0 <= value < (1 << n), (value, n)
    P = b.P
    wl = b.w
    base = len(wl)
    for i in range(n):
        wl.append((value >> i) & 1)
    if b.record:
        cons = b.constraints
        for i in range(n):
            s = base + i
            # bit * (bit - 1) == 0
            cons.append(({s: 1}, {s: 1, 0: P - 1}, {}))
        # sum(bit_i * 2^i) - w == 0
        c = {base + i: (1 << i) % P for i in range(n)}
        for s, coef in w.lc.items():
            nc = (c.get(s, 0) - coef) % P
            if nc:
                c[s] = nc
            elif s in c:
                del c[s]
        if w.k:
            nc = (c.get(0, 0) - w.k) % P
            if nc:
                c[0] = nc
            elif 0 in c:
                del c[0]
        cons.append(({}, {}, c))


def _lc_sum(Wc, terms, const: int = 0):
    """Fold [(wire, int coef)] + const into one wire in a single pass."""
    lc: dict = {}
    P = Wc.P
    k = const
    for w, coef in terms:
        coef %= P
        if coef == 0:
            continue
        if w.k:
            k += w.k * coef
        for s, c in w.lc.items():
            nc = (lc.get(s, 0) + c * coef) % P
            if nc:
                lc[s] = nc
            elif s in lc:
                del lc[s]
    return Wc(lc, k % P)


class EmuElem:
    """A foreign-field element: limb wires + exact signed integer witnesses
    and static per-limb bounds (lo <= ival <= hi, as plain ints)."""

    __slots__ = ("ws", "ivals", "los", "his")

    def __init__(self, ws, ivals, los, his):
        self.ws = ws
        self.ivals = ivals
        self.los = los
        self.his = his


class MulAcc:
    """Lazy accumulator in limb-product position space."""

    __slots__ = ("ws", "ivals", "los", "his")

    def __init__(self, npos: int):
        self.ws = [[] for _ in range(npos)]  # per-position (wire, coef)
        self.ivals = [0] * npos
        self.los = [0] * npos
        self.his = [0] * npos


class EmuField:
    """Factory for emulated arithmetic over prime `p` inside builder `b`."""

    def __init__(self, b: CircuitBuilder, p: int, limb_bits: int = 88,
                 n_limbs: int = 3):
        assert p < (1 << (limb_bits * n_limbs))
        self.b = b
        self.Wc = b.W
        self.p = p
        self.lb = limb_bits
        self.L = n_limbs
        self.mask = (1 << limb_bits) - 1
        self.p_limbs = self._int_limbs(p, n_limbs)
        self.top_bits = p.bit_length() - limb_bits * (n_limbs - 1)
        # signed position values must stay well inside the host field to
        # read unambiguously as integers
        self.max_abs = b.P // 4

    # ---- construction ----
    def _int_limbs(self, v: int, n: int):
        return [(v >> (self.lb * i)) & self.mask for i in range(n)]

    def const(self, v: int) -> EmuElem:
        v %= self.p
        ls = self._int_limbs(v, self.L)
        Wc = self.Wc
        return EmuElem([Wc(k=x) for x in ls], ls, list(ls), list(ls))

    def input(self, v: int, check: bool = True) -> EmuElem:
        """Allocate a fresh element from integer v (canonicalized mod p),
        range-checking each limb (top limb to the prime's residual width)."""
        v %= self.p
        ls = self._int_limbs(v, self.L)
        b = self.b
        ws, his = [], []
        for i, x in enumerate(ls):
            nbits = self.lb if i < self.L - 1 else self.top_bits
            w = b.wire(b.sig(x))
            if check:
                _bits_fast(b, w, x, nbits)
            ws.append(w)
            his.append((1 << nbits) - 1)
        return EmuElem(ws, ls, [0] * self.L, his)

    def from_wire(self, w, value: int) -> EmuElem:
        """Decompose an existing host-field wire (value < 2^(lb*L)) into a
        fresh range-checked limbed element, binding the limbs to the wire."""
        b = self.b
        ls = self._int_limbs(value, self.L)
        ws, his = [], []
        for i, x in enumerate(ls):
            nbits = self.lb if i < self.L - 1 else self.top_bits
            lw = b.wire(b.sig(x))
            _bits_fast(b, lw, x, nbits)
            ws.append(lw)
            his.append((1 << nbits) - 1)
        recomposed = _lc_sum(self.Wc,
                             [(lw, 1 << (self.lb * i))
                              for i, lw in enumerate(ws)])
        b.assert_zero(recomposed - w)
        return EmuElem(ws, ls, [0] * self.L, his)

    def val(self, x: EmuElem) -> int:
        return sum(iv << (self.lb * i) for i, iv in enumerate(x.ivals)) \
            % self.p

    # ---- linear ops (free) ----
    def add(self, x: EmuElem, y: EmuElem) -> EmuElem:
        return EmuElem([a + b for a, b in zip(x.ws, y.ws)],
                       [a + b for a, b in zip(x.ivals, y.ivals)],
                       [a + b for a, b in zip(x.los, y.los)],
                       [a + b for a, b in zip(x.his, y.his)])

    def sub(self, x: EmuElem, y: EmuElem) -> EmuElem:
        return EmuElem([a - b for a, b in zip(x.ws, y.ws)],
                       [a - b for a, b in zip(x.ivals, y.ivals)],
                       [a - b for a, b in zip(x.los, y.his)],
                       [a - b for a, b in zip(x.his, y.los)])

    def scale_int(self, x: EmuElem, c: int) -> EmuElem:
        bounds = [(lo * c, hi * c) for lo, hi in zip(x.los, x.his)]
        return EmuElem([w.scale(c % self.b.P) for w in x.ws],
                       [iv * c for iv in x.ivals],
                       [min(b_) for b_ in bounds], [max(b_) for b_ in bounds])

    def neg(self, x: EmuElem) -> EmuElem:
        return self.scale_int(x, -1)

    # ---- lazy multiplication ----
    def new_acc(self) -> MulAcc:
        return MulAcc(2 * self.L - 1)

    def acc_elem(self, acc: MulAcc, x: EmuElem, coef: int = 1):
        """acc += coef * x (coef a small signed int)."""
        if coef == 0:
            return
        P = self.b.P
        for i in range(self.L):
            acc.ws[i].append((x.ws[i], coef % P))
            acc.ivals[i] += x.ivals[i] * coef
            b1, b2 = x.los[i] * coef, x.his[i] * coef
            acc.los[i] += min(b1, b2)
            acc.his[i] += max(b1, b2)

    def raw_products(self, x: EmuElem, y: EmuElem):
        """Materialize the L*L limb products as wires (the only real
        multiplication constraints).  Returns a grid for reuse across the
        output coefficients of a tower multiplication."""
        b = self.b
        grid = []
        for i in range(self.L):
            row = []
            for j in range(self.L):
                xw, yw = x.ws[i], y.ws[j]
                iv = x.ivals[i] * y.ivals[j]
                cands = (x.los[i] * y.los[j], x.los[i] * y.his[j],
                         x.his[i] * y.los[j], x.his[i] * y.his[j])
                if xw.is_const:
                    w = yw.scale(xw.k)
                elif yw.is_const:
                    w = xw.scale(yw.k)
                else:
                    w = b.mul(xw, yw)
                row.append((w, iv, min(cands), max(cands)))
            grid.append(row)
        return grid

    def acc_products(self, acc: MulAcc, grid, coef: int = 1):
        """acc += coef * (x*y) given the raw product grid of (x, y)."""
        if coef == 0:
            return
        P = self.b.P
        for i in range(self.L):
            for j in range(self.L):
                w, iv, lo, hi = grid[i][j]
                k = i + j
                acc.ws[k].append((w, coef % P))
                acc.ivals[k] += iv * coef
                b1, b2 = lo * coef, hi * coef
                acc.los[k] += min(b1, b2)
                acc.his[k] += max(b1, b2)

    def acc_mul(self, acc: MulAcc, x: EmuElem, y: EmuElem, coef: int = 1):
        self.acc_products(acc, self.raw_products(x, y), coef)

    # ---- reduction ----
    def reduce(self, acc: MulAcc) -> EmuElem:
        """Enforce acc === r (mod p) for a fresh canonical-limbed r."""
        return self._reduce(acc, want_rem=True)

    def assert_zero(self, acc: MulAcc):
        """Enforce acc === 0 (mod p) (quotient witness only)."""
        self._reduce(acc, want_rem=False)

    def _reduce(self, acc: MulAcc, want_rem: bool):
        b = self.b
        Wc = self.Wc
        lb, L, p = self.lb, self.L, self.p
        two_lb = 1 << lb
        ivals, los, his = acc.ivals, acc.los, acc.his
        npos = len(ivals)
        while npos > 1 and not acc.ws[npos - 1] and ivals[npos - 1] == 0 \
                and los[npos - 1] == 0 and his[npos - 1] == 0:
            npos -= 1
        for lo, hi in zip(los, his):
            assert -self.max_abs < lo and hi < self.max_abs, \
                "emulated position bound overflows host field"

        V = sum(iv << (lb * i) for i, iv in enumerate(ivals))
        Vlo = sum(lo << (lb * i) for i, lo in enumerate(los))
        Vhi = sum(hi << (lb * i) for i, hi in enumerate(his))
        q, rem = divmod(V, p)
        if not want_rem:
            assert rem == 0, "emulated assert_zero violated at build time"

        # quotient witness, offset to non-negative, limb-decomposed
        qlo, qhi = Vlo // p - 1, Vhi // p + 1
        assert qlo <= q <= qhi
        qspan_bits = max(1, (qhi - qlo).bit_length())
        nql = (qspan_bits + lb - 1) // lb
        qshift = q - qlo
        q_ws, q_ivs, q_his = [], [], []
        for i in range(nql):
            nbits = min(lb, qspan_bits - lb * i)
            x = (qshift >> (lb * i)) & ((1 << nbits) - 1)
            w = b.wire(b.sig(x))
            _bits_fast(b, w, x, nbits)
            q_ws.append(w)
            q_ivs.append(x)
            q_his.append((1 << nbits) - 1)

        out = self.input(rem) if want_rem else None

        # constant product qlo * p, limb-decomposed with sign
        qlop = qlo * p
        mag = -qlop if qlop < 0 else qlop
        nconst = max(1, (mag.bit_length() + lb - 1) // lb)
        sign = -1 if qlop < 0 else 1
        qlop_limbs = [sign * ((mag >> (lb * i)) & self.mask)
                      for i in range(nconst)]

        # carry chain: t_k + c_{k-1} - (qshift*p)_k - qlop_k - r_k
        #              == c_k * 2^lb
        total_pos = max(npos, nql + L - 1, L, nconst)
        carry_w = None
        carry_iv = 0
        carry_lo = carry_hi = 0
        for k in range(total_pos):
            terms = []
            const = 0
            t_iv = 0
            t_lo = t_hi = 0
            if k < npos:
                terms.extend(acc.ws[k])
                t_iv += ivals[k]
                t_lo += los[k]
                t_hi += his[k]
            for i in range(max(0, k - L + 1), min(nql, k + 1)):
                pj = self.p_limbs[k - i]
                if pj:
                    terms.append((q_ws[i], -pj))
                    t_iv -= q_ivs[i] * pj
                    t_lo -= q_his[i] * pj
            if k < nconst and qlop_limbs[k]:
                const -= qlop_limbs[k]
                t_iv -= qlop_limbs[k]
                t_lo -= qlop_limbs[k]
                t_hi -= qlop_limbs[k]
            if out is not None and k < L:
                terms.append((out.ws[k], -1))
                t_iv -= out.ivals[k]
                t_lo -= out.his[k]
            if carry_w is not None:
                terms.append((carry_w, 1))
                t_iv += carry_iv
                t_lo += carry_lo
                t_hi += carry_hi
            if k == total_pos - 1:
                assert t_iv == 0, "emulated reduction does not telescope"
                b.assert_zero(_lc_sum(Wc, terms, const))
                carry_w = None
                continue
            assert t_iv % two_lb == 0, "carry misalignment"
            c_iv = t_iv >> lb
            c_lo = t_lo >> lb       # floor division (python >> floors)
            c_hi = (t_hi >> lb) + 1
            assert c_hi - c_lo < self.max_abs
            cw = b.wire(b.sig(c_iv % b.P))
            span_bits = max(1, (c_hi - c_lo).bit_length())
            _bits_fast(b, cw - Wc(k=c_lo % b.P), c_iv - c_lo, span_bits)
            terms.append((cw, -two_lb))
            b.assert_zero(_lc_sum(Wc, terms, const))
            carry_w, carry_iv, carry_lo, carry_hi = cw, c_iv, c_lo, c_hi
        return out

    # ---- conveniences ----
    def mul(self, x: EmuElem, y: EmuElem) -> EmuElem:
        acc = self.new_acc()
        self.acc_mul(acc, x, y)
        return self.reduce(acc)

    def assert_eq(self, x: EmuElem, y: EmuElem):
        acc = self.new_acc()
        self.acc_elem(acc, x, 1)
        self.acc_elem(acc, y, -1)
        self.assert_zero(acc)

    def div(self, x: EmuElem, y: EmuElem) -> EmuElem:
        """Witnessed division: z with z*y == x (requires y != 0 mod p)."""
        yv = self.val(y)
        z = self.input(self.val(x) * pow(yv, -1, self.p) % self.p)
        acc = self.new_acc()
        self.acc_mul(acc, z, y)
        self.acc_elem(acc, x, -1)
        self.assert_zero(acc)
        return z

    def inv(self, x: EmuElem) -> EmuElem:
        return self.div(self.const(1), x)
