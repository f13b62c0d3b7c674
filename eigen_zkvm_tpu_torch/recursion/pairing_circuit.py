"""BN254 optimal-ate pairing verification as a native circuit over a
foreign SNARK field (the gnark-bridge equivalent's core).

The reference wraps a BN254 Groth16 proof inside a BLS12-381 circuit via
gnark's std pairing library (recursion-gnark/ffi/go/eigen/recursion.go:30-82,
recursion-gnark/ffi/src/ffi/native.rs:32).  This module rebuilds that
capability natively on top of `emulated.EmuField`:

- Fq2/Fq6/Fq12 tower arithmetic in *flat* coefficient form: an Fq12 element
  is 12 emulated-Fq coefficients (basis u^e1 v^e2 w^e3, index
  m = e1 + 2 e2 + 6 e3), multiplied through a precomputed 204-term bilinear
  table so each product costs one lazy reduction per *output* coefficient;
- affine G1/G2 arithmetic with witnessed divisions (a division is one hint
  plus one quotient-only reduction - same cost as a multiplication);
- the optimal-ate Miller loop with the *same schedule and line formulas* as
  the value-space implementation (curves/bn254.py:400-446) so every
  intermediate witness is differentially checkable;
- NO in-circuit final exponentiation: following the residue-witness
  technique ("On Proving Pairings", Novakovic-Eagen 2024; gnark's
  millerLoopAndCheckFinalExp), the prover supplies c and a 27th root of
  unity w with  f_miller * w == c^lambda,  lambda = 6x+2 + q - q^2 + q^3.
  Since lambda = m*r and 27 | (q^12-1)/r, this certifies
  f_miller^((q^12-1)/r) == 1 at the cost of folding c^-(6x+2) into the
  Miller loop plus three Frobenius powers of c (all cheap), replacing a
  ~760-bit in-circuit exponentiation.

Soundness of the residue check:  f*w = c^lambda, w^27 = 1  ==>
f^h = c^(lambda h) w^-h with h = (q^12-1)/r; lambda h = (lambda/r)(q^12-1)
kills the c term and 27 | h kills the w term, so f^h = 1.  Completeness and
the witness construction are validated numerically in tests/test_torch_gnark_bridge.py.

Port of eigen_zkvm_tpu/recursion/pairing_circuit.py: the same bilinear
table, gadgets, Miller schedule and residue witness, constraint for
constraint, on the port's curves/bn254.py and recursion/emulated.py.
"""
from __future__ import annotations

from ..curves import bn254 as bn
from .emulated import EmuElem, EmuField, _lc_sum

Q = bn.P
X = bn.X_BN
LAMBDA = 6 * X + 2 + Q - Q * Q + Q ** 3
N_GROUP = Q ** 12 - 1
K_COFACTOR = N_GROUP // 27 // bn.R          # q^12-1 = 27 * r * k
_LOOP_BITS = bin(6 * X + 2)[3:]             # curves/bn254.py:428


# ---------------------------------------------------------------------------
# flat Fq12 representation and the bilinear multiplication table
# ---------------------------------------------------------------------------

def _reduce_basis(coef, e1, e2, e3, out):
    if e3 >= 2:
        _reduce_basis(coef, e1, e2 + 1, e3 - 2, out)      # w^2 = v
        return
    if e2 >= 3:
        _reduce_basis(coef * 9, e1, e2 - 3, e3, out)       # v^3 = 9 + u
        _reduce_basis(coef, e1 + 1, e2 - 3, e3, out)
        return
    if e1 >= 2:
        _reduce_basis(-coef, e1 - 2, e2, e3, out)          # u^2 = -1
        return
    m = e1 + 2 * e2 + 6 * e3
    out[m] = out.get(m, 0) + coef


def _build_table():
    tab = {}
    for i in range(12):
        e1i, ri = i % 2, i // 2
        for j in range(12):
            e1j, rj = j % 2, j // 2
            out: dict = {}
            _reduce_basis(1, e1i + e1j, ri % 3 + rj % 3, ri // 3 + rj // 3,
                          out)
            tab[(i, j)] = {m: c for m, c in out.items() if c}
    return tab


TABLE12 = _build_table()


def flat12(f12):
    """Nested bn254 tuple rep -> 12 flat ints (m = e1 + 2 e2 + 6 e3)."""
    v = [0] * 12
    for e3 in range(2):
        for e2 in range(3):
            for e1 in range(2):
                v[e1 + 2 * e2 + 6 * e3] = f12[e3][e2][e1]
    return v


def unflat12(v):
    return tuple(tuple(tuple(v[e1 + 2 * e2 + 6 * e3] for e1 in range(2))
                       for e2 in range(3)) for e3 in range(2))


def _frob_matrix(n: int):
    """Frobenius^n as an Fp-linear 12x12 constant matrix on flat coeffs."""
    cols = []
    for m in range(12):
        basis = [0] * 12
        basis[m] = 1
        img = unflat12(basis)
        for _ in range(n):
            img = bn.f12_frobenius(img)
        cols.append(flat12(img))
    # K[m][m'] = coefficient of output m from input m'
    return [[cols[mp][m] for mp in range(12)] for m in range(12)]


FROB1 = _frob_matrix(1)
FROB2 = _frob_matrix(2)
FROB3 = _frob_matrix(3)


# ---------------------------------------------------------------------------
# residue witness (host side)
# ---------------------------------------------------------------------------

_W27_CACHE = None


def w27_constant():
    """Deterministic generator of mu_27 in Fq12."""
    global _W27_CACHE
    if _W27_CACHE is None:
        seed = 0
        while True:
            seed += 1
            u = unflat12([seed + i * i + 1 for i in range(12)])
            w = bn.f12_pow(u, N_GROUP // 27)
            if bn.f12_pow(w, 9) != bn.F12_ONE:
                _W27_CACHE = w
                break
    return _W27_CACHE


def residue_witness(f):
    """Given a Miller-loop product f with f^((q^12-1)/r) == 1, return
    (c, j) with  f * w27^j == c^LAMBDA.  Raises ValueError when f is not a
    valid pairing product (witness generation is the completeness proof)."""
    w27 = w27_constant()
    k = K_COFACTOR
    kinv27 = pow(k % 27, -1, 27)
    f3 = bn.f12_pow(f, k * kinv27)          # mu27 component of f
    w = bn.f12_inv(f3)
    cur = bn.F12_ONE
    j = None
    for i in range(27):
        if cur == w:
            j = i
            break
        cur = bn.f12_mul(cur, w27)
    if j is None:
        raise ValueError("not a valid pairing product (mu27 projection)")
    fp = bn.f12_mul(f, w)
    if bn.f12_pow(fp, k) != bn.F12_ONE:
        raise ValueError("not a valid pairing product (r-part nonzero)")
    c = bn.f12_pow(fp, pow(LAMBDA % k, -1, k))
    assert bn.f12_pow(c, LAMBDA) == fp, "residue witness construction failed"
    return c, j


# ---------------------------------------------------------------------------
# circuit context
# ---------------------------------------------------------------------------

class PairingCircuit:
    """BN254 tower/curve/pairing gadgets over one EmuField instance.

    Fq values are EmuElem; Fq2 points/values are 2-lists; Fq12 values are
    12-lists of (EmuElem | None) in flat coefficient order (None == 0).
    """

    def __init__(self, b):
        self.b = b
        self.F = EmuField(b, Q)

    # ---- Fq12 basics ----
    def f12_input(self, v12):
        flat = flat12(v12)
        return [self.F.input(x) for x in flat]

    def f12_const(self, v12):
        return [self.F.const(x) if x else None for x in flat12(v12)]

    def f12_val(self, a):
        return unflat12([0 if x is None else self.F.val(x) for x in a])

    def _grids(self, cache, ai, bj):
        key = (id(ai), id(bj))
        g = cache.get(key)
        if g is None:
            gt = cache.get((id(bj), id(ai)))
            if gt is not None:
                L = self.F.L
                g = [[gt[j][i] for j in range(L)] for i in range(L)]
            else:
                g = self.F.raw_products(ai, bj)
            cache[key] = g
        return g

    def _mul12_accs(self, a, b):
        F = self.F
        accs = [None] * 12
        cache: dict = {}
        for i, ai in enumerate(a):
            if ai is None:
                continue
            for j, bj in enumerate(b):
                if bj is None:
                    continue
                grid = self._grids(cache, ai, bj)
                for m, k in TABLE12[(i, j)].items():
                    if accs[m] is None:
                        accs[m] = F.new_acc()
                    F.acc_products(accs[m], grid, k)
        return accs

    def f12_mul(self, a, b):
        F = self.F
        return [F.reduce(acc) if acc is not None else None
                for acc in self._mul12_accs(a, b)]

    def f12_sq(self, a):
        return self.f12_mul(a, a)

    def f12_mul_assert_const(self, a, b, expect12):
        """Assert a*b == expect (a constant Fq12 value) without allocating
        the product (quotient-only reductions)."""
        F = self.F
        accs = self._mul12_accs(a, b)
        exp = flat12(expect12)
        for m in range(12):
            acc = accs[m] if accs[m] is not None else F.new_acc()
            if exp[m]:
                F.acc_elem(acc, F.const(exp[m]), -1)
            F.assert_zero(acc)

    def f12_frobenius(self, a, mat):
        """Apply a constant Fp-linear map (Frobenius power) to flat a."""
        F = self.F
        accs = [None] * 12
        for mp, amp in enumerate(a):
            if amp is None:
                continue
            for m in range(12):
                kconst = mat[m][mp]
                if not kconst:
                    continue
                if accs[m] is None:
                    accs[m] = F.new_acc()
                F.acc_mul(accs[m], F.const(kconst), amp)
        return [F.reduce(acc) if acc is not None else None for acc in accs]

    # ---- Fq2 ----
    def fq2_input(self, v):
        return [self.F.input(v[0]), self.F.input(v[1])]

    def fq2_const(self, v):
        return [self.F.const(v[0]), self.F.const(v[1])]

    def fq2_val(self, a):
        return (self.F.val(a[0]), self.F.val(a[1]))

    def fq2_add(self, a, b):
        return [self.F.add(a[0], b[0]), self.F.add(a[1], b[1])]

    def fq2_sub(self, a, b):
        return [self.F.sub(a[0], b[0]), self.F.sub(a[1], b[1])]

    def fq2_neg(self, a):
        return [self.F.neg(a[0]), self.F.neg(a[1])]

    def fq2_scale_int(self, a, c):
        return [self.F.scale_int(a[0], c), self.F.scale_int(a[1], c)]

    def fq2_mul(self, a, b):
        F = self.F
        g00 = F.raw_products(a[0], b[0])
        g11 = F.raw_products(a[1], b[1])
        g01 = F.raw_products(a[0], b[1])
        g10 = F.raw_products(a[1], b[0])
        acc0 = F.new_acc()
        F.acc_products(acc0, g00, 1)
        F.acc_products(acc0, g11, -1)
        acc1 = F.new_acc()
        F.acc_products(acc1, g01, 1)
        F.acc_products(acc1, g10, 1)
        return [F.reduce(acc0), F.reduce(acc1)]

    def fq2_sq(self, a):
        F = self.F
        g00 = F.raw_products(a[0], a[0])
        g11 = F.raw_products(a[1], a[1])
        g01 = F.raw_products(a[0], a[1])
        acc0 = F.new_acc()
        F.acc_products(acc0, g00, 1)
        F.acc_products(acc0, g11, -1)
        acc1 = F.new_acc()
        F.acc_products(acc1, g01, 2)
        return [F.reduce(acc0), F.reduce(acc1)]

    def fq2_div(self, x, y):
        """Witnessed z = x / y in Fq2: constrain z*y == x."""
        F = self.F
        xv, yv = self.fq2_val(x), self.fq2_val(y)
        zv = bn.f2_mul(xv, bn.f2_inv(yv))
        z = [F.input(zv[0]), F.input(zv[1])]
        g00 = F.raw_products(z[0], y[0])
        g11 = F.raw_products(z[1], y[1])
        g01 = F.raw_products(z[0], y[1])
        g10 = F.raw_products(z[1], y[0])
        acc0 = F.new_acc()
        F.acc_products(acc0, g00, 1)
        F.acc_products(acc0, g11, -1)
        F.acc_elem(acc0, x[0], -1)
        F.assert_zero(acc0)
        acc1 = F.new_acc()
        F.acc_products(acc1, g01, 1)
        F.acc_products(acc1, g10, 1)
        F.acc_elem(acc1, x[1], -1)
        F.assert_zero(acc1)
        return z

    def fq2_mul_fq(self, a, x):
        """Fq2 * Fq -> Fq2 (two reductions)."""
        F = self.F
        return [F.mul(a[0], x), F.mul(a[1], x)]

    def fq2_assert_eq(self, a, b):
        self.F.assert_eq(a[0], b[0])
        self.F.assert_eq(a[1], b[1])

    # ---- G1 (affine, incomplete formulas, witnessed slopes) ----
    def g1_input(self, pt):
        return (self.F.input(pt[0]), self.F.input(pt[1]))

    def g1_const(self, pt):
        return (self.F.const(pt[0]), self.F.const(pt[1]))

    def g1_val(self, pt):
        return (self.F.val(pt[0]), self.F.val(pt[1]))

    def g1_neg(self, pt):
        return (pt[0], self.F.neg(pt[1]))

    def g1_assert_on_curve(self, pt):
        """y^2 == x^3 + 3."""
        F = self.F
        x, y = pt
        x2 = F.mul(x, x)
        acc = F.new_acc()
        F.acc_mul(acc, x2, x)
        F.acc_mul(acc, y, y, -1)
        F.acc_elem(acc, F.const(3), 1)
        F.assert_zero(acc)

    def g1_add(self, p1, p2):
        """Incomplete affine addition (x1 != x2 assumed for honest traces)."""
        F = self.F
        x1, y1 = p1
        x2, y2 = p2
        lam = F.div(F.sub(y2, y1), F.sub(x2, x1))
        acc = F.new_acc()
        F.acc_mul(acc, lam, lam)
        F.acc_elem(acc, x1, -1)
        F.acc_elem(acc, x2, -1)
        x3 = F.reduce(acc)
        acc = F.new_acc()
        F.acc_mul(acc, lam, F.sub(x1, x3))
        F.acc_elem(acc, y1, -1)
        y3 = F.reduce(acc)
        return (x3, y3)

    # ---- G2 (affine over Fq2) ----
    def g2_input(self, pt):
        return (self.fq2_input(pt[0]), self.fq2_input(pt[1]))

    def g2_const(self, pt):
        return (self.fq2_const(pt[0]), self.fq2_const(pt[1]))

    def g2_val(self, pt):
        return (self.fq2_val(pt[0]), self.fq2_val(pt[1]))

    def g2_assert_on_curve(self, pt):
        """y^2 == x^3 + 3/(9+u) on the D-twist (curves/bn254.py:380)."""
        F = self.F
        xx, yy = pt
        btw = bn.f2_mul((3, 0), bn.f2_inv((9, 1)))
        x2 = self.fq2_sq(xx)
        # x^3 - y^2 + btw == 0, coefficientwise
        g0 = F.raw_products(x2[0], xx[0])
        g1_ = F.raw_products(x2[1], xx[1])
        g01 = F.raw_products(x2[0], xx[1])
        g10 = F.raw_products(x2[1], xx[0])
        y0 = F.raw_products(yy[0], yy[0])
        y1_ = F.raw_products(yy[1], yy[1])
        y01 = F.raw_products(yy[0], yy[1])
        acc0 = F.new_acc()
        F.acc_products(acc0, g0, 1)
        F.acc_products(acc0, g1_, -1)
        F.acc_products(acc0, y0, -1)
        F.acc_products(acc0, y1_, 1)
        F.acc_elem(acc0, F.const(btw[0]), 1)
        F.assert_zero(acc0)
        acc1 = F.new_acc()
        F.acc_products(acc1, g01, 1)
        F.acc_products(acc1, g10, 1)
        F.acc_products(acc1, y01, -2)
        F.acc_elem(acc1, F.const(btw[1]), 1)
        F.assert_zero(acc1)

    def g2_double(self, T, need_line: bool = True):
        """Affine doubling with a witnessed slope (one hint + two
        quotient-only reductions instead of square+divide); returns
        (T2, lam, c) with the line through T being y = lam*x + c
        (curves/bn254.py:400)."""
        F = self.F
        xT, yT = T
        xv, yv = self.fq2_val(xT), self.fq2_val(yT)
        lamv = bn.f2_mul(bn.f2_smul(bn.f2_sq(xv), 3),
                         bn.f2_inv(bn.f2_smul(yv, 2)))
        lam = [F.input(lamv[0]), F.input(lamv[1])]
        # constrain lam * 2y - 3 x^2 == 0 componentwise
        ly00 = F.raw_products(lam[0], yT[0])
        ly11 = F.raw_products(lam[1], yT[1])
        ly01 = F.raw_products(lam[0], yT[1])
        ly10 = F.raw_products(lam[1], yT[0])
        xx00 = F.raw_products(xT[0], xT[0])
        xx11 = F.raw_products(xT[1], xT[1])
        xx01 = F.raw_products(xT[0], xT[1])
        acc0 = F.new_acc()
        F.acc_products(acc0, ly00, 2)
        F.acc_products(acc0, ly11, -2)
        F.acc_products(acc0, xx00, -3)
        F.acc_products(acc0, xx11, 3)
        F.assert_zero(acc0)
        acc1 = F.new_acc()
        F.acc_products(acc1, ly01, 2)
        F.acc_products(acc1, ly10, 2)
        F.acc_products(acc1, xx01, -6)
        F.assert_zero(acc1)
        return self._g2_finish(T, T, lam, need_line)

    def g2_add(self, T, Q2, need_line: bool = True):
        F = self.F
        xT, yT = T
        dxv = bn.f2_sub(self.fq2_val(xT), self.fq2_val(Q2[0]))
        dyv = bn.f2_sub(self.fq2_val(yT), self.fq2_val(Q2[1]))
        lamv = bn.f2_mul(dyv, bn.f2_inv(dxv))
        lam = [F.input(lamv[0]), F.input(lamv[1])]
        # constrain lam * (xT - xQ) - (yT - yQ) == 0
        dx = self.fq2_sub(xT, Q2[0])
        dy = self.fq2_sub(yT, Q2[1])
        g00 = F.raw_products(lam[0], dx[0])
        g11 = F.raw_products(lam[1], dx[1])
        g01 = F.raw_products(lam[0], dx[1])
        g10 = F.raw_products(lam[1], dx[0])
        acc0 = F.new_acc()
        F.acc_products(acc0, g00, 1)
        F.acc_products(acc0, g11, -1)
        F.acc_elem(acc0, dy[0], -1)
        F.assert_zero(acc0)
        acc1 = F.new_acc()
        F.acc_products(acc1, g01, 1)
        F.acc_products(acc1, g10, 1)
        F.acc_elem(acc1, dy[1], -1)
        F.assert_zero(acc1)
        return self._g2_finish(T, Q2, lam, need_line)

    def _g2_finish(self, T, Q2, lam, need_line: bool = True):
        F = self.F
        xT, yT = T
        # x3 = lam^2 - xT - xQ ; y3 = lam (xT - x3) - yT ; c = yT - lam xT
        ll00 = F.raw_products(lam[0], lam[0])
        ll11 = F.raw_products(lam[1], lam[1])
        ll01 = F.raw_products(lam[0], lam[1])
        accx0 = F.new_acc()
        F.acc_products(accx0, ll00, 1)
        F.acc_products(accx0, ll11, -1)
        F.acc_elem(accx0, xT[0], -1)
        F.acc_elem(accx0, Q2[0][0], -1)
        accx1 = F.new_acc()
        F.acc_products(accx1, ll01, 2)
        F.acc_elem(accx1, xT[1], -1)
        F.acc_elem(accx1, Q2[0][1], -1)
        x3 = [F.reduce(accx0), F.reduce(accx1)]
        dm = self.fq2_sub(xT, x3)
        g00 = F.raw_products(lam[0], dm[0])
        g11 = F.raw_products(lam[1], dm[1])
        g01 = F.raw_products(lam[0], dm[1])
        g10 = F.raw_products(lam[1], dm[0])
        acc0 = F.new_acc()
        F.acc_products(acc0, g00, 1)
        F.acc_products(acc0, g11, -1)
        F.acc_elem(acc0, yT[0], -1)
        acc1 = F.new_acc()
        F.acc_products(acc1, g01, 1)
        F.acc_products(acc1, g10, 1)
        F.acc_elem(acc1, yT[1], -1)
        y3 = [F.reduce(acc0), F.reduce(acc1)]
        if not need_line:
            return (x3, y3), lam, None
        # c = yT - lam*xT
        h00 = F.raw_products(lam[0], xT[0])
        h11 = F.raw_products(lam[1], xT[1])
        h01 = F.raw_products(lam[0], xT[1])
        h10 = F.raw_products(lam[1], xT[0])
        accc0 = F.new_acc()
        F.acc_elem(accc0, yT[0], 1)
        F.acc_products(accc0, h00, -1)
        F.acc_products(accc0, h11, 1)
        accc1 = F.new_acc()
        F.acc_elem(accc1, yT[1], 1)
        F.acc_products(accc1, h01, -1)
        F.acc_products(accc1, h10, -1)
        c = [F.reduce(accc0), F.reduce(accc1)]
        return (x3, y3), lam, c

    def _elem_acc(self, e):
        acc = self.F.new_acc()
        self.F.acc_elem(acc, e, 1)
        return acc

    # ---- line evaluation (matches curves/bn254.py:400-419) ----
    def line_eval_var(self, lam, c, xP, yP):
        """l(P) = yP - (lam xP) w - c w^3 as a sparse flat Fq12:
        nonzero coefficients at m in {0, 6, 7, 8, 9}."""
        F = self.F
        lxp = [F.mul(lam[0], xP), F.mul(lam[1], xP)]
        out = [None] * 12
        out[0] = yP
        out[6] = F.neg(lxp[0])
        out[7] = F.neg(lxp[1])
        out[8] = F.neg(c[0])
        out[9] = F.neg(c[1])
        return out

    def line_eval_const(self, lam_c, c_c, xP, yP):
        """Line with CONSTANT slope/intercept (fixed G2 chain) evaluated at
        a variable G1 point: all coefficients linear in xP/yP, but the big
        constant products need one reduction each for the w-coefficients."""
        F = self.F
        lxp0 = self._const_times(lam_c[0], xP)
        lxp1 = self._const_times(lam_c[1], xP)
        out = [None] * 12
        out[0] = yP
        out[6] = F.neg(lxp0)
        out[7] = F.neg(lxp1)
        out[8] = F.const((-c_c[0]) % Q) if c_c[0] else None
        out[9] = F.const((-c_c[1]) % Q) if c_c[1] else None
        return out

    def _const_times(self, const_int, x):
        if const_int == 0:
            return self.F.const(0)
        acc = self.F.new_acc()
        self.F.acc_mul(acc, self.F.const(const_int), x)
        return self.F.reduce(acc)

    # ---- G2 subgroup membership: psi(Q) == [6x^2] Q ----
    def g2_assert_in_subgroup(self, Qpt):
        """BN254 G2 membership (Scott): psi(Q) == [6x^2]Q, with
        psi(x, y) = (conj(x) G12, conj(y) G13) (curves/bn254.py:439-440)."""
        F = self.F
        xq, yq = Qpt
        # psi(Q): conj is free (negate imaginary part), gamma mults reduce
        cx = [xq[0], F.neg(xq[1])]
        cy = [yq[0], F.neg(yq[1])]
        g12, g13 = bn._G12, bn._G13
        psi_x = self._fq2_const_mul(g12, cx)
        psi_y = self._fq2_const_mul(g13, cy)
        # [6x^2]Q by double-and-add over the fixed scalar
        s = 6 * X * X
        acc = Qpt
        for bit in bin(s)[3:]:
            acc, _, _ = self.g2_double(acc, need_line=False)
            if bit == "1":
                acc, _, _ = self.g2_add(acc, Qpt, need_line=False)
        self.fq2_assert_eq(psi_x, acc[0])
        self.fq2_assert_eq(psi_y, acc[1])

    def _fq2_const_mul(self, kconst, a):
        """(k0 + k1 u) * (a0 + a1 u) with constant k: free products."""
        F = self.F
        k0, k1 = kconst
        acc0 = F.new_acc()
        F.acc_mul(acc0, F.const(k0), a[0])
        F.acc_mul(acc0, F.const(k1), a[1], -1)
        acc1 = F.new_acc()
        F.acc_mul(acc1, F.const(k0), a[1])
        F.acc_mul(acc1, F.const(k1), a[0])
        return [F.reduce(acc0), F.reduce(acc1)]


# ---------------------------------------------------------------------------
# fixed-G2 line precomputation (host side)
# ---------------------------------------------------------------------------

def precompute_lines(Qg2):
    """Run the Miller schedule on a constant G2 point, returning the
    (lam, c) Fq2 constants per step: [('d'|'a', lam, c), ...] followed by
    the two Frobenius end-lines (curves/bn254.py:421-445)."""
    def slope_dbl(T):
        return bn.f2_mul(bn.f2_smul(bn.f2_sq(T[0]), 3),
                         bn.f2_inv(bn.f2_smul(T[1], 2)))

    def slope_add(T, Q2):
        return bn.f2_mul(bn.f2_sub(T[1], Q2[1]),
                         bn.f2_inv(bn.f2_sub(T[0], Q2[0])))

    def step(T, lam):
        c = bn.f2_sub(T[1], bn.f2_mul(lam, T[0]))
        return c

    lines = []
    T = Qg2
    for bchar in _LOOP_BITS:
        lam = slope_dbl(T)
        lines.append(("d", lam, step(T, lam)))
        T = bn.g2_to_affine(bn.g2_double(bn.g2_from_affine(T)))
        if bchar == "1":
            lam = slope_add(T, Qg2)
            lines.append(("a", lam, step(T, lam)))
            T = bn.g2_to_affine(bn.g2_add(bn.g2_from_affine(T),
                                          bn.g2_from_affine(Qg2)))
    q1 = (bn.f2_mul(bn.f2_conj(Qg2[0]), bn._G12),
          bn.f2_mul(bn.f2_conj(Qg2[1]), bn._G13))
    lam = slope_add(T, q1)
    lines.append(("f", lam, step(T, lam)))
    T = bn.g2_to_affine(bn.g2_add(bn.g2_from_affine(T), bn.g2_from_affine(q1)))
    q2 = (bn.f2_mul(Qg2[0], bn._G22), bn.f2_mul(Qg2[1], bn._G23))
    q2n = (q2[0], bn.f2_neg(q2[1]))
    lam = slope_add(T, q2n)
    lines.append(("f", lam, step(T, lam)))
    return lines


def miller_loop_and_residue_check(pc: PairingCircuit, var_pair, fixed_pairs,
                                  const_f12, c_elem, c_inv_elem, w_sel):
    """The heart of the bridge: assert

        [prod of miller loops] * const_f12 * w == c^LAMBDA

    where `var_pair` = (P_g1_elems, Q_g2_elems) is the variable-G2 pair,
    `fixed_pairs` = [(P_g1_elems, lines_const), ...] are variable-G1 /
    constant-G2 pairs with precomputed lines, `const_f12` folds the fully
    constant pairs (e.g. miller(-alpha, beta)), and w = sum_j w_sel[j] *
    w27^j is the one-hot-selected 27th root of unity.

    c^-(6x+2) rides the Miller schedule (one extra f12 mul per set bit);
    the q/q^2/q^3 components are Frobenius images of c / c_inv.
    """
    F = pc.F
    Pg1, Qg2 = var_pair
    xP, yP = Pg1
    T = Qg2
    fixed_iters = [iter(lines) for _, lines in fixed_pairs]
    f = c_inv_elem                       # leading bit of 6x+2
    for bchar in _LOOP_BITS:
        f = pc.f12_sq(f)
        T2, lam, c = pc.g2_double(T)
        f = pc.f12_mul(f, pc.line_eval_var(lam, c, xP, yP))
        T = T2
        for (Pf, _), it in zip(fixed_pairs, fixed_iters):
            kind, lamc, cc = next(it)
            assert kind == "d"
            f = pc.f12_mul(f, pc.line_eval_const(lamc, cc, Pf[0], Pf[1]))
        if bchar == "1":
            f = pc.f12_mul(f, c_inv_elem)
            Ta, lam, c = pc.g2_add(T, Qg2)
            f = pc.f12_mul(f, pc.line_eval_var(lam, c, xP, yP))
            T = Ta
            for (Pf, _), it in zip(fixed_pairs, fixed_iters):
                kind, lamc, cc = next(it)
                assert kind == "a"
                f = pc.f12_mul(f, pc.line_eval_const(lamc, cc, Pf[0], Pf[1]))
    # frobenius end-lines for the variable pair: q1 = psi(Q), q2n
    Qv = pc.g2_val(Qg2)
    q1v = (bn.f2_mul(bn.f2_conj(Qv[0]), bn._G12),
           bn.f2_mul(bn.f2_conj(Qv[1]), bn._G13))
    # in-circuit q1 from Q (conj free, constant gamma mult)
    q1 = (pc._fq2_const_mul(bn._G12, [Qg2[0][0], F.neg(Qg2[0][1])]),
          pc._fq2_const_mul(bn._G13, [Qg2[1][0], F.neg(Qg2[1][1])]))
    assert pc.g2_val(q1) == q1v
    Tq, lam, c = pc.g2_add(T, q1)
    f = pc.f12_mul(f, pc.line_eval_var(lam, c, xP, yP))
    T = Tq
    q2n = (pc._fq2_const_mul(bn._G22, Qg2[0]),
           [x for x in pc._fq2_const_mul(bn._G23, Qg2[1])])
    q2n = (q2n[0], pc.fq2_neg(q2n[1]))
    _, lam, c = pc.g2_add(T, q2n)
    f = pc.f12_mul(f, pc.line_eval_var(lam, c, xP, yP))
    for (Pf, _), it in zip(fixed_pairs, fixed_iters):
        for _ in range(2):
            kind, lamc, cc = next(it)
            assert kind == "f"
            f = pc.f12_mul(f, pc.line_eval_const(lamc, cc, Pf[0], Pf[1]))
    # fold the constant pairs
    if const_f12 is not None:
        f = pc.f12_mul(f, pc.f12_const(const_f12))
    # f now equals miller_total * c^-(6x+2).  Multiply the Frobenius parts:
    # c^lambda = c^(6x+2) * c^q * c^-(q^2) * c^(q^3)
    # ==> check f * w * frob1(c_inv) * frob2(c) * frob3(c_inv) == 1
    f = pc.f12_mul(f, w_sel)
    f = pc.f12_mul(f, pc.f12_frobenius(c_inv_elem, FROB1))
    f = pc.f12_mul(f, pc.f12_frobenius(c_elem, FROB2))
    pc.f12_mul_assert_const(f, pc.f12_frobenius(c_inv_elem, FROB3),
                            bn.F12_ONE)


def one_hot_w27(pc: PairingCircuit, j: int):
    """Allocate 27 boolean selectors summing to 1 and return the selected
    w27^j as a flat Fq12 of lc-limbed elements (selection itself is free)."""
    b = pc.b
    F = pc.F
    Wc = b.W
    powers = []
    cur = bn.F12_ONE
    for _ in range(27):
        powers.append(flat12(cur))
        cur = bn.f12_mul(cur, w27_constant())
    sels = []
    for i in range(27):
        v = 1 if i == j else 0
        s = b.sig(v)
        w = b.wire(s)
        if b.record:
            b.constraints.append(({s: 1}, {s: 1, 0: b.P - 1}, {}))
        sels.append(w)
    b.assert_zero(_lc_sum(Wc, [(w, 1) for w in sels], -1))
    out = []
    for m in range(12):
        limbs_ws = []
        ivals = [0] * F.L
        his = [0] * F.L
        for l in range(F.L):
            terms = []
            for i, w in enumerate(sels):
                limb = (powers[i][m] >> (F.lb * l)) & F.mask
                if limb:
                    terms.append((w, limb))
                    his[l] += limb
                if i == j:
                    ivals[l] = limb
            limbs_ws.append(_lc_sum(Wc, terms))
        out.append(EmuElem(limbs_ws, ivals, [0] * F.L, his))
    return out
