"""BN254 (alt_bn128) curve arithmetic + optimal-ate pairing on Python ints.

The port's own copy of eigen_zkvm_tpu/curves/bn254.py (the port imports
nothing of that package): the constants, Fq2/Fq6/Fq12, G1/G2 in Jacobian
coordinates, the affine helpers and the pairing that Groth16's verifier
runs on the host.  The batched device arithmetic is ops/bigint.py and
ops/ec.py.

Tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - (9+u)),
Fq12 = Fq6[w]/(w^2 - v).  G2 lives on the D-type sextic twist
y^2 = x^3 + 3/(9+u).
"""
from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3
X_BN = 4965661367192848881  # BN parameter; loop count 6x+2

G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

# ---- Fq ----

def finv(a: int) -> int:
    return pow(a, P - 2, P)


def batch_inv(xs: list, m: int = P) -> list:
    """x^-1 mod m for each x (0 -> 0) with one pow (Montgomery's trick)."""
    pre, acc = [], 1
    for x in xs:
        pre.append(acc)
        acc = acc * (x or 1) % m
    inv = pow(acc, m - 2, m)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        if xs[i]:
            out[i] = inv * pre[i] % m
            inv = inv * xs[i] % m
    return out


# ---- Fq2: a + b*u, u^2 = -1 ----

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_smul(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_sq(a):
    t = a[0] * a[1] % P
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, (t + t) % P)


def f2_inv(a):
    t = finv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * t % P, (-a[1] * t) % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # v^3 = xi


def f2_mul_xi(a):
    # (9+u)*(a0+a1 u) = 9a0 - a1 + (a0 + 9a1)u
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


# ---- Fq6: c0 + c1 v + c2 v^2, each in Fq2 ----

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a, b):
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a, b):
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a, b):
    t0 = f2_mul(a[0], b[0])
    t1 = f2_mul(a[1], b[1])
    t2 = f2_mul(a[2], b[2])
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a[1], a[2]),
                                            f2_add(b[1], b[2])),
                                     f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a[0], a[1]), f2_add(b[0], b[1])),
                       f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a[0], a[2]), f2_add(b[0], b[2])),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sq(a):
    return f6_mul(a, a)


def f6_mul_v(a):
    """v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    c0 = f2_sub(f2_sq(a[0]), f2_mul_xi(f2_mul(a[1], a[2])))
    c1 = f2_sub(f2_mul_xi(f2_sq(a[2])), f2_mul(a[0], a[1]))
    c2 = f2_sub(f2_sq(a[1]), f2_mul(a[0], a[2]))
    t = f2_inv(f2_add(f2_mul(a[0], c0),
                      f2_mul_xi(f2_add(f2_mul(a[2], c1), f2_mul(a[1], c2)))))
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


# ---- Fq12: a + b w, each in Fq6; w^2 = v ----

F12_ONE = (F6_ONE, F6_ZERO)


def f12_mul(a, b):
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])),
                f6_add(t0, t1))
    return (c0, c1)


def f12_sq(a):
    return f12_mul(a, a)


def f12_inv(a):
    t = f6_inv(f6_sub(f6_sq(a[0]), f6_mul_v(f6_sq(a[1]))))
    return (f6_mul(a[0], t), f6_neg(f6_mul(a[1], t)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_pow(a, e: int):
    res = F12_ONE
    base = a
    while e:
        if e & 1:
            res = f12_mul(res, base)
        base = f12_sq(base)
        e >>= 1
    return res


# Frobenius coefficients: gamma1[i] = xi^((p-1)*i/6)


def _frob_coeffs():
    e = (P - 1) // 6
    c = []
    cur = F2_ONE
    xi_e = _f2_pow(XI, e)
    for i in range(6):
        c.append(cur)
        cur = f2_mul(cur, xi_e)
    return c


def _f2_pow(a, e):
    res = F2_ONE
    while e:
        if e & 1:
            res = f2_mul(res, a)
        a = f2_sq(a)
        e >>= 1
    return res


_FROB1 = _frob_coeffs()


def f12_frobenius(a):
    """a -> a^p."""
    c0 = (f2_conj(a[0][0]),
          f2_mul(f2_conj(a[0][1]), _FROB1[2]),
          f2_mul(f2_conj(a[0][2]), _FROB1[4]))
    c1 = (f2_mul(f2_conj(a[1][0]), _FROB1[1]),
          f2_mul(f2_conj(a[1][1]), _FROB1[3]),
          f2_mul(f2_conj(a[1][2]), _FROB1[5]))
    return (c0, c1)


# ---- G1 (Jacobian over Fq) ----

def g1_is_zero(p):
    return p[2] == 0


G1_ZERO = (1, 1, 0)


def g1_double(p):
    if p[2] == 0:
        return p
    X, Y, Z = p
    A = X * X % P
    Bb = Y * Y % P
    C = Bb * Bb % P
    D = 2 * ((X + Bb) * (X + Bb) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def g1_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return G1_ZERO
        return g1_double(p)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    rr = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = (((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H) % P
    return (X3, Y3, Z3)


def g1_neg(p):
    return (p[0], (-p[1]) % P, p[2])


def g1_mul(p, k: int):
    k %= R
    res = G1_ZERO
    while k:
        if k & 1:
            res = g1_add(res, p)
        p = g1_double(p)
        k >>= 1
    return res


def g1_from_affine(a):
    if a is None:
        return G1_ZERO
    return (a[0], a[1], 1)


def g1_to_affine(p):
    if p[2] == 0:
        return None
    zi = finv(p[2])
    zi2 = zi * zi % P
    return (p[0] * zi2 % P, p[1] * zi2 * zi % P)


def g1_is_on_curve(a) -> bool:
    if a is None:
        return True
    return (a[1] * a[1] - a[0] ** 3 - B) % P == 0


# ---- G2 (Jacobian over Fq2, twist curve y^2 = x^3 + b/xi) ----

B2 = f2_mul((B, 0), f2_inv(XI))
G2_ZERO = (F2_ONE, F2_ONE, F2_ZERO)


def g2_is_zero(p):
    return p[2] == F2_ZERO


def g2_double(p):
    if g2_is_zero(p):
        return p
    X, Y, Z = p
    A = f2_sq(X)
    Bb = f2_sq(Y)
    C = f2_sq(Bb)
    D = f2_smul(f2_sub(f2_sub(f2_sq(f2_add(X, Bb)), A), C), 2)
    E = f2_smul(A, 3)
    F = f2_sq(E)
    X3 = f2_sub(F, f2_smul(D, 2))
    Y3 = f2_sub(f2_mul(E, f2_sub(D, X3)), f2_smul(C, 8))
    Z3 = f2_smul(f2_mul(Y, Z), 2)
    return (X3, Y3, Z3)


def g2_add(p, q):
    if g2_is_zero(p):
        return q
    if g2_is_zero(q):
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = f2_sq(Z1)
    Z2Z2 = f2_sq(Z2)
    U1 = f2_mul(X1, Z2Z2)
    U2 = f2_mul(X2, Z1Z1)
    S1 = f2_mul(f2_mul(Y1, Z2), Z2Z2)
    S2 = f2_mul(f2_mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 != S2:
            return G2_ZERO
        return g2_double(p)
    H = f2_sub(U2, U1)
    I = f2_smul(f2_sq(H), 4)
    J = f2_mul(H, I)
    rr = f2_smul(f2_sub(S2, S1), 2)
    V = f2_mul(U1, I)
    X3 = f2_sub(f2_sub(f2_sq(rr), J), f2_smul(V, 2))
    Y3 = f2_sub(f2_mul(rr, f2_sub(V, X3)), f2_smul(f2_mul(S1, J), 2))
    Z3 = f2_mul(f2_sub(f2_sub(f2_sq(f2_add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def g2_neg(p):
    return (p[0], f2_neg(p[1]), p[2])


def g2_mul(p, k: int):
    k %= R
    res = G2_ZERO
    while k:
        if k & 1:
            res = g2_add(res, p)
        p = g2_double(p)
        k >>= 1
    return res


def g2_from_affine(a):
    if a is None:
        return G2_ZERO
    return (a[0], a[1], F2_ONE)


def g2_to_affine(p):
    if g2_is_zero(p):
        return None
    zi = f2_inv(p[2])
    zi2 = f2_sq(zi)
    return (f2_mul(p[0], zi2), f2_mul(p[1], f2_mul(zi2, zi)))


def g2_is_on_curve(a) -> bool:
    if a is None:
        return True
    return f2_sub(f2_sq(a[1]), f2_add(f2_mul(f2_sq(a[0]), a[0]), B2)) == F2_ZERO


def g1_to_affine_all(points) -> list:
    """g1_to_affine of each point with one inversion."""
    zi = batch_inv([p[2] for p in points])
    out = []
    for (X, Y, _), z in zip(points, zi):
        z2 = z * z % P
        out.append((X * z2 % P, Y * z2 % P * z % P) if z else None)
    return out


def g2_to_affine_all(points) -> list:
    """g2_to_affine of each point with one inversion."""
    norms = batch_inv([(p[2][0] * p[2][0] + p[2][1] * p[2][1]) % P
                       for p in points])
    out = []
    for (X, Y, Z), t in zip(points, norms):
        if not t:
            out.append(None)
            continue
        z = (Z[0] * t % P, (-Z[1]) * t % P)
        z2 = f2_sq(z)
        out.append((f2_mul(X, z2), f2_mul(Y, f2_mul(z2, z))))
    return out


# ---- optimal ate pairing ----
#
# D-type twist untwisting: a twist point (x, y) maps to (x/w^2, y/w^3) on
# E(Fq12).  Each line is multiplied through by w^3 (tangent/chord) or w^2
# (vertical); those factors lie in the subgroup killed by the final
# exponentiation, so the pairing value is unchanged.

# twist Frobenius constants
_G12 = _f2_pow(XI, (P - 1) // 3)        # gamma_{1,2}: x-coefficient of pi_p
_G13 = _f2_pow(XI, (P - 1) // 2)        # gamma_{1,3}: y-coefficient of pi_p
_G22 = _f2_pow(XI, (P * P - 1) // 3)    # gamma_{2,2} (lies in Fq)
_G23 = _f2_pow(XI, (P * P - 1) // 2)    # gamma_{2,3} (lies in Fq)


def _line(T, Q2, xP, yP):
    """Line through affine twist points T and Q2 (tangent when Q2 is None),
    evaluated at the G1 point P.

    Untwist multiplies: (x, y) -> (x w^2, y w^3), so the untwisted slope is
    lam*w and the line is l(P) = yP - (lam xP) w - c w^3 with
    c = yT - lam xT."""
    xT, yT = T
    if Q2 is None or (xT == Q2[0] and yT == Q2[1]):
        lam = f2_mul(f2_smul(f2_sq(xT), 3), f2_inv(f2_smul(yT, 2)))
    elif xT == Q2[0]:
        # vertical: xP - xT w^2
        return (((xP % P, 0), f2_neg(xT), F2_ZERO), F6_ZERO)
    else:
        lam = f2_mul(f2_sub(yT, Q2[1]), f2_inv(f2_sub(xT, Q2[0])))
    c = f2_sub(yT, f2_mul(lam, xT))
    e_c0 = ((yP % P, 0), F2_ZERO, F2_ZERO)
    e_c1 = (f2_neg(f2_smul(lam, xP)), f2_neg(c), F2_ZERO)
    return (e_c0, e_c1)


def miller_loop(Pg1, Qg2):
    """Optimal ate Miller loop with affine line evaluations."""
    if Pg1 is None or Qg2 is None:
        return F12_ONE
    xP, yP = Pg1
    loop_bits = bin(6 * X_BN + 2)[3:]
    T = Qg2
    f = F12_ONE
    for bchar in loop_bits:
        f = f12_sq(f)
        f = f12_mul(f, _line(T, None, xP, yP))
        T = g2_to_affine(g2_double(g2_from_affine(T)))
        if bchar == "1":
            f = f12_mul(f, _line(T, Qg2, xP, yP))
            T = g2_to_affine(g2_add(g2_from_affine(T), g2_from_affine(Qg2)))

    q1 = (f2_mul(f2_conj(Qg2[0]), _G12), f2_mul(f2_conj(Qg2[1]), _G13))
    q2 = (f2_mul(Qg2[0], _G22), f2_mul(Qg2[1], _G23))
    f = f12_mul(f, _line(T, q1, xP, yP))
    T = g2_to_affine(g2_add(g2_from_affine(T), g2_from_affine(q1)))
    q2n = (q2[0], f2_neg(q2[1]))
    f = f12_mul(f, _line(T, q2n, xP, yP))
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r): exact easy part, hard part by plain square-multiply
    (correct first; the Fuentes-Castaneda chain is a later optimization)."""
    fi = f12_inv(f)
    f = f12_mul(f12_conj(f), fi)                       # ^(p^6 - 1)
    f = f12_mul(f12_frobenius(f12_frobenius(f)), f)    # ^(p^2 + 1)
    return f12_pow(f, (P ** 4 - P ** 2 + 1) // R)      # hard part


def pairing(Pg1, Qg2):
    """e(P, Q) for affine P in G1, Q in G2 (None = identity)."""
    if Pg1 is None or Qg2 is None:
        return F12_ONE
    return final_exponentiation(miller_loop(Pg1, Qg2))


def multi_pairing(pairs) -> bool:
    """Check prod e(P_i, Q_i) == 1 with one shared final exponentiation."""
    f = F12_ONE
    for Pg1, Qg2 in pairs:
        if Pg1 is None or Qg2 is None:
            continue
        f = f12_mul(f, miller_loop(Pg1, Qg2))
    return final_exponentiation(f) == F12_ONE
