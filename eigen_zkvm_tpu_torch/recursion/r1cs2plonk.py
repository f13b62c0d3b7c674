"""R1CS -> plonkish gates + additions.

Behavioral port of the reference transform (recursion/src/r1cs2plonk.rs):
each R1CS constraint A*B=C becomes either a single mul gate (when both A and
B are genuine linear combinations) or a sum gate; wide linear combinations
are reduced pairwise through auxiliary variables recorded as PlonkAdds so
the witness extension can be replayed at exec time.

A constraint here is a triple of {signal: coef} dicts (key 0 = constant),
as produced by recursion/circuit.py.

Copy of eigen_zkvm_tpu/recursion/r1cs2plonk.py.
"""
from __future__ import annotations

P = 0xFFFFFFFF00000001


class PlonkGate:
    __slots__ = ("s", "q")

    def __init__(self, sl, sr, so, qm, ql, qr, qo, qc):
        self.s = (sl, sr, so)
        self.q = (qm % P, ql % P, qr % P, qo % P, qc % P)

    def str_key(self) -> str:
        return ",".join(format(x, "x") for x in self.q)


class PlonkAdd:
    __slots__ = ("s1", "s2", "c1", "c2")

    def __init__(self, s1, s2, c1, c2):
        self.s1, self.s2, self.c1, self.c2 = s1, s2, c1 % P, c2 % P


def _reduce_coefs(lc: dict, max_c: int, gates, adds, n_var: list):
    k = 0
    cs = []
    for key in sorted(lc):
        val = lc[key] % P
        if key == 0:
            k = (k + val) % P
        elif val != 0:
            cs.append((key, val))
    while len(cs) > max_c:
        c1 = cs.pop(0)
        c2 = cs.pop(0)
        so = n_var[0]
        n_var[0] += 1
        gates.append(PlonkGate(c1[0], c2[0], so, 0, P - c1[1], P - c2[1], 1, 0))
        adds.append(PlonkAdd(c1[0], c2[0], c1[1], c2[1]))
        cs.append((so, 1))
    s = [c[0] for c in cs] + [0] * (max_c - len(cs))
    coefs = [c[1] for c in cs] + [0] * (max_c - len(cs))
    return k, s, coefs


def _join(lc1: dict, k: int, lc2: dict) -> dict:
    res = {}
    for key, val in lc1.items():
        res[key] = (k * val) % P
    for key, val in lc2.items():
        res[key] = (res.get(key, 0) + val) % P
    return {k2: v for k2, v in res.items() if v % P != 0}


def _lc_type(lc: dict) -> str:
    k = 0
    n = 0
    for key in list(lc):
        v = lc[key] % P
        if v == 0:
            del lc[key]
        elif key == 0:
            k = (k + v) % P
        else:
            n += 1
    if n > 0:
        return str(n)
    return "k" if k != 0 else "0"


def r1cs2plonk(constraints: list, n_vars: int):
    """constraints: [(A,B,C) dicts]; returns (gates, adds, n_vars_total)."""
    n_var = [n_vars]
    gates: list[PlonkGate] = []
    adds: list[PlonkAdd] = []

    for A, B, C in constraints:
        lc_a, lc_b, lc_c = dict(A), dict(B), dict(C)
        ta, tb = _lc_type(lc_a), _lc_type(lc_b)
        if ta == "0" or tb == "0":
            lc_c = {k: v for k, v in lc_c.items() if v % P != 0}
            k, s, c = _reduce_coefs(lc_c, 3, gates, adds, n_var)
            gates.append(PlonkGate(s[0], s[1], s[2], 0, c[0], c[1], c[2], k))
        elif ta == "k":
            lc = _join(lc_b, lc_a[0], lc_c)
            k, s, c = _reduce_coefs(lc, 3, gates, adds, n_var)
            gates.append(PlonkGate(s[0], s[1], s[2], 0, c[0], c[1], c[2], k))
        elif tb == "k":
            lc = _join(lc_a, lc_b[0], lc_c)
            k, s, c = _reduce_coefs(lc, 3, gates, adds, n_var)
            gates.append(PlonkGate(s[0], s[1], s[2], 0, c[0], c[1], c[2], k))
        else:
            ka, sa, ca = _reduce_coefs(lc_a, 1, gates, adds, n_var)
            kb, sb, cb = _reduce_coefs(lc_b, 1, gates, adds, n_var)
            kc, sc, cc = _reduce_coefs(lc_c, 1, gates, adds, n_var)
            gates.append(PlonkGate(
                sa[0], sb[0], sc[0],
                ca[0] * cb[0] % P,
                ca[0] * kb % P,
                ka * cb[0] % P,
                P - cc[0] if cc[0] else 0,
                (ka * kb - kc) % P))

    return gates, adds, n_var[0]
