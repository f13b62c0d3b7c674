"""What a proof of a PIL claims, at one point: the eSTARK's constraint
polynomial C, built from the PIL's identities and, for each plookup, the
PIL-STARK plookup argument, evaluated at a GF(p^3) point from the values
the proof opens there.

For a PIL of polynomial identities and plookups, the eSTARK commits:
stage 1, the trace; stage 2, each plookup's h1 and h2; stage 3, each
plookup's grand product z and the intermediate polynomials; stage 4, the
quotient's pieces.  With challenges u, defVal (stage 2), gamma, beta
(stage 3) and vc (stage 4), plookup k of tuple f over table t adds

    t_k = ((t_0 u + t_1) u + ...) , then (t_k - defVal) selT + defVal
    f_k = ((f_0 u + f_1) u + ...) , then (f_k - t_k) selF + t_k
    c1  = L1 (z - 1)
    num = (f_k + gamma) (t_k + beta t_k' + gamma (1 + beta)) (1 + beta)
    den = (h1 + beta h2 + gamma (1 + beta)) (h2 + beta h1' + gamma (1 + beta))
    c2  = z' den - z num

to the identities (c1, c2 after the PIL's own), and C folds them by vc:
C = (..(e_0 vc + e_1) vc + ..) .  An intermediate polynomial im stands for
an expression e of too high a degree: each use of e reads im, and
(e - im), with e expanded once, is folded into C after the identities.
The expressions the argument adds are numbered after the PIL's, t_k and
f_k for each plookup, then c1, num, den and c2 for each, so that an
intermediate polynomial names its expression by that number.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

from . import field as F


def _num(v) -> int:
    return int(v) % F.P


def _op(op, *values, **kw) -> dict:
    return dict(op=op, values=list(values), **kw)


def _ch(name: str) -> dict:
    return {"op": "challenge", "name": name}


def _e(i: int, prime: bool = False) -> dict:
    return {"op": "exp", "id": i, "next": prime}


def _cm(i: int, prime: bool = False) -> dict:
    return {"op": "cm", "id": i, "next": prime}


@dataclass
class Air:
    """The PIL with the argument's expressions and polynomials added."""
    expressions: list
    identities: list            # expression ids, in C's order
    n_cm1: int
    stages: list                # cm ids of stages 1-3 in commit order
    plookups: list = dfield(default_factory=list)  # (h1, h2, z, t, f, ...)
    l1: int | None = None

    @classmethod
    def of(cls, pil: dict) -> "Air":
        for kind in ("permutationIdentities", "connectionIdentities"):
            if pil.get(kind):
                raise NotImplementedError(f"the reference has no {kind}")
        ex = list(pil["expressions"])
        n1 = pil["nCommitments"]
        ids = [pi["e"] for pi in pil["polIdentities"]]
        u, dv, g, b = (_ch(n) for n in ("u", "defVal", "gamma", "beta"))
        one = {"op": "number", "value": "1"}
        pls = pil["plookupIdentities"]
        air = cls(ex, ids, n1, [list(range(n1)), [], []])
        if pls:
            air.l1 = pil["references"]["Global.L1"]["id"]
        ts, fs = [], []
        for pi in pls:
            t = None
            for j in pi["t"]:
                t = _e(j) if t is None else _op("add", _op("mul", u, t), _e(j))
            if pi.get("selT") is not None:
                t = _op("add", _op("mul", _op("sub", t, dv), _e(pi["selT"])),
                        dv)
            ts.append(len(ex))
            ex.append(t)
            f = None
            for j in pi["f"]:
                f = _e(j) if f is None else _op("add", _op("mul", f, u), _e(j))
            if pi.get("selF") is not None:
                f = _op("add", _op("mul", _op("sub", f, _e(ts[-1])),
                                   _e(pi["selF"])), _e(ts[-1]))
            fs.append(len(ex))
            ex.append(f)
        h = [(n1 + 2 * k, n1 + 2 * k + 1) for k in range(len(pls))]
        zs = [n1 + 2 * len(pls) + k for k in range(len(pls))]
        air.stages[1] = [c for pair in h for c in pair]
        air.stages[2] = list(zs)
        gb = _op("mul", g, _op("add", one, b))
        for k in range(len(pls)):
            (h1, h2), z = h[k], zs[k]
            base = len(ex)
            ex.append(_op("mul", {"op": "const", "id": air.l1, "next": False},
                          _op("sub", _cm(z), one)))
            ex.append(_op("mul", _op("mul", _op("add", _e(fs[k]), g),
                                     _op("add", _op("add", _e(ts[k]),
                                                    _op("mul", _e(ts[k], True),
                                                        b)), gb)),
                          _op("add", one, b)))
            ex.append(_op("mul",
                          _op("add", _op("add", _cm(h1), _op("mul", _cm(h2), b)),
                              gb),
                          _op("add", _op("add", _cm(h2), _op("mul", _cm(h1, True),
                                                             b)), gb)))
            ex.append(_op("sub", _op("mul", _cm(z, True), _e(base + 2)),
                          _op("mul", _cm(z), _e(base + 1))))
            air.identities += [base, base + 3]
            air.plookups.append({"h1": h1, "h2": h2, "z": z, "t": ts[k],
                                 "f": fs[k], "c1": base, "num": base + 1,
                                 "den": base + 2, "c2": base + 3})
        return air

    def dim(self, e: dict) -> int:
        """1 where e is over GL alone, 3 where it takes a challenge or a
        polynomial of stages 2-4."""
        op = e["op"]
        if op == "challenge":
            return 3
        if op == "cm":
            return 1 if e["id"] < self.n_cm1 else 3
        if op == "exp":
            return self.dim(self.expressions[e["id"]])
        return max([self.dim(v) for v in e.get("values", [])] + [1])


class Point:
    """Evaluation of the Air's expressions at xi from the proof's openings.

    `value(kind, id, prime)` gives a polynomial's opening at xi (or at
    xi w where prime); `im` maps an expression id to the cm id of its
    intermediate polynomial."""

    def __init__(self, air: Air, value, im: dict, publics: list,
                 challenges: dict):
        self.air, self.value, self.im = air, value, im
        self.publics, self.ch = publics, challenges

    def ev(self, e: dict, prime: bool = False, expand: bool = False):
        op = e["op"]
        nxt = prime or bool(e.get("next", False))
        if prime and e.get("next"):
            raise ValueError("a shifted reference under a shifted one")
        if op == "number":
            return F.e3(_num(e["value"]))
        if op == "public":
            return F.e3(self.publics[e["id"]])
        if op == "challenge":
            return self.ch[e["name"]]
        if op in ("cm", "const"):
            return self.value(op, e["id"], nxt)
        if op == "exp":
            if e["id"] in self.im and not expand:
                return self.value("cm", self.im[e["id"]], nxt)
            return self.ev(self.air.expressions[e["id"]], nxt)
        vals = [self.ev(v, prime) for v in e["values"]]
        if op == "add":
            return F.add3(*vals)
        if op == "sub":
            return F.sub3(*vals)
        if op == "mul":
            return F.mul3(*vals)
        if op == "neg":
            return F.neg3(*vals)
        raise NotImplementedError(f"the reference has no PIL op {op!r}")

    def c(self) -> tuple:
        """C at xi."""
        vc = self.ch["vc"]
        acc = None
        for i in self.air.identities:
            t = self.ev(_e(i))
            acc = t if acc is None else F.add3(F.mul3(vc, acc), t)
        for eid in sorted(self.im):
            t = F.sub3(self.ev(_e(eid), expand=True),
                       self.value("cm", self.im[eid], False))
            acc = t if acc is None else F.add3(F.mul3(vc, acc), t)
        return acc
