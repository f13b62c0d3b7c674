"""Programmatic PIL authoring: the in-memory PIL JSON schema
(stark/types.py) built with pilcom's degree conventions.

Copy of eigen_zkvm_tpu/stark/pil_builder.py, imports pointed at the port:
constant and committed columns, publics, intermediates, polynomial
identities, and plookup, permutation and connection arguments, as the
port's AIRs (bench_chain.build_chain_air, examples/) and zkVM machines
(zkvm/machine.py, zkvm/rv32.py) use them.
"""
from __future__ import annotations

from .types import (ConnectionIdentity, Expression, PIL, PlookupIdentity,
                    PolIdentity, Public, Reference)


class PilBuilder:
    def __init__(self, n_bits: int):
        self.n_bits = n_bits
        self.deg = 1 << n_bits
        self.expressions: list[Expression] = []
        self.references: dict = {}
        self.publics: list = []
        self.pol_identities: list = []
        self.plookup_identities: list = []
        self.permutation_identities: list = []
        self.connection_identities: list = []
        self.n_const = 0
        self.n_cm = 0

    # ---- polynomial references ----
    def const_pol(self, name: str, length: int | None = None) -> int:
        ref = Reference("constP", self.n_const, self.deg, length is not None,
                        None, length)
        self.references[name] = ref
        self.n_const += length or 1
        return ref.id

    def cm_pol(self, name: str, length: int | None = None) -> int:
        ref = Reference("cmP", self.n_cm, self.deg, length is not None,
                        None, length)
        self.references[name] = ref
        self.n_cm += length or 1
        return ref.id

    # ---- expression nodes (pilcom deg conventions) ----
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
        """sum of (coef, expr) terms."""
        acc = None
        for k, e in terms:
            t = e if k == 1 else self.smul(k, e)
            acc = t if acc is None else self.add(acc, t)
        return acc

    # ---- statements ----
    def intermediate(self, e) -> Expression:
        """`pol name = e;` — returns a deg-1 exp reference."""
        self.expressions.append(e)
        ref = Expression("exp", 1, len(self.expressions) - 1)
        ref.next = False
        return ref

    def identity(self, e, file_name="pil_builder", line=0):
        self.expressions.append(e)
        self.pol_identities.append(
            PolIdentity(len(self.expressions) - 1, file_name, line))

    def public_input(self, name: str, pol_expr, idx: int) -> Expression:
        """Declare `public name = pol(idx);` — returns the :name node."""
        pid = len(self.publics)
        assert pol_expr.op == "cm"
        self.publics.append(Public("cmP", pol_expr.id, idx, pid, name))
        return self.public(pid)

    def plookup(self, f: list, t: list, sel_f=None, sel_t=None,
                file_name="pil_builder", line=0):
        """{selF: f...} in {selT: t...}  (each a list of expressions)."""
        self.plookup_identities.append(
            self._lookup(f, t, sel_f, sel_t, file_name, line))

    def permutation(self, f: list, t: list, sel_f=None, sel_t=None,
                    file_name="pil_builder", line=0):
        self.permutation_identities.append(
            self._lookup(f, t, sel_f, sel_t, file_name, line))

    def _lookup(self, f, t, sel_f, sel_t, file_name, line):
        fid = [self._push(e) for e in f]
        tid = [self._push(e) for e in t]
        return PlookupIdentity(
            fid, tid, self._push(sel_f) if sel_f is not None else None,
            self._push(sel_t) if sel_t is not None else None, file_name, line)

    def connect(self, pols: list, connections: list,
                file_name="pil_builder", line=0):
        pid = [self._push(e) for e in pols]
        cid = [self._push(e) for e in connections]
        self.connection_identities.append(
            ConnectionIdentity(pid, cid, file_name, line))

    def _push(self, e) -> int:
        self.expressions.append(e)
        return len(self.expressions) - 1

    def build(self) -> PIL:
        return PIL(
            nCommitments=self.n_cm, nQ=0, nIm=0, nConstants=self.n_const,
            publics=self.publics, references=self.references,
            expressions=self.expressions, polIdentities=self.pol_identities,
            plookupIdentities=self.plookup_identities,
            permutationIdentities=self.permutation_identities,
            connectionIdentities=self.connection_identities)


def pil_to_json(pil) -> dict:
    """The PIL JSON that types.PIL.from_json reads, with the plookup,
    permutation and connection identities (a copy of
    eigen_zkvm_tpu_torch/bench_chain.py::pil_to_json)."""
    def expr(e):
        d = {"op": e.op, "deg": e.deg}
        if e.id is not None:
            d["id"] = e.id
        if e.next is not None:
            d["next"] = bool(e.next)
        if e.value is not None:
            d["value"] = e.value
        if e.values is not None:
            d["values"] = [expr(v) for v in e.values]
        if e.idQ is not None:
            d["idQ"] = e.idQ
        if e.keep is not None:
            d["keep"] = e.keep
        return d

    def lookup(p):
        return {"f": p.f, "t": p.t, "selF": p.selF, "selT": p.selT,
                "fileName": p.fileName, "line": p.line}

    refs = {}
    for k, v in pil.references.items():
        r = {"type": v.type_, "id": v.id, "polDeg": v.polDeg,
             "isArray": v.isArray}
        if v.isArray:
            r["len"] = v.len
        refs[k] = r
    return {
        "nCommitments": pil.nCommitments, "nQ": pil.nQ, "nIm": pil.nIm,
        "nConstants": pil.nConstants,
        "publics": [{"polType": p.polType, "polId": p.polId, "idx": p.idx,
                     "id": p.id, "name": p.name} for p in pil.publics],
        "references": refs,
        "expressions": [expr(e) for e in pil.expressions],
        "polIdentities": [{"e": p.e, "fileName": p.fileName, "line": p.line}
                          for p in pil.polIdentities],
        "plookupIdentities": [lookup(p) for p in pil.plookupIdentities],
        "permutationIdentities": [lookup(p)
                                  for p in pil.permutationIdentities],
        "connectionIdentities": [
            {"pols": c.pols, "connections": c.connections,
             "fileName": c.fileName, "line": c.line}
            for c in pil.connectionIdentities],
    }
