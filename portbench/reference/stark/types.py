"""PIL JSON schema + StarkStruct config — the framework's circuit IR.

Copy of eigen_zkvm_tpu/stark/types.py, imports pointed at the port.

File formats are kept byte-compatible with the reference so its fixtures,
pilcom outputs and downstream circom verifiers work unchanged
(reference: starky/src/types.rs).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

from ..field import P as P_INT


class Expression:
    __slots__ = ("op", "deg", "id", "next", "value", "values", "keep", "keep2ns", "idQ", "const_")

    def __init__(self, op, deg=0, id=None, value=None, values=None):
        self.op = op
        self.deg = deg
        self.id = id
        self.next = None
        self.value = value
        self.values = values
        self.keep = None
        self.keep2ns = None
        self.idQ = None
        self.const_ = None

    def next_flag(self) -> bool:
        return bool(self.next)

    def clone(self) -> "Expression":
        e = Expression(self.op, self.deg, self.id, self.value,
                       [v.clone() for v in self.values] if self.values is not None else None)
        e.next = self.next
        e.keep = self.keep
        e.keep2ns = self.keep2ns
        e.idQ = self.idQ
        e.const_ = self.const_
        return e

    @staticmethod
    def from_json(obj: dict) -> "Expression":
        e = Expression(obj["op"], obj.get("deg", 0), obj.get("id"), obj.get("value"),
                       [Expression.from_json(v) for v in obj["values"]] if "values" in obj else None)
        e.next = obj.get("next")
        e.keep = obj.get("keep")
        e.keep2ns = obj.get("keep2ns")
        e.idQ = obj.get("idQ")
        e.const_ = obj.get("const")
        return e

    def __repr__(self):
        return f"Expr({self.op}, id={self.id}, next={self.next})"


@dataclass
class Public:
    polType: str
    polId: int
    idx: int
    id: int
    name: str


@dataclass
class Reference:
    type_: str
    id: int
    polDeg: int
    isArray: bool
    elementType: Optional[str] = None
    len: Optional[int] = None


@dataclass
class PolIdentity:
    e: int
    fileName: str = ""
    line: int = 0


@dataclass
class PlookupIdentity:
    f: Optional[list] = None
    t: Optional[list] = None
    selF: Optional[int] = None
    selT: Optional[int] = None
    fileName: str = ""
    line: int = 0


@dataclass
class ConnectionIdentity:
    pols: Optional[list] = None
    connections: Optional[list] = None
    fileName: str = ""
    line: int = 0


@dataclass
class PIL:
    nCommitments: int
    nQ: int
    nIm: int
    nConstants: int
    publics: list
    references: dict
    expressions: list
    polIdentities: list
    plookupIdentities: list
    permutationIdentities: list
    connectionIdentities: list
    cm_dims: list = field(default_factory=list)
    q2exp: list = field(default_factory=list)

    @staticmethod
    def from_json(obj: dict) -> "PIL":
        refs = {
            k: Reference(
                type_=v["type"], id=v["id"], polDeg=v["polDeg"], isArray=v["isArray"],
                elementType=v.get("elementType"), len=v.get("len"))
            for k, v in obj["references"].items()
        }
        return PIL(
            nCommitments=obj["nCommitments"],
            nQ=obj["nQ"],
            nIm=obj.get("nIm", 0),
            nConstants=obj["nConstants"],
            publics=[Public(p["polType"], p["polId"], p["idx"], p["id"], p["name"]) for p in obj["publics"]],
            references=refs,
            expressions=[Expression.from_json(e) for e in obj["expressions"]],
            polIdentities=[PolIdentity(p["e"], p.get("fileName", ""), p.get("line", 0)) for p in obj["polIdentities"]],
            plookupIdentities=[
                PlookupIdentity(p.get("f"), p.get("t"), p.get("selF"), p.get("selT"),
                                p.get("fileName", ""), p.get("line", 0))
                for p in obj.get("plookupIdentities", [])
            ],
            permutationIdentities=[
                PlookupIdentity(p.get("f"), p.get("t"), p.get("selF"), p.get("selT"),
                                p.get("fileName", ""), p.get("line", 0))
                for p in (obj.get("permutationIdentities") or [])
            ],
            connectionIdentities=[
                ConnectionIdentity(p.get("pols"), p.get("connections"),
                                   p.get("fileName", ""), p.get("line", 0))
                for p in (obj.get("connectionIdentities") or [])
            ],
        )


@dataclass
class Step:
    nBits: int


@dataclass
class StarkStruct:
    nBits: int
    nBitsExt: int
    nQueries: int
    verificationHashType: str
    steps: list

    @staticmethod
    def from_json(obj: dict) -> "StarkStruct":
        return StarkStruct(
            nBits=obj["nBits"], nBitsExt=obj["nBitsExt"], nQueries=obj["nQueries"],
            verificationHashType=obj["verificationHashType"],
            steps=[Step(s["nBits"]) for s in obj["steps"]],
        )


def load_pil(path: str) -> PIL:
    with open(path) as f:
        return PIL.from_json(json.load(f))


def load_starkstruct(path: str) -> StarkStruct:
    with open(path) as f:
        return StarkStruct.from_json(json.load(f))


def parse_pil_number(raw: str) -> int:
    """Parse a PIL literal (decimal or 0x...) into canonical GL (reference: types.rs)."""
    v = int(raw, 16) if raw.startswith("0x") else int(raw)
    return v % P_INT
