"""PIL expression AST constructors (reference: starky/src/expressionops.rs).

Copy of eigen_zkvm_tpu/stark/expressionops.py, imports pointed at the port.
"""
from __future__ import annotations

from .types import Expression

CHALLENGE_MAP = {"u": 0, "defVal": 1, "gamma": 2, "beta": 3,
                 "vc": 4, "vf1": 5, "vf2": 6, "xi": 7}


def add(a, b):
    return Expression("add", 0, None, None, [a.clone(), b.clone()])


def sub(a, b):
    return Expression("sub", 0, None, None, [a.clone(), b.clone()])


def mul(a, b):
    return Expression("mul", 0, None, None, [a.clone(), b.clone()])


def neg(a):
    return Expression("neg", 0, None, None, [a.clone()])


def exp(id_, next_=None):
    e = Expression("exp", 0, id_)
    e.next = next_
    return e


def cm(id_, next_=None):
    e = Expression("cm", 0, id_)
    e.next = next_
    return e


def const_(id_, next_=None):
    e = Expression("const", 0, id_)
    e.next = next_
    return e


def q(id_, next_=None):
    e = Expression("q", 0, id_)
    e.next = next_
    return e


def challenge(name):
    assert name in CHALLENGE_MAP, "challenge not defined"
    return Expression("challenge", 0, CHALLENGE_MAP[name])


def number(n: str):
    return Expression("number", 0, None, n)


def eval_(n: int):
    return Expression("eval", 0, n)


def x_div_x_sub_xi():
    return Expression("xDivXSubXi", 0)


def x_div_x_sub_wxi():
    return Expression("xDivXSubWXi", 0)


def x():
    return Expression("x", 0)


def nop():
    return Expression("nop", 0)


def is_nop(e):
    return e.op == "nop"
