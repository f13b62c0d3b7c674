"""PIL expression -> 3-address program codegen.

Copy of eigen_zkvm_tpu/stark/starkinfo_codegen.py, imports pointed at the port.

Faithful reimplementation of the reference's compiler data model
(reference: starky/src/starkinfo_codegen.rs): expressions compile to ordered
`Section` lists (op, dest, src Nodes) grouped into `Segment`s.  The prover
does NOT interpret these per-row — eigen_zkvm_tpu.stark.vm lowers a Segment
to whole-column vectorized array operations (the TPU-first redesign of the
reference's per-row interpreter.rs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .types import PIL, Expression


@dataclass
class Node:
    type_: str
    id: int = 0
    value: Optional[str] = None
    dim: int = 0
    prime: bool = False
    tree_pos: int = 0
    p: int = 0
    exp_id: int = 0

    def clone(self) -> "Node":
        return Node(self.type_, self.id, self.value, self.dim, self.prime,
                    self.tree_pos, self.p, self.exp_id)


@dataclass
class Section:
    op: str
    dest: Node
    src: list


@dataclass
class Segment:
    first: list = field(default_factory=list)
    i: list = field(default_factory=list)
    last: list = field(default_factory=list)
    tmp_used: int = 0

    def is_some(self) -> bool:
        return bool(self.first or self.i or self.last)


@dataclass
class Code:
    exp_id: int
    prime: bool
    tmp_used: int
    code: list
    idQ: Optional[int] = None


class Context:
    def __init__(self):
        self.exp_id = 0
        self.tmp_used = 0
        self.code: list[Code] = []
        self.calculated: dict = {}  # ("exps"/"expsPrime", exp_id) -> bool


class ContextC:
    def __init__(self, exp_id, tmp_used):
        self.exp_id = exp_id
        self.tmp_used = tmp_used
        self.code: list[Section] = []


class ContextF:
    def __init__(self, starkinfo, tmp_used=0, dom="", tmpexps=None):
        self.exp_map: dict = {}  # (p, id) -> tmp id
        self.tmp_used = tmp_used
        self.dom = dom
        self.tmpexps = tmpexps if tmpexps is not None else {}
        self.starkinfo = starkinfo


class EVIdx:
    def __init__(self):
        self.cm: dict = {}
        self.const_: dict = {}

    def get(self, type_, p, id_):
        if type_ == "cm":
            return self.cm.get((p, id_))
        assert type_ == "const"
        return self.const_.get((p, id_))

    def set(self, type_, p, id_, idx):
        if type_ == "cm":
            self.cm[(p, id_)] = idx
        else:
            assert type_ == "const"
            self.const_[(p, id_)] = idx


@dataclass
class PolType:
    section: str
    section_pos: int
    dim: int
    exp_id: int


class Index:
    """Per-section integer map (widths / offsets / degrees)."""

    SECTIONS = ("cm1_n", "cm1_2ns", "cm2_n", "cm2_2ns", "cm3_n", "cm3_2ns",
                "cm4_n", "cm4_2ns", "tmpexp_n", "q_2ns", "f_2ns")

    def __init__(self):
        for s in self.SECTIONS:
            setattr(self, s, 0)

    def get(self, name):
        if name in self.SECTIONS:
            return getattr(self, name)
        return None  # reference returns usize::MAX for unknown

    def set(self, name, val):
        assert name in self.SECTIONS, name
        setattr(self, name, val)


class IndexVec:
    def __init__(self):
        for s in Index.SECTIONS:
            setattr(self, s, [])

    def get(self, name):
        return getattr(self, name)


def pil_code_gen(ctx: Context, pil: PIL, exp_id: int, prime: bool,
                 res_type: str = "", res_id: int = 0, muladd: bool = False):
    prime_idx = "expsPrime" if prime else "exps"
    if (prime_idx, exp_id) in ctx.calculated:
        if res_type:
            idx = next(i for i, x in enumerate(ctx.code)
                       if x.exp_id == exp_id and x.prime == prime)
            c = ctx.code[idx]
            dest = Node(res_type, res_id, None, 0, prime, 0)
            c.code.append(Section("copy", dest, [c.code[-1].dest.clone()]))
        return

    exp = pil.expressions[exp_id]
    calculate_deps(ctx, pil, exp, prime, exp_id, False)

    code_ctx = ContextC(exp_id, ctx.tmp_used)
    e = find_muladd(pil.expressions[exp_id]) if muladd else pil.expressions[exp_id]
    ret_ref = eval_exp(code_ctx, pil, e, prime)
    if ret_ref.type_ == "tmp":
        code_ctx.code[-1].dest = Node("exp", exp_id, None, 0, prime, 0)
        code_ctx.tmp_used -= 1
    else:
        exp_node = Node("exp", exp_id, None, 0, prime, 0)
        code_ctx.code.append(Section("copy", exp_node, [ret_ref]))
    if res_type:
        assert not prime, "Prime in retType"
        dest = Node(res_type, res_id, None, 0, prime, 0)
        src = Node("exp", exp_id, None, 0, prime, 0)
        code_ctx.code.append(Section("copy", dest, [src]))

    ctx.code.append(Code(exp_id, prime, 0, code_ctx.code, None))
    ctx.calculated[(prime_idx, exp_id)] = True
    if code_ctx.tmp_used > ctx.tmp_used:
        ctx.tmp_used = code_ctx.tmp_used


def find_muladd(exp: Expression) -> Expression:
    if exp.values is not None:
        values = exp.values
        if exp.op == "add" and values[0].op == "mul":
            vv = values[0].values
            a = find_muladd(vv[0])
            b = find_muladd(vv[1])
            c = find_muladd(values[1])
            return Expression("muladd", 0, None, None, [a, b, c])
        elif exp.op == "add" and values[1].op == "mul":
            vv = values[1].values
            a = find_muladd(vv[0])
            b = find_muladd(vv[1])
            c = find_muladd(values[0])
            return Expression("muladd", 0, None, None, [a, b, c])
        else:
            r = exp.clone()
            r.values = [find_muladd(v) for v in values]
            return r
    return exp.clone()


def eval_exp(code_ctx: ContextC, pil: PIL, exp: Expression, prime: bool) -> Node:
    assert exp.op != "nop", "eval on nop"
    # iterative postorder to avoid Python recursion limits on deep PIL chains
    stack = [(exp, False)]
    results: list[Node] = []
    while stack:
        node, visited = stack.pop()
        if not visited:
            stack.append((node, True))
            if node.values:
                for v in reversed(node.values):
                    stack.append((v, False))
        else:
            n = len(node.values) if node.values else 0
            children = results[len(results) - n:] if n else []
            del results[len(results) - n:]
            results.append(_eval_single_op(code_ctx, pil, node, prime, children))
    assert len(results) == 1
    return results[0]


def _eval_single_op(code_ctx, pil, exp, prime, values) -> Node:
    op = exp.op
    if op in ("add", "sub", "mul", "muladd"):
        r = Node("tmp", code_ctx.tmp_used)
        code_ctx.tmp_used += 1
        code_ctx.code.append(Section(op, r.clone(), list(values)))
        return r
    if op == "addc":
        b = Node("number", 0, str(exp.const_))
        r = Node("tmp", code_ctx.tmp_used)
        code_ctx.tmp_used += 1
        code_ctx.code.append(Section("add", r.clone(), [values[0], b]))
        return r
    if op == "mulc":
        b = Node("number", 0, str(exp.const_))
        r = Node("tmp", code_ctx.tmp_used)
        code_ctx.tmp_used += 1
        code_ctx.code.append(Section("mul", r.clone(), [values[0], b]))
        return r
    if op == "neg":
        a = Node("number", 0, "0")
        r = Node("tmp", code_ctx.tmp_used)
        code_ctx.tmp_used += 1
        code_ctx.code.append(Section("sub", r.clone(), [a, values[0]]))
        return r
    if op in ("cm", "const", "exp", "q"):
        if exp.next_flag() and prime:
            raise ValueError("Double Prime")
        return Node(op, exp.id, None, 0, exp.next_flag() or prime, 0)
    if op == "number":
        return Node("number", 0, exp.value)
    if op in ("public", "challenge", "eval"):
        return Node(op, exp.id)
    if op in ("xDivXSubXi", "xDivXSubWXi", "x"):
        return Node(op, 0)
    raise ValueError(f"InvalidOperator: eval_exp: {op}")


def calculate_deps(ctx, pil, expr, prime, exp_id, muladd):
    if expr.op == "exp":
        id_ = expr.id
        if prime and expr.next_flag():
            raise ValueError("Double prime")
        pil_code_gen(ctx, pil, id_, prime or expr.next_flag(), "", 0, muladd)
    if expr.values is not None:
        for e in expr.values:
            calculate_deps(ctx, pil, e, prime, exp_id, muladd)


def build_code(ctx: Context, pil: PIL) -> Segment:
    seg = Segment(
        first=build_linear_code(ctx, pil, "first"),
        i=build_linear_code(ctx, pil, "i"),
        last=build_linear_code(ctx, pil, "last"),
        tmp_used=ctx.tmp_used,
    )
    # Mark non-kept expressions as present-but-invalid, as the reference does
    # (its `calculated.contains_key` check treats any marker as calculated).
    for i, e in enumerate(pil.expressions):
        if e.keep is None and e.idQ is None:
            ctx.calculated[("exps", i)] = False
            ctx.calculated[("expsPrime", i)] = False
    ctx.code = []
    return seg


def build_linear_code(ctx: Context, pil: PIL, loop_pos: str) -> list:
    if loop_pos in ("i", "last"):
        exp_and_expprimes = _get_exp_and_expprimes(ctx, pil)
    else:
        exp_and_expprimes = {}
    res = []
    for i in range(len(ctx.code)):
        ep = exp_and_expprimes.get(i)
        if ep and ((loop_pos == "i" and not ctx.code[i].prime) or loop_pos == "last"):
            continue
        for cc in ctx.code[i].code:
            res.append(Section(cc.op, cc.dest.clone(), [s.clone() for s in cc.src]))
    return res


def _get_exp_and_expprimes(ctx: Context, pil: PIL) -> dict:
    calc_exps = {}
    for i in range(len(ctx.code)):
        e = pil.expressions[ctx.code[i].exp_id]
        if e.idQ is not None or e.keep is not None or e.keep2ns is not None:
            mask = 2 if ctx.code[i].prime else 1
            calc_exps[ctx.code[i].exp_id] = calc_exps.get(ctx.code[i].exp_id, 0) | mask
    return {k: (v == 3) for k, v in calc_exps.items()}


def iterate_code(segment: Segment, f, ctx: ContextF, pil: PIL):
    for sec in (segment.first, segment.i, segment.last):
        for c in sec:
            for s in c.src:
                f(s, ctx, pil)
            f(c.dest, ctx, pil)
