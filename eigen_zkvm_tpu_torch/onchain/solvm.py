"""Solidity-subset interpreter for the generated Groth16 verifier.

Executes the ACTUAL emitted `verifier.sol` source (groth16/api.py
generate_verifier_from_vk — the ZoKrates-derived template the reference
ships, groth16/src/template.rs): tokenizer + recursive-descent parser +
tree-walking evaluator over the subset the template uses (libraries,
contracts, structs, memory arrays, for/if/require/return, inline-assembly
`staticcall` to the BN254 precompiles).

EVM semantics honored at the boundaries:
  - uint256 wrapping arithmetic
  - `require` failure raises RevertError (the EVM revert)
  - precompiles 0x06/0x07/0x08 follow EIP-196/197: field elements must be
    canonical, points must lie on the curve (G2: in the r-torsion for the
    pairing), malformed input makes the staticcall report failure —
    backed by curves/bn254, including the (imag, real) Fp2 wire order

Scope note: this runs contract SOURCE, not EVM bytecode (no solc exists in
this environment to compile it) — the template's logic, vk constant
rendering, and precompile call conventions are all exercised for real.

Copy of eigen_zkvm_tpu/onchain/solvm.py on the port's curves/bn254.py.
"""
from __future__ import annotations

import re

from ..curves import bn254

U256 = (1 << 256) - 1


class RevertError(Exception):
    """require() failed — the EVM revert."""


# ---- tokenizer -------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<op>:=|&&|\|\||==|!=|<=|>=|\+\+|--|[{}()\[\];.,=<>!+\-*/%&|^~?:])
  | (?P<ws>\s+)
""", re.VERBOSE | re.DOTALL)


def tokenize(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"bad token at {src[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup in ("comment", "ws"):
            continue
        toks.append(m.group())
    return toks


# ---- AST via recursive descent --------------------------------------------

_ELEM_TYPES = {"uint", "uint256", "uint8", "bool", "address", "bytes32"}


class Parser:
    def __init__(self, toks):
        self.t = toks
        self.i = 0

    def peek(self, k=0):
        return self.t[self.i + k] if self.i + k < len(self.t) else None

    def next(self):
        tok = self.t[self.i]
        self.i += 1
        return tok

    def expect(self, tok):
        got = self.next()
        if got != tok:
            raise SyntaxError(f"expected {tok!r}, got {got!r} @@ "
                              f"{' '.join(self.t[self.i-3:self.i+3])}")
        return got

    def accept(self, tok):
        if self.peek() == tok:
            self.i += 1
            return True
        return False

    # -- top level --
    def parse_file(self):
        units = {}
        while self.peek() is not None:
            tok = self.peek()
            if tok == "pragma":
                while self.next() != ";":
                    pass
            elif tok in ("library", "contract"):
                kind = self.next()
                name = self.next()
                units[name] = self.parse_body(kind, name)
            else:
                raise SyntaxError(f"unexpected top-level {tok!r}")
        return units

    def parse_body(self, kind, name):
        self.expect("{")
        structs, funcs = {}, {}
        while not self.accept("}"):
            tok = self.peek()
            if tok == "using":
                while self.next() != ";":
                    pass
            elif tok == "struct":
                self.next()
                sname = self.next()
                structs[sname] = self.parse_struct()
            elif tok == "function":
                self.next()
                fname = self.next()
                funcs[fname] = self.parse_function()
            else:
                raise SyntaxError(f"unexpected member {tok!r} in {name}")
        return {"kind": kind, "structs": structs, "funcs": funcs}

    def parse_struct(self):
        self.expect("{")
        fields = []
        while not self.accept("}"):
            ftype = self.parse_type()
            fname = self.next()
            self.expect(";")
            fields.append((fname, ftype))
        return fields

    def parse_type(self):
        base = self.next()
        if self.peek() == "." :
            self.next()
            base = (base, self.next())  # qualified: (lib, struct)
        dims = []
        while self.peek() == "[":
            self.next()
            if self.peek() == "]":
                dims.append(None)  # dynamic
            else:
                dims.append(int(self.next(), 0))
            self.expect("]")
        return {"base": base, "dims": dims}

    def parse_function(self):
        self.expect("(")
        params = []
        while not self.accept(")"):
            ptype = self.parse_type()
            self.accept("memory")
            params.append((self.next(), ptype))
            self.accept(",")
        rets = []
        while self.peek() not in ("{", ";"):
            tok = self.next()
            if tok == "returns":
                self.expect("(")
                while not self.accept(")"):
                    rtype = self.parse_type()
                    self.accept("memory")
                    rname = None
                    if self.peek() not in (",", ")"):
                        rname = self.next()
                    rets.append((rname, rtype))
                    self.accept(",")
        body = self.parse_block()
        return {"params": params, "rets": rets, "body": body}

    # -- statements --
    def parse_block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self.parse_stmt())
        return ("block", stmts)

    def _looks_like_decl(self):
        """type ident   (where type = elem type, known-struct, lib.struct,
        possibly with [..] dims)"""
        j = self.i
        t = self.t
        if t[j] in _ELEM_TYPES or (t[j][0].isupper() and t[j] not in
                                   ("Pairing",)):
            k = j + 1
        elif j + 2 < len(t) and t[j + 1] == "." and t[j][0].isupper():
            k = j + 3
        else:
            return False
        while k < len(t) and t[k] == "[":
            k += 1
            while t[k] != "]":
                k += 1
            k += 1
        if k < len(t) and t[k] == "memory":
            k += 1
        return k < len(t) and re.match(r"[A-Za-z_$]", t[k]) and \
            t[k] not in ("memory",) and self.t[k] != "(" and \
            (k + 1 < len(t) and t[k + 1] in ("=", ";"))

    def parse_stmt(self):
        tok = self.peek()
        if tok == "{":
            return self.parse_block()
        if tok == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt()
            other = None
            if self.accept("else"):
                other = self.parse_stmt()
            return ("if", cond, then, other)
        if tok == "for":
            self.next()
            self.expect("(")
            init = self.parse_stmt()  # consumes its ';'
            cond = self.parse_expr()
            self.expect(";")
            post = self.parse_expr()
            self.expect(")")
            body = self.parse_stmt()
            return ("for", init, cond, post, body)
        if tok == "return":
            self.next()
            if self.peek() == ";":
                self.next()
                return ("return", None)
            e = self.parse_expr()
            self.expect(";")
            return ("return", e)
        if tok == "require":
            self.next()
            self.expect("(")
            e = self.parse_expr()
            msg = None
            if self.accept(","):
                msg = self.parse_expr()
            self.expect(")")
            self.expect(";")
            return ("require", e, msg)
        if tok == "assembly":
            self.next()
            return ("assembly", self.parse_asm_block())
        if self._looks_like_decl():
            vtype = self.parse_type()
            self.accept("memory")
            name = self.next()
            init = None
            if self.accept("="):
                init = self.parse_expr()
            self.expect(";")
            return ("decl", name, vtype, init)
        e = self.parse_expr()
        self.expect(";")
        return ("expr", e)

    def parse_asm_block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            name = self.next()
            self.expect(":=")
            stmts.append((name, self.parse_asm_expr()))
        return stmts

    def parse_asm_expr(self):
        tok = self.next()
        if self.peek() == "(":
            self.next()
            args = []
            while not self.accept(")"):
                args.append(self.parse_asm_expr())
                self.accept(",")
            return ("acall", tok, args)
        if re.match(r"0x|[0-9]", tok):
            return ("num", int(tok, 0))
        return ("var", tok)

    # -- expressions (precedence climbing) --
    def parse_expr(self):
        return self.parse_assign()

    def parse_assign(self):
        lhs = self.parse_or()
        if self.peek() == "=":
            self.next()
            rhs = self.parse_assign()
            return ("assign", lhs, rhs)
        return lhs

    def _binop(self, sub, ops):
        e = sub()
        while self.peek() in ops:
            op = self.next()
            e = ("bin", op, e, sub())
        return e

    def parse_or(self):
        return self._binop(self.parse_and, ("||",))

    def parse_and(self):
        return self._binop(self.parse_cmp, ("&&",))

    def parse_cmp(self):
        return self._binop(self.parse_add,
                           ("==", "!=", "<", ">", "<=", ">="))

    def parse_add(self):
        return self._binop(self.parse_mul, ("+", "-"))

    def parse_mul(self):
        return self._binop(self.parse_unary, ("*", "/", "%"))

    def parse_unary(self):
        if self.peek() == "!":
            self.next()
            return ("not", self.parse_unary())
        if self.peek() == "-":
            self.next()
            return ("neg", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            if self.accept("."):
                name = self.next()
                if name == "length":
                    e = ("length", e)
                else:
                    e = ("member", e, name)
            elif self.accept("["):
                idx = self.parse_expr()
                self.expect("]")
                e = ("index", e, idx)
            elif self.peek() == "(":
                self.next()
                args = []
                while not self.accept(")"):
                    args.append(self.parse_expr())
                    self.accept(",")
                e = ("call", e, args)
            elif self.peek() == "++":
                self.next()
                e = ("postinc", e)
            else:
                return e

    def parse_primary(self):
        tok = self.next()
        if tok == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if tok == "[":  # array literal
            elems = []
            while not self.accept("]"):
                elems.append(self.parse_expr())
                self.accept(",")
            return ("array", elems)
        if tok == "new":
            t = self.parse_type()
            self.expect("(")
            n = self.parse_expr()
            self.expect(")")
            return ("new_array", t, n)
        if tok in ("true", "false"):
            return ("num", 1 if tok == "true" else 0)
        if re.match(r"0x[0-9a-fA-F]+$|\d+$", tok):
            return ("num", int(tok, 0))
        return ("var", tok)


# ---- evaluator -------------------------------------------------------------


class _Ref:
    """An assignable location."""

    __slots__ = ("get", "set")

    def __init__(self, get, set_):
        self.get = get
        self.set = set_


class SolContract:
    """Parse `source` and expose the contract's public functions.

    call("verifyTx", proof, inputs) evaluates with EVM semantics; struct
    values are dicts keyed by field name, arrays are lists, uints are ints.
    """

    def __init__(self, source: str):
        self.units = Parser(tokenize(source)).parse_file()
        self.contract = next(u for u in self.units.values()
                             if u["kind"] == "contract")
        self.gas_used = 0

    # -- struct helpers --
    def _find_struct(self, base):
        if isinstance(base, tuple):
            lib, name = base
            return self.units[lib]["structs"][name]
        for u in self.units.values():
            if base in u["structs"]:
                return u["structs"][base]
        return None

    def zero_value(self, vtype):
        dims = vtype["dims"]
        if dims:
            inner = {"base": vtype["base"], "dims": dims[:-1]}
            if dims[-1] is None:
                return []
            return [self.zero_value(inner) for _ in range(dims[-1])]
        fields = self._find_struct(vtype["base"])
        if fields is not None:
            return {fn: self.zero_value(ft) for fn, ft in fields}
        return 0

    # -- public API --
    def call(self, name: str, *args):
        return self._call_func(self.contract, name, list(args))

    def _call_func(self, unit, name, args):
        f = unit["funcs"][name]
        env = [{}]
        for (pname, _pt), v in zip(f["params"], args):
            env[0][pname] = v
        ret_names = []
        for rname, rtype in f["rets"]:
            if rname:
                env[0][rname] = self.zero_value(rtype)
                ret_names.append(rname)
        try:
            self._exec_stmt(f["body"], env, unit)
        except _ReturnSignal as r:
            if r.value is not None:
                return r.value
        if ret_names:
            return env[0][ret_names[0]]
        return None

    # -- statements --
    def _exec_stmt(self, st, env, unit):
        op = st[0]
        if op == "block":
            env.append({})
            try:
                for s in st[1]:
                    self._exec_stmt(s, env, unit)
            finally:
                env.pop()
        elif op == "decl":
            _, name, vtype, init = st
            env[-1][name] = self._eval(init, env, unit) \
                if init is not None else self.zero_value(vtype)
        elif op == "expr":
            self._eval(st[1], env, unit)
        elif op == "if":
            if self._eval(st[1], env, unit):
                self._exec_stmt(st[2], env, unit)
            elif st[3] is not None:
                self._exec_stmt(st[3], env, unit)
        elif op == "for":
            env.append({})
            try:
                self._exec_stmt(st[1], env, unit)
                while self._eval(st[2], env, unit):
                    self._exec_stmt(st[4], env, unit)
                    self._eval(st[3], env, unit)
            finally:
                env.pop()
        elif op == "return":
            raise _ReturnSignal(self._eval(st[1], env, unit)
                                if st[1] is not None else None)
        elif op == "require":
            if not self._eval(st[1], env, unit):
                raise RevertError("require failed")
        elif op == "assembly":
            self._exec_asm(st[1], env, unit)
        else:
            raise NotImplementedError(op)

    # -- expressions --
    def _lvalue(self, e, env, unit) -> _Ref:
        kind = e[0]
        if kind == "var":
            name = e[1]
            for scope in reversed(env):
                if name in scope:
                    return _Ref(lambda s=scope: s[name],
                                lambda v, s=scope: s.__setitem__(name, v))
            # new local (for-loop inits always declare; bare assignment to
            # an unknown name should not silently create state)
            raise NameError(name)
        if kind == "member":
            obj = self._eval(e[1], env, unit)
            return _Ref(lambda: obj[e[2]],
                        lambda v: obj.__setitem__(e[2], v))
        if kind == "index":
            obj = self._eval(e[1], env, unit)
            idx = self._eval(e[2], env, unit)
            return _Ref(lambda: obj[idx],
                        lambda v: obj.__setitem__(idx, v))
        raise NotImplementedError(f"lvalue {kind}")

    def _eval(self, e, env, unit):
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "var":
            name = e[1]
            for scope in reversed(env):
                if name in scope:
                    return scope[name]
            raise NameError(name)
        if kind == "assign":
            v = self._eval(e[2], env, unit)
            self._lvalue(e[1], env, unit).set(v)
            return v
        if kind == "postinc":
            ref = self._lvalue(e[1], env, unit)
            v = ref.get()
            ref.set((v + 1) & U256)
            return v
        if kind == "bin":
            op = e[1]
            if op == "&&":
                return (self._eval(e[2], env, unit) and
                        self._eval(e[3], env, unit) and 1) or 0
            if op == "||":
                return (self._eval(e[2], env, unit) or
                        self._eval(e[3], env, unit)) and 1 or 0
            a = self._eval(e[2], env, unit)
            b = self._eval(e[3], env, unit)
            if op == "+":
                return (a + b) & U256
            if op == "-":
                return (a - b) & U256
            if op == "*":
                return (a * b) & U256
            if op == "/":
                if b == 0:
                    raise RevertError("division by zero")
                return a // b
            if op == "%":
                if b == 0:
                    raise RevertError("modulo by zero")
                return a % b
            if op == "==":
                return int(a == b)
            if op == "!=":
                return int(a != b)
            if op == "<":
                return int(a < b)
            if op == ">":
                return int(a > b)
            if op == "<=":
                return int(a <= b)
            if op == ">=":
                return int(a >= b)
            raise NotImplementedError(op)
        if kind == "not":
            return int(not self._eval(e[1], env, unit))
        if kind == "neg":
            return (-self._eval(e[1], env, unit)) & U256
        if kind == "length":
            return len(self._eval(e[1], env, unit))
        if kind == "member":
            return self._eval(e[1], env, unit)[e[2]]
        if kind == "index":
            return self._eval(e[1], env, unit)[
                self._eval(e[2], env, unit)]
        if kind == "array":
            return [self._eval(x, env, unit) for x in e[1]]
        if kind == "new_array":
            t = e[1]
            n = self._eval(e[2], env, unit)
            inner = {"base": t["base"], "dims": t["dims"][:-1]}
            return [self.zero_value(inner) for _ in range(n)]
        if kind == "call":
            return self._eval_call(e, env, unit)
        raise NotImplementedError(kind)

    def _eval_call(self, e, env, unit):
        target, args_ast = e[1], e[2]
        args = [self._eval(a, env, unit) for a in args_ast]
        # qualified: Lib.fn(...) or Lib.Struct(...)
        if target[0] == "member" and target[1][0] == "var" and \
                target[1][1] in self.units:
            lib = self.units[target[1][1]]
            name = target[2]
            if name in lib["structs"]:
                return self._construct(lib["structs"][name], args)
            return self._call_func(lib, name, args)
        if target[0] == "var":
            name = target[1]
            if name in _ELEM_TYPES:  # elementary cast: uint(x)
                return args[0] & U256
            if name in unit["funcs"]:
                return self._call_func(unit, name, args)
            if name in unit["structs"]:
                return self._construct(unit["structs"][name], args)
            for u in self.units.values():
                if name in u["funcs"]:
                    return self._call_func(u, name, args)
        raise NotImplementedError(f"call target {target}")

    def _construct(self, fields, args):
        out = {}
        for (fname, ftype), v in zip(fields, args):
            if isinstance(v, (list, tuple)):
                v = list(v)
            out[fname] = v
        if len(args) < len(fields):
            for fname, ftype in fields[len(args):]:
                out[fname] = self.zero_value(ftype)
        return out

    # -- inline assembly (the three precompile staticcalls) --
    def _exec_asm(self, stmts, env, unit):
        for name, expr in stmts:
            v = self._eval_asm(expr, env, unit)
            self._lvalue(("var", name), env, unit).set(v)

    def _eval_asm(self, e, env, unit):
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "var":
            return self._eval(("var", e[1]), env, unit)
        name, args = e[1], e[2]
        if name == "gas":
            return 1 << 30
        if name in ("add", "sub", "mul"):
            # pointer arithmetic: add(arr, 0x20) skips the length slot of a
            # dynamic array — for our object model that IS the array
            a = self._eval_asm(args[0], env, unit)
            if isinstance(a, list):
                return a
            b = self._eval_asm(args[1], env, unit)
            if isinstance(b, list):
                return b
            return {"add": (a + b) & U256, "sub": (a - b) & U256,
                    "mul": (a * b) & U256}[name]
        if name == "staticcall":
            _gas = self._eval_asm(args[0], env, unit)
            addr = self._eval_asm(args[1], env, unit)
            inp = self._eval_asm(args[2], env, unit)
            _insz = self._eval_asm(args[3], env, unit)
            out = self._eval_asm(args[4], env, unit)
            _outsz = self._eval_asm(args[5], env, unit)
            words = self._flatten_words(inp)
            return self._precompile(addr, words, out)
        raise NotImplementedError(f"asm {name}")

    def _flatten_words(self, obj):
        if isinstance(obj, list):
            out = []
            for v in obj:
                out.extend(self._flatten_words(v))
            return out
        if isinstance(obj, dict):
            out = []
            for v in obj.values():
                out.extend(self._flatten_words(v))
            return out
        return [obj]

    # -- EIP-196/197 precompiles over curves/bn254 --
    def _precompile(self, addr, words, out) -> int:
        q = bn254.P
        try:
            if addr == 6:  # ecAdd
                x1, y1, x2, y2 = (words + [0] * 4)[:4]
                p = self._g1_load(x1, y1)
                r = self._g1_load(x2, y2)
                s = bn254.g1_to_affine(bn254.g1_add(
                    bn254.g1_from_affine(p), bn254.g1_from_affine(r)))
                self._g1_store(out, s)
                return 1
            if addr == 7:  # ecMul
                x, y, s = (words + [0] * 3)[:3]
                p = self._g1_load(x, y)
                r = bn254.g1_to_affine(
                    bn254.g1_mul(bn254.g1_from_affine(p), s))
                self._g1_store(out, r)
                return 1
            if addr == 8:  # ecPairing
                if len(words) % 6:
                    return 0
                acc = bn254.F12_ONE
                for k in range(0, len(words), 6):
                    ax, ay, bx_im, bx_re, by_im, by_re = words[k : k + 6]
                    for w in (ax, ay, bx_im, bx_re, by_im, by_re):
                        if w >= q:
                            raise RevertError("non-canonical field element")
                    g1 = self._g1_load(ax, ay)
                    g2 = None if (bx_im, bx_re, by_im, by_re) == (0,) * 4 \
                        else ((bx_re, bx_im), (by_re, by_im))
                    if g2 is not None:
                        self._g2_check(g2)
                    if g1 is None or g2 is None:
                        continue
                    acc = bn254.f12_mul(acc, bn254.pairing(g1, g2))
                out[0] = int(acc == bn254.F12_ONE)
                return 1
        except RevertError:
            return 0
        return 0

    def _g1_load(self, x, y):
        """EVM wire G1: (0,0) encodes infinity; must be canonical, on curve."""
        if x >= bn254.P or y >= bn254.P:
            raise RevertError("non-canonical")
        if (x, y) == (0, 0):
            return None
        if not bn254.g1_is_on_curve((x, y)):
            raise RevertError("not on curve")
        return (x, y)

    def _g2_check(self, g2):
        if not bn254.g2_is_on_curve(g2):
            raise RevertError("g2 not on curve")
        # EIP-197: G2 inputs must be in the r-torsion
        if not bn254.g2_is_zero(bn254.g2_mul(bn254.g2_from_affine(g2),
                                             bn254.R)):
            raise RevertError("g2 not in subgroup")

    def _g1_store(self, out, p):
        x, y = (0, 0) if p is None else p
        if isinstance(out, dict):
            keys = list(out.keys())
            out[keys[0]], out[keys[1]] = x, y
        else:
            out[0], out[1] = x, y


class _ReturnSignal(Exception):
    def __init__(self, value):
        self.value = value
