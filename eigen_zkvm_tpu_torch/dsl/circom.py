"""circom front-end: parse + elaborate a practical circom-2 subset into the
native CircuitBuilder (R1CS + witness) — the dsl_compile equivalent
(reference: dsl_compile/src/lib.rs wrapping the vendored circom compiler).

Supported subset (enough for hand-written arithmetic circuits and the
simple circomlib-style gadgets): templates with parameters, components
(incl. arrays of components and `component main = T();`), signal
input/output/intermediate (with array dims), var, functions with
while/if/return, for loops, compile-time conditionals, `<==`/`==>`
(assign + constrain), `<--`/`-->` (witness hints), `===` (constrain),
arithmetic (+ - * / \\ % ** unary-) over the field, comparisons and
boolean ops in compile-time expressions, bit ops on vars, include
resolution across search paths.

`template custom` (circom-2 custom gates) is supported: the body computes
witness only (no R1CS constraints) and one gate use is recorded with the
declared signals in declaration order — the layout the compressor's
plonk_setup expects per gate name; template args become gate params.

Not supported (use the native circuit builders or externally compiled
.r1cs for these): anonymous components, buses, tags, tuple assignments,
public-signal lists other than main's.

Port of eigen_zkvm_tpu/dsl/circom.py (the tokenizer and the parser, host
code, unchanged); the elaborator (dsl/elaborate.py) builds on the port's
recursion/circuit.CircuitBuilder.
"""
from __future__ import annotations

import re

_TOKEN = re.compile(r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<num>0x[0-9a-fA-F]+|\d+)
  | (?P<id>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><==|==>|<--|-->|===|\+\+|--|\+=|-=|\*=|<=|>=|==|!=|&&|\|\||<<|>>|\*\*|[-+*/\\%!<>=(){}\[\],;.?:&|^~])
  | (?P<ws>\s+)
  | (?P<str>"[^"]*")
""", re.VERBOSE | re.DOTALL)


def _tokenize(src: str):
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if not m:
            raise SyntaxError(f"bad token at {src[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("comment", "ws"):
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


class _Parser:
    """Recursive-descent parser producing a small statement/expression AST
    (tuples: (kind, ...))."""

    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise SyntaxError(f"expected {val!r}, got {t[1]!r}")
        return t

    def accept(self, val):
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # ---- top level ----
    def parse_file(self):
        items = {"templates": {}, "functions": {}, "main": None,
                 "includes": [], "custom": set()}
        while self.peek()[0] != "eof":
            t = self.peek()[1]
            if t == "pragma":
                while self.next()[1] != ";":
                    pass
            elif t == "include":
                self.next()
                items["includes"].append(self.next()[1].strip('"'))
                self.expect(";")
            elif t == "template":
                self.next()
                is_custom = False
                while self.peek()[1] in ("parallel", "custom"):
                    is_custom |= self.next()[1] == "custom"
                name = self.next()[1]
                params = self._param_list()
                body = self._block()
                items["templates"][name] = (params, body)
                if is_custom:
                    items["custom"].add(name)
            elif t == "function":
                self.next()
                name = self.next()[1]
                params = self._param_list()
                body = self._block()
                items["functions"][name] = (params, body)
            elif t == "component":
                # component main [{public [a, b]}] = T(args);
                self.next()
                assert self.next()[1] == "main"
                publics = []
                if self.accept("{"):
                    self.expect("public")
                    self.expect("[")
                    while not self.accept("]"):
                        tok = self.next()[1]
                        if tok != ",":
                            publics.append(tok)
                    self.expect("}")
                self.expect("=")
                name = self.next()[1]
                self.expect("(")
                args = []
                if not self.accept(")"):
                    while True:
                        args.append(self._expr())
                        if not self.accept(","):
                            break
                    self.expect(")")
                self.expect(";")
                items["main"] = (name, args, publics)
            else:
                raise SyntaxError(f"unexpected top-level token {t!r}")
        return items

    def _param_list(self):
        self.expect("(")
        params = []
        if not self.accept(")"):
            while True:
                params.append(self.next()[1])
                if not self.accept(","):
                    break
            self.expect(")")
        return params

    def _block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self._stmt())
        return stmts

    # ---- statements ----
    def _stmt(self):
        t = self.peek()[1]
        if t == "{":
            return ("block", self._block())
        if t == "signal":
            self.next()
            kind = "intermediate"
            if self.peek()[1] in ("input", "output"):
                kind = self.next()[1]
            names = []
            while True:
                name = self.next()[1]
                dims = []
                while self.accept("["):
                    dims.append(self._expr())
                    self.expect("]")
                init = None
                if self.peek()[1] in ("<==", "<--"):
                    op = self.next()[1]
                    init = (op, self._expr())
                names.append((name, dims, init))
                if not self.accept(","):
                    break
            self.expect(";")
            return ("signal", kind, names)
        if t == "var":
            st = self._var_decl()
            self.expect(";")
            return st
        if t == "component":
            self.next()
            name = self.next()[1]
            dims = []
            while self.accept("["):
                dims.append(self._expr())
                self.expect("]")
            init = None
            if self.accept("="):
                init = self._expr()
            self.expect(";")
            return ("component", name, dims, init)
        if t == "for":
            self.next()
            self.expect("(")
            init = self._var_decl() if self.peek()[1] == "var" \
                else self._simple_stmt()
            self.expect(";")
            cond = self._expr()
            self.expect(";")
            step = self._simple_stmt()
            self.expect(")")
            body = self._stmt()
            return ("for", init, cond, step, body)
        if t == "while":
            self.next()
            self.expect("(")
            cond = self._expr()
            self.expect(")")
            body = self._stmt()
            return ("while", cond, body)
        if t == "if":
            self.next()
            self.expect("(")
            cond = self._expr()
            self.expect(")")
            then = self._stmt()
            els = None
            if self.accept("else"):
                els = self._stmt()
            return ("if", cond, then, els)
        if t == "return":
            self.next()
            e = self._expr()
            self.expect(";")
            return ("return", e)
        if t == "assert":
            self.next()
            self.expect("(")
            e = self._expr()
            self.expect(")")
            self.expect(";")
            return ("assert", e)
        if t == "log":
            self.next()
            self.expect("(")
            depth = 1
            while depth:
                tok = self.next()[1]
                if tok == "(":
                    depth += 1
                elif tok == ")":
                    depth -= 1
            self.expect(";")
            return ("nop",)
        s = self._simple_stmt()
        self.expect(";")
        return s

    def _var_decl(self):
        self.expect("var")
        names = []
        while True:
            name = self.next()[1]
            dims = []
            while self.accept("["):
                dims.append(self._expr())
                self.expect("]")
            init = None
            if self.accept("="):
                init = self._expr()
            names.append((name, dims, init))
            if not self.accept(","):
                break
        return ("var", names)

    def _simple_stmt(self):
        lhs = self._expr()
        t = self.peek()[1]
        if t in ("<==", "<--", "===", "="):
            self.next()
            rhs = self._expr()
            return ("assign", t, lhs, rhs)
        if t in ("==>", "-->"):
            self.next()
            rhs = self._expr()
            op = "<==" if t == "==>" else "<--"
            return ("assign", op, rhs, lhs)
        if t in ("+=", "-=", "*="):
            self.next()
            return ("assign", "=", lhs,
                    ("bin", t[0], lhs, self._expr()))
        if t in ("++", "--"):
            self.next()
            return ("assign", "=", lhs, ("bin", t[0], lhs, ("num", 1)))
        return ("expr", lhs)

    # ---- expressions (precedence climbing) ----
    _PREC = [["?"], ["||"], ["&&"], ["|"], ["^"], ["&"],
             ["==", "!="], ["<", ">", "<=", ">="], ["<<", ">>"],
             ["+", "-"], ["*", "/", "\\", "%"], ["**"]]

    def _expr(self, level=0):
        if level == 0:
            # ternary
            cond = self._expr(1)
            if self.accept("?"):
                a = self._expr(0)
                self.expect(":")
                b = self._expr(0)
                return ("ternary", cond, a, b)
            return cond
        if level >= len(self._PREC):
            return self._unary()
        ops = self._PREC[level]
        lhs = self._expr(level + 1)
        while self.peek()[1] in ops:
            op = self.next()[1]
            rhs = self._expr(level + 1)
            lhs = ("bin", op, lhs, rhs)
        return lhs

    def _unary(self):
        t = self.peek()
        if t[1] in ("-", "!", "~"):
            self.next()
            return ("un", t[1], self._unary())
        return self._postfix()

    def _postfix(self):
        e = self._primary()
        while True:
            t = self.peek()[1]
            if t == "[":
                self.next()
                idx = self._expr()
                self.expect("]")
                e = ("index", e, idx)
            elif t == ".":
                self.next()
                e = ("member", e, self.next()[1])
            elif t == "(" and e[0] == "name":
                self.next()
                args = []
                if not self.accept(")"):
                    while True:
                        args.append(self._expr())
                        if not self.accept(","):
                            break
                    self.expect(")")
                e = ("call", e[1], args)
            else:
                return e

    def _primary(self):
        kind, val = self.next()
        if kind == "num":
            return ("num", int(val, 0))
        if kind == "id":
            return ("name", val)
        if val == "(":
            e = self._expr()
            self.expect(")")
            return e
        if val == "[":
            items = []
            if not self.accept("]"):
                while True:
                    items.append(self._expr())
                    if not self.accept(","):
                        break
                self.expect("]")
            return ("array", items)
        raise SyntaxError(f"unexpected {val!r}")


def parse(src: str):
    return _Parser(_tokenize(src)).parse_file()
