"""circom elaboration: execute parsed templates against the CircuitBuilder.

Semantics follow circom 2: constraint expressions must stay quadratic
(linear*linear + linear); `<--` evaluates in value space only; components
execute their bodies once every input signal has been assigned; `main`'s
outputs and declared public inputs become the circuit's public signals.

Port of eigen_zkvm_tpu/dsl/elaborate.py on the port's
recursion/circuit.CircuitBuilder: the same constraints, witness, publics,
custom-gate records and .sym entries, and the same exceptions on input
outside the subset.
"""
from __future__ import annotations

import os

from ..recursion.circuit import CircuitBuilder
from . import circom as _parser


class Sig:
    """A signal: wire + known witness value."""

    __slots__ = ("w",)

    def __init__(self, w):
        self.w = w


class Quad:
    """A quadratic expression a*b + c (a, b, c linear wires)."""

    __slots__ = ("a", "b", "c")

    def __init__(self, a, b, c):
        self.a = a
        self.b = b
        self.c = c


class Component:
    def __init__(self, elab, tname, args, path="main"):
        self.elab = elab
        self.tname = tname
        self.args = args
        self.path = path
        elab.components.append(self)
        self.signals = {}       # name -> Sig or nested lists
        self.inputs = []        # flat list of (container, key) slots pending
        self.n_unset = 0
        self.executed = False
        params, body = elab.templates[tname]
        assert len(params) == len(args), (tname, params, args)
        self.env = dict(zip(params, args))
        self._declare_pass(body)
        if self.n_unset == 0:
            self._execute()

    # first pass: declare input signals so the parent can assign them
    def _declare_pass(self, body):
        for st in body:
            if st[0] == "signal" and st[1] == "input":
                for name, dims, _init in st[2]:
                    shape = [self.elab._int(self.env, d) for d in dims]
                    self.signals[name] = self._make_unset(shape)
                    self.n_unset += self._count(shape)

    def _make_unset(self, shape):
        if not shape:
            return None
        return [self._make_unset(shape[1:]) for _ in range(shape[0])]

    @staticmethod
    def _count(shape):
        n = 1
        for d in shape:
            n *= d
        return n

    def assign_input(self, path, sig: Sig):
        """path: (name, idx...) — set one input slot; run when complete."""
        name, *idx = path
        if not idx:
            assert self.signals.get(name) is None
            self.signals[name] = sig
        else:
            cur = self.signals[name]
            for i in idx[:-1]:
                cur = cur[i]
            assert cur[idx[-1]] is None
            cur[idx[-1]] = sig
        self.n_unset -= 1
        if self.n_unset == 0 and not self.executed:
            self._execute()

    def _execute(self):
        self.executed = True
        _params, body = self.elab.templates[self.tname]
        env = dict(self.env)
        env["$signals"] = self.signals
        env["$component"] = self
        env["$prefix"] = self.path
        if self.tname in self.elab.custom:
            self._execute_custom(env, body)
            return
        self.elab._exec_block(env, body, skip_input_decl=True)

    def _execute_custom(self, env, body):
        """`template custom` (circom-2 custom gates): the body computes the
        witness but emits NO R1CS constraints — the gate's semantics live
        in the proving system (compressor12's PIL selectors).  One gate use
        is recorded with every declared signal in declaration order (the
        layout recursion/plonk_setup.py expects per gate name), template
        args becoming gate params (reference: vendored circom's custom
        gates sections + compressor12_setup.rs gate handling)."""
        b = self.elab.b
        rec = b.record
        b.record = False
        try:
            self.elab._exec_block(env, body, skip_input_decl=True)
        finally:
            b.record = rec

        def flat(v, out):
            if isinstance(v, list):
                for x in v:
                    flat(x, out)
            else:
                assert v is not None, \
                    f"unset signal in custom template {self.tname}"
                out.append(b.materialize(v.w))

        ids: list = []
        for st in body:
            if st[0] == "signal":
                for name, _dims, _init in st[2]:
                    flat(self.signals[name], ids)
        if rec:
            entry = (self.tname, ids)
            if self.args:
                entry = (self.tname, ids, tuple(int(a) for a in self.args))
            b.custom_gates.append(entry)


class Elaborator:
    def __init__(self, source: str, search_paths=(), prime: int | None = None):
        self.components: list = []  # every instantiated Component, main first
        from ..recursion.circuit import P as GL_P
        self.prime = prime or GL_P
        self.b = CircuitBuilder(prime=self.prime)
        self.templates = {}
        self.functions = {}
        self.custom = set()   # names of `template custom` declarations
        self._load(source, list(search_paths), set())
        self.main = self._ast["main"]

    def _load(self, src, paths, seen):
        ast = _parser.parse(src)
        self._ast = ast
        self.templates.update(ast["templates"])
        self.functions.update(ast["functions"])
        self.custom.update(ast.get("custom", ()))
        for inc in ast["includes"]:
            if inc in seen:
                continue
            seen.add(inc)
            for p in paths:
                f = os.path.join(p, inc)
                if os.path.exists(f):
                    sub = _parser.parse(open(f).read())
                    self.templates.update(sub["templates"])
                    self.functions.update(sub["functions"])
                    self.custom.update(sub.get("custom", ()))
                    for inc2 in sub["includes"]:
                        if inc2 not in seen:
                            seen.add(inc2)
                            # one level of nesting at a time
                            self._load(open(os.path.join(
                                os.path.dirname(f), inc2)).read()
                                if os.path.exists(os.path.join(
                                    os.path.dirname(f), inc2))
                                else "", paths, seen)
                    break

    # ---- public API ----
    def run(self, inputs: dict):
        """inputs: {signal_name: int | nested list}.  Elaborates main and
        returns the populated CircuitBuilder."""
        tname, arg_exprs, publics = self.main
        args = [self._int({}, a) for a in arg_exprs]
        params, body = self.templates[tname]
        env = dict(zip(params, args))
        comp = Component.__new__(Component)
        comp.elab = self
        comp.path = "main"
        self.components.append(comp)
        comp.tname = tname
        comp.args = args
        comp.signals = {}
        comp.inputs = []
        comp.n_unset = 0
        comp.executed = True
        comp.env = env

        # main: allocate public signals first (outputs then declared public
        # inputs per circom's witness layout), then private inputs
        in_decls = []
        out_decls = []
        for st in body:
            if st[0] == "signal" and st[1] in ("input", "output"):
                for name, dims, _init in st[2]:
                    shape = [self._int(env, d) for d in dims]
                    (in_decls if st[1] == "input" else out_decls).append(
                        (name, shape))

        def alloc(shape, maker):
            if not shape:
                return maker()
            return [alloc(shape[1:], maker) for _ in range(shape[0])]

        # outputs: values are computed by the body; allocate placeholders
        # as publics and bind with === at the end
        out_placeholders = {}
        for name, shape in out_decls:
            out_placeholders[name] = alloc(
                shape, lambda: Sig(self.b.public(0)))
        pub_names = set(self.main[2])
        priv, pub = [], []
        for name, shape in in_decls:
            (pub if name in pub_names else priv).append((name, shape))

        def get_input(name, path):
            v = inputs[name]
            for i in path:
                v = v[i]
            return int(v)

        def alloc_inputs(decls, public):
            for name, shape in decls:
                def rec(shape, path):
                    if not shape:
                        val = get_input(name, path)
                        w = self.b.public(val) if public else \
                            self.b.wire(self.b.sig(val))
                        return Sig(w)
                    return [rec(shape[1:], path + [i])
                            for i in range(shape[0])]
                comp.signals[name] = rec(shape, [])

        alloc_inputs(pub, True)
        # fix output placeholder values now that publics are final?  outputs
        # precede inputs in circom; we allocated outputs first already.
        alloc_inputs(priv, False)

        env["$signals"] = comp.signals
        env["$component"] = comp
        env["$prefix"] = "main"
        env["$main_outputs"] = out_placeholders
        self._exec_block(env, body, skip_input_decl=True, is_main=True)

        # bind output placeholders to computed outputs
        for name, ph in out_placeholders.items():
            def bind(ph, real):
                if isinstance(ph, list):
                    for a, b2 in zip(ph, real):
                        bind(a, b2)
                    return
                # retro-fix the public value, then constrain equality
                sid = next(iter(ph.w.lc))
                self.b.w[sid] = self.b.val(real.w)
                self.b.assert_eq(ph.w, real.w)
            bind(ph, comp.signals[name])
            # the public placeholder IS the output's witness entry
            comp.signals[name] = ph
        self.b.sym = sym_table(self)
        return self.b

    # ---- execution ----
    def _exec_block(self, env, body, skip_input_decl=False, is_main=False):
        for st in body:
            self._exec_stmt(env, st, skip_input_decl, is_main)

    def _exec_stmt(self, env, st, skip_input_decl=False, is_main=False):
        kind = st[0]
        b = self.b
        if kind == "block":
            self._exec_block(env, st[1], skip_input_decl, is_main)
        elif kind == "nop":
            pass
        elif kind == "signal":
            _, sk, decls = st
            sigs = env["$signals"]
            for name, dims, init in decls:
                if sk == "input" and skip_input_decl:
                    continue
                if sk == "output" and is_main:
                    # computed into $signals; placeholder handled in run()
                    pass
                shape = [self._int(env, d) for d in dims]

                def mk(shape):
                    if not shape:
                        return None
                    return [mk(shape[1:]) for _ in range(shape[0])]

                sigs[name] = mk(shape)
                if init is not None:
                    assert not shape
                    op, e = init
                    sigs[name] = self._assign_signal(env, op, e)
        elif kind == "var":
            for name, dims, init in st[1]:
                shape = [self._int(env, d) for d in dims]

                def mkv(shape):
                    if not shape:
                        return 0
                    return [mkv(shape[1:]) for _ in range(shape[0])]

                env[name] = mkv(shape) if shape else (
                    self._value(env, init) if init is not None else 0)
                if shape and init is not None:
                    env[name] = self._value(env, init)
        elif kind == "component":
            _, name, dims, init = st
            shape = [self._int(env, d) for d in dims]
            if shape:
                def mkc(shape):
                    if not shape:
                        return None
                    return [mkc(shape[1:]) for _ in range(shape[0])]
                env.setdefault("$components", {})
                env["$signals"].setdefault("$comp_" + name, None)
                env[name] = mkc(shape)
            elif init is not None:
                env[name] = self._instantiate(env, init, varname=name)
            else:
                env[name] = None
        elif kind == "for":
            self._exec_stmt(env, st[1])
            while self._int(env, st[2]):
                self._exec_stmt(env, st[4], skip_input_decl, is_main)
                self._exec_stmt(env, st[3])
        elif kind == "while":
            while self._int(env, st[1]):
                self._exec_stmt(env, st[2], skip_input_decl, is_main)
        elif kind == "if":
            if self._int(env, st[1]):
                self._exec_stmt(env, st[2], skip_input_decl, is_main)
            elif st[3] is not None:
                self._exec_stmt(env, st[3], skip_input_decl, is_main)
        elif kind == "assert":
            assert self._int(env, st[1]), "circom assert failed"
        elif kind == "assign":
            _, op, lhs, rhs = st
            if op == "=":
                self._assign_var(env, lhs, rhs)
            elif op == "===":
                self._constrain_eq(env, lhs, rhs)
            else:  # <== or <--
                target = self._assign_signal(env, op, rhs)
                self._store_signal(env, lhs, target)
        elif kind == "expr":
            self._eval(env, st[1])
        elif kind == "return":
            raise _Return(self._value(env, st[1]))
        else:
            raise ValueError(kind)

    def _instantiate(self, env, init, varname=None):
        assert init[0] == "call"
        args = [self._int(env, a) for a in init[2]]
        path = env.get("$prefix", "main") + "." + (varname or init[1])
        return Component(self, init[1], args, path=path)

    # ---- assignment helpers ----
    def _assign_signal(self, env, op, rhs):
        if op == "<--":
            val = self._value(env, rhs)
            return Sig(self.b.wire(self.b.sig(val)))
        q = self._quad(env, rhs)
        if isinstance(q, Quad):
            # sig = a*b + c  ->  materialize a*b, add c
            prod = self.b.mul(q.a, q.b)
            return Sig(prod + q.c)
        return Sig(q)

    def _store_signal(self, env, lhs, sig: Sig):
        """lhs is a signal lvalue (possibly a component input)."""
        base, path = self._lvalue(env, lhs)
        if isinstance(base, Component):
            base.assign_input(path, sig)
            return
        # local signal (possibly array slot)
        sigs = env["$signals"]
        name, *idx = path
        if not idx:
            sigs[name] = sig
        else:
            cur = sigs[name]
            for i in idx[:-1]:
                cur = cur[i]
            cur[idx[-1]] = sig

    def _constrain_eq(self, env, lhs, rhs):
        ql = self._quad(env, lhs)
        qr = self._quad(env, rhs)
        if isinstance(ql, Quad) and isinstance(qr, Quad):
            raise ValueError("non-quadratic constraint")
        if isinstance(qr, Quad):
            ql, qr = qr, ql
        if isinstance(ql, Quad):
            # a*b + c === lin  ->  a*b = lin - c
            self.b._constraint(ql.a, ql.b, qr - ql.c)
            av = self.b.val(ql.a) * self.b.val(ql.b)
            assert (av + self.b.val(ql.c) - self.b.val(qr)) % self.prime == 0
        else:
            self.b.assert_eq(ql, qr)

    def _assign_var(self, env, lhs, rhs):
        try:
            q = self._quad(env, rhs)
            if isinstance(q, Quad):
                val = q
            elif q.is_const:
                val = q.k
            else:
                val = q
        except Exception:
            val = self._value(env, rhs)
        if lhs[0] == "name":
            env[lhs[1]] = val
            return
        # array var slot
        path = []
        e = lhs
        while e[0] == "index":
            path.insert(0, self._int(env, e[2]))
            e = e[1]
        assert e[0] == "name"
        cur = env[e[1]]
        for i in path[:-1]:
            cur = cur[i]
        cur[path[-1]] = val

    def _lvalue(self, env, e):
        """Resolve an lvalue into (component-or-None, (name, idx...))."""
        idx = []
        while e[0] == "index":
            idx.insert(0, self._int(env, e[2]))
            e = e[1]
        if e[0] == "member":
            inner = e[1]
            inner_idx = []
            while inner[0] == "index":
                inner_idx.insert(0, self._int(env, inner[2]))
                inner = inner[1]
            comp = env[inner[1]]
            for i in inner_idx:
                comp = comp[i]
            return comp, tuple([e[2]] + idx)
        assert e[0] == "name"
        return None, tuple([e[1]] + idx)

    # ---- expression evaluation ----
    def _int(self, env, e) -> int:
        v = self._value(env, e)
        assert isinstance(v, int), f"expected compile-time value, got {v}"
        return v

    def _value(self, env, e):
        """Value-space evaluation: signals read as their witness values."""
        P = self.prime
        k = e[0]
        if k == "num":
            return e[1] % P
        if k == "name":
            v = env.get(e[1])
            if v is None and e[1] in env.get("$signals", {}):
                v = env["$signals"][e[1]]
            if isinstance(v, Sig):
                return self.b.val(v.w)
            if isinstance(v, Quad):
                return (self.b.val(v.a) * self.b.val(v.b)
                        + self.b.val(v.c)) % P
            if v.__class__.__name__.startswith("W"):
                return self.b.val(v)
            return v
        if k == "index":
            base = self._value_container(env, e[1])
            i = self._int(env, e[2])
            v = base[i]
            return self.b.val(v.w) if isinstance(v, Sig) else v
        if k == "member":
            comp, path = self._lvalue(env, e)
            sig = comp.signals[path[0]]
            for i in path[1:]:
                sig = sig[i]
            return self.b.val(sig.w) if isinstance(sig, Sig) else sig
        if k == "array":
            return [self._value(env, x) for x in e[1]]
        if k == "call":
            return self._call(env, e[1], [self._value(env, a) for a in e[2]])
        if k == "ternary":
            return self._value(env, e[2]) if self._int(env, e[1]) else \
                self._value(env, e[3])
        if k == "un":
            v = self._value(env, e[2])
            if e[1] == "-":
                return (-v) % P
            if e[1] == "!":
                return 0 if v else 1
            return (~v) % P
        if k == "bin":
            op = e[1]
            a = self._value(env, e[2])
            if op in ("&&", "||"):
                if op == "&&":
                    return 1 if (a and self._value(env, e[3])) else 0
                return 1 if (a or self._value(env, e[3])) else 0
            bv = self._value(env, e[3])

            def signed(x):
                return x - P if x > P // 2 else x

            if op == "+":
                return (a + bv) % P
            if op == "-":
                return (a - bv) % P
            if op == "*":
                return (a * bv) % P
            if op == "**":
                return pow(a, bv, P)
            if op == "/":
                return a * pow(bv, P - 2, P) % P
            if op == "\\":
                return (signed(a) // signed(bv)) % P
            if op == "%":
                return (signed(a) % signed(bv)) % P
            if op == "==":
                return 1 if a == bv else 0
            if op == "!=":
                return 1 if a != bv else 0
            if op == "<":
                return 1 if signed(a) < signed(bv) else 0
            if op == ">":
                return 1 if signed(a) > signed(bv) else 0
            if op == "<=":
                return 1 if signed(a) <= signed(bv) else 0
            if op == ">=":
                return 1 if signed(a) >= signed(bv) else 0
            if op == "<<":
                return (a << bv) % P
            if op == ">>":
                return a >> bv
            if op == "&":
                return a & bv
            if op == "|":
                return a | bv
            if op == "^":
                return a ^ bv
        raise ValueError(k)

    def _value_container(self, env, e):
        if e[0] == "name":
            v = env.get(e[1])
            if v is None and e[1] in env.get("$signals", {}):
                v = env["$signals"][e[1]]
            return v
        if e[0] == "index":
            return self._value_container(env, e[1])[self._int(env, e[2])]
        if e[0] == "member":
            comp, path = self._lvalue(env, e)
            sig = comp.signals[path[0]]
            for i in path[1:]:
                sig = sig[i]
            return sig
        raise ValueError(e[0])

    def _call(self, env, name, args):
        params, body = self.functions[name]
        fenv = dict(zip(params, args))
        fenv["$signals"] = {}
        try:
            self._exec_block(fenv, body)
        except _Return as r:
            return r.value
        raise ValueError(f"function {name} did not return")

    def _quad(self, env, e):
        """Constraint-space evaluation -> W (linear) or Quad."""
        b = self.b
        W = b.W
        k = e[0]
        if k == "num":
            return W(k=e[1])
        if k in ("name", "index", "member"):
            v = self._signal_or_value(env, e)
            if isinstance(v, Sig):
                return v.w
            if isinstance(v, Quad):
                return v
            if v.__class__.__name__.startswith("W"):
                return v
            assert isinstance(v, int), f"cannot use {v} in a constraint"
            return W(k=v)
        if k == "un" and e[1] == "-":
            q = self._quad(env, e[2])
            if isinstance(q, Quad):
                return Quad(q.a, q.b.scale(self.prime - 1),
                            q.c.scale(self.prime - 1))
            return q.scale(self.prime - 1)
        if k == "ternary":
            return self._quad(env, e[2]) if self._int(env, e[1]) else \
                self._quad(env, e[3])
        if k == "call":
            return W(k=self._value(env, e))
        if k == "bin":
            op = e[1]
            if op in ("+", "-"):
                a = self._quad(env, e[2])
                c = self._quad(env, e[3])
                if isinstance(a, Quad) and isinstance(c, Quad):
                    raise ValueError("non-quadratic expression")
                if isinstance(c, Quad):
                    if op == "+":
                        return Quad(c.a, c.b, c.c + a)
                    return Quad(c.a, c.b.scale(self.prime - 1),
                                a - c.c)
                if isinstance(a, Quad):
                    return Quad(a.a, a.b, a.c + c if op == "+" else a.c - c)
                return a + c if op == "+" else a - c
            if op == "*":
                a = self._quad(env, e[2])
                c = self._quad(env, e[3])
                for x, y in ((a, c), (c, a)):
                    if isinstance(x, Quad):
                        if isinstance(y, Quad) or not y.is_const:
                            raise ValueError("non-quadratic expression")
                        return Quad(x.a.scale(y.k), x.b, x.c.scale(y.k))
                if a.is_const:
                    return c.scale(a.k)
                if c.is_const:
                    return a.scale(c.k)
                return Quad(a, c, W())
            if op == "**":
                base = self._quad(env, e[2])
                exp = self._int(env, e[3])
                assert base.is_const or exp <= 2
                if base.is_const:
                    return W(k=pow(base.k, exp, self.prime))
                if exp == 0:
                    return W(k=1)
                if exp == 1:
                    return base
                return Quad(base, base, W())
            # compile-time ops inside constraint expressions
            return W(k=self._value(env, e))
        raise ValueError(k)

    def _signal_or_value(self, env, e):
        if e[0] == "name":
            sigs = env.get("$signals", {})
            if e[1] in sigs:
                return sigs[e[1]]
            return env[e[1]]
        if e[0] == "index":
            return self._value_container(env, e[1])[self._int(env, e[2])]
        if e[0] == "member":
            comp, path = self._lvalue(env, e)
            sig = comp.signals[path[0]]
            for i in path[1:]:
                sig = sig[i]
            return sig
        raise ValueError(e[0])


class _Return(Exception):
    def __init__(self, value):
        self.value = value


def sym_table(elab: "Elaborator"):
    """Flatten every component's declared signals into .sym entries:
    (fqname, witness_sid_or_-1, component_idx).  A signal whose wire is a
    linear combination (an alias the builder never materialized) gets
    witness -1 — the same convention circom uses for signals its O2
    simplification substituted away."""
    entries = []
    for ci, comp in enumerate(elab.components):
        for name, val in sorted(comp.signals.items()):
            if name.startswith("$"):
                continue

            def rec(v, suffix):
                if isinstance(v, list):
                    for i, x in enumerate(v):
                        rec(x, f"{suffix}[{i}]")
                    return
                fq = f"{comp.path}.{name}{suffix}"
                if v is None:
                    entries.append((fq, -1, ci))
                    return
                w = v.w
                if not w.is_const and w.k == 0 and len(w.lc) == 1 \
                        and next(iter(w.lc.values())) == 1:
                    entries.append((fq, next(iter(w.lc)), ci))
                else:
                    entries.append((fq, -1, ci))

            rec(val, "")
    return entries


def write_sym(builder, path: str):
    """Write a circom-compatible .sym file (#label,#witness,#component,name)
    from a compile_circom-produced builder (after any simplification —
    eliminated signals carry witness -1, like circom's own output)."""
    with open(path, "w") as f:
        for i, (fq, sid, ci) in enumerate(getattr(builder, "sym", []), 1):
            f.write(f"{i},{sid},{ci},{fq}\n")


def compile_circom(source: str, inputs: dict, search_paths=(),
                   prime: int | None = None) -> CircuitBuilder:
    """Parse + elaborate a circom source with concrete inputs; returns the
    populated CircuitBuilder (constraints + witness), ready for groth16 or
    the compressor pipeline (dsl_compile/src/lib.rs circom_compiler role)."""
    return Elaborator(source, search_paths, prime).run(inputs)
