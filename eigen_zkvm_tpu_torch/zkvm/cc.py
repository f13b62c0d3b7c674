"""C compiler for zkVM guests: pycparser AST -> RV32IM assembly -> ELF.

The reference builds guests with a real compiler toolchain (powdr
`compile_rust`, zkvm/src/lib.rs:172).  This module is that toolchain for
the native RV32 machine: a C front-end (pycparser) with the classic -O0
codegen shape — sp-based stack frames, memory-resident locals, a
caller-saved temp-register pool with spill slots, RV32IM arithmetic
(native mul/div/rem), byte/half/word loads and stores, signed vs
unsigned comparisons picked by type — so the proved binaries exercise
encodings and control-flow patterns hand-written assembly does not
(register pressure spills, nested-call argument shuffles, compiler-
generated branch chains).

Subset: int/unsigned/char/unsigned char/short, 1-D arrays, pointers,
functions, globals with initializers, if/else, while/do/for,
break/continue, full expression grammar (incl. compound assignment,
?:, && || with short-circuit), sizeof, casts between the integer types,
string literals (NUL-terminated .data blobs).  No floats, no 64-bit
ints, no structs/unions, no varargs — guest-shaped C.

Pipeline: `compile_c(source)` -> (asm, data bytes) -> rv32_isa.assemble
-> elf.make_elf, ready for elf_execute_and_prove.

Copy of eigen_zkvm_tpu/zkvm/cc.py for the PyTorch port, on the port's
rv32_isa and elf.  It imports pycparser at its top: a module that must
load without pycparser (chip_smoke.py's path) does not import it."""
from __future__ import annotations

import re

from pycparser import c_ast, c_parser

from .elf import load_c_elf  # noqa: F401 (the loader shim, re-exported)

WORD = 4
# Memory layout: data LOW (so hot globals get single-instruction absolute
# addressing at imm(zero)), stack just above data, text ABOVE the RAM
# image (cc output never reads .text, so the continuation digest only
# covers data+stack — see elf.load_elf include_exec_in_image)
DATA_VADDR = 0x80
STACK_TOP = 0x2000            # sp at entry (grows down, inside the image)
TEXT_VADDR = 0x4000

# caller-saved expression registers, in allocation order
_POOL = ["t0", "t1", "t2", "t3", "t4", "t5", "t6", "a6", "a7"]
_NSPILL = 8                   # frame slots for pool overflow + call saves


class CompileError(ValueError):
    pass


def _preprocess(src: str) -> str:
    """Comments + object-like #define only (guests need no real cpp)."""
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    src = re.sub(r"//[^\n]*", "", src)
    defines: dict[str, str] = {}
    out = []
    for line in src.splitlines():
        ls = line.strip()
        if ls.startswith("#"):
            m = re.match(r"#\s*define\s+(\w+)\s+(.+)$", ls)
            if m:
                defines[m.group(1)] = m.group(2).strip()
                out.append("")
                continue
            if re.match(r"#\s*(if|endif|else|include|pragma|undef)", ls):
                raise CompileError(f"unsupported directive: {ls}")
            raise CompileError(f"unsupported directive: {ls}")
        out.append(line)
    text = "\n".join(out)
    # iterative object-macro substitution (bounded)
    for _ in range(8):
        changed = False
        for k, v in defines.items():
            new = re.sub(rf"\b{k}\b", v, text)
            if new != text:
                text = new
                changed = True
        if not changed:
            break
    return text


class CType:
    """Integer/pointer scalar model: every value is one 32-bit register;
    the type drives load/store width, signedness and pointer scaling."""

    def __init__(self, kind: str, signed: bool = True, elem: "CType" = None,
                 count: int | None = None):
        self.kind = kind          # int | char | short | ptr | array | void
        self.signed = signed
        self.elem = elem
        self.count = count

    @property
    def size(self) -> int:
        if self.kind in ("int", "ptr"):
            return 4
        if self.kind == "short":
            return 2
        if self.kind == "char":
            return 1
        if self.kind == "array":
            return self.elem.size * self.count
        return 0

    def decay(self) -> "CType":
        if self.kind == "array":
            return CType("ptr", elem=self.elem)
        return self

    def __repr__(self):
        return f"CType({self.kind}{'' if self.signed else ' unsigned'})"


INT = CType("int")
UINT = CType("int", signed=False)
CHAR = CType("char")
UCHAR = CType("char", signed=False)
VOID = CType("void")


def _type_of(decl_type, typedefs) -> CType:
    if isinstance(decl_type, c_ast.TypeDecl):
        return _type_of(decl_type.type, typedefs)
    if isinstance(decl_type, c_ast.IdentifierType):
        names = decl_type.names
        signed = "unsigned" not in names
        base = [n for n in names if n not in ("signed", "unsigned")]
        name = base[0] if base else "int"
        if name in typedefs:
            t = typedefs[name]
            return CType(t.kind, signed and t.signed, t.elem, t.count)
        if name in ("int", "long"):
            return CType("int", signed)
        if name == "short":
            return CType("short", signed)
        if name == "char":
            return CType("char", signed)
        if name == "void":
            return VOID
        raise CompileError(f"unsupported type {names}")
    if isinstance(decl_type, c_ast.PtrDecl):
        return CType("ptr", elem=_type_of(decl_type.type, typedefs))
    if isinstance(decl_type, c_ast.ArrayDecl):
        elem = _type_of(decl_type.type, typedefs)
        if decl_type.dim is None:
            return CType("array", elem=elem, count=0)  # sized by init
        return CType("array", elem=elem, count=_const_int(decl_type.dim))
    raise CompileError(f"unsupported declarator {type(decl_type).__name__}")


def _const_int(node) -> int:
    if isinstance(node, c_ast.Constant):
        return int(node.value.rstrip("uUlL"), 0)
    if isinstance(node, c_ast.UnaryOp) and node.op == "-":
        return -_const_int(node.expr)
    if isinstance(node, c_ast.BinaryOp):
        a, b = _const_int(node.left), _const_int(node.right)
        return {"+": a + b, "-": a - b, "*": a * b, "/": a // b,
                "<<": a << b, ">>": a >> b, "|": a | b, "&": a & b}[node.op]
    raise CompileError("array dimension must be a constant expression")


class _Fn:
    def __init__(self, name, ret, params):
        self.name = name
        self.ret = ret
        self.params = params      # [(name, CType)]


class Compiler:
    def __init__(self):
        self.asm: list[str] = []
        # the image-span marker: a nonzero word at DATA_VADDR pins the RAM
        # image's base (zero words are elided from the ELF image, and the
        # continuation digest must cover every address the guest touches)
        self.data = bytearray(b"\x5a\x00\x00\x00")
        self.globals: dict[str, tuple[int, CType]] = {}  # name -> (addr, t)
        self.fns: dict[str, _Fn] = {}
        self.typedefs: dict[str, CType] = {}
        self._label = 0

    # ---- emission helpers -------------------------------------------
    def e(self, line: str):
        self.asm.append("    " + line)

    def lab(self, name: str):
        self.asm.append(name + ":")

    def newlabel(self, hint="L") -> str:
        self._label += 1
        return f".{hint}{self._label}"

    # ---- top level ---------------------------------------------------
    def compile(self, source: str) -> tuple[str, bytes]:
        ast = c_parser.CParser().parse(_preprocess(source))
        # pass 1: layout globals, collect prototypes
        for ext in ast.ext:
            if isinstance(ext, c_ast.Typedef):
                self.typedefs[ext.name] = _type_of(ext.type, self.typedefs)
            elif isinstance(ext, c_ast.Decl) and not isinstance(
                    ext.type, c_ast.FuncDecl):
                self._global_decl(ext)
            elif isinstance(ext, c_ast.Decl):
                self._proto(ext.name, ext.type)
            elif isinstance(ext, c_ast.FuncDef):
                self._proto(ext.decl.name, ext.decl.type)
        if "main" not in self.fns:
            raise CompileError("no main()")
        # crt0: sp to stack top, call main, halt with a0 = result
        self.e(f"li sp, {STACK_TOP}")
        self.e("jal ra, main")
        self.e("ecall")
        # pass 2: function bodies
        for ext in ast.ext:
            if isinstance(ext, c_ast.FuncDef):
                self._function(ext)
        return "\n".join(self.asm) + "\n", bytes(self.data)

    def _proto(self, name, ftype):
        ret = _type_of(ftype.type, self.typedefs)
        params = []
        if ftype.args:
            for p in ftype.args.params:
                if isinstance(p, c_ast.EllipsisParam):
                    raise CompileError("varargs unsupported")
                t = _type_of(p.type, self.typedefs).decay()
                if t.kind == "void":
                    continue
                params.append((p.name, t))
        if len(params) > 6:
            raise CompileError("more than 6 parameters")
        self.fns[name] = _Fn(name, ret, params)

    def _global_decl(self, decl):
        t = _type_of(decl.type, self.typedefs)
        init_bytes = b""
        if decl.init is not None:
            init_bytes, t = self._init_bytes(decl.init, t)
        size = t.size if t.size else len(init_bytes)
        size = max(size, len(init_bytes), 1)
        while len(self.data) % WORD:
            self.data.append(0)
        addr = DATA_VADDR + len(self.data)
        self.data += init_bytes.ljust(size, b"\x00")
        self.globals[decl.name] = (addr, t)

    def _init_bytes(self, init, t: CType) -> tuple[bytes, CType]:
        def scalar(node, ty):
            v = _const_int(node) & 0xFFFFFFFF
            return v.to_bytes(4, "little")[: ty.size]

        if isinstance(init, c_ast.InitList):
            if t.kind != "array":
                raise CompileError("brace init on non-array")
            out = b""
            for e_ in init.exprs:
                out += scalar(e_, t.elem)
            count = t.count or len(init.exprs)
            out = out.ljust(t.elem.size * count, b"\x00")
            return out, CType("array", elem=t.elem, count=count)
        if isinstance(init, c_ast.Constant) and init.type == "string":
            s = init.value[1:-1].encode().decode("unicode_escape").encode()
            s += b"\x00"
            count = t.count or len(s)
            return s.ljust(count, b"\x00"), CType(
                "array", elem=CType("char"), count=count)
        return scalar(init, t), t

    # ---- functions -----------------------------------------------------
    def _function(self, fd: c_ast.FuncDef):
        fn = self.fns[fd.decl.name]
        self.cur = fn
        self.locals: dict[str, tuple[int, CType]] = {}
        self.frame = 0            # bytes of locals allocated so far
        self.depth = 0            # expression register-stack depth
        self.breaks: list[str] = []
        self.continues: list[str] = []

        # collect local declaration sizes (walk body) so the frame size is
        # known up front — two-pass like a real compiler
        body_asm_mark = len(self.asm)
        self.lab(fn.name)
        # frame: [ra][saved s-regs][spill x8][locals...]
        self._frame_slots: dict[str, int] = {}
        self._alloc_locals(fd.body)
        # register promotion: word-sized scalars whose address is never
        # taken live in callee-saved s-registers (most-used first)
        self.promoted = self._promote(fd)
        nsaved = len(set(self.promoted.values()))
        frame = (WORD + nsaved * WORD + _NSPILL * WORD + self.frame
                 + 15) & ~15
        self._frame_size = frame
        self._nsaved = nsaved
        self.e(f"addi sp, sp, -{frame}")
        self.e(f"sw ra, {frame - 4}(sp)")
        for i, reg in enumerate(sorted(set(self.promoted.values()))):
            self.e(f"sw {reg}, {frame - 8 - 4 * i}(sp)")
        for i, (pname, pt) in enumerate(fn.params):
            if pname in self.promoted:
                self.locals[pname] = (-1, pt)
                self.e(f"mv {self.promoted[pname]}, a{i}")
                continue
            off = self._frame_slots[pname]
            self.locals[pname] = (off, pt)
            self.e(f"sw a{i}, {off}(sp)")
        self._stmt(fd.body)
        # fallthrough return
        self.lab(f".{fn.name}_ret")
        self.e(f"lw ra, {frame - 4}(sp)")
        for i, reg in enumerate(sorted(set(self.promoted.values()))):
            self.e(f"lw {reg}, {frame - 8 - 4 * i}(sp)")
        self.e(f"addi sp, sp, {frame}")
        self.e("jalr zero, ra, 0")
        del body_asm_mark

    _SREGS = ["s2", "s3", "s4", "s5", "s6", "s7", "s8", "s9", "s10", "s11"]

    def _promote(self, fd) -> dict[str, str]:
        """Pick up to len(_SREGS) word-sized scalar locals/params whose
        address is never taken; they live in callee-saved registers."""
        uses: dict[str, int] = {}
        addr_taken: set[str] = set()
        types: dict[str, CType] = {p: t for p, t in self.cur.params}

        def walk(n, depth):
            if isinstance(n, c_ast.UnaryOp) and n.op == "&" and isinstance(
                    n.expr, c_ast.ID):
                addr_taken.add(n.expr.name)
            if isinstance(n, c_ast.ID):
                uses[n.name] = uses.get(n.name, 0) + (1 << min(depth, 8))
            if isinstance(n, c_ast.Decl) and not isinstance(
                    n.type, c_ast.FuncDecl):
                t = self._decl_types.get(id(n)) or _type_of(
                    n.type, self.typedefs)
                types[n.name] = t
            d2 = depth + (1 if isinstance(
                n, (c_ast.While, c_ast.For, c_ast.DoWhile)) else 0)
            for _, c in n.children():
                walk(c, d2)

        walk(fd.body, 0)
        cands = []
        for name, cnt in uses.items():
            t = types.get(name)
            if t is None or name in addr_taken:
                continue
            if t.kind in ("int", "ptr") and t.size == 4:
                cands.append((cnt, name))
        cands.sort(reverse=True)
        return {name: self._SREGS[i]
                for i, (_, name) in enumerate(cands[: len(self._SREGS)])}

    def _alloc_locals(self, node):
        """Assign frame offsets for params + every local decl in the body."""
        for pname, pt in self.cur.params:
            self._frame_slots[pname] = self._take(pt.size if pt.kind != "array" else 4)

        def walk(n):
            if isinstance(n, c_ast.Decl) and not isinstance(
                    n.type, c_ast.FuncDecl):
                t = _type_of(n.type, self.typedefs)
                if t.kind == "array" and t.count == 0 and n.init is not None:
                    if isinstance(n.init, c_ast.InitList):
                        t = CType("array", elem=t.elem,
                                  count=len(n.init.exprs))
                    elif (isinstance(n.init, c_ast.Constant)
                          and n.init.type == "string"):
                        s = n.init.value[1:-1].encode().decode(
                            "unicode_escape")
                        t = CType("array", elem=CType("char"),
                                  count=len(s) + 1)
                self._frame_slots[n.name] = self._take(max(t.size, 4))
                self._decl_types = getattr(self, "_decl_types", {})
                self._decl_types[id(n)] = t
            for _, c in (n.children() if n is not None else []):
                walk(c)

        walk(node)

    def _take(self, size: int) -> int:
        size = (size + 3) & ~3
        off = 0 + self.frame
        self.frame += size
        return off

    # ---- statements ----------------------------------------------------
    def _stmt(self, n):
        if n is None:
            return
        if isinstance(n, c_ast.Compound):
            for item in (n.block_items or []):
                self._stmt(item)
        elif isinstance(n, c_ast.Decl):
            t = self._decl_types.get(id(n)) or _type_of(
                n.type, self.typedefs)
            if n.name in self.promoted:
                self.locals[n.name] = (-1, t)
                if n.init is not None:
                    r = self._expr(n.init, want=t)
                    self.e(f"mv {self.promoted[n.name]}, {r}")
                    self._pop()
                return
            off = self._frame_slots[n.name]
            self.locals[n.name] = (off, t)
            if n.init is not None:
                if t.kind == "array":
                    blob, t2 = self._init_bytes(n.init, t)
                    self.locals[n.name] = (off, t2)
                    # memberwise stores
                    r = self._push()
                    for i in range(0, len(blob), t.elem.size):
                        v = int.from_bytes(
                            blob[i : i + t.elem.size], "little")
                        self.e(f"li {r}, {v}")
                        self._store_to(f"{off + i}(sp)", t.elem, r)
                    self._pop()
                else:
                    r = self._expr(n.init, want=t)
                    self._store_to(f"{off}(sp)", t, r)
                    self._pop()
        elif isinstance(n, c_ast.Return):
            if n.expr is not None:
                r = self._expr(n.expr)
                self.e(f"mv a0, {r}")
                self._pop()
            self.e(f"j .{self.cur.name}_ret")
        elif isinstance(n, c_ast.If):
            els = self.newlabel("else")
            end = self.newlabel("fi")
            self._branch_false(n.cond, els)
            self._stmt(n.iftrue)
            if n.iffalse is not None:
                self.e(f"j {end}")
            self.lab(els)
            if n.iffalse is not None:
                self._stmt(n.iffalse)
                self.lab(end)
        elif isinstance(n, c_ast.While):
            top = self.newlabel("wh")
            end = self.newlabel("done")
            self.lab(top)
            self._branch_false(n.cond, end)
            self.breaks.append(end)
            self.continues.append(top)
            self._stmt(n.stmt)
            self.breaks.pop()
            self.continues.pop()
            self.e(f"j {top}")
            self.lab(end)
        elif isinstance(n, c_ast.DoWhile):
            top = self.newlabel("do")
            cont = self.newlabel("docond")
            end = self.newlabel("done")
            self.lab(top)
            self.breaks.append(end)
            self.continues.append(cont)
            self._stmt(n.stmt)
            self.breaks.pop()
            self.continues.pop()
            self.lab(cont)
            self._branch_true(n.cond, top)
            self.lab(end)
        elif isinstance(n, c_ast.For):
            if n.init is not None:
                if isinstance(n.init, c_ast.DeclList):
                    for d in n.init.decls:
                        self._stmt(d)
                else:
                    self._stmt(n.init)
            top = self.newlabel("for")
            cont = self.newlabel("next")
            end = self.newlabel("done")
            self.lab(top)
            if n.cond is not None:
                self._branch_false(n.cond, end)
            self.breaks.append(end)
            self.continues.append(cont)
            self._stmt(n.stmt)
            self.breaks.pop()
            self.continues.pop()
            self.lab(cont)
            if n.next is not None:
                self._stmt(n.next)
            self.e(f"j {top}")
            self.lab(end)
        elif isinstance(n, c_ast.Break):
            self.e(f"j {self.breaks[-1]}")
        elif isinstance(n, c_ast.Continue):
            self.e(f"j {self.continues[-1]}")
        elif isinstance(n, c_ast.EmptyStatement):
            pass
        else:  # expression statement
            r = self._expr(n)
            if r is not None:
                self._pop()

    # ---- expression register stack --------------------------------------
    def _reg(self, d: int) -> str:
        if d < len(_POOL):
            return _POOL[d]
        raise CompileError("expression too deep (register pool exhausted)")

    def _push(self) -> str:
        r = self._reg(self.depth)
        self.depth += 1
        return r

    def _pop(self) -> str:
        self.depth -= 1
        return self._reg(self.depth)

    def _spill_off(self, i: int) -> int:
        # frame top-down: [ra][saved s-regs][spill slots][locals]
        return (self._frame_size - 4 - self._nsaved * WORD
                - _NSPILL * WORD + i * WORD)

    # ---- lvalues ---------------------------------------------------------
    def _lvalue(self, n) -> tuple[str, CType]:
        """Evaluate an lvalue: pushes the ADDRESS register (except for
        sp-relative scalars, returned as f'{off}(sp)' with depth
        unchanged).  Returns (place, type) where place is 'off(sp)' or a
        register holding the address."""
        if isinstance(n, c_ast.ID):
            if n.name in self.locals:
                off, t = self.locals[n.name]
                if n.name in self.promoted:
                    return "@" + self.promoted[n.name], t
                if t.kind == "array":
                    r = self._push()
                    self.e(f"addi {r}, sp, {off}")
                    return r, t
                return f"{off}(sp)", t
            if n.name in self.globals:
                addr, t = self.globals[n.name]
                if t.kind != "array" and addr < 2048:
                    return f"{addr}(zero)", t
                r = self._push()
                self.e(f"li {r}, {addr}")
                return r, t
            raise CompileError(f"undeclared identifier {n.name}")
        if isinstance(n, c_ast.ArrayRef):
            # peephole: global array with a constant index in the low 2 KB
            # -> one absolute-addressed load/store at imm(zero)
            if (isinstance(n.name, c_ast.ID)
                    and n.name.name in self.globals
                    and n.name.name not in self.locals):
                addr, gt = self.globals[n.name.name]
                if gt.kind == "array":
                    try:
                        k = _const_int(n.subscript)
                    except CompileError:
                        k = None
                    if k is not None:
                        a = addr + k * gt.elem.size
                        if 0 <= a < 2048:
                            return f"{a}(zero)", gt.elem
            base, bt = self._lvalue_or_value(n.name)
            idx = self._expr(n.subscript)
            elem = bt.elem
            if elem.size > 1:
                sh = {2: 1, 4: 2}[elem.size]
                self.e(f"slli {idx}, {idx}, {sh}")
            self.e(f"add {base}, {base}, {idx}")
            self._pop()
            return base, elem
        if isinstance(n, c_ast.UnaryOp) and n.op == "*":
            r = self._expr(n.expr)
            t = self._etype(n.expr)
            return r, (t.elem if t.elem is not None else INT)
        raise CompileError(f"unsupported lvalue {type(n).__name__}")

    def _lvalue_or_value(self, n) -> tuple[str, CType]:
        """Pointer-ish base for indexing: arrays give their address,
        pointers give their VALUE."""
        t = self._etype(n)
        if t.kind == "array":
            place, _ = self._lvalue(n)
            return place, t
        r = self._expr(n)
        return r, t

    def _store_to(self, place: str, t: CType, src: str):
        if place.startswith("@"):
            self.e(f"mv {place[1:]}, {src}")
            return
        op = {1: "sb", 2: "sh", 4: "sw"}[max(t.decay().size, 1)]
        if "(" in place:
            self.e(f"{op} {src}, {place}")
        else:
            self.e(f"{op} {src}, 0({place})")

    def _load_from(self, place: str, t: CType, dst: str):
        if place.startswith("@"):
            self.e(f"mv {dst}, {place[1:]}")
            return
        t = t.decay()
        op = {1: "lb" if t.signed else "lbu",
              2: "lh" if t.signed else "lhu",
              4: "lw"}[max(t.size, 1)]
        if "(" in place:
            self.e(f"{op} {dst}, {place}")
        else:
            self.e(f"{op} {dst}, 0({place})")

    # ---- expression types -------------------------------------------------
    def _etype(self, n) -> CType:
        if isinstance(n, c_ast.Constant):
            if n.type == "string":
                return CType("ptr", elem=CType("char"))
            if n.type == "char":
                return CHAR
            return UINT if n.value.lower().rstrip("l").endswith("u") else INT
        if isinstance(n, c_ast.ID):
            if n.name in self.locals:
                return self.locals[n.name][1]
            if n.name in self.globals:
                return self.globals[n.name][1]
            raise CompileError(f"undeclared identifier {n.name}")
        if isinstance(n, c_ast.ArrayRef):
            return self._etype(n.name).decay().elem
        if isinstance(n, c_ast.UnaryOp):
            if n.op == "*":
                return self._etype(n.expr).decay().elem or INT
            if n.op == "&":
                return CType("ptr", elem=self._etype(n.expr))
            if n.op == "sizeof":
                return UINT
            if n.op == "!":
                return INT
            return self._etype(n.expr)
        if isinstance(n, c_ast.BinaryOp):
            lt = self._etype(n.left).decay()
            rt = self._etype(n.right).decay()
            if n.op in ("<", ">", "<=", ">=", "==", "!=", "&&", "||"):
                return INT
            if lt.kind == "ptr":
                return lt if n.op in ("+", "-") and rt.kind != "ptr" else (
                    INT if rt.kind == "ptr" else lt)
            if rt.kind == "ptr":
                return rt
            signed = lt.signed and rt.signed
            return CType("int", signed)
        if isinstance(n, c_ast.Assignment):
            return self._etype(n.lvalue)
        if isinstance(n, c_ast.FuncCall):
            f = self.fns.get(n.name.name)
            return f.ret if f else INT
        if isinstance(n, c_ast.Cast):
            return _type_of(n.to_type.type, self.typedefs).decay()
        if isinstance(n, c_ast.TernaryOp):
            return self._etype(n.iftrue)
        return INT

    # ---- branches -----------------------------------------------------------
    def _branch_false(self, cond, target):
        self._branch(cond, target, when_true=False)

    def _branch_true(self, cond, target):
        self._branch(cond, target, when_true=True)

    def _branch(self, cond, target, when_true: bool):
        """Fused compare-and-branch for relational conditions (the pattern
        every real compiler emits), falling back to truthiness."""
        if isinstance(cond, c_ast.BinaryOp) and cond.op in (
                "<", ">", "<=", ">=", "==", "!="):
            lt = self._etype(cond.left).decay()
            rt = self._etype(cond.right).decay()
            unsigned = (not lt.signed or not rt.signed
                        or lt.kind == "ptr" or rt.kind == "ptr")
            a = self._expr(cond.left)
            b = self._expr(cond.right)
            op = cond.op if when_true else {
                "<": ">=", ">=": "<", ">": "<=", "<=": ">",
                "==": "!=", "!=": "==",}[cond.op]
            ins = {"==": "beq", "!=": "bne",
                   "<": "bltu" if unsigned else "blt",
                   ">=": "bgeu" if unsigned else "bge"}
            if op in ins:
                self.e(f"{ins[op]} {a}, {b}, {target}")
            elif op == ">":
                self.e(f"{ins_gt(unsigned)} {b}, {a}, {target}")
            else:  # <=
                self.e(f"{'bgeu' if unsigned else 'bge'} {b}, {a}, {target}")
            self._pop()
            self._pop()
            return
        if isinstance(cond, c_ast.UnaryOp) and cond.op == "!":
            self._branch(cond.expr, target, not when_true)
            return
        r = self._expr(cond)
        self.e(f"{'bne' if when_true else 'beq'} {r}, zero, {target}")
        self._pop()

    # ---- expressions ----------------------------------------------------------
    def _expr(self, n, want: CType | None = None) -> str | None:
        """Evaluate; pushes one register with the value (returns it).
        Statement-expressions with no value return None."""
        if isinstance(n, c_ast.Constant):
            if n.type == "string":
                s = n.value[1:-1].encode().decode("unicode_escape").encode()
                s += b"\x00"
                while len(self.data) % WORD:
                    self.data.append(0)
                addr = DATA_VADDR + len(self.data)
                self.data += s
                r = self._push()
                self.e(f"li {r}, {addr}")
                return r
            if n.type == "char":
                v = ord(n.value[1:-1].encode().decode("unicode_escape"))
            else:
                v = int(n.value.rstrip("uUlL"), 0)
            r = self._push()
            self.e(f"li {r}, {v & 0xFFFFFFFF}")
            return r
        if isinstance(n, c_ast.ID):
            place, t = self._lvalue(n)
            if t.kind == "array":
                return place  # decayed address already in a register
            if place.startswith("@"):
                r = self._push()
                self.e(f"mv {r}, {place[1:]}")
                return r
            if "(" in place:
                r = self._push()
                self._load_from(place, t, r)
                return r
            self._load_from(f"0({place})", t, place)
            return place
        if isinstance(n, c_ast.ArrayRef) or (
                isinstance(n, c_ast.UnaryOp) and n.op == "*"):
            place, t = self._lvalue(n)
            if t.kind == "array":
                return place
            if "(" in place:   # memory place with no pushed register
                r = self._push()
                self._load_from(place, t, r)
                return r
            self._load_from(f"0({place})", t, place)
            return place
        if isinstance(n, c_ast.UnaryOp):
            return self._unary(n)
        if isinstance(n, c_ast.BinaryOp):
            return self._binary(n)
        if isinstance(n, c_ast.Assignment):
            return self._assign(n)
        if isinstance(n, c_ast.FuncCall):
            return self._call(n)
        if isinstance(n, c_ast.Cast):
            to = _type_of(n.to_type.type, self.typedefs).decay()
            r = self._expr(n.expr)
            src = self._etype(n.expr).decay()
            if to.size == 1 and src.size > 1:
                self.e(f"andi {r}, {r}, 0xff")
                if to.signed:
                    self.e(f"slli {r}, {r}, 24")
                    self.e(f"srai {r}, {r}, 24")
            elif to.size == 2 and src.size > 2:
                self.e(f"slli {r}, {r}, 16")
                self.e(f"{'srai' if to.signed else 'srli'} {r}, {r}, 16")
            return r
        if isinstance(n, c_ast.TernaryOp):
            els = self.newlabel("qel")
            end = self.newlabel("qend")
            self._branch_false(n.cond, els)
            r = self._expr(n.iftrue)
            self.e(f"j {end}")
            self._pop()
            self.lab(els)
            r2 = self._expr(n.iftrue if False else n.iffalse)
            assert r2 == r
            self.lab(end)
            return r
        if isinstance(n, c_ast.ExprList):
            r = None
            for e_ in n.exprs:
                if r is not None:
                    self._pop()
                r = self._expr(e_)
            return r
        raise CompileError(f"unsupported expression {type(n).__name__}")

    def _unary(self, n) -> str:
        if n.op == "sizeof":
            if isinstance(n.expr, c_ast.Typename):
                t = _type_of(n.expr.type, self.typedefs)
            else:
                t = self._etype(n.expr)
            r = self._push()
            self.e(f"li {r}, {t.size}")
            return r
        if n.op == "&":
            place, t = self._lvalue(n.expr)
            if place.startswith("@"):
                raise CompileError("address of register variable")
            if place.endswith("(zero)"):
                off = place.split("(")[0]
                r = self._push()
                self.e(f"li {r}, {off}")
                return r
            if "(" in place:
                off = place.split("(")[0]
                r = self._push()
                self.e(f"addi {r}, sp, {off}")
                return r
            return place
        if n.op in ("++", "--", "p++", "p--"):
            place, t = self._lvalue(n.expr)
            step = (t.decay().elem.size if t.decay().kind == "ptr"
                    and t.decay().elem is not None else 1)
            if place.startswith("@") or "(" in place:
                val = self._push()
                self._load_from(place, t, val)
                res = val
                if n.op in ("p++", "p--"):       # post: value BEFORE
                    tmp = self._push()
                    self.e(f"addi {tmp}, {val}, "
                           f"{step if n.op == 'p++' else -step}")
                    self._store_to(place, t, tmp)
                    self._pop()
                else:
                    self.e(f"addi {val}, {val}, "
                           f"{step if n.op == '++' else -step}")
                    self._store_to(place, t, val)
                return res
            addr = place
            val = self._push()
            self._load_from(f"0({addr})", t, val)
            if n.op in ("p++", "p--"):
                tmp = self._push()
                self.e(f"addi {tmp}, {val}, "
                       f"{step if n.op == 'p++' else -step}")
                self._store_to(f"0({addr})", t, tmp)
                self._pop()
                self.e(f"mv {addr}, {val}")
                self._pop()
                return addr
            self.e(f"addi {val}, {val}, {step if n.op == '++' else -step}")
            self._store_to(f"0({addr})", t, val)
            self.e(f"mv {addr}, {val}")
            self._pop()
            return addr
        r = self._expr(n.expr)
        if n.op == "-":
            self.e(f"sub {r}, zero, {r}")
        elif n.op == "~":
            self.e(f"xori {r}, {r}, -1")
        elif n.op == "!":
            self.e(f"sltiu {r}, {r}, 1")
        elif n.op == "+":
            pass
        else:
            raise CompileError(f"unsupported unary {n.op}")
        return r

    _BINOPS = {"+": "add", "-": "sub", "&": "and", "|": "or", "^": "xor",
               "*": "mul"}

    def _binary(self, n) -> str:
        if n.op in ("&&", "||"):
            # short-circuit with a materialized 0/1 result
            end = self.newlabel("sc")
            r = self._expr(n.left)
            self.e(f"sltu {r}, zero, {r}")  # normalize to 0/1
            if n.op == "&&":
                self.e(f"beq {r}, zero, {end}")
            else:
                self.e(f"bne {r}, zero, {end}")
            self._pop()
            r2 = self._expr(n.right)
            self.e(f"sltu {r2}, zero, {r2}")
            self.lab(end)
            if self.depth == 0 or self._reg(self.depth - 1) != r:
                self.depth += 1
            return r
        lt = self._etype(n.left).decay()
        rt = self._etype(n.right).decay()
        a = self._expr(n.left)
        # pointer arithmetic scaling
        if n.op in ("+", "-") and lt.kind == "ptr" and rt.kind != "ptr":
            b = self._expr(n.right)
            if lt.elem.size > 1:
                self.e(f"slli {b}, {b}, {({2:1,4:2}[lt.elem.size])}")
            self.e(f"{'add' if n.op == '+' else 'sub'} {a}, {a}, {b}")
            self._pop()
            return a
        b = self._expr(n.right)
        unsigned = (not lt.signed or not rt.signed
                    or lt.kind == "ptr" or rt.kind == "ptr")
        if n.op in self._BINOPS:
            self.e(f"{self._BINOPS[n.op]} {a}, {a}, {b}")
            if n.op == "-" and lt.kind == "ptr" and rt.kind == "ptr":
                if lt.elem.size > 1:
                    self.e(f"srai {a}, {a}, {({2:1,4:2}[lt.elem.size])}")
        elif n.op == "/":
            self.e(f"{'divu' if unsigned else 'div'} {a}, {a}, {b}")
        elif n.op == "%":
            self.e(f"{'remu' if unsigned else 'rem'} {a}, {a}, {b}")
        elif n.op == "<<":
            self.e(f"sll {a}, {a}, {b}")
        elif n.op == ">>":
            self.e(f"{'srl' if not lt.signed is False and not lt.signed else 'srl'} {a}, {a}, {b}"
                   if False else
                   f"{'srl' if not lt.signed else 'sra'} {a}, {a}, {b}")
        elif n.op in ("<", ">", "<=", ">=", "==", "!="):
            if n.op == "<":
                self.e(f"{'sltu' if unsigned else 'slt'} {a}, {a}, {b}")
            elif n.op == ">":
                self.e(f"{'sltu' if unsigned else 'slt'} {a}, {b}, {a}")
            elif n.op == "<=":
                self.e(f"{'sltu' if unsigned else 'slt'} {a}, {b}, {a}")
                self.e(f"xori {a}, {a}, 1")
            elif n.op == ">=":
                self.e(f"{'sltu' if unsigned else 'slt'} {a}, {a}, {b}")
                self.e(f"xori {a}, {a}, 1")
            elif n.op == "==":
                self.e(f"xor {a}, {a}, {b}")
                self.e(f"sltiu {a}, {a}, 1")
            else:  # !=
                self.e(f"xor {a}, {a}, {b}")
                self.e(f"sltu {a}, zero, {a}")
        else:
            raise CompileError(f"unsupported binary {n.op}")
        self._pop()
        return a

    def _assign(self, n) -> str:
        if n.op != "=":
            # a op= b  ->  load, op, store (lvalue evaluated once)
            place, t = self._lvalue(n.lvalue)
            cur = self._push()
            if place.startswith("@") or "(" in place:
                self._load_from(place, t, cur)
            else:
                self._load_from(f"0({place})", t, cur)
            b = self._expr(n.rvalue)
            op = n.op[:-1]
            unsigned = not t.signed
            if op in self._BINOPS:
                self.e(f"{self._BINOPS[op]} {cur}, {cur}, {b}")
            elif op == "/":
                self.e(f"{'divu' if unsigned else 'div'} {cur}, {cur}, {b}")
            elif op == "%":
                self.e(f"{'remu' if unsigned else 'rem'} {cur}, {cur}, {b}")
            elif op == "<<":
                self.e(f"sll {cur}, {cur}, {b}")
            elif op == ">>":
                self.e(f"{'srl' if not t.signed else 'sra'} {cur}, {cur}, {b}")
            else:
                raise CompileError(f"unsupported compound {n.op}")
            self._pop()
            if place.startswith("@") or "(" in place:
                self._store_to(place, t, cur)
                return cur
            self._store_to(f"0({place})", t, cur)
            # shift result down over the address register
            self.e(f"mv {place}, {cur}")
            self._pop()
            return place
        place, t = self._lvalue(n.lvalue)
        r = self._expr(n.rvalue)
        if place.startswith("@") or "(" in place:
            self._store_to(place, t, r)
            return r
        self._store_to(f"0({place})", t, r)
        self.e(f"mv {place}, {r}")
        self._pop()
        return place

    _INTRINSICS = {"__mulhu": "mulhu", "__mulh": "mulh",
                   "__mulhsu": "mulhsu"}

    def _call(self, n) -> str:
        name = n.name.name
        if name in self._INTRINSICS:
            a = self._expr(n.args.exprs[0])
            b = self._expr(n.args.exprs[1])
            self.e(f"{self._INTRINSICS[name]} {a}, {a}, {b}")
            self._pop()
            return a
        if name not in self.fns:
            raise CompileError(f"call to undeclared function {name}")
        args = n.args.exprs if n.args is not None else []
        if len(args) > 6:
            raise CompileError("more than 6 arguments")
        # save live expression registers to the spill area
        live = self.depth
        if live > _NSPILL:
            raise CompileError("too many live temporaries across a call")
        for i in range(live):
            self.e(f"sw {self._reg(i)}, {self._spill_off(i)}(sp)")
        # evaluate args (each lands on the expr stack), then move to a0..
        for a_ in args:
            self._expr(a_)
        for i in range(len(args) - 1, -1, -1):
            self.e(f"mv a{i}, {self._pop()}")
        self.e(f"jal ra, {name}")
        for i in range(live):
            self.e(f"lw {self._reg(i)}, {self._spill_off(i)}(sp)")
        r = self._push()
        self.e(f"mv {r}, a0")
        return r


def ins_gt(unsigned: bool) -> str:
    return "bltu" if unsigned else "blt"


def compile_c(source: str):
    """C source -> (asm text, data bytes)."""
    c = Compiler()
    return c.compile(source)


def c_to_elf(source: str) -> bytes:
    """C source -> ELF32 executable: data at DATA_VADDR, text at
    TEXT_VADDR (above the RAM image), image covering data + stack."""
    from .elf import make_elf
    from .rv32_isa import assemble

    asm, data = compile_c(source)
    if len(data) > STACK_TOP - DATA_VADDR - 512:
        raise CompileError("data segment collides with the stack region")
    # pad data so the image (data..stack) covers the stack region; the
    # last word is a nonzero marker so the span reaches STACK_TOP
    data = data + b"\x00" * (STACK_TOP - DATA_VADDR - len(data))
    data = data[:-4] + b"\x5a\x00\x00\x00"
    return make_elf(assemble(asm, base=TEXT_VADDR), entry=TEXT_VADDR,
                    text_vaddr=TEXT_VADDR, data_bytes=data,
                    data_vaddr=DATA_VADDR)


def c_execute(source: str, max_cycles: int = 1 << 22):
    """Compile and run on the executor; returns (final_state, a0)."""
    from .rv32_isa import execute

    program, entry, image0, ram_words, mem_base = load_c_elf(
        c_to_elf(source))
    mem = {}
    if image0 is not None:
        mem = {mem_base + i: int(w) for i, w in enumerate(image0) if w}
    states, final = execute(program, entry, mem=mem, max_cycles=max_cycles)
    return final, final.regs[10]
