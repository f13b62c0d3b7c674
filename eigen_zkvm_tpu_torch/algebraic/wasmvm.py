"""Minimal WebAssembly (MVP, integer subset) interpreter.

The native replacement for the reference's wasmer dependency
(algebraic/src/witness/witness_calculator.rs:11,58 — `wasmer::{Instance,
Module, Store}`): circom-emitted witness generators are small integer-only
wasm modules (i32/i64 arithmetic, linear memory, call_indirect dispatch),
so a compact structured interpreter covers them completely — no JIT, no
external runtime, works on any host.

Scope: every MVP integer instruction, linear memory (load/store/grow),
globals, tables + call_indirect, imported host functions, data/elem
segments, multi-value-free (single-return) functions — exactly what circom
2.x codegen emits.  Float opcodes raise (circom never emits them).

    mod = WasmModule(open("circuit.wasm", "rb").read())
    inst = Instance(mod, imports={"runtime": {...}})
    inst.invoke("init", 1)

Copy of eigen_zkvm_tpu/algebraic/wasmvm.py: host code, no device work.
"""
from __future__ import annotations

import struct

# ---- binary decoding -------------------------------------------------------


def _leb_u(buf: bytes, p: int):
    r = s = 0
    while True:
        b = buf[p]
        p += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, p
        s += 7


def _leb_s(buf: bytes, p: int):
    r = s = 0
    while True:
        b = buf[p]
        p += 1
        r |= (b & 0x7F) << s
        s += 7
        if not b & 0x80:
            if b & 0x40:
                r -= 1 << s
            return r, p


class FuncType:
    __slots__ = ("params", "results")

    def __init__(self, params, results):
        self.params = params
        self.results = results


class Func:
    """One decoded function body: flat instruction list with pre-resolved
    structured-control targets."""

    __slots__ = ("type_idx", "n_locals", "instrs")

    def __init__(self, type_idx, n_locals, instrs):
        self.type_idx = type_idx
        self.n_locals = n_locals
        self.instrs = instrs


PAGE = 65536

# control opcodes get target slots patched at decode time:
#   ("block", arity, end_idx)   br -> end_idx (+1 to skip the end marker)
#   ("loop", arity, self_idx)   br -> self_idx (re-enters, re-pushes label)
#   ("if", arity, else_idx, end_idx)


class WasmModule:
    def __init__(self, data: bytes):
        assert data[:4] == b"\x00asm", "not a wasm module"
        self.types: list[FuncType] = []
        self.imports = []          # (module, name, kind, extra)
        self.import_funcs = []     # (module, name, type_idx), in func order
        self.n_imported_funcs = 0
        self.func_type_idxs = []   # for module-defined funcs
        self.funcs: list[Func] = []
        self.table_min = 0
        self.mem_min = 0
        self.globals = []          # (valtype, mutable, init_value)
        self.exports = {}          # name -> (kind, idx)
        self.elems = []            # (offset, [func_idx])
        self.datas = []            # (offset, bytes)
        self.start = None
        pos = 8
        while pos < len(data):
            sid = data[pos]
            pos += 1
            size, pos = _leb_u(data, pos)
            body = data[pos : pos + size]
            pos += size
            if sid == 1:
                self._sec_type(body)
            elif sid == 2:
                self._sec_import(body)
            elif sid == 3:
                self._sec_func(body)
            elif sid == 4:
                self._sec_table(body)
            elif sid == 5:
                self._sec_memory(body)
            elif sid == 6:
                self._sec_global(body)
            elif sid == 7:
                self._sec_export(body)
            elif sid == 8:
                self.start, _ = _leb_u(body, 0)
            elif sid == 9:
                self._sec_elem(body)
            elif sid == 10:
                self._sec_code(body)
            elif sid == 11:
                self._sec_data(body)
            # custom (0) and datacount (12) sections are ignored

    def _sec_type(self, b):
        n, p = _leb_u(b, 0)
        for _ in range(n):
            assert b[p] == 0x60
            p += 1
            np_, p = _leb_u(b, p)
            params = list(b[p : p + np_])
            p += np_
            nr, p = _leb_u(b, p)
            results = list(b[p : p + nr])
            p += nr
            self.types.append(FuncType(params, results))

    def _sec_import(self, b):
        n, p = _leb_u(b, 0)
        for _ in range(n):
            ml, p = _leb_u(b, p)
            mod = b[p : p + ml].decode()
            p += ml
            nl, p = _leb_u(b, p)
            nm = b[p : p + nl].decode()
            p += nl
            kind = b[p]
            p += 1
            if kind == 0:  # func
                ti, p = _leb_u(b, p)
                self.imports.append((mod, nm, 0, ti))
                self.import_funcs.append((mod, nm, ti))
                self.n_imported_funcs += 1
            elif kind == 1:  # table
                p += 1  # elemtype
                fl = b[p]
                p += 1
                mn, p = _leb_u(b, p)
                if fl & 1:
                    _, p = _leb_u(b, p)
                self.imports.append((mod, nm, 1, mn))
            elif kind == 2:  # memory
                fl = b[p]
                p += 1
                mn, p = _leb_u(b, p)
                if fl & 1:
                    _, p = _leb_u(b, p)
                self.imports.append((mod, nm, 2, mn))
                self.mem_min = max(self.mem_min, mn)
            elif kind == 3:  # global
                vt = b[p]
                mu = b[p + 1]
                p += 2
                self.imports.append((mod, nm, 3, (vt, mu)))
            else:
                raise ValueError(f"import kind {kind}")

    def _sec_func(self, b):
        n, p = _leb_u(b, 0)
        for _ in range(n):
            ti, p = _leb_u(b, p)
            self.func_type_idxs.append(ti)

    def _sec_table(self, b):
        n, p = _leb_u(b, 0)
        if n:
            p += 1  # elemtype 0x70
            fl = b[p]
            p += 1
            self.table_min, p = _leb_u(b, p)
            if fl & 1:
                _, p = _leb_u(b, p)

    def _sec_memory(self, b):
        n, p = _leb_u(b, 0)
        if n:
            fl = b[p]
            p += 1
            mn, p = _leb_u(b, p)
            self.mem_min = max(self.mem_min, mn)

    def _const_expr(self, b, p):
        op = b[p]
        p += 1
        if op == 0x41:
            v, p = _leb_s(b, p)
        elif op == 0x42:
            v, p = _leb_s(b, p)
        elif op == 0x23:  # global.get (imported const) — unsupported here
            v, p = _leb_u(b, p)
            raise NotImplementedError("global.get in const expr")
        else:
            raise NotImplementedError(f"const expr opcode {op:#x}")
        assert b[p] == 0x0B
        return v, p + 1

    def _sec_global(self, b):
        n, p = _leb_u(b, 0)
        for _ in range(n):
            vt = b[p]
            mu = b[p + 1]
            p += 2
            v, p = self._const_expr(b, p)
            self.globals.append((vt, mu, v))

    def _sec_export(self, b):
        n, p = _leb_u(b, 0)
        for _ in range(n):
            nl, p = _leb_u(b, p)
            nm = b[p : p + nl].decode()
            p += nl
            kind = b[p]
            p += 1
            idx, p = _leb_u(b, p)
            self.exports[nm] = (kind, idx)

    def _sec_elem(self, b):
        n, p = _leb_u(b, 0)
        for _ in range(n):
            flags, p = _leb_u(b, p)
            assert flags == 0, f"elem segment flags {flags}"
            off, p = self._const_expr(b, p)
            cnt, p = _leb_u(b, p)
            idxs = []
            for _ in range(cnt):
                fi, p = _leb_u(b, p)
                idxs.append(fi)
            self.elems.append((off, idxs))

    def _sec_data(self, b):
        n, p = _leb_u(b, 0)
        for _ in range(n):
            flags, p = _leb_u(b, p)
            assert flags == 0, f"data segment flags {flags}"
            off, p = self._const_expr(b, p)
            ln, p = _leb_u(b, p)
            self.datas.append((off, bytes(b[p : p + ln])))
            p += ln

    def _sec_code(self, b):
        n, p = _leb_u(b, 0)
        for i in range(n):
            sz, p = _leb_u(b, p)
            end = p + sz
            nl_groups, q = _leb_u(b, p)
            n_locals = 0
            for _ in range(nl_groups):
                cnt, q = _leb_u(b, q)
                q += 1  # valtype
                n_locals += cnt
            instrs = self._decode_body(b, q, end, self.func_type_idxs[i])
            self.funcs.append(Func(self.func_type_idxs[i], n_locals, instrs))
            p = end

    def _block_arity(self, bt: int) -> int:
        # sleb-decoded blocktype: -64 = empty, other negatives = one value
        # type, non-negative = function-type index
        if bt == -64:
            return 0
        if bt < 0:
            return 1
        return len(self.types[bt].results)

    def _decode_body(self, b, p, end, type_idx):
        instrs = []
        ctrl = []  # decode-time stack of instr indices for block/loop/if
        while p < end:
            op = b[p]
            p += 1
            if op in (0x02, 0x03, 0x04):  # block / loop / if
                bt, p = _leb_s(b, p)
                arity = self._block_arity(bt)
                idx = len(instrs)
                name = {0x02: "block", 0x03: "loop", 0x04: "if"}[op]
                instrs.append([name, arity, None, None])
                ctrl.append(idx)
            elif op == 0x05:  # else
                i = ctrl[-1]
                assert instrs[i][0] == "if"
                # condition-false jumps past the then-arm's goto-end marker
                instrs[i][2] = len(instrs) + 1
                instrs.append(["else_jump", i])  # placeholder -> end
            elif op == 0x0B:  # end
                if not ctrl:  # function end
                    instrs.append(("func_end",))
                    break
                i = ctrl.pop()
                here = len(instrs)
                kind = instrs[i][0]
                if kind == "block":
                    instrs[i][3] = here
                elif kind == "loop":
                    instrs[i][3] = here
                else:  # if
                    instrs[i][3] = here
                    if instrs[i][2] is None:
                        instrs[i][2] = here  # no else: jump straight to end
                instrs.append(("end",))
            elif op == 0x0C:
                d, p = _leb_u(b, p)
                instrs.append(("br", d))
            elif op == 0x0D:
                d, p = _leb_u(b, p)
                instrs.append(("br_if", d))
            elif op == 0x0E:
                cnt, p = _leb_u(b, p)
                tgts = []
                for _ in range(cnt):
                    d, p = _leb_u(b, p)
                    tgts.append(d)
                dflt, p = _leb_u(b, p)
                instrs.append(("br_table", tgts, dflt))
            elif op == 0x0F:
                instrs.append(("return",))
            elif op == 0x10:
                fi, p = _leb_u(b, p)
                instrs.append(("call", fi))
            elif op == 0x11:
                ti, p = _leb_u(b, p)
                p += 1  # table idx (0)
                instrs.append(("call_indirect", ti))
            elif op == 0x00:
                instrs.append(("unreachable",))
            elif op == 0x01:
                pass  # nop
            elif op == 0x1A:
                instrs.append(("drop",))
            elif op == 0x1B:
                instrs.append(("select",))
            elif op in (0x20, 0x21, 0x22, 0x23, 0x24):
                i, p = _leb_u(b, p)
                nm = {0x20: "local.get", 0x21: "local.set", 0x22: "local.tee",
                      0x23: "global.get", 0x24: "global.set"}[op]
                instrs.append((nm, i))
            elif 0x28 <= op <= 0x3E:  # loads/stores
                _, p = _leb_u(b, p)  # align
                off, p = _leb_u(b, p)
                instrs.append((op, off))
            elif op == 0x3F:
                p += 1
                instrs.append(("memory.size",))
            elif op == 0x40:
                p += 1
                instrs.append(("memory.grow",))
            elif op == 0x41:
                v, p = _leb_s(b, p)
                instrs.append(("const", v & 0xFFFFFFFF))
            elif op == 0x42:
                v, p = _leb_s(b, p)
                instrs.append(("const", v & 0xFFFFFFFFFFFFFFFF))
            elif 0x45 <= op <= 0xC4:
                instrs.append((op,))
            else:
                raise NotImplementedError(f"opcode {op:#x}")
        # patch else_jump placeholders to their if's end index
        for k, ins in enumerate(instrs):
            if isinstance(ins, list) and ins[0] == "else_jump":
                instrs[k] = ("goto", instrs[ins[1]][3])
            elif isinstance(ins, list):
                instrs[k] = tuple(ins)
        return instrs


# ---- execution -------------------------------------------------------------

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


def _s32(v):
    return v - 0x100000000 if v & 0x80000000 else v


def _s64(v):
    return v - 0x10000000000000000 if v & 0x8000000000000000 else v


class Trap(RuntimeError):
    pass


class Instance:
    """One instantiated module.  `imports` maps module -> name -> callable;
    imported functions receive unsigned python ints and return an int or
    None (per their wasm signature)."""

    def __init__(self, mod: WasmModule, imports=None):
        self.mod = mod
        self.mem = bytearray(mod.mem_min * PAGE)
        self.globals = [v for (_, _, v) in mod.globals]
        self.table = [None] * mod.table_min
        for off, idxs in mod.elems:
            for j, fi in enumerate(idxs):
                if off + j >= len(self.table):
                    self.table.extend([None] * (off + j + 1 - len(self.table)))
                self.table[off + j] = fi
        for off, blob in mod.datas:
            self.mem[off : off + len(blob)] = blob
        self.host_funcs = []
        imports = imports or {}
        for (m, nm, _ti) in mod.import_funcs:
            try:
                self.host_funcs.append(imports[m][nm])
            except KeyError:
                raise KeyError(f"missing import {m}.{nm}")
        if mod.start is not None:
            self._call(mod.start, [])

    # -- public API --
    def invoke(self, name: str, *args):
        kind, idx = self.mod.exports[name]
        assert kind == 0, f"{name} is not a function export"
        nif = self.mod.n_imported_funcs
        ti = self.mod.import_funcs[idx][2] if idx < nif \
            else self.mod.funcs[idx - nif].type_idx
        params = self.mod.types[ti].params
        assert len(args) == len(params), f"{name} wants {len(params)} args"
        masked = [a & (M64 if t == 0x7E else M32)
                  for a, t in zip(args, params)]
        res = self._call(idx, masked)
        return res[0] if res else None

    def memory_bytes(self) -> bytearray:
        return self.mem

    # -- internals --
    def _call(self, func_idx: int, args):
        nif = self.mod.n_imported_funcs
        if func_idx < nif:
            r = self.host_funcs[func_idx](*args)
            return [] if r is None else [r & M64]
        f = self.mod.funcs[func_idx - nif]
        ft = self.mod.types[f.type_idx]
        locals_ = list(args) + [0] * f.n_locals
        return self._exec(f, ft, locals_)

    def _mem_u(self, addr, size):
        b = self.mem[addr : addr + size]
        if len(b) < size:
            raise Trap(f"oob load at {addr}")
        return int.from_bytes(b, "little")

    def _mem_w(self, addr, size, val):
        if addr + size > len(self.mem):
            raise Trap(f"oob store at {addr}")
        self.mem[addr : addr + size] = (val & ((1 << (8 * size)) - 1)).to_bytes(
            size, "little")

    def _exec(self, f: Func, ft: FuncType, locals_):
        instrs = f.instrs
        stack = []
        # label stack: (target_idx, stack_height, arity, is_loop)
        labels = [(len(instrs) - 1, 0, len(ft.results), False)]
        pc = 0
        mod = self.mod
        glob = self.globals
        while True:
            ins = instrs[pc]
            op = ins[0]
            if op == "const":
                stack.append(ins[1])
            elif op == "local.get":
                stack.append(locals_[ins[1]])
            elif op == "local.set":
                locals_[ins[1]] = stack.pop()
            elif op == "local.tee":
                locals_[ins[1]] = stack[-1]
            elif isinstance(op, int):
                if 0x28 <= op <= 0x35:  # loads
                    addr = stack.pop() + ins[1]
                    sz, signed, mask = _LOAD[op]
                    v = self._mem_u(addr, sz)
                    if signed and v & (1 << (8 * sz - 1)):
                        v -= 1 << (8 * sz)
                    stack.append(v & mask)
                elif 0x36 <= op <= 0x3E:  # stores
                    v = stack.pop()
                    addr = stack.pop() + ins[1]
                    self._mem_w(addr, _STORE[op], v)
                else:
                    _NUMERIC[op](stack)
            elif op == "block":
                labels.append((ins[3], len(stack), ins[1], False))
            elif op == "loop":
                labels.append((pc, len(stack), ins[1], True))
            elif op == "if":
                c = stack.pop()
                labels.append((ins[3], len(stack), ins[1], False))
                if not c:
                    # else target: first else-body instr, or the "end"
                    # marker for else-less ifs (which pops the label)
                    pc = ins[2]
                    continue
            elif op == "goto":  # end-of-then jump over the else arm
                pc = ins[1]
                continue
            elif op == "end":
                labels.pop()
            elif op == "func_end":
                return stack[len(stack) - len(ft.results):]
            elif op == "br" or op == "br_if" or op == "br_table":
                if op == "br_if":
                    if not stack.pop():
                        pc += 1
                        continue
                    d = ins[1]
                elif op == "br_table":
                    i = _s32(stack.pop())
                    tgts, dflt = ins[1], ins[2]
                    d = tgts[i] if 0 <= i < len(tgts) else dflt
                else:
                    d = ins[1]
                if d + 1 >= len(labels):  # br out of the function body
                    return stack[len(stack) - len(ft.results):]
                target, height, arity, is_loop = labels[-1 - d]
                vals = stack[len(stack) - arity:] if (arity and not is_loop) \
                    else []
                del labels[len(labels) - 1 - d:]
                del stack[height:]
                stack.extend(vals)
                pc = target
                if not is_loop:
                    pc += 1  # skip the "end" marker (label already popped)
                continue
            elif op == "return":
                return stack[len(stack) - len(ft.results):]
            elif op == "call":
                fi = ins[1]
                nif = mod.n_imported_funcs
                ti = mod.import_funcs[fi][2] if fi < nif \
                    else mod.funcs[fi - nif].type_idx
                np_ = len(mod.types[ti].params)
                args = stack[len(stack) - np_:]
                del stack[len(stack) - np_:]
                stack.extend(self._call(fi, args))
            elif op == "call_indirect":
                ti = ins[1]
                elem = stack.pop()
                if elem >= len(self.table) or self.table[elem] is None:
                    raise Trap("bad call_indirect")
                fi = self.table[elem]
                np_ = len(mod.types[ti].params)
                args = stack[len(stack) - np_:]
                del stack[len(stack) - np_:]
                stack.extend(self._call(fi, args))
            elif op == "drop":
                stack.pop()
            elif op == "select":
                c = stack.pop()
                b = stack.pop()
                a = stack.pop()
                stack.append(a if c else b)
            elif op == "global.get":
                stack.append(glob[ins[1]])
            elif op == "global.set":
                glob[ins[1]] = stack.pop()
            elif op == "memory.size":
                stack.append(len(self.mem) // PAGE)
            elif op == "memory.grow":
                d = stack.pop()
                old = len(self.mem) // PAGE
                self.mem.extend(bytes(d * PAGE))
                stack.append(old)
            elif op == "unreachable":
                raise Trap("unreachable")
            else:
                raise NotImplementedError(op)
            pc += 1


# (opcode) -> (bytes, signed, result mask) for loads; bytes for stores
_LOAD = {
    0x28: (4, False, M32), 0x29: (8, False, M64),
    0x2C: (1, True, M32), 0x2D: (1, False, M32),
    0x2E: (2, True, M32), 0x2F: (2, False, M32),
    0x30: (1, True, M64), 0x31: (1, False, M64),
    0x32: (2, True, M64), 0x33: (2, False, M64),
    0x34: (4, True, M64), 0x35: (4, False, M64),
}
# i32.store=0x36 i64.store=0x37 (0x38/0x39 are f32/f64 — never emitted by
# circom, absent here so they raise) i32.store8/16=0x3a/0x3b
# i64.store8/16/32=0x3c/0x3d/0x3e
_STORE = {0x36: 4, 0x37: 8, 0x3A: 1, 0x3B: 2, 0x3C: 1, 0x3D: 2, 0x3E: 4}


def _div_s(a, b, bits):
    if b == 0:
        raise Trap("integer divide by zero")
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    if q >= 1 << (bits - 1):
        raise Trap("integer overflow")
    return q


def _rem_s(a, b):
    if b == 0:
        raise Trap("integer divide by zero")
    r = abs(a) % abs(b)
    return -r if a < 0 else r


def _clz(v, bits):
    if v == 0:
        return bits
    return bits - v.bit_length()


def _ctz(v, bits):
    if v == 0:
        return bits
    return (v & -v).bit_length() - 1


def _rotl(v, n, bits, mask):
    n %= bits
    return ((v << n) | (v >> (bits - n))) & mask


def _rotr(v, n, bits, mask):
    n %= bits
    return ((v >> n) | (v << (bits - n))) & mask


def _mk_numeric():
    t = {}

    def bin32(op, fn):
        def h(st):
            b = st.pop()
            a = st.pop()
            st.append(fn(a, b) & M32)
        t[op] = h

    def bin64(op, fn):
        def h(st):
            b = st.pop()
            a = st.pop()
            st.append(fn(a, b) & M64)
        t[op] = h

    def un(op, fn):
        def h(st):
            st.append(fn(st.pop()))
        t[op] = h

    # -- i32 compare --
    un(0x45, lambda a: int(a == 0))
    bin32(0x46, lambda a, b: int(a == b))
    bin32(0x47, lambda a, b: int(a != b))
    bin32(0x48, lambda a, b: int(_s32(a) < _s32(b)))
    bin32(0x49, lambda a, b: int(a < b))
    bin32(0x4A, lambda a, b: int(_s32(a) > _s32(b)))
    bin32(0x4B, lambda a, b: int(a > b))
    bin32(0x4C, lambda a, b: int(_s32(a) <= _s32(b)))
    bin32(0x4D, lambda a, b: int(a <= b))
    bin32(0x4E, lambda a, b: int(_s32(a) >= _s32(b)))
    bin32(0x4F, lambda a, b: int(a >= b))
    # -- i64 compare --
    un(0x50, lambda a: int(a == 0))
    bin64(0x51, lambda a, b: int(a == b))
    bin64(0x52, lambda a, b: int(a != b))
    bin64(0x53, lambda a, b: int(_s64(a) < _s64(b)))
    bin64(0x54, lambda a, b: int(a < b))
    bin64(0x55, lambda a, b: int(_s64(a) > _s64(b)))
    bin64(0x56, lambda a, b: int(a > b))
    bin64(0x57, lambda a, b: int(_s64(a) <= _s64(b)))
    bin64(0x58, lambda a, b: int(a <= b))
    bin64(0x59, lambda a, b: int(_s64(a) >= _s64(b)))
    bin64(0x5A, lambda a, b: int(a >= b))
    # -- i32 arithmetic --
    un(0x67, lambda a: _clz(a, 32))
    un(0x68, lambda a: _ctz(a, 32))
    un(0x69, lambda a: bin(a).count("1"))
    bin32(0x6A, lambda a, b: a + b)
    bin32(0x6B, lambda a, b: a - b)
    bin32(0x6C, lambda a, b: a * b)
    bin32(0x6D, lambda a, b: _div_s(_s32(a), _s32(b), 32))
    bin32(0x6E, lambda a, b: a // b if b else _trap())
    bin32(0x6F, lambda a, b: _rem_s(_s32(a), _s32(b)))
    bin32(0x70, lambda a, b: a % b if b else _trap())
    bin32(0x71, lambda a, b: a & b)
    bin32(0x72, lambda a, b: a | b)
    bin32(0x73, lambda a, b: a ^ b)
    bin32(0x74, lambda a, b: a << (b % 32))
    bin32(0x75, lambda a, b: _s32(a) >> (b % 32))
    bin32(0x76, lambda a, b: a >> (b % 32))
    bin32(0x77, lambda a, b: _rotl(a, b, 32, M32))
    bin32(0x78, lambda a, b: _rotr(a, b, 32, M32))
    # -- i64 arithmetic --
    un(0x79, lambda a: _clz(a, 64))
    un(0x7A, lambda a: _ctz(a, 64))
    un(0x7B, lambda a: bin(a).count("1"))
    bin64(0x7C, lambda a, b: a + b)
    bin64(0x7D, lambda a, b: a - b)
    bin64(0x7E, lambda a, b: a * b)
    bin64(0x7F, lambda a, b: _div_s(_s64(a), _s64(b), 64))
    bin64(0x80, lambda a, b: a // b if b else _trap())
    bin64(0x81, lambda a, b: _rem_s(_s64(a), _s64(b)))
    bin64(0x82, lambda a, b: a % b if b else _trap())
    bin64(0x83, lambda a, b: a & b)
    bin64(0x84, lambda a, b: a | b)
    bin64(0x85, lambda a, b: a ^ b)
    bin64(0x86, lambda a, b: a << (b % 64))
    bin64(0x87, lambda a, b: _s64(a) >> (b % 64))
    bin64(0x88, lambda a, b: a >> (b % 64))
    bin64(0x89, lambda a, b: _rotl(a, b, 64, M64))
    bin64(0x8A, lambda a, b: _rotr(a, b, 64, M64))
    # -- conversions --
    un(0xA7, lambda a: a & M32)                       # i32.wrap_i64
    un(0xAC, lambda a: _s32(a) & M64)                 # i64.extend_i32_s
    un(0xAD, lambda a: a & M32)                       # i64.extend_i32_u
    # sign-extension ops (post-MVP but emitted by modern LLVM)
    un(0xC0, lambda a: (_s32(a << 24 & M32) >> 24) & M32)  # i32.extend8_s
    un(0xC1, lambda a: (_s32(a << 16 & M32) >> 16) & M32)  # i32.extend16_s
    un(0xC2, lambda a: (_s64(a << 56 & M64) >> 56) & M64)  # i64.extend8_s
    un(0xC3, lambda a: (_s64(a << 48 & M64) >> 48) & M64)  # i64.extend16_s
    un(0xC4, lambda a: (_s64(a << 32 & M64) >> 32) & M64)  # i64.extend32_s
    return t


def _trap():
    raise Trap("integer divide by zero")


_NUMERIC = _mk_numeric()
