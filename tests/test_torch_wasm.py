"""The port's WASM interpreter and circom-2 witness calculator
(eigen_zkvm_tpu_torch/algebraic/{wasmvm,witness_calculator}.py) against the
JAX package's, on the CPU, on modules this file assembles byte by byte
(LEB128; the type, import, function, table, memory, global, export, start,
elem, code and data sections):

  (i)  a circom-ABI module: the exports and imports the witness calculator
       drives, computing a multiplier's witness [1, a*b, a, b] for inputs
       below 2^32 with i64.mul;
  (ii) an opcode sweep: one export a group of opcodes, run on both
       interpreters with seeded arguments; the results, the traps, the
       memory bytes and the globals must be equal.

A circom-emitted module (tests/test_wasm_witness.py's fixtures) is not in
the repository; these modules stand in for it.
"""
import numpy as np
import pytest

from eigen_zkvm_tpu.algebraic import wasmvm as jwasm
from eigen_zkvm_tpu.algebraic import witness_calculator as jwc
from eigen_zkvm_tpu_torch.algebraic import wasmvm, witness_calculator
from eigen_zkvm_tpu_torch.algebraic.witness import witness_from_bytes
from eigen_zkvm_tpu_torch.curves import bn254

I32, I64, EMPTY = 0x7F, 0x7E, 0x40
M32, M64 = (1 << 32) - 1, (1 << 64) - 1

# ---- a small WASM binary assembler


def uleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def sleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        done = (n == 0 and not b & 0x40) or (n == -1 and b & 0x40)
        out.append(b | (0 if done else 0x80))
        if done:
            return bytes(out)


def vec(items) -> bytes:
    items = list(items)
    return uleb(len(items)) + b"".join(items)


def name(s: str) -> bytes:
    return vec([bytes([c]) for c in s.encode()])


def section(sid: int, payload: bytes) -> bytes:
    return bytes([sid]) + uleb(len(payload)) + payload


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


_NUMERIC = {}
for _base, _names in (
        (0x45, "i32.eqz i32.eq i32.ne i32.lt_s i32.lt_u i32.gt_s i32.gt_u "
               "i32.le_s i32.le_u i32.ge_s i32.ge_u i64.eqz i64.eq i64.ne "
               "i64.lt_s i64.lt_u i64.gt_s i64.gt_u i64.le_s i64.le_u "
               "i64.ge_s i64.ge_u"),
        (0x67, "i32.clz i32.ctz i32.popcnt i32.add i32.sub i32.mul "
               "i32.div_s i32.div_u i32.rem_s i32.rem_u i32.and i32.or "
               "i32.xor i32.shl i32.shr_s i32.shr_u i32.rotl i32.rotr "
               "i64.clz i64.ctz i64.popcnt i64.add i64.sub i64.mul "
               "i64.div_s i64.div_u i64.rem_s i64.rem_u i64.and i64.or "
               "i64.xor i64.shl i64.shr_s i64.shr_u i64.rotl i64.rotr"),
        (0x28, "i32.load i64.load f32.load f64.load i32.load8_s "
               "i32.load8_u i32.load16_s i32.load16_u i64.load8_s "
               "i64.load8_u i64.load16_s i64.load16_u i64.load32_s "
               "i64.load32_u i32.store i64.store f32.store f64.store "
               "i32.store8 i32.store16 i64.store8 i64.store16 i64.store32"),
        (0xC0, "i32.extend8_s i32.extend16_s i64.extend8_s i64.extend16_s "
               "i64.extend32_s")):
    for _k, _n in enumerate(_names.split()):
        _NUMERIC[_n] = _base + _k
_NUMERIC.update({"i32.wrap_i64": 0xA7, "i64.extend_i32_s": 0xAC,
                 "i64.extend_i32_u": 0xAD})
_PLAIN = {"unreachable": 0x00, "nop": 0x01, "else": 0x05, "end": 0x0B,
          "return": 0x0F, "drop": 0x1A, "select": 0x1B}
_IDX = {"br": 0x0C, "br_if": 0x0D, "call": 0x10, "local.get": 0x20,
        "local.set": 0x21, "local.tee": 0x22, "global.get": 0x23,
        "global.set": 0x24}
_BLOCK = {"block": 0x02, "loop": 0x03, "if": 0x04}


def asm(instrs) -> bytes:
    """Instructions as names or (name, immediates...) tuples."""
    out = bytearray()
    for ins in instrs:
        op, *args = (ins,) if isinstance(ins, str) else ins
        if op in _PLAIN:
            out.append(_PLAIN[op])
        elif op in _IDX:
            out += bytes([_IDX[op]]) + uleb(args[0])
        elif op in _BLOCK:
            out += bytes([_BLOCK[op], args[0] if args else EMPTY])
        elif op == "br_table":
            out += b"\x0e" + vec([uleb(d) for d in args[0]]) + uleb(args[1])
        elif op == "call_indirect":
            out += b"\x11" + uleb(args[0]) + b"\x00"
        elif op in ("memory.size", "memory.grow"):
            out += bytes([0x3F if op == "memory.size" else 0x40, 0])
        elif op == "i32.const":
            out += b"\x41" + sleb(_signed(args[0], 32))
        elif op == "i64.const":
            out += b"\x42" + sleb(_signed(args[0], 64))
        elif ".load" in op or ".store" in op:
            out += bytes([_NUMERIC[op]]) + uleb(0) + uleb(
                args[0] if args else 0)
        else:
            out.append(_NUMERIC[op])
    return bytes(out)


def _const_expr(vt: int, v: int) -> bytes:
    return asm([("i32.const" if vt == I32 else "i64.const", v)]) + b"\x0b"


def module(types, funcs, exports, imports=(), table=None, memory=None,
           globals_=(), start=None, elems=(), datas=()) -> bytes:
    """types: [(params, results)]; imports: [(module, name, type)];
    funcs: [(type, [(count, valtype)], instrs)]; exports: [(name, kind,
    index)]; globals_: [(valtype, mutable, value)]; elems: [(offset,
    [function])]; datas: [(offset, bytes)]."""
    body = section(1, vec([b"\x60" + vec([bytes([t]) for t in p])
                           + vec([bytes([t]) for t in r])
                           for p, r in types]))
    if imports:
        body += section(2, vec([name(m) + name(n) + b"\x00" + uleb(t)
                                for m, n, t in imports]))
    body += section(3, vec([uleb(t) for t, _, _ in funcs]))
    if table is not None:
        body += section(4, vec([b"\x70\x00" + uleb(table)]))
    if memory is not None:
        body += section(5, vec([b"\x00" + uleb(memory)]))
    if globals_:
        body += section(6, vec([bytes([vt, mut]) + _const_expr(vt, v)
                                for vt, mut, v in globals_]))
    body += section(7, vec([name(n) + bytes([kind]) + uleb(i)
                            for n, kind, i in exports]))
    if start is not None:
        body += section(8, uleb(start))
    if elems:
        body += section(9, vec([uleb(0) + _const_expr(I32, off)
                                + vec([uleb(f) for f in idxs])
                                for off, idxs in elems]))
    codes = []
    for _, locals_, instrs in funcs:
        code = vec([uleb(n) + bytes([t]) for n, t in locals_]) \
            + asm(instrs) + b"\x0b"
        codes.append(uleb(len(code)) + code)
    body += section(10, vec(codes))
    if datas:
        body += section(11, vec([uleb(0) + _const_expr(I32, off)
                                 + uleb(len(b)) + b for off, b in datas]))
    return b"\x00asm\x01\x00\x00\x00" + body


def test_leb128_round_trips_through_both_decoders():
    rng = np.random.default_rng(3)
    values = [0, 1, 63, 64, 127, 128, 2**31, 2**32 - 1, 2**63, 2**64 - 1] \
        + [int(x) for x in rng.integers(0, 2**63, size=64)]
    for v in values:
        for mod in (jwasm, wasmvm):
            assert mod._leb_u(uleb(v) + b"\xff", 0) == (v, len(uleb(v)))
        for s in (v, -v - 1, _signed(v, 64)):
            for mod in (jwasm, wasmvm):
                assert mod._leb_s(sleb(s), 0) == (s, len(sleb(s)))


# ---- (i) the circom-ABI multiplier

SHARED, PRIME, SIGNALS, MESSAGE = 0, 64, 128, 512


def multiplier_module() -> bytes:
    """A circom-2 witness module for c = a * b: the shared RW memory (8
    words) at SHARED, the prime at PRIME, the four 32-byte signals at
    SIGNALS; setInputSignal copies a and b by their FNV-1a hashes and, when
    both are set, stores a * b (i64.mul of their low words) as signal 1;
    an unknown name reports MESSAGE through printErrorMessage and traps
    through exceptionHandler(1)."""
    (a_msb, a_lsb), (b_msb, b_lsb) = (witness_calculator.fnv64(s)
                                      for s in "ab")
    types = [([I32], []), ([], []), ([I32, I32], []), ([], [I32]),
             ([I32], [I32]), ([I32, I32, I32], [])]
    imports = [("runtime", "exceptionHandler", 0),
               ("runtime", "printErrorMessage", 1)]
    copy = (2, [(1, I32)], [          # f2: copy(dst, src), 8 words
        ("block",), ("loop",),
        ("local.get", 2), ("i32.const", 8), "i32.ge_u", ("br_if", 1),
        ("local.get", 0), ("local.get", 2), ("i32.const", 2), "i32.shl",
        "i32.add",
        ("local.get", 1), ("local.get", 2), ("i32.const", 2), "i32.shl",
        "i32.add", ("i32.load",),
        ("i32.store",),
        ("local.get", 2), ("i32.const", 1), "i32.add", ("local.set", 2),
        ("br", 0), "end", "end"])

    def is_name(msb, lsb):
        return [("local.get", 0), ("i32.const", msb), "i32.eq",
                ("local.get", 1), ("i32.const", lsb), "i32.eq", "i32.and"]

    funcs = [
        copy,
        (3, [], [("i32.const", 8)]),                       # f3
        (1, [], [("i32.const", SHARED), ("i32.const", PRIME),
                 ("call", 2)]),                            # f4
        (3, [], [("i32.const", 2)]),                       # f5
        (0, [(1, I32)], [                                  # f6: init
            ("i32.const", 0), ("local.set", 1),
            ("block",), ("loop",),
            ("local.get", 1), ("i32.const", 128), "i32.ge_u", ("br_if", 1),
            ("i32.const", SIGNALS), ("local.get", 1), "i32.add",
            ("i64.const", 0), ("i64.store",),
            ("local.get", 1), ("i32.const", 8), "i32.add", ("local.set", 1),
            ("br", 0), "end", "end",
            ("i32.const", SIGNALS), ("i32.const", 1), ("i32.store",),
            ("i32.const", 0), ("global.set", 0)]),
        (4, [], [("local.get", 0), ("i32.const", 2), "i32.shl",
                 ("i32.load", SHARED)]),                   # f7
        (2, [], [("local.get", 0), ("i32.const", 2), "i32.shl",
                 ("local.get", 1), ("i32.store", SHARED)]),  # f8
        (5, [], [*is_name(a_msb, a_lsb),                   # f9
                 ("if",),
                 ("i32.const", SIGNALS + 64), ("i32.const", SHARED),
                 ("call", 2),
                 "else",
                 *is_name(b_msb, b_lsb),
                 ("if",),
                 ("i32.const", SIGNALS + 96), ("i32.const", SHARED),
                 ("call", 2),
                 "else",
                 ("i32.const", MESSAGE), ("global.set", 1), ("call", 1),
                 ("i32.const", 1), ("call", 0), "return",
                 "end", "end",
                 ("global.get", 0), ("i32.const", 1), "i32.add",
                 ("global.set", 0),
                 ("global.get", 0), ("i32.const", 2), "i32.eq",
                 ("if",),
                 ("i32.const", SIGNALS + 32),
                 ("i32.const", SIGNALS + 64), ("i64.load32_u",),
                 ("i32.const", SIGNALS + 96), ("i64.load32_u",),
                 "i64.mul", ("i64.store",),
                 "end"]),
        (3, [], [("i32.const", 4)]),                       # f10
        (0, [], [("i32.const", SHARED), ("i32.const", SIGNALS),  # f11
                 ("local.get", 0), ("i32.const", 5), "i32.shl", "i32.add",
                 ("call", 2)]),
        (3, [(1, I32)], [                                  # f12
            ("global.get", 1), ("i32.load8_u",), ("local.set", 0),
            ("local.get", 0),
            ("if",),
            ("global.get", 1), ("i32.const", 1), "i32.add",
            ("global.set", 1),
            "end",
            ("local.get", 0)]),
    ]
    exports = [(n, 0, i) for i, n in enumerate(
        ("getFieldNumLen32", "getRawPrime", "getVersion", "init",
         "readSharedRWMemory", "writeSharedRWMemory", "setInputSignal",
         "getWitnessSize", "getWitness", "getMessageChar"), start=3)]
    exports.append(("memory", 2, 0))
    return module(types, funcs, exports, imports=imports, memory=1,
                  globals_=[(I32, 1, 0), (I32, 1, 0)],
                  datas=[(PRIME, bn254.R.to_bytes(32, "little")),
                         (MESSAGE, b"unknown input signal\x00")])


def _calculators():
    data = multiplier_module()
    return (witness_calculator.WitnessCalculator(wasmvm.WasmModule(data)),
            jwc.WitnessCalculator(jwasm.WasmModule(data)))


def test_fnv64_matches_the_jax_package():
    assert witness_calculator.fnv64("") == (0xCBF29CE4, 0x84222325)
    msb, lsb = witness_calculator.fnv64("a")
    assert (msb << 32) | lsb == 0xAF63DC4C8601EC8C
    rng = np.random.default_rng(7)
    names = ["a", "b", "main.in[3]", "été"] + [
        "".join(chr(c) for c in rng.integers(32, 127, size=n))
        for n in rng.integers(1, 40, size=64)]
    for s in names:
        assert witness_calculator.fnv64(s) == jwc.fnv64(s)


@pytest.mark.parametrize("a,b", [(3, 11), (0, 7), (2**32 - 1, 2**32 - 1),
                                 (123456789, 987654321)])
def test_multiplier_witness_and_wtns_equal_the_jax_calculator(tmp_path, a, b):
    port, jax = _calculators()
    assert (port.prime, port.n32, port.version) == \
        (jax.prime, jax.n32, jax.version) == (bn254.R, 8, 2)
    for sanity in (False, True):
        w = port.calculate_witness({"a": a, "b": [b]}, sanity_check=sanity)
        assert w == jax.calculate_witness({"a": a, "b": [b]},
                                          sanity_check=sanity)
        assert w == [1, a * b, a, b]
    paths = {k: str(tmp_path / f"{k}.wtns") for k in ("port", "jax")}
    port.save_wtns(paths["port"], w)
    jax.save_wtns(paths["jax"], w)
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        data = f.read()
        assert data == g.read()
    assert witness_from_bytes(data) == w
    assert port.inst.memory_bytes() == jax.inst.memory_bytes()


def test_unknown_signal_traps_in_both():
    port, jax = _calculators()
    msgs = []
    for calc, trap in ((port, wasmvm.Trap), (jax, jwasm.Trap)):
        with pytest.raises(trap) as e:
            calc.calculate_witness({"a": 1, "nope": 1}, sanity_check=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == \
        "circom runtime exception: signal not found: unknown input signal"


# ---- (ii) the opcode sweep

_BIN32 = ("i32.add i32.sub i32.mul i32.and i32.or i32.xor i32.shl "
          "i32.shr_s i32.shr_u i32.rotl i32.rotr i32.eq i32.ne i32.lt_s "
          "i32.lt_u i32.gt_s i32.gt_u i32.le_s i32.le_u i32.ge_s "
          "i32.ge_u").split()
_UN32 = "i32.clz i32.ctz i32.popcnt i32.eqz".split()
_BIN64 = [n.replace("i32", "i64") for n in _BIN32]
_UN64 = [n.replace("i32", "i64") for n in _UN32]
_DIV = "div_s div_u rem_s rem_u".split()
# memory areas of the sweep's groups
A32, A64, ADIV32, ADIV64, ACONV, DATA = 0, 1024, 2048, 2304, 3072, 4096
SWEEP_DATA = bytes(range(0x70, 0x90)) + b"\x80\xff\x7f\x00\x01\xfe"


_CMP = {"eqz", "eq", "ne", "lt_s", "lt_u", "gt_s", "gt_u", "le_s", "le_u",
        "ge_s", "ge_u"}


def _store_each(base, width, ops):
    """Each op of the group on (a, b) (or a, for a unary op) stored at
    base + width * k; an i64 comparison's i32 result is widened first."""
    out = []
    for k, op in enumerate(ops):
        ty, kind = op.split(".")
        unary = kind in ("clz", "ctz", "popcnt", "eqz")
        out += [("i32.const", base + width * k), ("local.get", 0),
                *([] if unary else [("local.get", 1)]), op,
                *(["i64.extend_i32_u"] if ty == "i64" and kind in _CMP
                  else []),
                (f"{ty}.store",)]
    return out


def sweep_module() -> bytes:
    types = [([I32, I32], [I32]), ([I64, I64], [I64]), ([I64, I32], [I64]),
             ([I32, I64], [I64]), ([I32], [I32]), ([I32, I32, I32], [I32]),
             ([], []), ([], [I32])]
    g32, g64, gk = 0, 1, 2        # globals: i32 mut, i64 mut, i32 const
    a, b = ("local.get", 0), ("local.get", 1)
    loads = ("i32.load", "i32.load8_s", "i32.load8_u", "i32.load16_s",
             "i32.load16_u", "i64.load", "i64.load8_s", "i64.load8_u",
             "i64.load16_s", "i64.load16_u", "i64.load32_s", "i64.load32_u")
    funcs = [(0, [], [a, b, op]) for op in
             ("i32.add", "i32.sub", "i32.mul", "i32.xor")]    # f0-f3
    funcs += [
        # f4 arith32(a, b): every i32 binary and unary op stored; a ^ b
        (0, [], _store_each(A32, 4, _BIN32 + _UN32) + [a, b, "i32.xor"]),
        # f5 arith64(a, b); a + b
        (1, [], _store_each(A64, 8, _BIN64 + _UN64) + [a, b, "i64.add"]),
        # f6 div32(a, b): signed and unsigned quotients and remainders
        (0, [], _store_each(ADIV32, 4, [f"i32.{d}" for d in _DIV])
         + [a, b, "i32.rem_u"]),
        # f7 div64(a, b)
        (1, [], _store_each(ADIV64, 8, [f"i64.{d}" for d in _DIV])
         + [a, b, "i64.div_u"]),
        # f8 conv(a: i64, b: i32): wraps and extends; a ^ extend_s(b)
        (2, [], [("i32.const", ACONV), a, "i32.wrap_i64", ("i32.store",),
                 ("i32.const", ACONV + 8), b, "i64.extend_i32_s",
                 ("i64.store",),
                 ("i32.const", ACONV + 16), b, "i64.extend_i32_u",
                 ("i64.store",),
                 ("i32.const", ACONV + 24), b, "i32.extend8_s",
                 ("i32.store",),
                 ("i32.const", ACONV + 28), b, "i32.extend16_s",
                 ("i32.store",),
                 ("i32.const", ACONV + 32), a, "i64.extend8_s",
                 ("i64.store",),
                 ("i32.const", ACONV + 40), a, "i64.extend16_s",
                 ("i64.store",),
                 ("i32.const", ACONV + 48), a, "i64.extend32_s",
                 ("i64.store",),
                 a, b, "i64.extend_i32_s", "i64.xor"]),
        # f9 mem(addr: i32, v: i64): stores of every width at addr, then
        # loads of every width at addr, addr + 8 and the data segment,
        # summed
        (3, [(1, I64)], [
            a, b, ("i64.store",),
            a, b, "i32.wrap_i64", ("i32.store8", 8),
            a, b, "i32.wrap_i64", ("i32.store16", 10),
            a, b, "i32.wrap_i64", ("i32.store", 12),
            a, b, ("i64.store8", 16),
            a, b, ("i64.store16", 18),
            a, b, ("i64.store32", 20)]
         + [x for off, at in ((0, a), (8, a), (DATA + 1, ("i32.const", 0)))
            for ld in loads
            for x in (("local.get", 2), at, (ld, off),
                      *(["i64.extend_i32_u"] if ld.startswith("i32")
                        else []),
                      "i64.add", ("local.set", 2))]
         + [("local.get", 2)]),
        # f10 grow(d): memory.size, memory.grow, memory.size
        (4, [], [("memory.size",), ("i32.const", 1000), "i32.mul",
                 a, ("memory.grow",), ("i32.const", 10), "i32.mul",
                 "i32.add", ("memory.size",), "i32.add"]),
        # f11 ctrl(n): a loop with if/else and a br_table on i % 4, a
        # valued block left by br_if, an if with a result, direct calls
        (4, [(2, I32)], [
            ("block",), ("loop",),
            ("local.get", 1), a, "i32.ge_u", ("br_if", 1),
            ("local.get", 1), ("i32.const", 1), "i32.and",
            ("if",),
            ("local.get", 2), ("local.get", 1), "i32.add", ("local.set", 2),
            "else",
            ("local.get", 2), ("i32.const", 3), "i32.xor", ("local.set", 2),
            "end",
            ("block",), ("block",), ("block",), ("block",),
            ("local.get", 1), ("i32.const", 3), "i32.and",
            ("br_table", [0, 1, 2], 3),
            "end",
            ("local.get", 2), ("i32.const", 10), "i32.add", ("local.set", 2),
            ("br", 2),
            "end",
            ("local.get", 2), ("i32.const", 100), "i32.mul",
            ("local.set", 2), ("br", 1),
            "end",
            ("local.get", 2), ("i32.const", 7), "i32.sub", ("local.set", 2),
            "end",
            ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
            ("br", 0),
            "end", "end",
            ("block", I32),
            ("i32.const", 5), a, "i32.eqz", ("br_if", 0),
            "drop", ("i32.const", 9),
            "end",
            ("local.get", 2), ("call", 0),
            a, ("i32.const", 2), "i32.rem_u",
            ("if", I32), ("i32.const", 1000), "else", ("i32.const", 2000),
            "end",
            ("call", 0)]),
        # f12 indirect(k, a, b): call_indirect of table entry k on (a, b)
        (5, [], [b, ("local.get", 2), a, ("call_indirect", 0)]),
        # f13 globals(x): g32 += x; g64 *= x; g32 + wrap(g64) + gk
        (4, [], [("global.get", g32), a, "i32.add", ("global.set", g32),
                 ("global.get", g64), a, "i64.extend_i32_u", "i64.mul",
                 ("global.set", g64),
                 ("global.get", g32), ("global.get", g64), "i32.wrap_i64",
                 "i32.add", ("global.get", gk), "i32.add"]),
        # f14 select(a, b, c): an early return, nop, select, local.tee,
        # drop
        (5, [(1, I32)], [
            ("local.get", 2), ("i32.const", 7), "i32.eq",
            ("if",), ("i32.const", 77), "return", "end",
            "nop", a, b, ("local.get", 2), "select", ("local.tee", 3),
            ("local.get", 3), "drop"]),
        # f15 unreach(): traps
        (7, [], ["unreachable"]),
        # f16, the start function: g32 += 1
        (6, [], [("global.get", g32), ("i32.const", 1), "i32.add",
                 ("global.set", g32)]),
    ]
    names = ["add", "sub", "mul", "xor", "arith32", "arith64", "div32",
             "div64", "conv", "mem", "grow", "ctrl", "indirect", "globals",
             "select", "unreach"]
    exports = [(n, 0, i) for i, n in enumerate(names)] + [("memory", 2, 0)]
    return module(types, funcs, exports, table=5, memory=1,
                  globals_=[(I32, 1, 7), (I64, 1, 5), (I32, 0, 100)],
                  start=16, elems=[(0, [0, 1, 2, 3])],
                  datas=[(DATA, SWEEP_DATA)])


EDGE32 = [0, 1, 2, 31, 32, 33, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
EDGE64 = [0, 1, 63, 64, 65, (1 << 63) - 1, 1 << 63, M64, 0xFFFFFFFF]


def _calls(rng):
    """(export, args) in a fixed order: edge pairs, then seeded draws."""
    r32 = [int(x) for x in rng.integers(0, 2**32, size=12, dtype=np.uint64)]
    r64 = [int(x) for x in rng.integers(0, 2**64, size=12, dtype=np.uint64)]
    calls = []
    for a in EDGE32 + r32[:4]:
        for b in EDGE32[:5] + r32[4:6] + [0xFFFFFFFF]:
            calls += [("arith32", (a, b)), ("div32", (a, b))]
    for a in EDGE64 + r64[:4]:
        for b in EDGE64[:5] + r64[4:6] + [M64]:
            calls += [("arith64", (a, b)), ("div64", (a, b))]
    for a, b in zip(EDGE64 + r64, EDGE32 + r32):
        calls.append(("conv", (a, b)))
    for addr in (0, 100, 8189, 65500, 65512, 65513, 70000):
        for v in (EDGE64[5:] + r64[:2]):
            calls.append(("mem", (addr, v)))
    for n in list(range(10)) + [17, 33]:
        calls.append(("ctrl", (n,)))
    for k in (0, 1, 2, 3, 4, 5, 9):
        calls.append(("indirect", (k, r32[6], r32[7])))
    for x in [3, 0, 0xFFFFFFFF] + r32[8:10]:
        calls.append(("globals", (x,)))
    for c in (0, 1, 7):
        calls.append(("select", (r32[10], r32[11], c)))
    calls += [("unreach", ()), ("grow", (0,)), ("grow", (1,)),
              ("mem", (65536 + 8, M64)), ("grow", (2,)), ("grow", (0,))]
    return calls


def _run(mod, data, calls):
    """Each call's ("ret", value) or ("trap", message), with the memory
    and globals after it."""
    inst = mod.Instance(mod.WasmModule(data))
    out = []
    for name_, args in calls:
        try:
            res = ("ret", inst.invoke(name_, *args))
        except mod.Trap as e:
            res = ("trap", str(e))
        out.append((name_, args, res, bytes(inst.memory_bytes()),
                    list(inst.globals)))
    return out


def test_opcode_sweep_gives_the_jax_interpreters_results():
    data = sweep_module()
    calls = _calls(np.random.default_rng(19))
    port, jax = _run(wasmvm, data, calls), _run(jwasm, data, calls)
    assert len(port) == len(jax) == len(calls)
    for p, j in zip(port, jax):
        assert p[:3] == j[:3]
        assert p[3] == j[3], p[:3]
        assert p[4] == j[4], p[:3]
    results = {(n, a): r for n, a, r, _, _ in port}
    traps = {k for k, r in results.items() if r[0] == "trap"}
    # the traps the sweep is built to reach, and no other
    want = {("div32", (1, 0)), ("div64", (1, 0)),
            ("div32", (0x80000000, 0xFFFFFFFF)), ("div64", (1 << 63, M64)),
            ("unreach", ()), ("mem", (70000, M64)), ("mem", (65513, M64))}
    assert want <= traps
    indirect = {c for c in calls if c[0] == "indirect"}
    assert {c for c in indirect if c[1][0] >= 4} <= traps
    assert not {c for c in indirect if c[1][0] < 4} & traps
    assert {k[0] for k in traps} <= {"div32", "div64", "unreach", "mem",
                                     "indirect"}
    assert results[("grow", (1,))] == ("ret", 1000 + 10 + 2)
    assert results[("mem", (65536 + 8, M64))][0] == "ret"


def _sweep_memory_after(name_, args):
    inst = wasmvm.Instance(wasmvm.WasmModule(sweep_module()))
    res = inst.invoke(name_, *args)
    return res, inst


@pytest.mark.parametrize("a,b", [(5, 3), (0x80000000, 1), (0xFFFFFFFF, 31),
                                 (0x12345678, 0x9ABCDEF0)])
def test_arith32_matches_python_integers(a, b):
    """The i32 group's stored words against Python integer arithmetic."""
    res, inst = _sweep_memory_after("arith32", (a, b))
    words = np.frombuffer(bytes(inst.memory_bytes()[A32 : A32 + 4 * 25]),
                          dtype="<u4")

    def s(v):
        return v - (1 << 32) if v >> 31 else v

    sh = b % 32
    want = [(a + b) & M32, (a - b) & M32, (a * b) & M32, a & b, a | b, a ^ b,
            (a << sh) & M32, (s(a) >> sh) & M32, a >> sh,
            ((a << sh) | (a >> (32 - sh))) & M32,
            ((a >> sh) | (a << (32 - sh))) & M32,
            int(a == b), int(a != b), int(s(a) < s(b)), int(a < b),
            int(s(a) > s(b)), int(a > b), int(s(a) <= s(b)), int(a <= b),
            int(s(a) >= s(b)), int(a >= b),
            32 - a.bit_length(), (a & -a).bit_length() - 1 if a else 32,
            bin(a).count("1"), int(a == 0)]
    assert [int(w) for w in words] == want
    assert res == a ^ b


def test_ctrl_and_globals_follow_their_programs():
    """The control-flow group against the same program in Python, and the
    globals after the start function and two calls."""
    for n in (0, 1, 2, 5, 8, 13):
        acc = 0
        for i in range(n):
            acc = (acc + i) & M32 if i & 1 else acc ^ 3
            acc = [(acc + 10) & M32, (acc * 100) & M32, (acc - 7) & M32,
                   acc][i % 4]
        want = (5 if n == 0 else 9) + acc + (1000 if n % 2 else 2000)
        assert _sweep_memory_after("ctrl", (n,))[0] == want & M32
    inst = wasmvm.Instance(wasmvm.WasmModule(sweep_module()))
    assert inst.globals[:3] == [8, 5, 100]      # the start function ran
    assert inst.invoke("globals", 2) == 10 + 10 + 100
    assert inst.invoke("globals", 3) == 13 + 30 + 100
