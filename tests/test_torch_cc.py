"""The port's C toolchain (eigen_zkvm_tpu_torch/zkvm/cc.py) and its C guests
(zkvm/{guest_keccak,guest_secp256k1,guest_evm_c}.py) against the JAX
package's.

Every C source that the JAX package's tests compile (tests/
test_cc_evm.py's programs, the keccak sources, the secp256k1 unit and full
recovery guests, the EVM interpreter guest for every bytecode those tests
run) gives the same assembly, data and ELF bytes from both compilers; the
port's compiler rebuilds the committed guest data/guests/evm_token.elf.gz
byte for byte (and data/guests/ecrecover.elf.gz: tests/test_torch_rv32.py).  Then the JAX tests'
behavioural cases on the port's modules and executors: keccak against
keccak256_ref, the EVM guest differentially against evm_mirror (the fuzz
at the JAX test's seed), gas metering and out-of-gas, and ecrecover
against ecrecover_ref, a forged hint failing closed and out-of-range
signatures rejected.  Every comparison is exact.
"""
import random

import numpy as np
import pytest
import torch

pytest.importorskip("pycparser")

from eigen_zkvm_tpu.zkvm import cc as j_cc  # noqa: E402
from eigen_zkvm_tpu.zkvm import guest_evm_c as j_evm_c  # noqa: E402
from eigen_zkvm_tpu.zkvm import guest_keccak as j_keccak  # noqa: E402
from eigen_zkvm_tpu.zkvm import guest_secp256k1 as j_secp  # noqa: E402
from eigen_zkvm_tpu_torch.zkvm import cc, guest_evm_c  # noqa: E402
from eigen_zkvm_tpu_torch.zkvm import guest_keccak  # noqa: E402
from eigen_zkvm_tpu_torch.zkvm import guest_secp256k1 as g  # noqa: E402
from eigen_zkvm_tpu_torch.zkvm import rv32_native as rn  # noqa: E402
from eigen_zkvm_tpu_torch.zkvm.rv32_isa import execute  # noqa: E402

U256 = (1 << 256) - 1
MIN256 = 1 << 255
# scripts/zkvm_e2e.py's signer (tests/test_secp256k1_guest.py's vector)
PRIV = 0xC0FFEE254729296A45A3885639AC7E10F9D54979787FA3A62E9E0C2F1B1B1B1B
K_NONCE = 0xA1B2C3D4E5F60718293A4B5C6D7E8F901122334455667788991011121314D00D
MSGS = (b"round-4 ecrecover vector", b"another message")
KECCAK_MSGS = (b"abc", b"x" * 135, b"y" * 136, b"z" * 200)

PROGRAMS = r"""
int fib(int n) { if (n < 2) return n; return fib(n-1) + fib(n-2); }
unsigned gcd(unsigned a, unsigned b) {
    while (b != 0) { unsigned t = a % b; a = b; b = t; }
    return a;
}
int arr[8] = {3, 1, 4, 1, 5, 9, 2, 6};
int main() {
    int i; int sum = 0;
    for (i = 0; i < 8; i++) sum += arr[i];
    unsigned char *p = (unsigned char *)0;  /* NULL-ish unused */
    return sum * 1000000 + fib(10) * 1000 + (int)gcd(252u, 198u);
}
"""
ACC16 = r"""
int acc[16];
int main() {
    int i;
    for (i = 0; i < 16; i++) acc[i] = i * i + 1;
    int s = 0;
    for (i = 0; i < 16; i++) s += acc[i];
    return s;
}
"""
# if (callvalue < 100) { sstore(5, callvalue*3) } else { sstore(5, 7) }
BRANCH_CODE = bytes.fromhex(
    "34" "6064" "9010" "6011" "57" "6007600555" "601a56" "5b"
    "34600302" "600555" "5b" "00")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _push32(v: int) -> bytes:
    return bytes([0x7F]) + (v & U256).to_bytes(32, "big")


def _keccak_source(msg: bytes, keccak=guest_keccak) -> str:
    blob = ", ".join(str(b) for b in msg)
    return keccak.keccak_c_source() + f"""
unsigned char msg[{len(msg)}] = {{{blob}}};
unsigned char dig[32];
int main() {{
    keccak256(msg, {len(msg)}u, dig);
    return (int)((unsigned)dig[0] | ((unsigned)dig[1] << 8)
         | ((unsigned)dig[2] << 16) | ((unsigned)dig[3] << 24));
}}
"""


def _arith_code():
    """tests/test_cc_evm.py's extended-arithmetic program (seed 0xE5D):
    (code, cases, first free slot)."""
    rng = random.Random(0xE5D)
    ops2 = [0x04, 0x05, 0x06, 0x07, 0x12, 0x13, 0x1A, 0x1B, 0x1C, 0x1D]
    ops3 = [0x08, 0x09]
    code, slot, cases = b"", 0, []
    for _ in range(12):
        op = rng.choice(ops2)
        a = rng.choice([rng.getrandbits(256), rng.getrandbits(64),
                        MIN256, U256, 0, 1])
        b = rng.choice([rng.getrandbits(256), rng.getrandbits(32),
                        U256, 0, 1, 7, 255, 256])
        code += _push32(b) + _push32(a) + bytes([op])
        code += _push32(slot) + bytes([0x55])
        cases.append((op, a, b))
        slot += 1
    for _ in range(2):
        op = rng.choice(ops3)
        n = rng.getrandbits(200) | 1
        b, c = rng.getrandbits(256), rng.getrandbits(256)
        code += _push32(n) + _push32(c) + _push32(b) + bytes([op])
        code += _push32(slot) + bytes([0x55])
        cases.append((op, b, c, n))
        slot += 1
    code += _push32(3) + _push32(123456789) + bytes([0x0A])
    code += _push32(slot) + bytes([0x55])
    slot += 1
    code += _push32(0xFF80) + _push32(0) + bytes([0x0B])
    code += _push32(slot) + bytes([0x55])
    slot += 1
    return code + bytes([0x00]), cases, slot


ENV_CALLDATA = bytes(range(1, 41))
ENV_CODE = (
    _push32(8) + _push32(4) + _push32(0) + bytes([0x37])
    + _push32(32) + _push32(0) + _push32(64) + bytes([0x39])
    + bytes([0x36]) + _push32(0) + bytes([0x55])
    + bytes([0x38]) + _push32(1) + bytes([0x55])
    + bytes([0x58]) + _push32(2) + bytes([0x55])
    + bytes([0x59]) + _push32(3) + bytes([0x55])
    + bytes([0x5A]) + _push32(4) + bytes([0x55])
    + _push32(0x77) + _push32(8) + _push32(0) + bytes([0xA1])
    + _push32(4) + _push32(64) + bytes([0xA0])
    + bytes([0x00]))
GAS_CODE = (_push32(7) + _push32(5) + bytes([0x55])
            + _push32(2) + _push32(10) + bytes([0x0A])
            + _push32(6) + bytes([0x55])
            + bytes([0x00]))


def _fuzz_programs():
    """tests/test_cc_evm.py's random programs (seed 0xF122): (calldata,
    [code, ...])."""
    rng = random.Random(0xF122)
    ops0 = [0x34, 0x36, 0x38, 0x58, 0x59, 0x5A]
    ops2 = [0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x0B, 0x10, 0x11,
            0x12, 0x13, 0x14, 0x16, 0x17, 0x18, 0x1A, 0x1B, 0x1C, 0x1D]
    ops3 = [0x08, 0x09]
    calldata = bytes(rng.randrange(256) for _ in range(64))
    codes = []
    for _ in range(12):
        code, depth = b"", 0
        for _ in range(rng.randrange(4, 16)):
            r = rng.random()
            if depth == 0 or r < 0.35:
                v = rng.choice([rng.getrandbits(256), rng.getrandbits(32),
                                rng.getrandbits(8), 0, 1])
                code += _push32(v)
                depth += 1
            elif depth >= 3 and r < 0.45:
                code += bytes([rng.choice(ops3)])
                depth -= 2
            elif depth >= 2 and r < 0.75:
                code += bytes([rng.choice(ops2)])
                depth -= 1
            elif r < 0.85:
                code += bytes([rng.choice(ops0)])
                depth += 1
            else:
                code += bytes([0x15])
        for s in range(min(depth, 4)):
            code += _push32(s) + bytes([0x55])
            depth -= 1
        codes.append(code + bytes([0x00]))
    return calldata, codes


def _vector(msg: bytes):
    e = int.from_bytes(g.keccak256_ref(msg), "big")
    v, r, s = g.sign(e, PRIV, K_NONCE)
    return e, v, r, s


def _sources(keccak=guest_keccak, evm_c=guest_evm_c, secp=g) -> dict:
    """name: C source, for every source the JAX package's tests compile,
    from the given modules' source functions (the port's or the JAX
    package's)."""
    out = {"programs": PROGRAMS, "acc16": ACC16}
    for i, msg in enumerate(KECCAK_MSGS):
        out[f"keccak {i}"] = _keccak_source(msg, keccak)
    evm = {"token": (guest_evm_c.TOKEN_CODE, guest_evm_c.TOKEN_CALLDATA, 0,
                     guest_evm_c.TOKEN_STORAGE, 30_000_000),
           "branch 40": (BRANCH_CODE, b"", 40, {}, 30_000_000),
           "branch 250": (BRANCH_CODE, b"", 250, {}, 30_000_000),
           "arith": (_arith_code()[0], b"", 0, {}, 30_000_000),
           "env": (ENV_CODE, ENV_CALLDATA, 0, {}, 30_000_000),
           "gas": (GAS_CODE, b"", 0, {}, 30_000_000),
           "oog": (GAS_CODE, b"", 0, {}, 1000)}
    calldata, codes = _fuzz_programs()
    for i, code in enumerate(codes):
        evm[f"fuzz {i}"] = (code, calldata, 7, {}, 200_000)
    for name, (code, cd, cv, st, gas) in evm.items():
        out[f"evm {name}"] = evm_c.build_guest_source(
            code, cd, cv, st, gas_limit=gas)
    for name, src in _secp_sources(secp).items():
        out[f"secp256k1 {name}"] = src
    return out


def _secp_sources(g=g) -> dict:
    out = {}
    rng = random.Random(77)
    for op, mod in (("mul_p", g.P), ("mul_n", g.N),
                    ("inv_p", g.P), ("inv_n", g.N)):
        a, b = rng.randrange(1, mod), rng.randrange(1, mod)
        out[f"unit {op}"] = g.build_unit_source(op, a, b)
    for i, (a, b) in enumerate(((g.P - 1, g.P - 1), (g.P - 1, 1),
                                (2**256 % g.P, 977))):
        out[f"unit mul_p edge {i}"] = g.build_unit_source("mul_p", a, b)
    for i, msg in enumerate(MSGS):
        out[f"recover {i}"] = g.build_guest_source(*_vector(msg))
    e, v, r, s = _vector(MSGS[0])
    out["flipped v"] = g.build_guest_source(e, 1 - v, r, s)
    good = g.sqrt_hint(r, v)
    for i, bad in enumerate((good ^ 1, (good + 1) % g.P, g.P - good)):
        out[f"forged hint {i}"] = g.build_guest_source(e, v, r, s,
                                                       ry_hint=bad)
    for i, (rr, ss) in enumerate(((g.N, s), (0, s), (r, g.N + 1), (r, 0))):
        out[f"out of range {i}"] = g.build_guest_source(e, v, rr % 2**256,
                                                        ss % 2**256)
    return out


SOURCES = _sources()
J_SOURCES = _sources(j_keccak, j_evm_c, j_secp)


@pytest.mark.parametrize("name", list(SOURCES))
def test_sources_compile_to_the_jax_compilers_bytes(name):
    """The port's guest source functions give the JAX package's text, and
    the port's compiler gives the JAX compiler's assembly, data and ELF."""
    src = SOURCES[name]
    assert src == J_SOURCES[name]
    asm, data = cc.compile_c(src)
    j_asm, j_data = j_cc.compile_c(src)
    assert asm == j_asm
    assert data == j_data
    assert cc.c_to_elf(src) == j_cc.c_to_elf(src)


def test_source_functions_match_the_jax_package():
    """keccak_c_source, the EVM and secp256k1 guest sources and the
    oracles' module constants are the JAX package's."""
    assert guest_keccak.keccak_c_source() == j_keccak.keccak_c_source()
    code, cd = guest_evm_c.TOKEN_CODE, guest_evm_c.TOKEN_CALLDATA
    assert guest_evm_c.token_source() == j_evm_c.build_guest_source(
        code, cd, 0, guest_evm_c.TOKEN_STORAGE)
    e, v, r, s = _vector(MSGS[0])
    assert g.build_guest_source(e, v, r, s) == \
        j_secp.build_guest_source(e, v, r, s)
    assert g.build_unit_source("inv_n", 5, 7) == \
        j_secp.build_unit_source("inv_n", 5, 7)
    assert (g.P, g.N, g.GX, g.GY) == (j_secp.P, j_secp.N, j_secp.GX,
                                      j_secp.GY)
    assert g.sqrt_hint(r, v) == j_secp.sqrt_hint(r, v)
    assert g.ecrecover_ref(e, v, r, s) == j_secp.ecrecover_ref(e, v, r, s)
    assert guest_evm_c.evm_mirror(code, cd, 0, {1: 41}) == \
        j_evm_c.evm_mirror(code, cd, 0, {1: 41})


def test_the_port_compiler_rebuilds_the_evm_token_fixture():
    """data/guests/evm_token.elf.gz is cc.c_to_elf of the token guest's
    source; run to its end it returns TOKEN_A0, evm_mirror's digest word 0
    (the post-state: balances[keccak(K || 0)] = A, the counter 42)."""
    blob = guest_evm_c.load_token_elf()
    assert cc.c_to_elf(guest_evm_c.token_source()) == blob
    rc, pairs, _ret, dig, _gas = guest_evm_c.evm_mirror(
        guest_evm_c.TOKEN_CODE, guest_evm_c.TOKEN_CALLDATA, 0,
        guest_evm_c.TOKEN_STORAGE)
    assert rc == 1 and dict(pairs)[1] == 42
    assert int.from_bytes(dig[:4], "little") == guest_evm_c.TOKEN_A0
    ctx, _cycles = _native_run_elf(blob, 1 << 24)
    assert ctx.regs[10] == guest_evm_c.TOKEN_A0


# ---- behaviour: the JAX tests' cases on the port


def test_compiler_produces_working_binaries():
    _final, a0 = cc.c_execute(PROGRAMS)
    assert a0 == 31 * 1000000 + 55 * 1000 + 18
    _final, a0 = cc.c_execute(ACC16)
    assert a0 == sum(i * i + 1 for i in range(16))


@pytest.mark.parametrize("i", range(len(KECCAK_MSGS)))
def test_guest_keccak256_bit_exact(i):
    """The in-guest keccak (u32 lane pairs) matches keccak256_ref, which
    gives the known empty-string digest and the JAX package's."""
    assert guest_keccak.keccak256_ref(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    msg = KECCAK_MSGS[i]
    assert guest_keccak.keccak256_ref(msg) == j_keccak.keccak256_ref(msg)
    _f, a0 = cc.c_execute(_keccak_source(msg), max_cycles=1 << 24)
    assert a0 == int.from_bytes(guest_keccak.keccak256_ref(msg)[:4],
                                "little")


def _run_guest(code, calldata, callvalue, storage, gas_limit=30_000_000):
    src = guest_evm_c.build_guest_source(code, calldata, callvalue, storage,
                                         gas_limit=gas_limit)
    program, entry, image0, _rw, mem_base = cc.load_c_elf(cc.c_to_elf(src))
    mem = {mem_base + i: int(w) for i, w in enumerate(image0) if w}
    _states, final = execute(program, entry, mem=mem, max_cycles=1 << 24)
    return final


def test_evm_bytecode_with_keccak_differential():
    """The token contract (mapping-slot keccak, storage, DIV/SHR/SAR/NOT)
    on the compiled guest == the mirror == Python big ints."""
    K, A = 0xDEADBEEF, 12345
    code, cd = guest_evm_c.TOKEN_CODE, guest_evm_c.TOKEN_CALLDATA
    rc, pairs, _ret, dig, _gas = guest_evm_c.evm_mirror(code, cd, 0,
                                                        {1: 41})
    vals = dict(pairs)
    assert rc == 1 and vals[1] == 42
    slot = int.from_bytes(guest_keccak.keccak256_ref(
        K.to_bytes(32, "big") + (0).to_bytes(32, "big")), "big")
    assert vals[slot] == A
    assert vals[7] == A // 3 and vals[8] == A >> 5
    assert vals[9] == ((A ^ U256) >> 3) | (U256 ^ (U256 >> 3))
    final = _run_guest(code, cd, 0, {1: 41})
    assert final.regs[10] == int.from_bytes(dig[:4], "little")


@pytest.mark.parametrize("cv,want", [(40, 120), (250, 7)])
def test_evm_branching_and_arithmetic(cv, want):
    rc, pairs, _ret, dig, _gas = guest_evm_c.evm_mirror(BRANCH_CODE, b"",
                                                        cv, {})
    assert rc == 0 and dict(pairs)[5] == want
    final = _run_guest(BRANCH_CODE, b"", cv, {})
    assert final.regs[10] == int.from_bytes(dig[:4], "little")


def _want(cs):
    def s2c(v):
        return v - (1 << 256) if v & MIN256 else v

    op = cs[0]
    if op == 0x04:
        return cs[1] // cs[2] if cs[2] else 0
    if op == 0x05:
        sa, sb = s2c(cs[1]), s2c(cs[2])
        return 0 if sb == 0 else ((abs(sa) // abs(sb))
                                  * (-1 if (sa < 0) != (sb < 0) else 1)
                                  & U256)
    if op == 0x06:
        return cs[1] % cs[2] if cs[2] else 0
    if op == 0x07:
        sa, sb = s2c(cs[1]), s2c(cs[2])
        return 0 if sb == 0 else ((abs(sa) % abs(sb))
                                  * (-1 if sa < 0 else 1)) & U256
    if op == 0x08:
        return (cs[1] + cs[2]) % cs[3] if cs[3] else 0
    if op == 0x09:
        return (cs[1] * cs[2]) % cs[3] if cs[3] else 0
    if op == 0x12:
        return 1 if s2c(cs[1]) < s2c(cs[2]) else 0
    if op == 0x13:
        return 1 if s2c(cs[1]) > s2c(cs[2]) else 0
    if op == 0x1A:
        return (cs[2] >> (8 * (31 - cs[1]))) & 0xFF if cs[1] < 32 else 0
    if op == 0x1B:
        return (cs[2] << cs[1]) & U256 if cs[1] < 256 else 0
    if op == 0x1C:
        return cs[2] >> cs[1] if cs[1] < 256 else 0
    assert op == 0x1D
    return ((s2c(cs[2]) >> min(cs[1], 255)) & U256 if cs[1] < 256
            else (U256 if cs[2] & MIN256 else 0))


def test_evm_extended_arithmetic_differential():
    """DIV/SDIV/MOD/SMOD/ADDMOD/MULMOD/EXP/SIGNEXTEND/SLT/SGT/BYTE/SHL/SHR/
    SAR over the JAX test's seeded operands: guest == mirror == Python."""
    code, cases, slot = _arith_code()
    rc, pairs, _ret, dig, _gas = guest_evm_c.evm_mirror(code, b"", 0, {})
    assert rc == 0
    vals = dict(pairs)
    for i, cs in enumerate(cases):
        assert vals[i] == _want(cs), f"case {i} op {cs[0]:#x}"
    assert vals[slot - 2] == pow(123456789, 3, 1 << 256)
    assert vals[slot - 1] == (1 << 256) - 0x80
    final = _run_guest(code, b"", 0, {})
    assert final.regs[10] == int.from_bytes(dig[:4], "little")


def test_evm_env_copy_and_log_opcodes():
    rc, pairs, _ret, dig, _gas = guest_evm_c.evm_mirror(ENV_CODE,
                                                        ENV_CALLDATA, 0, {})
    assert rc == 0
    vals = dict(pairs)
    assert vals[0] == len(ENV_CALLDATA) and vals[1] == len(ENV_CODE)
    assert vals[3] == 96 and vals[4] < 30_000_000
    final = _run_guest(ENV_CODE, ENV_CALLDATA, 0, {})
    assert final.regs[10] == int.from_bytes(dig[:4], "little")
    nolog = ENV_CODE[: -len(_push32(4) + _push32(64) + b"\xa0\x00")] \
        + bytes([0x00])
    assert guest_evm_c.evm_mirror(nolog, ENV_CALLDATA, 0, {})[3] != dig


def test_evm_random_program_fuzz_differential():
    """The JAX test's 12 random programs (seed 0xF122, gas 200,000): the
    guest's digest equals the mirror's on every clean end, a0 is 0 on
    every error or out-of-gas end, and the mirror equals the JAX one."""
    calldata, codes = _fuzz_programs()
    n_ok = 0
    for trial, code in enumerate(codes):
        res = guest_evm_c.evm_mirror(code, calldata, 7, {}, gas_limit=200_000)
        assert res == j_evm_c.evm_mirror(code, calldata, 7, {},
                                         gas_limit=200_000)
        rc, dig = res[0], res[3]
        final = _run_guest(code, calldata, 7, {}, gas_limit=200_000)
        if rc in (0, 1):
            assert final.regs[10] == int.from_bytes(dig[:4], "little"), trial
            n_ok += 1
        else:
            assert final.regs[10] == 0, trial
    assert n_ok >= 6


def test_evm_gas_metering_and_oog():
    rc, pairs, _r, dig, gas = guest_evm_c.evm_mirror(GAS_CODE, b"", 0, {})
    assert rc == 0 and dict(pairs) == {5: 7, 6: 100}
    assert gas < 30_000_000
    final = _run_guest(GAS_CODE, b"", 0, {})
    assert final.regs[10] == int.from_bytes(dig[:4], "little")
    rc2 = guest_evm_c.evm_mirror(GAS_CODE, b"", 0, {}, gas_limit=1000)[0]
    assert rc2 == 3
    src = guest_evm_c.build_guest_source(GAS_CODE, b"", 0, {},
                                         gas_limit=1000)
    _f, a0 = cc.c_execute(src, max_cycles=1 << 24)
    assert a0 == 0


# ---- secp256k1 on the native executor


def _native_run_elf(blob: bytes, max_cycles: int):
    program, entry, image0, ram_words, mem_base = cc.load_c_elf(blob)
    ctx = rn.NativeRun(program, entry, mem_words=np.asarray(
        image0, dtype=np.uint32), mem_base=mem_base, n_words=ram_words)
    rc, cycles, _rows, _ = ctx.run(max_cycles=max_cycles)
    assert rc == rn.RV_HALTED, "guest did not halt"
    return ctx, cycles


def _native_run(src: str, max_cycles: int = 1 << 26):
    return _native_run_elf(cc.c_to_elf(src), max_cycles)


def _read_out_addr(src: str, ctx) -> bytes:
    c = cc.Compiler()
    c.compile(src)
    base, _t = c.globals["out_addr"]
    out = bytearray()
    for i in range(20):
        ba = base + i
        w = int(ctx.mem[(ba >> 2) - ctx.mem_base])
        out.append((w >> (8 * (ba & 3))) & 0xFF)
    return bytes(out)


def test_field_unit_guests_differential():
    for name, src in _secp_sources().items():
        if name.startswith("unit"):
            ctx, _ = _native_run(src)
            assert ctx.regs[10] == 1, f"{name} mismatch vs host bignum"


@pytest.mark.parametrize("msg", MSGS)
def test_ecrecover_bit_exact_vs_reference(msg):
    e, v, r, s = _vector(msg)
    expect = g.ecrecover_ref(e, v, r, s)
    assert expect == g.address_of(g.pubkey_of(PRIV))
    assert expect == j_secp.ecrecover_ref(e, v, r, s)
    src = g.build_guest_source(e, v, r, s)
    ctx, cycles = _native_run(src)
    assert ctx.regs[10] == 1, "guest reported invalid signature"
    assert _read_out_addr(src, ctx) == expect
    assert cycles > 10_000_000


def test_flipped_v_recovers_the_other_candidate():
    e, v, r, s = _vector(MSGS[0])
    src = g.build_guest_source(e, 1 - v, r, s)
    ctx, _ = _native_run(src)
    assert ctx.regs[10] == 1
    got = _read_out_addr(src, ctx)
    assert got == g.ecrecover_ref(e, 1 - v, r, s) != g.ecrecover_ref(e, v,
                                                                     r, s)


def test_forged_hint_fails_closed():
    """A wrong ry (wrong root, wrong parity) can only make the guest
    return 0, never a recovered address."""
    e, v, r, s = _vector(MSGS[0])
    good = g.sqrt_hint(r, v)
    for bad in (good ^ 1, (good + 1) % g.P, g.P - good):
        ctx, _ = _native_run(g.build_guest_source(e, v, r, s, ry_hint=bad),
                             max_cycles=1 << 22)
        assert ctx.regs[10] == 0, "forged hint must be rejected"


def test_out_of_range_signature_rejected():
    e, v, r, s = _vector(MSGS[0])
    for rr, ss in ((g.N, s), (0, s), (r, g.N + 1), (r, 0)):
        ctx, _ = _native_run(g.build_guest_source(e, v, rr % 2**256,
                                                  ss % 2**256),
                             max_cycles=1 << 22)
        assert ctx.regs[10] == 0
