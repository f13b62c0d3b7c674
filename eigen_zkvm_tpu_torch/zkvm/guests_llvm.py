"""LLVM-compiled guest programs (foreign-codegen fixtures).

Three guests authored as textual LLVM IR and compiled by the system
libLLVM-15 RISC-V backend at -O2 (zkvm/llvm_backend.py) — the foreign
-toolchain exposure the in-repo cc.py (-O0-shaped) cannot provide
(reference analog: powdr compile_rust, zkvm/src/lib.rs:172).  The
linked ELF bytes are committed under data/llvm_guests/ (provenance:
`llvm_backend.ir_to_elf` of these IR strings; byte-stable for the pinned
LLVM 15).

Each guest returns its result in a0 at the final ecall; `*_expected()`
is the host-side oracle.

Copy of eigen_zkvm_tpu/zkvm/guests_llvm.py for the PyTorch port: its
`DATA_DIR` holds the port's own copy of the three ELFs,
eigen_zkvm_tpu_torch/data/llvm_guests/<name>.elf.gz (gzip of the JAX
package's bytes); `load_fixture` returns the ELF bytes."""
from __future__ import annotations

import gzip
import os

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "llvm_guests")

# ---------------------------------------------------------------------------
# Guest 1: CRC32 — runtime-generated table (global array stores through
# auipc-relative addressing under medany), byte loads, shift/xor loops.
# ---------------------------------------------------------------------------
CRC32_IR = r"""
@table = internal global [256 x i32] zeroinitializer, align 4
@buf = internal global [64 x i8] zeroinitializer, align 1

define internal void @mktable() {
entry:
  br label %outer
outer:
  %n = phi i32 [0, %entry], [%n1, %outer.end]
  br label %inner
inner:
  %k = phi i32 [0, %outer], [%k1, %inner]
  %c = phi i32 [%n, %outer], [%c2, %inner]
  %odd = and i32 %c, 1
  %isodd = icmp ne i32 %odd, 0
  %shr = lshr i32 %c, 1
  %x = xor i32 %shr, -306674912
  %c2 = select i1 %isodd, i32 %x, i32 %shr
  %k1 = add i32 %k, 1
  %kc = icmp ult i32 %k1, 8
  br i1 %kc, label %inner, label %outer.end
outer.end:
  %p = getelementptr [256 x i32], [256 x i32]* @table, i32 0, i32 %n
  store i32 %c2, i32* %p
  %n1 = add i32 %n, 1
  %nc = icmp ult i32 %n1, 256
  br i1 %nc, label %outer, label %done
done:
  ret void
}

define i32 @main() {
entry:
  call void @mktable()
  br label %fill
fill:
  %i = phi i32 [0, %entry], [%i1, %fill]
  %v = mul i32 %i, 197
  %v2 = add i32 %v, 13
  %vt = trunc i32 %v2 to i8
  %bp = getelementptr [64 x i8], [64 x i8]* @buf, i32 0, i32 %i
  store i8 %vt, i8* %bp
  %i1 = add i32 %i, 1
  %fc = icmp ult i32 %i1, 64
  br i1 %fc, label %fill, label %crc
crc:
  %j = phi i32 [0, %fill], [%j1, %crc]
  %acc = phi i32 [-1, %fill], [%acc1, %crc]
  %cp = getelementptr [64 x i8], [64 x i8]* @buf, i32 0, i32 %j
  %byte = load i8, i8* %cp
  %bz = zext i8 %byte to i32
  %mix = xor i32 %acc, %bz
  %idx = and i32 %mix, 255
  %tp = getelementptr [256 x i32], [256 x i32]* @table, i32 0, i32 %idx
  %tv = load i32, i32* %tp
  %hi = lshr i32 %acc, 8
  %acc1 = xor i32 %tv, %hi
  %j1 = add i32 %j, 1
  %jc = icmp ult i32 %j1, 64
  br i1 %jc, label %crc, label %done
done:
  %out = xor i32 %acc1, -1
  ret i32 %out
}
"""


def crc32_expected() -> int:
    import zlib

    data = bytes((i * 197 + 13) & 0xFF for i in range(64))
    return zlib.crc32(data)


# ---------------------------------------------------------------------------
# Guest 2: widening-multiply + constant-division mix — i64 multiplies
# select mulh/mulhu, x/7 and x%10 compile to magic-number sequences
# (mulh + srli/srai + add) cc.py never emits; plus a Collatz branch loop.
# ---------------------------------------------------------------------------
MULDIV_IR = r"""
define i32 @main() {
entry:
  br label %loop
loop:
  %i = phi i32 [1, %entry], [%i1, %loop]
  %s = phi i32 [0, %entry], [%s4, %loop]
  %a = mul i32 %i, -1640531535        ; 2654435761 (u32 wrap)
  %a64u = zext i32 %a to i64
  %i64u = zext i32 %i to i64
  %pu = mul i64 %a64u, %i64u
  %hu = lshr i64 %pu, 32
  %huw = trunc i64 %hu to i32         ; mulhu a, i
  %a64s = sext i32 %a to i64
  %i64s = sext i32 %i to i64
  %ps = mul i64 %a64s, %i64s
  %hs = lshr i64 %ps, 32
  %hsw = trunc i64 %hs to i32         ; mulh a, i
  %q7 = sdiv i32 %a, 7                ; magic-number division
  %r10 = urem i32 %a, 10              ; magic-number remainder
  %s1 = add i32 %s, %huw
  %s2 = xor i32 %s1, %hsw
  %s3 = add i32 %s2, %q7
  %s4 = add i32 %s3, %r10
  %i1 = add i32 %i, 1
  %c = icmp ult i32 %i1, 200
  br i1 %c, label %loop, label %collatz
collatz:
  %n = phi i32 [27, %loop], [%n2, %odd], [%n1, %even]
  %len = phi i32 [0, %loop], [%len1, %odd], [%len1, %even]
  %done = icmp eq i32 %n, 1
  br i1 %done, label %exit, label %step
step:
  %len1 = add i32 %len, 1
  %par = and i32 %n, 1
  %iseven = icmp eq i32 %par, 0
  br i1 %iseven, label %even, label %odd
even:
  %n1 = lshr i32 %n, 1
  br label %collatz
odd:
  %t = mul i32 %n, 3
  %n2 = add i32 %t, 1
  br label %collatz
exit:
  %mix = mul i32 %len, 65599
  %out = add i32 %s4, %mix
  ret i32 %out
}
"""


def muldiv_expected() -> int:
    M = 0xFFFFFFFF

    def s32(v):
        return v - (1 << 32) if v & 0x80000000 else v

    s = 0
    for i in range(1, 200):
        a = (i * 2654435761) & M
        huw = (a * i) >> 32
        hsw = ((s32(a) * i) >> 32) & M
        sa = s32(a)
        q7 = (abs(sa) // 7) * (-1 if sa < 0 else 1) & M
        r10 = a % 10
        s = (s + huw) & M
        s ^= hsw
        s = (s + q7) & M
        s = (s + r10) & M
    n, ln = 27, 0
    while n != 1:
        ln += 1
        n = n // 2 if n % 2 == 0 else 3 * n + 1
    return (s + ln * 65599) & M


# ---------------------------------------------------------------------------
# Guest 3: shellsort over an alloca array — sp-relative frame addressing,
# register pressure/spills, signed compares, gap sequence division.
# ---------------------------------------------------------------------------
SORT_IR = r"""
define i32 @main() {
entry:
  %arr = alloca [64 x i32], align 4
  br label %fill
fill:
  %i = phi i32 [0, %entry], [%i1, %fill]
  %seed = phi i32 [12345, %entry], [%seed1, %fill]
  %m = mul i32 %seed, 1103515245
  %seed1 = add i32 %m, 12345
  %val = srem i32 %seed1, 1000
  %p = getelementptr [64 x i32], [64 x i32]* %arr, i32 0, i32 %i
  store i32 %val, i32* %p
  %i1 = add i32 %i, 1
  %c = icmp ult i32 %i1, 64
  br i1 %c, label %fill, label %gaps
gaps:
  %gap = phi i32 [32, %fill], [%gap1, %gapnext]
  %gz = icmp eq i32 %gap, 0
  br i1 %gz, label %sum, label %outer
outer:
  %oi = phi i32 [%gap, %gaps], [%oi1, %place]
  %pp = getelementptr [64 x i32], [64 x i32]* %arr, i32 0, i32 %oi
  %tmp = load i32, i32* %pp
  br label %shift
shift:
  %j = phi i32 [%oi, %outer], [%jm, %doshift]
  %big = icmp uge i32 %j, %gap
  br i1 %big, label %cmp, label %place
cmp:
  %jm = sub i32 %j, %gap
  %qp = getelementptr [64 x i32], [64 x i32]* %arr, i32 0, i32 %jm
  %qv = load i32, i32* %qp
  %gt = icmp sgt i32 %qv, %tmp
  br i1 %gt, label %doshift, label %place
doshift:
  %dp = getelementptr [64 x i32], [64 x i32]* %arr, i32 0, i32 %j
  store i32 %qv, i32* %dp
  br label %shift
place:
  %fp = getelementptr [64 x i32], [64 x i32]* %arr, i32 0, i32 %j
  store i32 %tmp, i32* %fp
  %oi1 = add i32 %oi, 1
  %oc = icmp ult i32 %oi1, 64
  br i1 %oc, label %outer, label %outer.end.pre
outer.end.pre:
  br label %outer.end
outer.end:
  %gap1 = lshr i32 %gap, 1
  br label %gapnext
gapnext:
  br label %gaps
sum:
  %k = phi i32 [0, %gaps], [%k1, %sum]
  %acc = phi i32 [0, %gaps], [%acc1, %sum]
  %sp = getelementptr [64 x i32], [64 x i32]* %arr, i32 0, i32 %k
  %sv = load i32, i32* %sp
  %w = mul i32 %acc, 31
  %acc1 = add i32 %w, %sv
  %k1 = add i32 %k, 1
  %kc = icmp ult i32 %k1, 64
  br i1 %kc, label %sum, label %ret
ret:
  ret i32 %acc1
}
"""


def sort_expected() -> int:
    M = 0xFFFFFFFF

    def s32(v):
        return v - (1 << 32) if v & 0x80000000 else v

    arr = []
    seed = 12345
    for _ in range(64):
        seed = (seed * 1103515245 + 12345) & M
        s = s32(seed)
        v = abs(s) % 1000 * (-1 if s < 0 else 1)  # C srem semantics
        arr.append(v)
    arr.sort()
    acc = 0
    for v in arr:
        acc = (acc * 31 + v) & M
    return acc


GUESTS = {
    "crc32": (CRC32_IR, crc32_expected),
    "muldiv": (MULDIV_IR, muldiv_expected),
    "sort": (SORT_IR, sort_expected),
}


def fixture_path(name: str) -> str:
    return os.path.join(DATA_DIR, f"{name}.elf.gz")


def load_fixture(name: str) -> bytes:
    with open(fixture_path(name), "rb") as f:
        return gzip.decompress(f.read())
