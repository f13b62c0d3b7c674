"""Native RV32IM execution: ctypes adapter for native/rv32_exec.cpp.

Copy of eigen_zkvm_tpu/zkvm/rv32_native.py for the PyTorch port; the
C++ source is the port's copy (eigen_zkvm_tpu_torch/native/), built with
g++ at first use into eigen_zkvm_tpu_torch/_build/ (git-ignored).  There
is no fallback: when g++ is missing, the build fails or the library does
not load, `library()` (and with it `NativeRun` and `NativeChunker`)
raises `NativeBuildError` with the compiler's output.

The reference's guests run through compiled Rust (powdr executor,
zkvm/src/lib.rs:168-231).  This adapter gives the native machine the same
property: guests execute at ~10^8 instr/s over a dense word memory, with
chunk-boundary snapshots so that continuation chunks can be
re-materialized individually — proving a selected chunk of a
multi-million-cycle guest costs one small capture run, not a full
Python-interpreter replay.

The Python interpreter (rv32_isa.execute) stays the semantic authority;
tests/test_torch_rv32.py drives both over the same guests and asserts
state-for-state equality.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from dataclasses import dataclass

import numpy as np

from .rv32_isa import RvState

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "rv32_exec.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# the executor uses no OpenMP, and no -march=native: a build directory
# copied to another host must still load there
CXX_FLAGS = ["-O3", "-funroll-loops", "-shared", "-fPIC"]

# Fixed ABI op ids — must match `enum Op` in native/rv32_exec.cpp.
OP_IDS = {
    "add": 0, "sub": 1, "sll": 2, "slt": 3, "sltu": 4, "xor": 5, "srl": 6,
    "sra": 7, "or": 8, "and": 9, "mul": 10, "mulh": 11, "mulhsu": 12,
    "mulhu": 13, "div": 14, "divu": 15, "rem": 16, "remu": 17, "addi": 18,
    "andi": 19, "ori": 20, "xori": 21, "slti": 22, "sltiu": 23, "slli": 24,
    "srli": 25, "srai": 26, "lb": 27, "lh": 28, "lw": 29, "lbu": 30,
    "lhu": 31, "sb": 32, "sh": 33, "sw": 34, "beq": 35, "bne": 36,
    "blt": 37, "bge": 38, "bltu": 39, "bgeu": 40, "lui": 41, "auipc": 42,
    "jal": 43, "jalr": 44, "ecall": 45, "fence": 46,
}
_GAP = 255  # undecodable / unmapped pc slot -> RV_ERR_PC

RV_HALTED, RV_ROWS, RV_CYCLES = 0, 1, 2

_lib = None


class NativeBuildError(RuntimeError):
    pass


def build() -> str:
    """The executor's shared library in BUILD_DIR, compiled with g++
    unless a build of the same source, flags and host architecture is
    there already.  Returns its path; raises NativeBuildError with g++'s
    output when it cannot be built."""
    with open(SRC, "rb") as f:
        src = f.read()
    stamp = hashlib.sha256(" ".join(CXX_FLAGS + [platform.machine()])
                           .encode() + b"\0" + src).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"librv32_exec.{stamp}.so")
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found on PATH: the native RV32 "
                               "executor cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"g++ did not run: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ failed on {SRC} ({proc.returncode}):"
                               f"\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def library():
    """The loaded executor (built at first use); raises NativeBuildError
    when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    so = build()
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        raise NativeBuildError(f"cannot load {so}: {e}") from e
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rv32_run.restype = ctypes.c_int
    lib.rv32_run.argtypes = [
        u8p, u8p, u8p, u8p, i32p, ctypes.c_int64, ctypes.c_uint32,
        u32p, ctypes.c_int64, ctypes.c_int64,
        u32p, u32p,
        ctypes.c_int64, ctypes.c_int64,
        u32p, u8p, u32p, u32p, u32p, u32p, u8p,
        i64p, i64p,
    ]
    _lib = lib
    return lib


@dataclass
class PackedProgram:
    op: np.ndarray
    rd: np.ndarray
    rs1: np.ndarray
    rs2: np.ndarray
    imm: np.ndarray
    text_base: int


def pack_program(program: dict) -> PackedProgram:
    """Dense program arrays indexed by (pc - text_base) / 4."""
    pcs = sorted(program)
    base = pcs[0]
    n = (pcs[-1] - base) // 4 + 1
    op = np.full(n, _GAP, dtype=np.uint8)
    rd = np.zeros(n, dtype=np.uint8)
    rs1 = np.zeros(n, dtype=np.uint8)
    rs2 = np.zeros(n, dtype=np.uint8)
    imm64 = np.zeros(n, dtype=np.int64)
    for pc, ins in program.items():
        i = (pc - base) // 4
        op[i] = OP_IDS[ins.op]
        rd[i] = ins.rd
        rs1[i] = ins.rs1
        rs2[i] = ins.rs2
        imm64[i] = ins.imm & 0xFFFFFFFF
    return PackedProgram(op, rd, rs1, rs2,
                         imm64.astype(np.uint32).view(np.int32), base)


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


class NativeRun:
    """One native execution context: dense memory + register file that
    persist across resumed `run` calls (chunked execution)."""

    def __init__(self, program: dict, pc0: int, regs0=None,
                 mem_words: np.ndarray | None = None, mem_base: int = 0,
                 n_words: int | None = None):
        self.pp = program if isinstance(program, PackedProgram) \
            else pack_program(program)
        self.pc = np.array([pc0], dtype=np.uint32)
        self.regs = np.zeros(32, dtype=np.uint32)
        if regs0 is not None:
            self.regs[:] = np.asarray(regs0, dtype=np.uint64).astype(
                np.uint32)
        self.mem_base = mem_base
        if mem_words is not None:
            self.mem = np.ascontiguousarray(mem_words, dtype=np.uint32)
            if n_words is not None and n_words > len(self.mem):
                self.mem = np.concatenate(
                    [self.mem, np.zeros(n_words - len(self.mem),
                                        dtype=np.uint32)])
        else:
            self.mem = np.zeros(n_words or (1 << 16), dtype=np.uint32)
        self.halted = False

    def run(self, max_rows: int = 1 << 62, max_cycles: int = 1 << 22,
            capture: bool = False):
        """Execute until halt / row budget / cycle cap.  Returns
        (rc, cycles, rows, trace) where trace is a dict of compact
        per-cycle arrays when capture=True."""
        lib = library()
        cap_n = min(max_cycles, max_rows) if capture else 0
        t = {k: np.zeros(cap_n, dtype=d) for k, d in (
            ("pc", np.uint32), ("rd", np.uint8), ("rdv", np.uint32),
            ("mwa", np.uint32), ("mold", np.uint32), ("mnew", np.uint32),
            ("mfl", np.uint8))} if capture else None
        oc = np.zeros(1, dtype=np.int64)
        orw = np.zeros(1, dtype=np.int64)
        u32, u8, i32, i64 = (ctypes.c_uint32, ctypes.c_uint8,
                             ctypes.c_int32, ctypes.c_int64)
        rc = lib.rv32_run(
            _ptr(self.pp.op, u8), _ptr(self.pp.rd, u8),
            _ptr(self.pp.rs1, u8), _ptr(self.pp.rs2, u8),
            _ptr(self.pp.imm, i32), len(self.pp.op), self.pp.text_base,
            _ptr(self.mem, u32), len(self.mem), self.mem_base,
            _ptr(self.regs, u32), _ptr(self.pc, u32),
            max_rows, min(max_cycles, cap_n or max_cycles),
            *( [_ptr(t["pc"], u32), _ptr(t["rd"], u8), _ptr(t["rdv"], u32),
                _ptr(t["mwa"], u32), _ptr(t["mold"], u32),
                _ptr(t["mnew"], u32), _ptr(t["mfl"], u8)] if capture
               else [ctypes.POINTER(u32)(), ctypes.POINTER(u8)(),
                     ctypes.POINTER(u32)(), ctypes.POINTER(u32)(),
                     ctypes.POINTER(u32)(), ctypes.POINTER(u32)(),
                     ctypes.POINTER(u8)()] ),
            _ptr(oc, i64), _ptr(orw, i64))
        assert rc >= 0, f"native executor error rc={rc} at pc={self.pc[0]:#x}"
        if rc == RV_HALTED:
            self.halted = True
        return rc, int(oc[0]), int(orw[0]), t


def materialize_states(regs_in, pc_in: int, trace: dict, n_cycles: int,
                       final_pc: int, halted: bool) -> list[RvState]:
    """Reconstruct the rv32_isa.execute `states` list for one chunk from
    the compact capture (identical layout: state k+1 carries instruction
    k's mem_op; the last state is flagged halted after an ecall)."""
    regs = [int(x) for x in regs_in]
    states = [RvState(pc_in, list(regs))]
    t_pc, t_rd, t_rdv = trace["pc"], trace["rd"], trace["rdv"]
    t_mwa, t_mold, t_mnew, t_mfl = (trace["mwa"], trace["mold"],
                                    trace["mnew"], trace["mfl"])
    for i in range(n_cycles):
        rd = int(t_rd[i])
        if rd:
            regs[rd] = int(t_rdv[i])
        fl = int(t_mfl[i])
        mem_op = None if fl == 0 else (
            int(t_mwa[i]), int(t_mold[i]), int(t_mnew[i]),
            1 if fl == 2 else 0)
        npc = int(t_pc[i + 1]) if i + 1 < n_cycles else final_pc
        states.append(RvState(npc, list(regs), False, mem_op=mem_op))
    if halted:
        states[-1].halted = True
    return states


def execute_native(program, pc0: int, regs0=None, mem: dict | None = None,
                   max_cycles: int = 1 << 32, n_words: int | None = None,
                   mem_base: int = 0):
    """Drop-in final-state equivalent of rv32_isa.execute (no state list):
    returns (final RvState, cycles).  `mem` is the word-addressed dict
    the Python executor takes; it must fit the dense window."""
    mw = np.zeros(n_words or (1 << 16), dtype=np.uint32)
    if mem:
        hi = max(mem)
        assert hi - mem_base < len(mw), "memory outside the dense window"
        for a, v in mem.items():
            mw[a - mem_base] = v
    ctx = NativeRun(program, pc0, regs0, mem_words=mw, mem_base=mem_base)
    rc, cycles, rows, _ = ctx.run(max_cycles=max_cycles)
    assert rc == RV_HALTED, f"guest did not halt (rc={rc})"
    final = RvState(int(ctx.pc[0]), [int(x) for x in ctx.regs], True)
    return final, cycles


@dataclass
class ChunkInfo:
    regs_in: np.ndarray      # 32 x u32 at chunk entry
    pc_in: int
    image_in: np.ndarray     # u64 RAM image at chunk entry (ram_words)
    n_cycles: int
    n_rows: int
    halted: bool             # this chunk ends at the final ecall


class NativeChunker:
    """Row-budgeted continuation chunking without state materialization:
    runs the guest natively, snapshotting (regs, pc, RAM image) at every
    chunk boundary.  `states_for(k)` re-executes one chunk with capture
    to produce the exact rv32_isa state list for arithmetization —
    chunk-boundary semantics mirror rv32_lib.rv32_generate_chunks (each
    chunk carries at most 2^n_bits trace rows including the boundary
    row; sb/sh cost 2)."""

    def __init__(self, program: dict, entry: int = 0, n_bits: int = 12,
                 ram_words: int | None = None, image0=None, regs0=None,
                 rows_budget: int | None = None, mem_base: int = 0,
                 max_cycles: int = 1 << 34):
        self.program = program
        self.pp = pack_program(program)
        self.n_bits = n_bits
        self.budget = (rows_budget or (1 << n_bits)) - 1  # boundary row
        self.ram_words = ram_words
        self.mem_base = mem_base
        nw = ram_words if ram_words is not None else (1 << 16)
        image0 = (np.zeros(nw, dtype=np.uint64) if image0 is None
                  else np.asarray(image0, dtype=np.uint64))
        self.chunks: list[ChunkInfo] = []
        ctx = NativeRun(self.pp, entry, regs0,
                        mem_words=image0.astype(np.uint32),
                        mem_base=mem_base, n_words=nw)
        total = 0
        while True:
            info = ChunkInfo(ctx.regs.copy(), int(ctx.pc[0]),
                             ctx.mem.astype(np.uint64), 0, 0, False)
            rc, cycles, rows, _ = ctx.run(max_rows=self.budget,
                                          max_cycles=max_cycles)
            info.n_cycles, info.n_rows = cycles, rows
            info.halted = rc == RV_HALTED
            self.chunks.append(info)
            total += cycles
            if rc == RV_HALTED:
                break
            assert rc == RV_ROWS, f"unexpected rc={rc}"
            assert cycles > 0, "chunk made no progress (budget too small)"
            if total > max_cycles:
                raise RuntimeError("execution exceeded max_cycles")
        self.final = RvState(int(ctx.pc[0]),
                             [int(x) for x in ctx.regs], ctx.halted)
        # post-halt RAM image: the final chunk's mem_out publics digest
        # exactly this (the last chunk spins at the ecall, so no writes
        # follow) — consumers bind guest outputs through it
        self.final_image = ctx.mem.astype(np.uint64)
        self.total_cycles = total

    def states_for(self, k: int) -> tuple[list[RvState], np.ndarray]:
        """(states, image_in) for chunk k — the rv32_generate_chunks
        chunk tuple, materialized on demand."""
        info = self.chunks[k]
        ctx = NativeRun(self.pp, info.pc_in, info.regs_in,
                        mem_words=info.image_in.astype(np.uint32),
                        mem_base=self.mem_base,
                        n_words=len(info.image_in))
        rc, cycles, rows, trace = ctx.run(max_rows=self.budget,
                                          capture=True,
                                          max_cycles=info.n_cycles + 1)
        assert cycles == info.n_cycles, "non-deterministic replay"
        # halted comes from the authoritative capture run: when the final
        # ecall lands exactly on the row budget, the replay's cycle cap
        # (cap_n = min(n_cycles+1, budget) = n_cycles) makes it exit with
        # RV_CYCLES before re-fetching the ecall, so rc alone under-reports
        states = materialize_states(info.regs_in, info.pc_in, trace,
                                    cycles, int(ctx.pc[0]),
                                    info.halted)
        return states, info.image_in
